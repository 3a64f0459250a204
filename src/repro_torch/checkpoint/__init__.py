"""Checksummed, resumable checkpoints, as ``repro.checkpoint``."""
