"""Deterministic synthetic data, as ``repro.data``."""
