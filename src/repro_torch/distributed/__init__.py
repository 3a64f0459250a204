"""Serving over a mesh of devices in one process: the replicated-weights,
sharded-batch rules (``sharding``) and the heartbeat and elastic shrink
(``fault_tolerance``). The JAX package's training halves of both modules
and ``compression.py`` wait for ROADMAP A3 (the resilient trainer and the
1-bit gradient all-reduce)."""
