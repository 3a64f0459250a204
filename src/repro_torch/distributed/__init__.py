"""A mesh of devices in one process: the replicated-weights,
sharded-batch serving rules (``sharding``), heartbeats, stragglers, the
elastic shrink and the recovery loop (``fault_tolerance``), and the
compressed data-parallel gradient reduce (``compression``). Not ported:
``fault_tolerance.make_elastic_mesh`` and ``sharding``'s LM rule table,
which wait for the LM trainer (ROADMAP A5, A6)."""
