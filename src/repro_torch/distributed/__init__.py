"""A mesh of devices in one process: the sharding rules (``sharding``: the
LM rule table the dry run lays cells out by, and the replicated-weights,
sharded-batch serving rules), heartbeats, stragglers, the elastic shrink
and the recovery loop (``fault_tolerance``), and the compressed
data-parallel gradient reduce (``compression``)."""
