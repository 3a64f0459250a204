"""A mesh of devices in one process: the sharding rules (``sharding``: the
LM rule table the dry run and tensor-parallel training lay params out by,
the activation constraints, and the replicated-weights, sharded-batch
serving rules), the model axis's collectives and laid-out tensors
(``tensor_parallel``), heartbeats, stragglers, the elastic shrink
and the recovery loop (``fault_tolerance``), and the compressed
data-parallel gradient reduce (``compression``)."""
