"""The roofline of a step without running it on the fleet: its cost
counted op by op (``op_cost``) and the three-term bound against the
H100's published peaks (``analysis``)."""
