"""Hand-written CUDA kernels for Hopper (``csrc/``), their build and
their checked, counted wrappers (``ops``)."""
