"""PyTorch and CUDA port of the binarized-network package ``repro``.

Imports ``torch`` and never ``jax`` or ``repro``. Layout mirrors the
JAX package: ``core`` (bit ops, layers, the CIFAR BNN), ``kernels``
(hand-written CUDA kernels for Hopper and their wrappers), ``serve``
(the bucket-scheduled serving engine) and ``launch`` (the CLI).
"""
