"""PyTorch and CUDA port of the binarized-network package ``repro``.

Imports ``torch`` and never ``jax`` or ``repro``. Layout mirrors the
JAX package: ``core`` (bit ops, layers, the CIFAR BNN), ``kernels``
(hand-written CUDA kernels for Hopper and their wrappers), ``serve``
(the serving engines), ``optim``, ``train`` and ``checkpoint`` (the
BNN trainer and its resumable checkpoints), ``data`` (the synthetic
streams), ``models`` and ``configs`` (the LM stack) and ``launch`` (the
CLIs).
"""
