"""Global-norm gradient clipping."""

from __future__ import annotations

import torch

from repro_torch import tree


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, the leaves added in
    ``jax.tree.leaves`` order (``repro_torch.tree``), as the JAX package
    adds them."""
    total = 0
    for g in tree.leaves(grads):
        total = total + torch.sum(torch.square(g.to(torch.float32)))
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float):
    """Returns (clipped_grads, pre_clip_norm)."""
    norm = global_norm(grads)
    # A true division: ``float / tensor`` is a reciprocal and a product
    # in torch, which rounds twice.
    scale = torch.clamp(torch.div(max_norm, norm + 1e-9), max=1.0)
    return tree.tree_map(lambda g: (g * scale).to(g.dtype), grads), norm
