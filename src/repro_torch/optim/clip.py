"""Global-norm gradient clipping, of a tree or of a tree laid out over the
model axis (``distributed.sharding.Shards``)."""

from __future__ import annotations

import torch

from repro_torch import tree
from repro_torch.distributed.sharding import MODEL_AXIS, Shards, spec_at


def _square_sum(g: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.square(g.to(torch.float32)))


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, the leaves added in
    ``jax.tree.leaves`` order (``repro_torch.tree``), as the JAX package
    adds them.

    Of ``Shards`` (one data shard's trees, one a model rank, on the first
    rank's device): a leaf split over the model axis adds its ranks'
    sums of squares in rank order, and a replicated leaf, whose every rank
    holds the whole gradient, is counted once, so the norm is the whole
    tree's."""
    if not isinstance(grads, Shards):
        total = 0
        for g in tree.leaves(grads):
            total = total + _square_sum(g)
        return torch.sqrt(total)
    row = grads.rows()[0]
    home = tree.leaves(row[0])[0].device
    total = 0
    for (path, first), *rest in zip(tree.leaves_with_path(row[0]),
                                    *map(tree.leaves, row[1:])):
        parts = [first, *rest] if MODEL_AXIS in spec_at(grads.specs, path) else [first]
        for g in parts:
            total = total + _square_sum(g).to(home)
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float):
    """Returns (clipped_grads, pre_clip_norm): every leaf (every rank's,
    of ``Shards``) scaled by ``min(1, max_norm / (norm + 1e-9))``."""
    norm = global_norm(grads)
    # A true division: ``float / tensor`` is a reciprocal and a product
    # in torch, which rounds twice.
    scale = torch.clamp(torch.div(max_norm, norm + 1e-9), max=1.0)

    def clip(g):
        return (g * scale.to(g.device)).to(g.dtype)

    if isinstance(grads, Shards):
        return Shards([tree.tree_map(clip, t) for t in grads], grads.specs,
                      grads.mesh), norm
    return tree.tree_map(clip, grads), norm
