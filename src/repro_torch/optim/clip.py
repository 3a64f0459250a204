"""Global-norm gradient clipping, of a tree or of a tree laid out over a
mesh (``distributed.sharding.Shards``)."""

from __future__ import annotations

import torch

from repro_torch import tree
from repro_torch.distributed import process_group as pg
from repro_torch.distributed.sharding import (Shards, data_dim, model_axis_size,
                                              model_dim, spec_at)


def _square_sum(g: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.square(g.to(torch.float32)))


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, the leaves added in
    ``jax.tree.leaves`` order (``repro_torch.tree``), as the JAX package
    adds them.

    Of ``Shards`` (one tree a device of a mesh, each leaf the device's
    block), on the first device: each leaf adds the sums of squares of its
    distinct blocks in mesh order, so the norm is the whole tree's: a leaf
    split over the data axes each data row's block once, a leaf split over
    the model axis each rank's part once, a leaf a dim of which neither
    splits (held whole, or whole over the other axis) counted once over
    that axis. Where the mesh runs one process a device (its ``position``
    set) each process squares its own blocks, gathers every device's sums
    over the world and adds them in the same order, so every process holds
    the same norm, bit for bit the one-process norm."""
    if not isinstance(grads, Shards):
        total = 0
        for g in tree.leaves(grads):
            total = total + _square_sum(g)
        return torch.sqrt(total)
    m = model_axis_size(grads.mesh)
    home = tree.leaves(grads[0])[0].device
    if getattr(grads.mesh, "position", None) is None:
        blocks, square = list(zip(*map(tree.leaves, grads))), _square_sum
    else:
        own = torch.stack([_square_sum(g) for g in tree.leaves(grads[0])])
        blocks, square = list(zip(*pg.gather(own, pg.WORLD))), lambda ss: ss
    total = 0
    for (path, _), per_device in zip(tree.leaves_with_path(grads[0]), blocks):
        spec = spec_at(grads.specs, path)
        by_data, by_model = data_dim(spec) is not None, model_dim(spec) is not None
        for i, g in enumerate(per_device):
            if (by_data or i // m == 0) and (by_model or i % m == 0):
                total = total + square(g).to(home)
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
