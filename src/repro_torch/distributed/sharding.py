"""The BNN serving half of the JAX package's sharding rules (DESIGN.md
§10): packed weights replicated on every device of a 1-D serving mesh
(``launch.mesh.ServingMesh``), the batch split into one contiguous shard a
device.

The JAX package builds ``shard_map`` specs for this (``serve_specs``:
params ``P()``, images and logits ``P("data")``). The port drives the mesh
from one process, so the rule becomes data: :func:`replicate` makes one
packed tree a device and :func:`shard_rows` the size of each device's
shard. Each replica runs the single-device forward on its shard; samples
are independent, so the gathered logits equal the unsharded forward's bit
for bit.

The LM rule table (``param_spec``, ``state_spec``, ``batch_spec``,
``activation_mesh``, ``constrain``) is not ported: it waits for the LM
trainer and dry-run (ROADMAP A6 / A6d).
"""

from __future__ import annotations

import torch

from repro_torch.tree import tree_map


def mesh_devices(mesh) -> int:
    """Device count of a serving mesh (1 for ``None``: the single-device
    dispatch path)."""
    return 1 if mesh is None else len(mesh)


def replicate(packed: dict, mesh) -> list:
    """One packed tree a device of ``mesh``, in mesh order, each moved
    there with ``.to(device)``. Replicas on one device share one tree and
    its tensors: a forward only reads them. Every CPU entry of a mesh is
    the CPU, so a CPU mesh shares the tree ``packed`` itself when it lies
    there."""
    by_device: dict = {}
    out = []
    for dev in mesh.devices:
        home = dev if dev.type == "cuda" else torch.device("cpu")
        if home not in by_device:
            by_device[home] = tree_map(
                lambda t: t.to(home) if isinstance(t, torch.Tensor) else t,
                packed)
        out.append(by_device[home])
    return out


def shard_rows(rows: int, devices: int) -> int:
    """Rows of each device's shard of a ``rows``-row batch split into
    ``devices`` contiguous shards of equal size. Raises ``ValueError``
    when they do not divide it, as ``shard_map`` does; the serving
    executors pad to a multiple first."""
    if rows % devices:
        raise ValueError(f"a batch of {rows} rows does not divide the "
                         f"{devices}-device serving mesh")
    return rows // devices


__all__ = ["mesh_devices", "replicate", "shard_rows"]
