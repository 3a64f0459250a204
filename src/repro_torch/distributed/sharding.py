"""Sharding rules, as ``repro.distributed.sharding``: the LM rule table
(param / state / batch tree -> spec tree) and the BNN serving rules.

LM rule table (DESIGN.md §5), the JAX package's word for word:

* float weight matrices ``w [.., out, in]`` — 2D-sharded: ``out -> model``
  and ``in -> data`` (the data axis doubles as an FSDP axis). MoE stacks
  ``[E, out, in]`` shard experts over ``model`` and ``in`` over ``data``
  when the stack is too big to replicate.
* packed 1-bit weights ``w_packed [.., out, in/32]`` — ``out -> model``,
  replicated over data.
* embeddings / LM head ``[V, D]`` — vocab over ``model``, D over ``data``.
* norms, biases of tiny fan-out, SSM dynamics, recurrent R — replicated.
* every rule is divisibility-guarded: an axis that does not divide the
  dim is left unsharded.

Leading stack axes (periods, per-period layers) are never sharded. A spec
is a :class:`PartitionSpec`, a tuple of one entry a dim (an axis name, a
tuple of them, or None), equal as a tuple to the JAX package's. The tree
forms (:func:`params_shardings`, :func:`state_shardings`,
:func:`batch_shardings`) return spec trees: the port has no partitioner.
The dry run (``launch.dryrun``) reads a spec, through :func:`shard_shape`,
to size each device's shard and reckon the collectives
(``roofline.op_cost.collective_bytes``); tensor-parallel training lays the
params out by it (:func:`shard_params`, :func:`gather_params`). A mesh is
anything with the ``.shape`` of a ``jax.sharding.Mesh`` (axis name ->
size): ``launch.mesh.AbstractMesh``, the production meshes, a
``DeviceMesh`` or a ``ServingMesh``.

One process lays the whole rule table out, the data axes with the model
axis: :func:`shard_params` gives each device of a mesh its block of every
leaf, as ``jax.device_put`` with :func:`params_shardings` leaves each
device its ``addressable_shards``. A device's block is its own tensor
even where one process drives several devices of one card, so a mesh of
cards holds each block once (the FSDP half of the table, ``in -> data``,
divides every matrix's bytes by the data devices). The tensor-parallel
step (``train.step.make_tp_train_step``) gathers a leaf split over the
data axes where it is used (``tensor_parallel.ShardedTree``). The
activation constraints (:func:`activation_mesh`, :func:`constrain`,
:func:`constrain_seq`) keep the JAX names and signatures; under an
installed mesh :func:`constrain` lays an activation out by its guarded
spec, slicing or gathering the ranks' parts of a
``distributed.tensor_parallel.Ranked``, and checks each part's shape.

BNN serving (DESIGN.md §10): packed weights replicated on every device of
a 1-D serving mesh (``launch.mesh.ServingMesh``), the batch split into one
contiguous shard a device. The JAX package builds ``shard_map`` specs for
this (``serve_specs``); the port drives the mesh from one process, so the
rule becomes data: :func:`replicate` makes one packed tree a device and
:func:`shard_rows` the size of each device's shard. Each replica runs the
single-device forward on its shard; samples are independent, so the
gathered logits equal the unsharded forward's bit for bit.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Any, Optional

import torch

from repro_torch import tree
from repro_torch.tree import tree_map

# mesh-axis names used across the project
DATA_AXES = ("pod", "data")      # batch / FSDP axes (pod absent on 1-pod mesh)
MODEL_AXIS = "model"

# An MoE expert stack of more elements than this also splits ``in`` over
# the data axes (arctic's and jamba's); a smaller one is replicated over
# them. The JAX package's literal.
EXPERT_FSDP_ELEMENTS = 1e9

_REPLICATED_LEAVES = {
    "scale", "bias", "gamma", "beta", "mean", "var", "gn_scale",
    "conv_w", "conv_b", "A_log", "D", "R",
}


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``'s counterpart: one entry a dim, an
    axis name, a tuple of axis names or None (replicated); compares equal
    to a tuple of its entries."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def _shape(leaf) -> tuple:
    return tuple(getattr(leaf, "shape", ()))


def _axis_size(mesh, name) -> int:
    if isinstance(name, tuple):
        return math.prod(_axis_size(mesh, n) for n in name)
    return mesh.shape[name] if name in mesh.shape else 1


def _guard(mesh, dim: int, axis) -> Optional[Any]:
    """axis if it exists in the mesh and divides dim, else None."""
    if axis is None:
        return None
    if isinstance(axis, tuple):
        axis = tuple(a for a in axis if a in mesh.shape)
        if not axis:
            return None
        axis = axis if len(axis) > 1 else axis[0]
    elif axis not in mesh.shape:
        return None
    return axis if dim % _axis_size(mesh, axis) == 0 else None


# Megatron-style roles: column-parallel projections put the tensor axis
# on their OUT dim (q/k/v/up/gate produce model-sharded features);
# row-parallel projections contract over the model-sharded feature and
# put FSDP on their OUT dim (down/o/out: partial-sum -> one all-reduce /
# reduce-scatter per block instead of re-gathering the wide activation).
_ROW_PARALLEL = {"down_proj", "o_proj", "out_proj"}


def _matrix_spec(mesh, shape, *, name: str) -> P:
    """Weight base shape [..., out, in] -> role-dependent spec.

    column-parallel: (model on out, (pod,data)-FSDP on in)
    row-parallel:    ((pod,data)-FSDP on out, model on in)
    MoE stacks [E, out, in]: experts over model, FSDP on in only for a
    stack past ``EXPERT_FSDP_ELEMENTS`` (arctic, jamba); smaller stacks
    replicate over data.
    """
    if len(shape) >= 3:  # stacked experts
        e_ax = _guard(mesh, shape[0], MODEL_AXIS)
        big = float(math.prod(shape)) > EXPERT_FSDP_ELEMENTS
        in_ax = _guard(mesh, shape[-1], DATA_AXES) if big else None
        return P(e_ax, *(None,) * (len(shape) - 2), in_ax)
    if name in _ROW_PARALLEL:
        return P(_guard(mesh, shape[-2], DATA_AXES),
                 _guard(mesh, shape[-1], MODEL_AXIS))
    return P(_guard(mesh, shape[-2], MODEL_AXIS),
             _guard(mesh, shape[-1], DATA_AXES))


def param_spec(mesh, path, leaf) -> P:
    """The spec of one param leaf; ``path`` is its tuple of dict keys and
    list indices (``tree.leaves_with_path``)."""
    keys = list(path)
    name = keys[-1] if keys else ""
    parent = next((k for k in reversed(keys[:-1]) if isinstance(k, str)), "")
    shape = _shape(leaf)
    # stacked layers carry one leading period/layer axis — never sharded
    stacked = 1 if "layers" in keys and len(shape) >= 1 else 0
    base = shape[stacked:]
    lead = (None,) * stacked

    if name in _REPLICATED_LEAVES or len(base) == 0:
        return P()
    if len(base) == 1:
        if name in ("b", "alpha") and parent not in _ROW_PARALLEL:
            return P(*lead, _guard(mesh, base[0], MODEL_AXIS))
        return P()
    if parent == "router":  # tiny, accuracy-critical — replicate
        return P()
    if name == "w_packed":
        if len(base) >= 3:  # stacked experts [E, out, kw]
            return P(*lead, _guard(mesh, base[0], MODEL_AXIS),
                     *(None,) * (len(base) - 1))
        return P(*lead, _guard(mesh, base[-2], MODEL_AXIS), None)
    if name == "table":  # embedding [V, D]
        return P(_guard(mesh, base[0], MODEL_AXIS),
                 _guard(mesh, base[1], DATA_AXES))
    if name == "w":
        return P(*lead, *_matrix_spec(mesh, base, name=parent))
    return P()


def params_shardings(mesh, params) -> Any:
    return tree.map_with_path(lambda path, leaf: param_spec(mesh, path, leaf),
                              params)


# ----------------------------- streaming state -------------------------------


def state_spec(mesh, path, leaf) -> P:
    """KV caches [L, B, S, H, Dh]; SSM/xLSTM states [L, B, ...].

    Batch shards over (pod, data) when divisible; for batch-1
    long-context the KV sequence axis shards over model instead; other
    feature axes shard over model when they divide.
    """
    keys = list(path)
    shape = _shape(leaf)
    if len(shape) == 0:
        return P()
    name = keys[-1] if keys else ""
    top = keys[0] if keys else ""
    if top == "kv" or name in ("k", "v"):
        # [L, B, S, Hkv, Dh]
        b_ax = _guard(mesh, shape[1], DATA_AXES)
        if b_ax is None:
            b_ax = _guard(mesh, shape[1], "data")
        s_ax = _guard(mesh, shape[2], MODEL_AXIS)
        return P(None, b_ax, s_ax, None, None)
    if top == "memory" or name == "memory":
        # encoder memory [B, S, D]
        return P(_guard(mesh, shape[0], DATA_AXES),
                 _guard(mesh, shape[1], MODEL_AXIS), None)
    if len(shape) >= 2:
        b_ax = _guard(mesh, shape[1], DATA_AXES) or _guard(mesh, shape[1], "data")
        rest = [None] * (len(shape) - 2)
        # shard the largest divisible feature axis over model
        cands = [
            (shape[i], i) for i in range(2, len(shape))
            if _guard(mesh, shape[i], MODEL_AXIS) is not None
        ]
        if cands:
            _, i = max(cands)
            rest[i - 2] = MODEL_AXIS
        return P(None, b_ax, *rest)
    return P()


def state_shardings(mesh, state) -> Any:
    return tree.map_with_path(lambda path, leaf: state_spec(mesh, path, leaf),
                              state)


# ------------------------------- batches -------------------------------------


def batch_spec(mesh, path, leaf) -> P:
    shape = _shape(leaf)
    if len(shape) == 0:
        return P()
    b_ax = _guard(mesh, shape[0], DATA_AXES) or _guard(mesh, shape[0], "data")
    return P(b_ax, *(None,) * (len(shape) - 1))


def batch_shardings(mesh, batch) -> Any:
    return tree.map_with_path(lambda path, leaf: batch_spec(mesh, path, leaf),
                              batch)


def replicated(mesh) -> P:
    """The spec of a leaf held whole on every device."""
    del mesh
    return P()


def shard_shape(mesh, shape, spec) -> tuple:
    """The shape of one device's shard of a ``shape`` leaf laid out by
    ``spec``: each dim divided by the size of the axes it is sharded over
    (the rules only shard a dim its axes divide; ``ValueError`` if not)."""
    shape = tuple(shape)
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape {shape}")
    out = list(shape)
    for i, axis in enumerate(spec):
        if axis is None:
            continue
        size = _axis_size(mesh, axis)
        if shape[i] % size:
            raise ValueError(f"dim {i} of {shape} does not divide over {axis!r} "
                             f"({size} devices)")
        out[i] = shape[i] // size
    return tuple(out)


# ---------------------- the rule table's layout, in one process ----------------------


def _has_model(entry) -> bool:
    return entry == MODEL_AXIS or (isinstance(entry, tuple) and MODEL_AXIS in entry)


def model_axis_size(mesh) -> int:
    """Devices on the mesh's model axis (1 where it has none)."""
    return mesh.shape[MODEL_AXIS] if MODEL_AXIS in mesh.shape else 1


def data_axis_size(mesh) -> int:
    """Devices over the mesh's data axes (``("pod", "data")``; 1 where it
    has none)."""
    return math.prod(mesh.shape[a] for a in DATA_AXES if a in mesh.shape)


def flat_devices(mesh) -> tuple:
    """A mesh's devices in mesh order."""
    flat = getattr(mesh, "flat", None)
    return tuple(flat) if flat is not None else tuple(mesh.devices)


def model_part(spec) -> P:
    """``spec`` over the model axis alone: its ``model`` entries kept,
    every data entry dropped."""
    return P(*(MODEL_AXIS if _has_model(e) else None for e in spec))


def model_spec(mesh, path, leaf) -> P:
    """:func:`param_spec` over the model axis alone (:func:`model_part`)."""
    return model_part(param_spec(mesh, path, leaf))


def model_specs(mesh, params) -> Any:
    """:func:`model_spec` of every leaf, a spec tree."""
    return tree.map_with_path(lambda path, leaf: model_spec(mesh, path, leaf),
                              params)


def layout_spec(mesh, path, leaf) -> P:
    """:func:`param_spec` as :func:`shard_params` lays it out: a data
    entry dropped where the data axes hold one device (a split over one
    device leaves the dim whole), so on a ``(1, m)`` mesh it is
    :func:`model_spec`."""
    rows = data_axis_size(mesh)
    return P(*(e if e is None or _has_model(e) or rows > 1 else None
               for e in param_spec(mesh, path, leaf)))


def layout_specs(mesh, params) -> Any:
    """:func:`layout_spec` of every leaf, a spec tree."""
    return tree.map_with_path(lambda path, leaf: layout_spec(mesh, path, leaf),
                              params)


def data_dim(spec) -> Optional[int]:
    """The dim ``spec`` splits over the data axes, or None."""
    for dim, entry in enumerate(spec):
        if entry is not None and not _has_model(entry):
            return dim
    return None


def model_dim(spec) -> Optional[int]:
    """The dim ``spec`` splits over ``model``, or None."""
    for dim, entry in enumerate(spec):
        if _has_model(entry):
            return dim
    return None


def spec_at(specs, path: tuple) -> P:
    """The spec of the leaf at ``path`` of a spec tree."""
    for k in path:
        specs = specs[k]
    return specs


def _part(t: torch.Tensor, dim: int, parts: int, index: int) -> torch.Tensor:
    if t.shape[dim] % parts:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split into "
                         f"{parts} parts")
    w = t.shape[dim] // parts
    return t.narrow(dim, index * w, w)


def model_slice(t: torch.Tensor, spec, ranks: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s part of ``t`` laid out by ``spec`` (model entries):
    each dim split over ``model`` cut into ``ranks`` contiguous parts in
    rank order (a view)."""
    for dim, entry in enumerate(spec):
        if entry == MODEL_AXIS:
            t = _part(t, dim, ranks, rank)
    return t


def device_block(t: torch.Tensor, spec, ranks: int, rank: int, rows: int,
                 row: int) -> torch.Tensor:
    """The block of ``t`` laid out by ``spec`` that the device on data row
    ``row`` and model rank ``rank`` holds: each dim split over ``model``
    cut into ``ranks`` contiguous parts in rank order, each dim split over
    the data axes into ``rows`` in row order (a view)."""
    t = model_slice(t, spec, ranks, rank)
    dim = data_dim(spec)
    return t if dim is None else _part(t, dim, rows, row)


class Shards(list):
    """A tree laid out over ``mesh``: one tree a device, in mesh order
    (the model axis last), each leaf that device's block by ``specs``
    (:func:`layout_specs`, :func:`device_block`): its model rank's part
    of a dim split over ``model``, its data row's part of a dim split over
    the data axes, the whole of any other dim. Every device holds its own
    tensors. ``rows()`` groups the trees by data row, one a model rank.
    Where ``mesh`` runs one process a device (its ``position`` set) a
    process holds its own device's tree alone."""

    def __init__(self, trees, specs, mesh):
        super().__init__(trees)
        self.specs = specs
        self.mesh = mesh

    def rows(self) -> list:
        m = model_axis_size(self.mesh)
        return [list(self[i:i + m]) for i in range(0, len(self), m)]


def shard_params(params, mesh) -> Shards:
    """The full tree ``params`` (params or optimizer state, whose leaves
    the rule table also reads by path) as one tree a device of ``mesh``:
    each leaf the device's block by :func:`layout_spec`, over the data
    axes and ``model`` both, in mesh order (``model`` the last axis, the
    data axes before it), a copy on the device. A block's shape is
    :func:`shard_shape` of :func:`param_spec`, the shape of the JAX
    array's ``addressable_shards`` on that device. Where ``mesh`` runs one
    process a device (``position`` set) the process builds its own
    device's blocks alone, from the same full tree every process holds."""
    names = tuple(mesh.shape)
    if MODEL_AXIS in names and names[-1] != MODEL_AXIS:
        raise ValueError(f"the model axis must be the mesh's last, got {names}")
    if any(a != MODEL_AXIS and a not in DATA_AXES for a in names):
        raise ValueError(f"a mesh of data axes {DATA_AXES} and {MODEL_AXIS!r}, "
                         f"got {names}")
    specs = layout_specs(mesh, params)
    m, rows = model_axis_size(mesh), data_axis_size(mesh)
    devices = flat_devices(mesh)
    position = getattr(mesh, "position", None)
    held = range(len(devices)) if position is None else [position]
    trees = [tree.map_with_path(
        lambda path, t, i=i: device_block(
            t, spec_at(specs, path), m, i % m, rows, i // m).to(
            devices[i], copy=True).contiguous(), params)
        for i in held]
    return Shards(trees, specs, mesh)


def gather_params(shards: Shards, mesh) -> Any:
    """The full tree of :func:`shard_params`' ``shards``, on the first
    device: each leaf's blocks concatenated over ``model`` in rank order
    within each data row, then over the data axes in row order (a dim
    split over neither is the first device's). Where ``mesh`` runs one
    process a device every process takes part and gets the full tree on
    its own device, each leaf's blocks gathered over the world."""
    m = model_axis_size(mesh)
    home = tree.leaves(shards[0])[0].device
    if getattr(mesh, "position", None) is not None:
        from repro_torch.distributed import process_group as pg
        per_leaf = [pg.gather(leaf, pg.WORLD) for leaf in tree.leaves(shards[0])]
        trees = []
        for i in range(pg.world_size()):
            it = iter([blocks[i] for blocks in per_leaf])
            trees.append(tree.tree_map(lambda _: next(it), shards[0]))
        shards = Shards(trees, shards.specs, shards.mesh)

    def whole(path, *blocks):
        spec = spec_at(shards.specs, path)
        mdim, ddim = model_dim(spec), data_dim(spec)
        rows = [blocks[i:i + m] for i in range(0, len(blocks), m)]
        per_row = [torch.cat([b.to(home) for b in row], mdim) if mdim is not None
                   else row[0].to(home) for row in rows]
        return torch.cat(per_row, ddim) if ddim is not None else per_row[0]

    return tree.map_with_path(whole, *shards)


# ------------------------- activation constraints -----------------------------
#
# Models are mesh-agnostic; the launcher installs the active mesh here and
# model code calls ``constrain(x, ...)`` at layer boundaries, as the JAX
# package's does. Every axis is divisibility-guarded.

_ACTIVE = threading.local()


def get_active_mesh():
    return getattr(_ACTIVE, "mesh", None)


@contextlib.contextmanager
def activation_mesh(mesh):
    """Install ``mesh`` for :func:`constrain` in this thread, for the
    block."""
    prev = get_active_mesh()
    _ACTIVE.mesh = mesh
    try:
        yield
    finally:
        _ACTIVE.mesh = prev


def constrain(x, *axes):
    """``with_sharding_constraint`` under the installed mesh, guarded.

    ``axes`` entries are mesh-axis names / tuples / None, one a dim. With
    no mesh installed, ``x`` unchanged. Under a mesh the spec is each
    entry guarded against the whole tensor's dim:

    * a ``tensor_parallel.Ranked`` (one data shard's parts; its whole
      batch is its rows times the data axes' devices) is laid out by the
      spec's model entries (a dim whole on each rank and split here is
      sliced on each rank, the converse all-gathered);
    * a plain tensor is one device's whole tensor;

    and each rank's tensor is checked to be :func:`shard_shape` of the
    spec: ``ValueError`` if not.
    """
    mesh = get_active_mesh()
    if mesh is None:
        return x
    from repro_torch.distributed.tensor_parallel import Ranked
    whole = list(x.shape)
    if isinstance(x, Ranked):
        whole[0] *= data_axis_size(mesh)
    spec = P(*(_guard(mesh, n, a) for n, a in zip(whole, axes)))
    parts = [x]
    if isinstance(x, Ranked):
        x = x.laid_out([MODEL_AXIS if _has_model(e) else None for e in spec]
                       + [None] * (len(whole) - len(spec)), site="constrain")
        parts = x.parts
    want = shard_shape(mesh, whole, spec)
    for r, part in enumerate(parts):
        if tuple(part.shape) != want:
            raise ValueError(f"rank {r}'s tensor {tuple(part.shape)} is not the "
                             f"{want} shard of {tuple(whole)} by {spec}")
    return x


def constrain_seq(x):
    """Residual stream [B, S, D] between blocks: batch over (pod, data),
    seq and features replicated over model (the Megatron layout: the model
    axis works inside the blocks, through the column / row rules)."""
    return constrain(x, DATA_AXES, None, None)


# --------------------------- BNN serving (DESIGN.md §10) ----------------------


def mesh_devices(mesh) -> int:
    """Device count of a mesh, every axis counted (1 for ``None``: the
    single-device dispatch path)."""
    return 1 if mesh is None else math.prod(mesh.shape.values())


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


__all__ = ["DATA_AXES", "EXPERT_FSDP_ELEMENTS", "MODEL_AXIS", "P", "PartitionSpec",
           "Shards", "activation_mesh", "batch_shardings", "batch_spec", "constrain",
           "constrain_seq", "data_axis_size", "data_dim", "device_block",
           "flat_devices", "gather_params", "get_active_mesh", "layout_spec",
           "layout_specs", "mesh_devices", "model_axis_size", "model_dim",
           "model_part", "model_slice", "model_spec", "model_specs", "param_spec",
           "params_shardings", "replicate", "replicated", "shard_params",
           "shard_rows", "shard_shape", "spec_at", "state_shardings",
           "state_spec"]
