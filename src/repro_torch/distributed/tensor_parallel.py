"""Tensor parallelism over the ``"model"`` mesh axis: the collectives,
and the tensors and param trees laid out over the axis.

The JAX package has no counterpart: XLA's SPMD partitioner inserts the
all-reduces and gathers its sharded step needs. The port runs the model
axis of one data shard (a row of a ``launch.mesh.DeviceMesh``) one of two
ways, with the same model code:

* in lockstep, from one process: each layer runs every rank's part before
  the next starts, and a collective takes every rank's tensor at once, a
  list in mesh order, and returns one tensor a rank on that rank's device.
  Ranks that share a card run one after another.
* SPMD, one process a device (``distributed.process_group``): a process
  holds its own rank's part alone, and a collective gathers the other
  ranks' parts over the axis's group (``process_group.everyone``), does
  exactly what the lockstep collective does with the whole list, and keeps
  its own rank's result. So its sums run in the lockstep order and give
  the lockstep bits.

* :func:`all_reduce`: the sum in mesh order on the first rank's device
  (accumulated in float32 for narrower dtypes, then rounded once), a copy
  to each rank. Backward: the gradients of the ranks' copies summed the
  same way and passed to each input, whose contribution reached every
  copy.
* :func:`all_gather`: the ranks' tensors concatenated along a dim in mesh
  order, a copy to each rank. Backward: each input's slice of the
  gradients, summed over the ranks' copies in mesh order (a
  reduce-scatter: each rank uses its own copy of the gathered tensor).
* :func:`all_max`: the elementwise maximum, a copy to each rank, no
  gradient (it is the softmax's shift).

Each is deterministic: its sums run in a fixed order, so two runs give the
same bits. Each adds the bytes it moves a device to :data:`BYTES` in the
convention of ``roofline.op_cost.collective_bytes``: the result's bytes on
each device that receives it times ``COLL_MULT`` of its kind (2 for an
all-reduce), keyed by (kind, site, ``"fwd"`` or ``"bwd"``). Inside
:func:`counted_over` (a step over a whole mesh) that is the mean over the
mesh's devices: in lockstep a collective whose result lands on ``k`` of
the ``n`` devices adds ``k / n`` of its bytes, so the rows of a ``(data,
model)`` mesh, each its own collectives, add up to one device's bytes;
SPMD each process counts its own device and the block ends with the mean
of the counts over the world. The convention is the reckoning's, not the
wire's: a gathered all-reduce moves ``n - 1`` whole parts to each rank
where a ring moves ``2 (n - 1) / n`` of one.

A :class:`Ranked` is one activation laid out over the ranks: ``parts`` in
mesh order, the model rank of the first (``first``) and the ranks on the
axis (``size``), and ``spec``, one entry a dim, ``None`` (each rank holds
the whole dim) or ``"model"`` (split into contiguous equal parts in rank
order). In lockstep ``first`` is 0 and ``parts`` hold all ``size`` ranks;
SPMD ``first`` is the process's model rank and ``parts`` its one part.
Its dim 0 holds one data shard's rows. A :class:`RankedTree` is one param
tree a rank, placed the same way, beside the spec tree that laid it out
(``distributed.sharding.shard_params``). A :class:`ShardedTree` is the
params of a mesh with several data rows as its devices hold them, each
leaf in blocks over the data axes too; :func:`gathered` all-gathers a
leaf's blocks over the data axes onto a row's ranks where the leaf is
used (fully sharded data parallelism), giving the ``RankedTree`` the
model code computes with.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Callable, Optional

import torch

from repro_torch import tree
from repro_torch.distributed import compression
from repro_torch.distributed import process_group as pg

MODEL = "model"
# The wire-byte multiplier of each kind, as ``roofline.op_cost.COLL_MULT``.
_MULT = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0}

# (kind, site, "fwd" | "bwd") -> bytes moved per device, since the last
# ``reset_bytes``.
BYTES: collections.Counter = collections.Counter()


# Devices of the mesh whose step is being counted (:func:`counted_over`);
# None: each collective counts its bytes on one receiving device.
_MESH_DEVICES: Optional[int] = None


def reset_bytes() -> None:
    BYTES.clear()


@contextlib.contextmanager
def counted_over(devices: int):
    """Count :data:`BYTES` for the block as the mean over a mesh of
    ``devices`` devices (module docstring). Process-wide, so a backward
    that autograd runs on another thread counts the same way. Under a
    process group each process counts its own device, and the block's
    counts become their mean over the world as it ends."""
    global _MESH_DEVICES
    if pg.active():
        before = collections.Counter(BYTES)
        yield
        mean = pg.mean_over_world(BYTES - before)
        BYTES.clear()
        BYTES.update(before)
        BYTES.update(mean)
        return
    prev, _MESH_DEVICES = _MESH_DEVICES, devices
    try:
        yield
    finally:
        _MESH_DEVICES = prev


def add_bytes(kind: str, site: str, direction: str, nbytes: float,
              receivers: int) -> None:
    """Count a collective whose result of ``nbytes`` bytes lands on
    ``receivers`` devices (module docstring); under a process group, the
    bytes on this process's device."""
    if pg.active():
        receivers = 1
    BYTES[(kind, site, direction)] += (nbytes * _MULT[kind] * receivers
                                       / (_MESH_DEVICES or receivers))


def bytes_by_kind() -> dict:
    """:data:`BYTES` summed by kind of collective."""
    out: dict = collections.defaultdict(float)
    for (kind, _, _), n in BYTES.items():
        out[kind] += n
    return dict(out)


def _count(kind: str, site: str, direction: str, result: torch.Tensor,
           receivers: int) -> None:
    add_bytes(kind, site, direction, result.numel() * result.element_size(),
              receivers)


def _sum(xs) -> torch.Tensor:
    """``xs[0] + xs[1] + ...`` in mesh order on the device of ``xs[0]``,
    accumulated in float32 where the dtype is narrower, a new tensor."""
    home, dtype = xs[0].device, xs[0].dtype
    acc = torch.float32 if dtype in (torch.bfloat16, torch.float16) else dtype
    total = xs[0].to(acc, copy=True)
    for x in xs[1:]:
        total = total + x.to(home).to(acc)
    return total.to(dtype)


def _copies(total: torch.Tensor, devices) -> tuple:
    """One tensor a rank: ``total`` for the first, a copy for each other."""
    return tuple(total if i == 0 else total.to(dev, copy=True)
                 for i, dev in enumerate(devices))


def _mine(parts) -> tuple:
    """Of one result a rank of the axis, in mesh order, those of the ranks
    this process holds: all of them in lockstep, its own SPMD."""
    return tuple(parts) if not pg.active() else (parts[pg.index(MODEL)],)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, site, *xs):
        ctx.site, ctx.devices = site, [x.device for x in xs]
        total = _sum(pg.everyone(xs, MODEL))
        _count("all-reduce", site, "fwd", total, len(xs))
        return _copies(total, ctx.devices)

    @staticmethod
    def backward(ctx, *gs):
        live = [g for g in gs if g is not None]
        if not live:
            return (None,) * (1 + len(gs))
        total = _sum(pg.everyone(live, MODEL))
        _count("all-reduce", ctx.site, "bwd", total, len(gs))
        return (None, *_copies(total, ctx.devices))


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, site, dim, *xs):
        ctx.site, ctx.dim = site, dim
        ctx.devices = [x.device for x in xs]
        xs = pg.everyone(xs, MODEL)
        ctx.sizes = [x.shape[dim] for x in xs]
        home = xs[0].device
        total = torch.cat([x.to(home) for x in xs], dim)
        _count("all-gather", site, "fwd", total, len(ctx.devices))
        return _copies(total, ctx.devices)

    @staticmethod
    def backward(ctx, *gs):
        live = [g for g in gs if g is not None]
        if not live:
            return (None,) * (2 + len(gs))
        total = _sum(pg.everyone(live, MODEL))
        parts = torch.split(total, ctx.sizes, ctx.dim)
        _count("reduce-scatter", ctx.site, "bwd", parts[0], len(gs))
        return (None, None, *(p.to(dev, copy=True).contiguous()
                              for p, dev in zip(_mine(parts), ctx.devices)))


def all_reduce(xs, site: str = "") -> tuple:
    """The sum of the ranks' ``xs`` (same shape), one copy a rank."""
    return _AllReduce.apply(site, *xs)


def all_gather(xs, dim: int, site: str = "") -> tuple:
    """The ranks' ``xs`` concatenated along ``dim`` in mesh order, one copy
    a rank."""
    return _AllGather.apply(site, dim % xs[0].ndim, *xs)


def all_max(xs, site: str = "") -> tuple:
    """The elementwise maximum of the ranks' ``xs``, one copy a rank; no
    gradient flows through it."""
    with torch.no_grad():
        every = pg.everyone([x.detach() for x in xs], MODEL)
        home = every[0].device
        total = every[0].clone()
        for x in every[1:]:
            total = torch.maximum(total, x.to(home))
    _count("all-reduce", site, "fwd", total, len(xs))
    return _copies(total, [x.device for x in xs])


class _FirstRank(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, keep: bool):
        ctx.keep = keep
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.keep else torch.zeros_like(g)), None


def first_rank(xs) -> torch.Tensor:
    """The first model rank's copy of a collective's result, where the
    model reads that copy alone (the loss). In lockstep ``xs[0]``; SPMD
    every process computes on its own copy, which holds the same bits, and
    a process other than the first passes zeros back, as the lockstep
    graph sends none into the other ranks' copies."""
    if not pg.active():
        return xs[0]
    return _FirstRank.apply(xs[0], pg.index(MODEL) == 0)


def _placement(held: int, first: Optional[int], size: Optional[int]) -> tuple:
    """(first, size) of ``held`` parts: by default the process group's
    model rank and axis size under one, else 0 and ``held``."""
    spmd = pg.active()
    if first is None:
        first = pg.index(MODEL) if spmd else 0
    if size is None:
        size = pg.axis_size(MODEL) if spmd else held
    if not 0 <= first <= first + held <= size:
        raise ValueError(f"{held} parts from rank {first} on an axis of {size} ranks")
    return first, size


# --------------------------- laid-out activations -----------------------------


@dataclasses.dataclass(frozen=True)
class Ranked:
    """One activation over the model ranks of a data shard: ``parts`` in
    mesh order, ``spec`` one entry a dim (``None`` whole, ``"model"``
    split into contiguous parts in rank order), ``first`` the model rank
    of ``parts[0]`` and ``size`` the ranks on the axis (by default those
    of the process group where one runs, else 0 and ``len(parts)``)."""

    parts: tuple
    spec: tuple
    first: Optional[int] = None
    size: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(self, "parts", tuple(self.parts))
        spec = tuple(self.spec)
        ndim = self.parts[0].ndim
        if len(spec) != ndim or any(e not in (None, MODEL) for e in spec):
            raise ValueError(f"spec {spec} for a {ndim}-D tensor")
        object.__setattr__(self, "spec", spec)
        first, size = _placement(len(self.parts), self.first, self.size)
        object.__setattr__(self, "first", first)
        object.__setattr__(self, "size", size)

    @classmethod
    def replicated(cls, x: torch.Tensor, devices) -> "Ranked":
        """``x`` whole on every rank of ``devices``: a copy a device other
        than ``x``'s, ``x`` itself on its own."""
        return cls(tuple(x.to(d) for d in devices), (None,) * x.ndim)

    @property
    def ranks(self) -> int:
        """The ranks on the model axis."""
        return self.size

    @property
    def indices(self) -> range:
        """The model rank of each part."""
        return range(self.first, self.first + len(self.parts))

    @property
    def devices(self) -> tuple:
        return tuple(p.device for p in self.parts)

    @property
    def shape(self) -> tuple:
        """The shape of the data shard's whole tensor."""
        return tuple(n * self.ranks if e == MODEL else n
                     for n, e in zip(self.parts[0].shape, self.spec))

    def laid_out(self, spec, site: str = "") -> "Ranked":
        """The same tensor laid out by ``spec``: a dim the ranks hold
        whole and ``spec`` splits is sliced on each rank (no collective);
        a split dim ``spec`` wants whole is all-gathered."""
        spec = tuple(spec)
        parts = list(self.parts)
        for dim, (have, want) in enumerate(zip(self.spec, spec)):
            if have == want:
                continue
            if want == MODEL:
                n = parts[0].shape[dim]
                if n % self.ranks:
                    raise ValueError(f"dim {dim} of {n} does not split over "
                                     f"{self.ranks} ranks")
                w = n // self.ranks
                parts = [p.narrow(dim, r * w, w) for r, p in zip(self.indices, parts)]
            else:
                parts = list(all_gather(parts, dim, site))
        return Ranked(parts, spec, self.first, self.size)


def piece(x: Ranked, index: int, pieces: int, *, split: bool = True) -> Ranked:
    """Piece ``index`` of ``pieces`` equal pieces of the last dim of ``x``,
    which every rank holds whole (a fused projection's output gathered:
    mamba's and the mLSTM's two halves, the sLSTM's four gates): laid out
    over the ranks, rank ``r`` its contiguous ``1/m`` of the piece (a view,
    no collective), or whole on every rank with ``split=False``. The rule
    table splits a fused output into contiguous parts, which cut the
    pieces apart (at m = 2 rank 0 holds the whole first half), so a layer
    gathers first and takes each piece's channels here."""
    if x.spec[-1] == MODEL:
        raise ValueError("piece() takes a last dim every rank holds whole")
    width = x.parts[0].shape[-1]
    if width % pieces:
        raise ValueError(f"{width} does not split into {pieces} pieces")
    size = width // pieces
    if not split:
        return Ranked([p.narrow(-1, index * size, size) for p in x.parts], x.spec,
                      x.first, x.size)
    if size % x.ranks:
        raise ValueError(f"a piece of {size} does not split over {x.ranks} ranks")
    w = size // x.ranks
    return Ranked([p.narrow(-1, index * size + r * w, w) for r, p in zip(x.indices, x.parts)],
                  x.spec[:-1] + (MODEL,), x.first, x.size)


def _is_ranked(a) -> bool:
    return isinstance(a, (Ranked, RankedTree))


def each(fn: Callable, *args, spec=None) -> Ranked:
    """``fn`` on every rank: each :class:`Ranked` or :class:`RankedTree`
    argument gives its rank's part, any other is passed as it is. The
    result is laid out by ``spec``, by default the :class:`Ranked`
    arguments' (``ValueError`` where they differ)."""
    ranked = [a for a in args if _is_ranked(a)]
    ranks = len(ranked[0].parts)
    if any(len(a.parts) != ranks for a in ranked):
        raise ValueError("arguments laid out over different rank counts")
    if spec is None:
        specs = {a.spec for a in args if isinstance(a, Ranked)}
        if len(specs) != 1:
            raise ValueError(f"arguments laid out differently: {sorted(specs, key=str)}")
        (spec,) = specs
    outs = [fn(*(a.parts[r] if _is_ranked(a) else a for a in args))
            for r in range(ranks)]
    return Ranked(outs, spec, ranked[0].first, ranked[0].size)


# ------------------------------ laid-out params -------------------------------


def _map_specs(fn: Callable, specs):
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v) for k, v in specs.items()}
    if isinstance(specs, list):
        return [_map_specs(fn, v) for v in specs]
    return fn(specs)


class RankedTree:
    """One param (sub)tree a model rank of a data shard, in mesh order,
    and its spec tree (each leaf a spec over the model axis alone, as
    ``distributed.sharding.model_spec`` gives it), placed on the axis as a
    :class:`Ranked` is (``first``, ``size``). Indexing descends every
    rank's tree and the spec tree together; at a leaf, ``parts`` are
    tensors and ``spec`` their spec. ``path`` is the keys taken from the
    root (the collectives' byte counts name a projection by it)."""

    def __init__(self, parts, spec, path: tuple = (), first: Optional[int] = None,
                 size: Optional[int] = None):
        self.parts = tuple(parts)
        self.spec = spec
        self.path = path
        self.first, self.size = _placement(len(self.parts), first, size)

    @property
    def indices(self) -> range:
        """The model rank of each part."""
        return range(self.first, self.first + len(self.parts))

    def __getitem__(self, key) -> "RankedTree":
        return RankedTree([p[key] for p in self.parts], self.spec[key],
                          self.path + (key,), self.first, self.size)

    def __contains__(self, key) -> bool:
        return key in self.parts[0]

    def split(self, dim: int) -> bool:
        """Whether this leaf's ``dim`` is split over the ranks."""
        dim = dim % self.parts[0].ndim
        return dim < len(self.spec) and self.spec[dim] == MODEL

    def rank_slices(self, dim: int = 0) -> tuple:
        """Each rank's contiguous ``1/m`` slice along ``dim`` of a leaf every
        rank holds whole (a replicated leaf used a slice a rank: the SSM
        dynamics, ``R``, a group norm's scale), in rank order, views. Each
        rank's gradient is then zero outside its slice, so the step's sum
        over the ranks (``train.step._sum_replicated``) is exact."""
        if self.split(dim):
            raise ValueError(f"dim {dim} is already split over the ranks")
        m = self.size
        n = self.parts[0].shape[dim]
        if n % m:
            raise ValueError(f"dim {dim} of {n} does not split over {m} ranks")
        return tuple(p.narrow(dim, r * (n // m), n // m)
                     for r, p in zip(self.indices, self.parts))

    def index(self, i: int) -> "RankedTree":
        """Entry ``i`` of every leaf's leading stacked axis (a period's
        layer of ``params["layers"]``), the specs without their first
        entry."""
        from repro_torch.distributed.sharding import PartitionSpec
        return RankedTree(
            [tree.tree_map(lambda t: t[i], p) for p in self.parts],
            _map_specs(lambda s: PartitionSpec(*s[1:]), self.spec), self.path,
            self.first, self.size)


# ------------------------- params sharded over data ---------------------------


class _DataGather(torch.autograd.Function):
    """One rank's blocks of a leaf concatenated along the dim the data axes
    split, in row order, on one row's device. Backward: each block's slice
    of that row's gradient, moved to the block's device (the sum over the
    rows is the step's, ``train.step``).

    SPMD a process holds its own row's block: it gathers the others over
    its data group, and its backward gathers every row's gradient of the
    whole leaf and sums their slices of its block in row order (a
    reduce-scatter), the sum the lockstep step forms over the rows. With
    one microbatch that is the lockstep step's sum bit for bit; with more
    the rows are summed within each microbatch, before the microbatches."""

    @staticmethod
    def forward(ctx, site, dim, home, *blocks):
        ctx.dim = dim
        ctx.devices = [b.device for b in blocks]
        every = pg.everyone(blocks, pg.DATA)
        ctx.sizes = [b.shape[dim] for b in every]
        total = torch.cat([b.to(home) for b in every], dim)
        _count("all-gather", site, "fwd", total, 1)
        return total

    @staticmethod
    def backward(ctx, g):
        if pg.active():
            k = pg.index(pg.DATA)
            return None, None, None, compression._mesh_sum(
                [torch.split(x, ctx.sizes, ctx.dim)[k].contiguous()
                 for x in pg.everyone([g], pg.DATA)])
        parts = torch.split(g, ctx.sizes, ctx.dim)
        return (None, None, None, *(p.to(dev).contiguous()
                                    for p, dev in zip(parts, ctx.devices)))


class ShardedTree:
    """The param (sub)tree of a mesh with several data rows as its devices
    hold it (``distributed.sharding.shard_params``), seen from data row
    ``row``: ``blocks[k][r]`` the tree of the device on data row ``k`` and
    model rank ``r``, ``spec`` the layout spec tree (model and data
    entries). Indexing descends the blocks and the specs together, as
    :class:`RankedTree`'s does; :func:`gathered` makes the row's
    ``RankedTree``."""

    def __init__(self, blocks, spec, row: int, path: tuple = ()):
        self.blocks = [list(r) for r in blocks]
        self.spec = spec
        self.row = row
        self.path = path

    def __getitem__(self, key) -> "ShardedTree":
        return ShardedTree([[t[key] for t in r] for r in self.blocks], self.spec[key],
                           self.row, self.path + (key,))

    def __contains__(self, key) -> bool:
        return key in self.blocks[0][0]

    def index(self, i: int) -> "ShardedTree":
        """Entry ``i`` of every leaf's leading stacked axis (never split),
        the specs without their first entry."""
        from repro_torch.distributed.sharding import PartitionSpec
        return ShardedTree(
            [[tree.tree_map(lambda t: t[i], t) for t in r] for r in self.blocks],
            _map_specs(lambda s: PartitionSpec(*s[1:]), self.spec), self.row, self.path)


def _holds(node, key) -> bool:
    """Whether ``node`` is a dict that has ``key``, or one of its dict
    values does, at any depth."""
    return isinstance(node, dict) and (
        key in node or any(_holds(v, key) for v in node.values()))


def gathered(params, keep: Optional[str] = None):
    """What data row ``params.row``'s ranks compute with, from a
    :class:`ShardedTree`: a :class:`RankedTree` (model specs) whose every
    leaf split over the data axes is its rank's blocks all-gathered over
    them at the leaf's own width, in row order, onto the row's device of
    that rank (one ``"all-gather"`` a rank, ``"fwd"``, site ``"fsdp
    gather"``, counted on the one device it lands on), and whose every
    other leaf is the row's own block. Any other ``params`` (a
    ``RankedTree``: no data split) comes back as it is.

    With ``keep``, a subtree under a dict key ``keep`` stays a
    ``ShardedTree`` (a stack of layers, gathered one period at a time
    where it is used) and the dicts above it come back as dicts of the
    results, so a forward gathers everything else once."""
    if not isinstance(params, ShardedTree):
        return params
    node = params.blocks[0][0]
    if keep is not None and _holds(node, keep):
        return {k: params[k] if k == keep else gathered(params[k], keep) for k in node}
    from repro_torch.distributed.sharding import data_dim, model_part, spec_at
    d, rows = params.row, len(params.blocks)
    parts = []
    for r in range(len(params.blocks[0])):
        columns = [tree.leaves(params.blocks[k][r]) for k in range(rows)]
        out = []
        for j, (path, own) in enumerate(tree.leaves_with_path(params.blocks[d][r])):
            dim = data_dim(spec_at(params.spec, path))
            out.append(own if dim is None else _DataGather.apply(
                "fsdp gather", dim, own.device, *(c[j] for c in columns)))
        it = iter(out)
        parts.append(tree.tree_map(lambda _: next(it), params.blocks[d][r]))
    return RankedTree(parts, _map_specs(model_part, params.spec), params.path)


__all__ = ["BYTES", "MODEL", "Ranked", "RankedTree", "ShardedTree", "add_bytes",
           "all_gather", "all_max", "all_reduce", "bytes_by_kind", "counted_over",
           "each", "first_rank", "gathered", "piece", "reset_bytes"]
