"""One process a device: the process group that runs a training step SPMD.

The JAX package runs a sharded step as one SPMD program: every device
computes its part at once and XLA's collectives move the data between
them. PyTorch's counterpart is one process per mesh position and
``torch.distributed`` collectives, which this module sets up:

* :func:`init_from_env` (``torchrun``'s ``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` / ``MASTER_PORT``
  through ``env://``) and :func:`init` (a ``file://`` store, for tests and
  for processes spawned on one host) start the world; :func:`destroy` ends
  it. Rank ``i`` runs on ``cuda:(LOCAL_RANK % device_count)`` unless the
  caller asks for the CPU.
* The backend rule (:func:`backend_for`): ``nccl`` when every rank of a
  host has a card of its own, ``gloo`` when ranks share a card, and always
  on the CPU. NCCL refuses a communicator in which two ranks sit on one
  card, so asking for it there raises ``ValueError`` before the world
  starts, naming the card. Under gloo every collective stages its payload
  through host memory, explicitly; nothing drops to another backend or
  moves compute to the CPU when a collective fails.
* :func:`bind` lays a mesh over the world (rank ``i`` at the mesh's flat
  position ``i``, the model axis last, as ``launch.mesh`` orders it) and
  builds its groups: one model group a data row, one data group a model
  column, each by ``dist.new_group``, every process creating every group
  in the same order.
* :func:`gather` (and :func:`gather_tree`) is the one collective the
  steps use: every rank's tensor of an axis, in mesh order, moved as raw
  bytes, so each process then does exactly what the single-process
  (lockstep) step does with the whole list, and its sums run in the same
  order and give the same bits. :func:`everyone` is the seam: a lockstep
  list of every rank's part passes through; a process's one part is
  gathered.
* :func:`spawn` runs a function on every rank of a new world of processes
  on this host (``torch.multiprocessing``, ``spawn``), for tests and for
  ``chip_smoke.py``.

Every wait is bounded by :data:`TIMEOUT_S`: a peer that never arrives, or
processes that issue their collectives in different orders, fail the run
with a timeout instead of hanging it.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch import tree

MODEL, DATA, WORLD = "model", "data", "world"
# The bound on every wait of the process group, in seconds.
TIMEOUT_S = 120.0
# Bytes of each piece of a gloo gather (:func:`_gather_bytes`).
GLOO_PIECE = 2 << 20


@dataclasses.dataclass
class _World:
    rank: int
    size: int
    backend: str
    device: torch.device
    rows: int = 1                 # the bound mesh's data rows
    ranks: int = 1                # its model ranks
    axes: dict = dataclasses.field(default_factory=dict)    # axis -> group of the bound mesh
    built: dict = dataclasses.field(default_factory=dict)   # (rows, ranks) -> axes


_WORLD: Optional[_World] = None


def active() -> bool:
    """Whether this process is one rank of a started world."""
    return _WORLD is not None


def _world() -> _World:
    if _WORLD is None:
        raise RuntimeError("no process group: call process_group.init or init_from_env")
    return _WORLD


def rank() -> int:
    return _world().rank


def world_size() -> int:
    return _world().size


def backend() -> str:
    return _world().backend


def device() -> torch.device:
    """This rank's device."""
    return _world().device


def axis_size(axis: str) -> int:
    w = _world()
    return {MODEL: w.ranks, DATA: w.rows, WORLD: w.size}[axis]


def index(axis: str) -> int:
    """This rank's place along ``axis`` of the bound mesh (the model rank,
    the data row, or the world rank)."""
    w = _world()
    return {MODEL: w.rank % w.ranks, DATA: w.rank // w.ranks, WORLD: w.rank}[axis]


# ------------------------------- the backend rule -----------------------------


def _card(d: torch.device) -> str:
    name = f"cuda:{d.index}"
    if torch.cuda.is_available() and d.index < torch.cuda.device_count():
        name += f" ({torch.cuda.get_device_name(d.index)})"
    return name


def backend_for(devices, requested: Optional[str] = None) -> str:
    """The backend for ranks on ``devices`` (one a rank of a host):
    ``nccl`` when each has a card of its own, ``gloo`` where two share a
    card, and on the CPU. ``requested`` (``"nccl"`` or ``"gloo"``) is
    taken where it can run: ``ValueError`` for NCCL with two ranks on one
    card (NCCL refuses such a communicator) or on the CPU."""
    devs = [torch.device(d) for d in devices]
    if requested not in (None, "nccl", "gloo"):
        raise ValueError(f"backend {requested!r}: expected 'nccl' or 'gloo'")
    kinds = {d.type for d in devs}
    if not devs or len(kinds) > 1 or not kinds <= {"cuda", "cpu"}:
        raise ValueError(f"ranks on CUDA devices or on the CPU, got {list(map(str, devs))}")
    if kinds == {"cpu"}:
        if requested == "nccl":
            raise ValueError("nccl needs a card a rank; these ranks run on the CPU")
        return "gloo"
    counts: dict = {}
    for d in devs:
        counts[d.index] = counts.get(d.index, 0) + 1
    shared = sorted(i for i, c in counts.items() if c > 1)
    if requested == "nccl" and shared:
        i = shared[0]
        raise ValueError(f"nccl with {counts[i]} ranks on {_card(torch.device('cuda', i))}: "
                         "NCCL refuses a communicator in which two ranks share a "
                         "card; use gloo there")
    return requested or ("gloo" if shared else "nccl")


def rank_device(local_rank: int, device=None) -> torch.device:
    """The device of the rank ``local_rank`` of a host: the CPU where
    ``device`` names it, else ``cuda:(local_rank % device_count)``."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    from repro_torch.core.bnn import resolve_device
    resolve_device(device)          # raises when CUDA is asked for and absent
    return torch.device("cuda", local_rank % torch.cuda.device_count())


# ------------------------------- the world -----------------------------------


def _start(rank_: int, size: int, local_rank: int, local_size: int,
           init_method: str, requested: Optional[str], device,
           timeout: float) -> None:
    global _WORLD
    if _WORLD is not None:
        raise RuntimeError("a process group is already running in this process")
    if not 0 < timeout <= TIMEOUT_S:
        raise ValueError(f"timeout {timeout} s: at most {TIMEOUT_S} s")
    dev = rank_device(local_rank, device)
    name = backend_for([rank_device(j, device) for j in range(local_size)], requested)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(name, init_method=init_method, rank=rank_,
                            world_size=size,
                            timeout=datetime.timedelta(seconds=timeout))
    _WORLD = _World(rank_, size, name, dev)


def init(rank_: int, size: int, store_path: str, *, backend: Optional[str] = None,
         device=None, timeout: float = TIMEOUT_S) -> None:
    """Start rank ``rank_`` of a world of ``size`` processes on one host,
    meeting through the file ``store_path`` (``file://``; it must not
    exist yet). ``device="cpu"`` runs on the CPU; the backend follows
    :func:`backend_for` unless ``backend`` asks for one it allows; every
    wait is bounded by ``timeout`` seconds (at most :data:`TIMEOUT_S`)."""
    _start(rank_, size, rank_, size, f"file://{os.path.abspath(store_path)}", backend,
           device, timeout)


def init_from_env(*, backend: Optional[str] = None, device=None,
                  timeout: float = TIMEOUT_S) -> None:
    """Start this process's rank of the world ``torchrun`` describes in
    its environment (``env://``)."""
    env = os.environ
    size = int(env["WORLD_SIZE"])
    local_rank = int(env.get("LOCAL_RANK", env["RANK"]))
    _start(int(env["RANK"]), size, local_rank, int(env.get("LOCAL_WORLD_SIZE", size)),
           "env://", backend, device, timeout)


def destroy() -> None:
    """End the world (a no-op when none runs)."""
    global _WORLD
    if _WORLD is None:
        return
    _WORLD = None
    dist.destroy_process_group()


def world_devices() -> list:
    """The device of every rank: the CPU, or rank ``j`` on ``cuda:(j %
    device_count)``, its own device where ranks are laid out host by host
    (torchrun's order, the same count of cards a host)."""
    w = _world()
    if w.device.type == "cpu":
        return [torch.device("cpu")] * w.size
    return [torch.device("cuda", j % torch.cuda.device_count()) for j in range(w.size)]


def bind(mesh):
    """``mesh`` as this process holds it: the same mesh with ``position``
    its world rank, the groups of its axes built (once a shape) and made
    the ones :func:`gather` reads. A ``launch.mesh.ServingMesh`` is a 1-D
    data mesh; a ``DeviceMesh`` has its model axis last."""
    from repro_torch.distributed.sharding import data_axis_size, model_axis_size
    from repro_torch.launch.mesh import DeviceMesh, ServingMesh
    w = _world()
    if isinstance(mesh, ServingMesh):
        rows, ranks = len(mesh), 1
    else:
        rows, ranks = data_axis_size(mesh), model_axis_size(mesh)
    if rows * ranks != w.size:
        raise ValueError(f"a mesh of {rows * ranks} positions for a world of {w.size}")
    if (rows, ranks) not in w.built:
        w.built[(rows, ranks)] = _new_groups(rows, ranks, w.size)
    w.rows, w.ranks, w.axes = rows, ranks, w.built[(rows, ranks)]
    if isinstance(mesh, ServingMesh):
        return ServingMesh(mesh.devices, position=w.rank)
    return DeviceMesh(mesh.devices, mesh.axis_names, position=w.rank)


def _new_groups(rows: int, ranks: int, size: int) -> dict:
    """Every process creates every group, in one order: one model group a
    data row, then one data group a model column. The whole world is the
    default group (a world of one process too, so its collectives still go
    through the backend); any other group of one process needs no
    communicator (``None`` here)."""
    me = _world().rank
    groups = {WORLD: dist.group.WORLD}

    def make(members):
        if len(members) == size:
            return dist.group.WORLD
        if len(members) == 1:
            return None
        return dist.new_group(members, timeout=datetime.timedelta(seconds=TIMEOUT_S))

    for d in range(rows):
        g = make(list(range(d * ranks, (d + 1) * ranks)))
        if me // ranks == d:
            groups[MODEL] = g
    for r in range(ranks):
        g = make(list(range(r, size, ranks)))
        if me % ranks == r:
            groups[DATA] = g
    return groups


# ------------------------------- the collective -------------------------------


def _gather_bytes(flat: torch.Tensor, axis: str) -> list:
    """Every rank's ``uint8`` buffer of ``axis`` (equal sizes), in mesh
    order, on ``flat``'s device (this rank's entry ``flat`` itself). Under
    gloo a CUDA buffer goes through pinned host memory and back, and the
    buffer moves in pieces of :data:`GLOO_PIECE` bytes issued together:
    gloo moves one large message several times slower than its pieces
    (``scripts/spmd_gather_bench.py``)."""
    w = _world()
    group = w.axes.get(axis, dist.group.WORLD if axis == WORLD else None)
    if group is None:
        return [flat]
    n, me = axis_size(axis), index(axis)
    if w.backend != "gloo":
        out = [torch.empty_like(flat) for _ in range(n)]
        dist.all_gather(out, flat, group=group)
        return out
    staged = flat.is_cuda
    src = flat
    if staged:
        src = torch.empty(flat.numel(), dtype=torch.uint8, pin_memory=True)
        src.copy_(flat)
    parts = list(torch.empty((n, flat.numel()), dtype=torch.uint8,
                             pin_memory=staged).unbind(0))
    pending = [dist.all_gather([p[i:i + GLOO_PIECE] for p in parts],
                               src[i:i + GLOO_PIECE], group=group, async_op=True)
               for i in range(0, flat.numel(), GLOO_PIECE)]
    for work in pending:
        work.wait()
    return [flat if i == me else p.to(flat.device) if staged else p
            for i, p in enumerate(parts)]


def _as_bytes(x: torch.Tensor) -> torch.Tensor:
    return x.detach().contiguous().reshape(-1).view(torch.uint8)


def _from_bytes(b: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return b.clone().view(like.dtype).reshape(like.shape)


def gather(x: torch.Tensor, axis: str) -> list:
    """Every rank's ``x`` along ``axis`` (each the same shape and dtype),
    in mesh order, on ``x``'s device: this rank's entry is ``x`` itself.
    No gradient flows through it."""
    me = index(axis)
    got = _gather_bytes(_as_bytes(x), axis)
    return [x.detach() if i == me or len(got) == 1 else _from_bytes(b, x)
            for i, b in enumerate(got)]


def gather_tree(t, axis: str) -> list:
    """Every rank's tree ``t`` along ``axis`` (the same structure, shapes
    and dtypes), in mesh order: one collective for the whole tree."""
    leaves = tree.leaves(t)
    if not leaves:
        return [t] * axis_size(axis)
    me = index(axis)
    got = _gather_bytes(torch.cat([_as_bytes(x) for x in leaves]), axis)
    sizes = [x.numel() * x.element_size() for x in leaves]
    out = []
    for i, buf in enumerate(got):
        if i == me or len(got) == 1:
            out.append(tree.tree_map(torch.Tensor.detach, t))
            continue
        it = iter([_from_bytes(b, x) for b, x in zip(buf.split(sizes), leaves)])
        out.append(tree.tree_map(lambda _: next(it), t))
    return out


def _spawned(rank_: int, fn, size: int, workdir: str, device, backend_, args) -> None:
    torch.set_num_threads(1)
    init(rank_, size, os.path.join(workdir, "store"), device=device, backend=backend_)
    try:
        torch.save(fn(*args), os.path.join(workdir, f"rank{rank_}.pt"))
    finally:
        destroy()


def spawn(fn, size: int, *args, device=None, backend: Optional[str] = None,
          workdir: Optional[str] = None) -> list:
    """``fn(*args)`` on every rank of a new world of ``size`` processes on
    this host (``torch.multiprocessing``, ``spawn``; a ``file://`` store
    in ``workdir``, a new temporary directory by default; one intra-op
    thread a process), its results in rank order. A process that raises
    or dies fails the call. ``fn`` is a module-level function."""
    import tempfile
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        mp.start_processes(_spawned, args=(fn, size, tmp, device, backend, args),
                           nprocs=size, join=True, start_method="spawn")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(size)]


def everyone(xs, axis: str) -> list:
    """The parts of every rank of ``axis`` in mesh order: ``xs`` itself
    where it holds them all (one process drives the mesh, or the axis has
    one rank), else this process's one part gathered over the axis."""
    xs = list(xs)
    if not active() or len(xs) == axis_size(axis):
        return xs
    if len(xs) != 1:
        raise ValueError(f"{len(xs)} parts of a {axis} axis of {axis_size(axis)} "
                         "ranks: a process holds its own part")
    return gather(xs[0], axis)


def mean_over_world(values: dict) -> dict:
    """Each entry's mean over the world's ranks (every rank passing the
    same keys), in rank order."""
    out: list = [None] * world_size()
    dist.all_gather_object(out, dict(values))
    keys = sorted(set().union(*out), key=str)
    return {k: sum(o.get(k, 0.0) for o in out) / len(out) for k in keys}


__all__ = ["DATA", "GLOO_PIECE", "MODEL", "TIMEOUT_S", "WORLD", "active", "axis_size", "backend",
           "backend_for", "bind", "destroy", "device", "everyone", "gather",
           "gather_tree", "index", "init", "init_from_env", "mean_over_world",
           "rank", "rank_device", "spawn", "world_devices", "world_size"]
