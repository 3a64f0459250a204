"""Executor cache: one BNN forward per shape bucket, replayed from a CUDA
graph.

The JAX package compiles one XLA executable per ``(bucket, engine,
conv_impl, blocks)`` key and replays it. The port's counterpart is a
captured CUDA graph: on CUDA, :meth:`ExecutorCache.get` builds the
executor of a key once, in three steps,

1. the forward (:func:`repro_torch.core.bnn.bnn_serve_fn` with the kernel
   path and tiling bound) runs once on a side stream, on zeros: this
   builds the kernels and fills every host-side memo a launch reads
   (``cudaFuncSetAttribute``, the clusters' occupancy queries);
2. one ``torch.cuda.CUDAGraph`` captures the forward on a static input
   ``[bucket, 32, 32, 3]``; every graph of a cache (of a replica, on a
   mesh) shares one memory pool (``torch.cuda.graph_pool_handle()``),
   which is safe because their replays never overlap;
3. :meth:`GraphExecutor.launch` copies the images into the static input
   from a pinned host buffer, replays, and copies the logits out to
   another without waiting; :meth:`GraphExecutor.collect` waits for them.

A capture that fails raises with the key; the executor never runs eager
on CUDA instead. On the CPU an executor is the eager forward: no graph
exists there. The JAX package's invariant carries over with "compiled"
read as "captured" (on CUDA) or "built" (on the CPU): after warmup the
count ``ServeStats`` records under ``executors.compiles`` equals the
buckets warmed, and steady-state traffic adds none. A replay launches
the kernels it captured without passing through their wrappers, so the
executor adds them to ``kernels.ops.LAUNCHES`` itself; the capture
launched nothing and adds nothing.

The executors run on the device the packed params live on; host images
are copied there per dispatch and logits copied back.

On a serving mesh (``mesh=``, a ``launch.mesh.ServingMesh``) the params
are replicated on each of its devices and a key's executor is a
:class:`MeshExecutor`: one executor a replica, each replica with its own
graph pool and stream, so replicas that share a card replay concurrently
without sharing memory. A batch splits into one contiguous shard a
replica; every shard is launched before any is collected. The key gains
``"mesh{k}"`` and still counts once in ``executors.compiles``, as the
JAX package's one executable a key.

:class:`RaggedExecutorCache` is the continuous scheduler's variant: it
keys executors on tile-padded extent classes (:func:`extent_for`: powers
of two below the chain's batch tile, then tile multiples) instead of
bucket rungs, and builds them with ``bnn_serve_fn(..., ragged=True)``,
so the megakernel FC trunk pads the batch only to the tile. One graph a
class: the batch is zero-padded to the class, so the chain's real row
count is the class itself and is frozen with it, as the JAX package
compiles one executable a class.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.bnn import bnn_serve_fn
from repro_torch.distributed.sharding import mesh_devices, replicate, shard_rows
from repro_torch.kernels import ops
from repro_torch.kernels.autotune import AUTO, blocks_key
from repro_torch.kernels.ops import RAGGED_TILE_N
from repro_torch.serve.stats import ServeStats

IMAGE_SHAPE = (32, 32, 3)  # the CIFAR BNN's fixed per-image shape

_UNSET = object()  # rebuild() sentinel: mesh=None is a meaningful override


def extent_for(n: int, *, tile: int = RAGGED_TILE_N, devices: int = 1) -> int:
    """The extent class a ragged ``n``-row batch dispatches at: the next
    power of two while below ``tile``, then the next multiple of
    ``tile``. Monotone in ``n``, and ``extent_for(e) == e`` for every
    class ``e``: the class set is closed under re-dispatch.

    On a mesh of ``devices > 1`` the same ladder applies to each device's
    shard: the class is ``devices * extent_for(ceil(n / devices))``, so
    every class divides the mesh and each shard is a single-device
    class."""
    if n < 1:
        raise ValueError(f"batch needs >= 1 rows, got {n}")
    if devices > 1:
        return devices * extent_for(-(-n // devices), tile=tile)
    if n < tile:
        e = 1
        while e < n:
            e *= 2
        return min(e, tile)
    return -(-n // tile) * tile


def default_extents(max_rows: int, *, tile: int = RAGGED_TILE_N,
                    devices: int = 1) -> tuple[int, ...]:
    """Every class :func:`extent_for` gives for batches of up to
    ``max_rows`` rows: the continuous engine's warmup set (7 classes,
    1/2/4/8/16/24/32, for tile 8 and 32 rows). With ``devices > 1``, the
    classes of ``ceil(max_rows / devices)`` shard rows scaled by the
    device count."""
    if max_rows < 1:
        raise ValueError(f"max_rows must be >= 1, got {max_rows}")
    if devices > 1:
        return tuple(devices * e for e in default_extents(
            -(-max_rows // devices), tile=tile))
    cap = extent_for(max_rows, tile=tile)
    exts: list[int] = []
    e = 1
    while e < tile:
        if e <= cap:
            exts.append(e)
        e *= 2
    exts.extend(range(tile, cap + 1, tile))
    return tuple(exts)


def params_device(packed: dict) -> torch.device:
    """The device of the packed params (the first conv's weights)."""
    return packed["conv"][0]["w"].device


def _host_images(images: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(images, dtype=np.float32, copy=True))


class _Executor:
    """``launch(images)`` starts a forward, ``collect()`` returns its host
    logits; a call does both."""

    def __call__(self, images: np.ndarray) -> np.ndarray:
        self.launch(images)
        return self.collect()


class EagerExecutor(_Executor):
    """The forward as called, on the CPU (where no graph exists)."""

    def __init__(self, fn: Callable, packed: dict, device: torch.device):
        self.fn, self.packed, self.device = fn, packed, device
        self._out = None

    def launch(self, images: np.ndarray) -> None:
        self._out = self.fn(self.packed, _host_images(images).to(self.device))

    def collect(self) -> np.ndarray:
        out, self._out = self._out, None
        return out.cpu().numpy()


class GraphExecutor(_Executor):
    """One forward at ``rows`` images captured in a CUDA graph on
    ``device`` (module docstring): built by the constructor. ``launch``
    copies the images in from a pinned host buffer, replays and copies the
    logits out to another, all on ``stream`` (the current stream when
    None) and without waiting; ``collect`` waits for that copy."""

    def __init__(self, fn: Callable, packed: dict, rows: int,
                 device: torch.device, pool, key: tuple, *,
                 stream: Optional[torch.cuda.Stream] = None,
                 replica: Optional[int] = None):
        self.rows, self.key, self.device, self.stream = rows, key, device, stream
        self._done = None
        where = "" if replica is None else f" on replica {replica}"
        with torch.cuda.device(device):
            self.static_in = torch.zeros((rows,) + IMAGE_SHAPE, device=device)
            self.host_in = torch.empty(self.static_in.shape, pin_memory=True)
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                fn(packed, self.static_in)
            torch.cuda.current_stream(device).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            before = dict(ops.LAUNCHES)
            try:
                with torch.cuda.graph(self.graph, pool=pool):
                    self.static_out = fn(packed, self.static_in)
            except Exception as err:  # noqa: BLE001 — re-raised with the key
                raise RuntimeError(
                    f"CUDA graph capture of executor {key}{where} failed: "
                    f"{type(err).__name__}: {err}") from err
            finally:
                # The wrappers counted the launches they recorded; the
                # graph launches them at each replay.
                self.launches = {k: ops.LAUNCHES[k] - before[k] for k in before
                                 if ops.LAUNCHES[k] != before[k]}
                ops.add_launches({k: -v for k, v in self.launches.items()})
            self.host_out = torch.empty(self.static_out.shape,
                                        dtype=self.static_out.dtype,
                                        pin_memory=True)

    def launch(self, images: np.ndarray) -> None:
        if images.shape[0] != self.rows:
            raise ValueError(f"executor {self.key} takes {self.rows} images, "
                             f"got {images.shape[0]}")
        if self._done is not None:
            self._done.synchronize()    # the last copy out of host_in
        self.host_in.numpy()[...] = images
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            self.static_in.copy_(self.host_in, non_blocking=True)
            self.graph.replay()
            self.host_out.copy_(self.static_out, non_blocking=True)
            self._done = torch.cuda.current_stream().record_event()
        ops.add_launches(self.launches)

    def collect(self) -> np.ndarray:
        self._done.synchronize()
        return self.host_out.numpy().copy()


class MeshExecutor(_Executor):
    """One executor a replica of the serving mesh, in mesh order: a batch
    splits into one contiguous shard a replica; ``launch`` launches every
    shard before ``collect`` gathers any, so the replicas overlap."""

    def __init__(self, replicas: list):
        self.replicas = replicas

    def launch(self, images: np.ndarray) -> None:
        rows = shard_rows(images.shape[0], len(self.replicas))
        for i, ex in enumerate(self.replicas):
            ex.launch(images[i * rows:(i + 1) * rows])

    def collect(self) -> np.ndarray:
        return np.concatenate([ex.collect() for ex in self.replicas])


class ExecutorCache:
    """Lazy per-bucket executor map with hit/miss/capture accounting.

    ``mesh`` (a ``launch.mesh.ServingMesh``, DESIGN.md §10) serves every
    bucket data-parallel: the packed params are replicated on each of its
    devices (``distributed.sharding.replicate``), a key's executor holds
    one executor a replica (:class:`MeshExecutor`), each with its own
    graph pool and stream on CUDA, and the key gains ``"mesh{k}"``.
    ``executors.compiles`` still counts keys, as the JAX package counts
    one executable a key."""

    _TAG: tuple = ()

    def __init__(
        self,
        packed_params: dict,
        *,
        engine: str = "xla",
        conv_impl: str = "im2col",
        blocks: object = AUTO,
        mesh: object = None,
        stats: Optional[ServeStats] = None,
    ):
        self.packed = packed_params
        self.device = params_device(packed_params)
        self.engine = engine
        self.conv_impl = conv_impl
        self.blocks = blocks
        self.mesh = mesh
        self.devices = mesh_devices(mesh)
        self.stats = stats if stats is not None else ServeStats()
        self._fns: dict[tuple, object] = {}
        # (params, device, graph pool, stream) of each replica.
        if mesh is None:
            cuda = self.device.type == "cuda"
            self._replicas = [(packed_params, self.device,
                               torch.cuda.graph_pool_handle() if cuda else None,
                               None)]
        else:
            cuda = mesh.devices[0].type == "cuda"
            self._replicas = [
                (p, d, torch.cuda.graph_pool_handle() if cuda else None,
                 torch.cuda.Stream(d) if cuda else None)
                for p, d in zip(replicate(packed_params, mesh), mesh.devices)]

    def key(self, bucket: int) -> tuple:
        mesh = (f"mesh{self.devices}",) if self.mesh is not None else ()
        return (bucket, self.engine, self.conv_impl,
                blocks_key(self.blocks)) + self._TAG + mesh

    def _build(self):
        return bnn_serve_fn(engine=self.engine, conv_impl=self.conv_impl,
                            blocks=self.blocks)

    def _executor(self, fn: Callable, rows: int, key: tuple):
        """The executor of ``rows`` images: one a replica, under a
        :class:`MeshExecutor` on a mesh; a graph capture on CUDA."""
        shard = shard_rows(rows, self.devices)
        exs = []
        for i, (params, dev, pool, stream) in enumerate(self._replicas):
            if dev.type == "cuda":
                exs.append(GraphExecutor(
                    fn, params, shard, dev, pool, key, stream=stream,
                    replica=None if self.mesh is None else i))
            else:
                exs.append(EagerExecutor(fn, params, dev))
        return exs[0] if self.mesh is None else MeshExecutor(exs)

    def get(self, bucket: int):
        """The executor for ``bucket`` (``executor(images) -> logits``,
        host numpy both); builds (and counts) it on first use of that
        bucket: a graph capture on CUDA, one a replica on a mesh."""
        k = self.key(bucket)
        ex = self._fns.get(k)
        hit = ex is not None
        if not hit:
            ex = self._executor(self._build(), bucket, k)
            self._fns[k] = ex
        self.stats.on_executor("|".join(map(str, k)), hit=hit, compiled=not hit)
        return ex

    def run(self, images: np.ndarray) -> np.ndarray:
        """Execute a bucket-shaped batch; returns host logits
        ``[rows, num_classes]``. On a mesh, a batch whose rows do not
        divide it is padded with zero images to the next multiple (only
        out-of-ladder batches: the engines' ladders divide the mesh) and
        the pad rows' logits are dropped."""
        n = images.shape[0]
        run_n = -(-n // self.devices) * self.devices
        if run_n != n:
            pad = np.zeros((run_n - n,) + images.shape[1:], np.float32)
            images = np.concatenate([np.asarray(images, np.float32), pad])
        return self.get(run_n)(images)[:n]

    def _ctor_kwargs(self) -> dict:
        return {"conv_impl": self.conv_impl, "blocks": self.blocks,
                "mesh": self.mesh, "stats": self.stats}

    def rebuild(self, *, packed=None, engine: Optional[str] = None,
                mesh=_UNSET):
        """A fresh cache with ``packed``/``engine``/``mesh`` overridden
        (the failover and shrink paths; ``mesh=None`` serves unmeshed),
        its executors built lazily. The stats recorder is shared with
        this one."""
        kw = self._ctor_kwargs()
        if mesh is not _UNSET:
            kw["mesh"] = mesh
        return type(self)(
            self.packed if packed is None else packed,
            engine=self.engine if engine is None else engine, **kw)

    def release(self) -> None:
        """Drop every executor: their graphs (every replica's), static
        buffers and pool memory are freed once no caller holds them."""
        self._fns.clear()

    def warmup(self, buckets: Sequence[int]) -> int:
        """Build every bucket's executor and run it once on zero images
        (a replay on CUDA, every replica's on a mesh): kernel builds,
        captures and first launches happen here, not under traffic.
        Returns the executors built."""
        built = 0
        for b in buckets:
            built += self.key(b) not in self._fns
            self.get(b)(np.zeros((b,) + IMAGE_SHAPE, np.float32))
        return built

    @property
    def size(self) -> int:
        return len(self._fns)


class RaggedExecutorCache(ExecutorCache):
    """Executor cache keyed on extent classes, for the continuous
    scheduler's exact-row batches: ``run`` pads a batch with zero images
    up to its :func:`extent_for` class (bit-neutral for the real rows,
    which are independent samples) and returns the real rows' logits.
    Keys carry a ``"ragged"`` marker, so they never alias the bucket
    cache's over one stats recorder. On a mesh the classes are those of
    ``extent_for(..., devices=)``."""

    _TAG = ("ragged",)

    def __init__(self, packed_params: dict, *, tile: int = RAGGED_TILE_N,
                 **kwargs):
        super().__init__(packed_params, **kwargs)
        self.tile = int(tile)

    def _ctor_kwargs(self) -> dict:
        return {**super()._ctor_kwargs(), "tile": self.tile}

    def _build(self):
        return bnn_serve_fn(engine=self.engine, conv_impl=self.conv_impl,
                            blocks=self.blocks, ragged=True)

    def extent_of(self, n: int) -> int:
        return extent_for(n, tile=self.tile, devices=self.devices)

    def run(self, images: np.ndarray) -> np.ndarray:
        """Execute an exact-row batch at its extent class; returns host
        logits ``[n, num_classes]`` of the real rows only."""
        n = images.shape[0]
        extent = self.extent_of(n)
        if extent != n:
            pad = np.zeros((extent - n,) + images.shape[1:], np.float32)
            images = np.concatenate([np.asarray(images, np.float32), pad])
        return super().run(images)[:n]


__all__ = ["ExecutorCache", "RaggedExecutorCache", "EagerExecutor",
           "GraphExecutor", "MeshExecutor", "IMAGE_SHAPE", "default_extents",
           "extent_for", "params_device"]
