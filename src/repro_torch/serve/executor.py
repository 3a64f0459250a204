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
   ``[bucket, 32, 32, 3]``; every graph of a cache shares one memory
   pool (``torch.cuda.graph_pool_handle()``);
3. :meth:`GraphExecutor.__call__` copies the images into the static
   input, replays, and copies the logits out before the next replay.

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
from repro_torch.kernels import ops
from repro_torch.kernels.autotune import AUTO, blocks_key
from repro_torch.kernels.ops import RAGGED_TILE_N
from repro_torch.serve.stats import ServeStats

IMAGE_SHAPE = (32, 32, 3)  # the CIFAR BNN's fixed per-image shape


def extent_for(n: int, *, tile: int = RAGGED_TILE_N) -> int:
    """The extent class a ragged ``n``-row batch dispatches at: the next
    power of two while below ``tile``, then the next multiple of
    ``tile``. Monotone in ``n``, and ``extent_for(e) == e`` for every
    class ``e``: the class set is closed under re-dispatch."""
    if n < 1:
        raise ValueError(f"batch needs >= 1 rows, got {n}")
    if n < tile:
        e = 1
        while e < n:
            e *= 2
        return min(e, tile)
    return -(-n // tile) * tile


def default_extents(max_rows: int, *,
                    tile: int = RAGGED_TILE_N) -> tuple[int, ...]:
    """Every class :func:`extent_for` gives for batches of up to
    ``max_rows`` rows: the continuous engine's warmup set (7 classes,
    1/2/4/8/16/24/32, for tile 8 and 32 rows)."""
    if max_rows < 1:
        raise ValueError(f"max_rows must be >= 1, got {max_rows}")
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


class EagerExecutor:
    """The forward as called, on the CPU (where no graph exists)."""

    def __init__(self, fn: Callable, packed: dict, device: torch.device):
        self.fn, self.packed, self.device = fn, packed, device

    def __call__(self, images: np.ndarray) -> np.ndarray:
        x = _host_images(images).to(self.device)
        return self.fn(self.packed, x).cpu().numpy()


class GraphExecutor:
    """One forward at ``rows`` images captured in a CUDA graph (module
    docstring): built by the constructor, replayed by each call."""

    def __init__(self, fn: Callable, packed: dict, rows: int,
                 device: torch.device, pool, key: tuple):
        self.rows, self.key = rows, key
        self.static_in = torch.zeros((rows,) + IMAGE_SHAPE, device=device)
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
            raise RuntimeError(f"CUDA graph capture of executor {key} "
                               f"failed: {type(err).__name__}: {err}") from err
        finally:
            # The wrappers counted the launches they recorded; the graph
            # launches them at each replay.
            self.launches = {k: ops.LAUNCHES[k] - before[k]
                             for k in before if ops.LAUNCHES[k] != before[k]}
            ops.add_launches({k: -v for k, v in self.launches.items()})

    def __call__(self, images: np.ndarray) -> np.ndarray:
        if images.shape[0] != self.rows:
            raise ValueError(f"executor {self.key} takes {self.rows} images, "
                             f"got {images.shape[0]}")
        self.static_in.copy_(_host_images(images))
        self.graph.replay()
        ops.add_launches(self.launches)
        return self.static_out.cpu().numpy()


class ExecutorCache:
    """Lazy per-bucket executor map with hit/miss/capture accounting."""

    def __init__(
        self,
        packed_params: dict,
        *,
        engine: str = "xla",
        conv_impl: str = "im2col",
        blocks: object = AUTO,
        stats: Optional[ServeStats] = None,
    ):
        self.packed = packed_params
        self.device = params_device(packed_params)
        self.engine = engine
        self.conv_impl = conv_impl
        self.blocks = blocks
        self.stats = stats if stats is not None else ServeStats()
        self._fns: dict[tuple, object] = {}
        self._pool = (torch.cuda.graph_pool_handle()
                      if self.device.type == "cuda" else None)

    def key(self, bucket: int) -> tuple:
        return (bucket, self.engine, self.conv_impl, blocks_key(self.blocks))

    def _build(self):
        return bnn_serve_fn(engine=self.engine, conv_impl=self.conv_impl,
                            blocks=self.blocks)

    def get(self, bucket: int):
        """The executor for ``bucket`` (``executor(images) -> logits``,
        host numpy both); builds (and counts) it on first use of that
        bucket: a graph capture on CUDA."""
        k = self.key(bucket)
        ex = self._fns.get(k)
        hit = ex is not None
        if not hit:
            fn = self._build()
            if self.device.type == "cuda":
                ex = GraphExecutor(fn, self.packed, bucket, self.device,
                                   self._pool, k)
            else:
                ex = EagerExecutor(fn, self.packed, self.device)
            self._fns[k] = ex
        self.stats.on_executor("|".join(map(str, k)), hit=hit, compiled=not hit)
        return ex

    def run(self, images: np.ndarray) -> np.ndarray:
        """Execute a bucket-shaped batch; returns host logits
        ``[rows, num_classes]``."""
        return self.get(images.shape[0])(images)

    def _ctor_kwargs(self) -> dict:
        return {"conv_impl": self.conv_impl, "blocks": self.blocks,
                "stats": self.stats}

    def rebuild(self, *, packed=None, engine: Optional[str] = None):
        """A fresh cache with ``packed``/``engine`` overridden (the
        failover path), its executors built lazily for the new engine.
        The stats recorder is shared with this one."""
        return type(self)(
            self.packed if packed is None else packed,
            engine=self.engine if engine is None else engine,
            **self._ctor_kwargs(),
        )

    def release(self) -> None:
        """Drop every executor: their graphs, static buffers and pool
        memory are freed once no caller holds them."""
        self._fns.clear()

    def warmup(self, buckets: Sequence[int]) -> int:
        """Build every bucket's executor and run it once on zero images
        (a replay on CUDA), then synchronize the device: kernel builds,
        captures and first launches happen here, not under traffic.
        Returns the executors built."""
        built = 0
        for b in buckets:
            built += self.key(b) not in self._fns
            self.get(b)(np.zeros((b,) + IMAGE_SHAPE, np.float32))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
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
    cache's over one stats recorder."""

    def __init__(self, packed_params: dict, *, tile: int = RAGGED_TILE_N,
                 **kwargs):
        super().__init__(packed_params, **kwargs)
        self.tile = int(tile)

    def _ctor_kwargs(self) -> dict:
        return {**super()._ctor_kwargs(), "tile": self.tile}

    def key(self, extent: int) -> tuple:
        return super().key(extent) + ("ragged",)

    def _build(self):
        return bnn_serve_fn(engine=self.engine, conv_impl=self.conv_impl,
                            blocks=self.blocks, ragged=True)

    def extent_of(self, n: int) -> int:
        return extent_for(n, tile=self.tile)

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
           "GraphExecutor", "IMAGE_SHAPE", "default_extents", "extent_for",
           "params_device"]
