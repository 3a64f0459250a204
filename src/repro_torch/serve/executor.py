"""Executor cache: one BNN forward per shape bucket.

PyTorch runs eagerly, so an executor is a closure over
:func:`repro_torch.core.bnn.bnn_serve_fn` with the kernel path bound,
one per ``(bucket, engine, conv_impl)`` key. The JAX package's
invariant carries over with "compiled" read as "built": after warmup,
steady-state traffic is pure cache hits and the count of executors
built equals the number of buckets warmed (``ServeStats`` records both
under ``executors``).

The executors run on the device the packed params live on; host images
are copied there per dispatch and logits copied back.

:class:`RaggedExecutorCache` is the continuous scheduler's variant: it
keys executors on tile-padded extent classes (:func:`extent_for`: powers
of two below the chain's batch tile, then tile multiples) instead of
bucket rungs, and builds them with ``bnn_serve_fn(..., ragged=True)``,
so the megakernel FC trunk pads the batch only to the tile.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.bnn import bnn_serve_fn
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


class ExecutorCache:
    """Lazy per-bucket executor map with hit/miss/build accounting."""

    def __init__(
        self,
        packed_params: dict,
        *,
        engine: str = "xla",
        conv_impl: str = "im2col",
        stats: Optional[ServeStats] = None,
    ):
        self.packed = packed_params
        self.device = params_device(packed_params)
        self.engine = engine
        self.conv_impl = conv_impl
        self.stats = stats if stats is not None else ServeStats()
        self._fns: dict[tuple, object] = {}

    def key(self, bucket: int) -> tuple:
        return (bucket, self.engine, self.conv_impl)

    def _build(self):
        return bnn_serve_fn(engine=self.engine, conv_impl=self.conv_impl)

    def get(self, bucket: int):
        """The executor for ``bucket``; builds (and counts) it on first
        use of that bucket."""
        k = self.key(bucket)
        fn = self._fns.get(k)
        hit = fn is not None
        if not hit:
            fn = self._build()
            self._fns[k] = fn
        self.stats.on_executor("|".join(map(str, k)), hit=hit, compiled=not hit)
        return fn

    def run(self, images: np.ndarray) -> np.ndarray:
        """Execute a bucket-shaped batch; returns host logits
        ``[rows, num_classes]``."""
        fn = self.get(images.shape[0])
        x = torch.from_numpy(np.array(images, dtype=np.float32, copy=True))
        return fn(self.packed, x.to(self.device)).cpu().numpy()

    def _ctor_kwargs(self) -> dict:
        return {"conv_impl": self.conv_impl, "stats": self.stats}

    def rebuild(self, *, packed=None, engine: Optional[str] = None):
        """A fresh cache with ``packed``/``engine`` overridden (the
        failover path). The stats recorder is shared with this one."""
        return type(self)(
            self.packed if packed is None else packed,
            engine=self.engine if engine is None else engine,
            **self._ctor_kwargs(),
        )

    def warmup(self, buckets: Sequence[int]) -> int:
        """Build and run every bucket's executor once on zero images,
        then synchronize the device (kernel builds and first launches
        happen here, not under traffic). Returns the executors built."""
        built = 0
        for b in buckets:
            built += self.key(b) not in self._fns
            self.get(b)(self.packed, torch.zeros((b,) + IMAGE_SHAPE,
                                                 device=self.device))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return built


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
        return (extent, self.engine, self.conv_impl, "ragged")

    def _build(self):
        return bnn_serve_fn(engine=self.engine, conv_impl=self.conv_impl,
                            ragged=True)

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


__all__ = ["ExecutorCache", "RaggedExecutorCache", "IMAGE_SHAPE",
           "default_extents", "extent_for", "params_device"]
