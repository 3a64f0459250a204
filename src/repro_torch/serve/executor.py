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
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.bnn import bnn_serve_fn
from repro_torch.serve.stats import ServeStats

IMAGE_SHAPE = (32, 32, 3)  # the CIFAR BNN's fixed per-image shape


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

    def get(self, bucket: int):
        """The executor for ``bucket``; builds (and counts) it on first
        use of that bucket."""
        k = self.key(bucket)
        fn = self._fns.get(k)
        hit = fn is not None
        if not hit:
            fn = bnn_serve_fn(engine=self.engine, conv_impl=self.conv_impl)
            self._fns[k] = fn
        self.stats.on_executor("|".join(map(str, k)), hit=hit, compiled=not hit)
        return fn

    def run(self, images: np.ndarray) -> np.ndarray:
        """Execute a bucket-shaped batch; returns host logits
        ``[rows, num_classes]``."""
        fn = self.get(images.shape[0])
        x = torch.from_numpy(np.array(images, dtype=np.float32, copy=True))
        return fn(self.packed, x.to(self.device)).cpu().numpy()

    def rebuild(self, *, packed=None, engine: Optional[str] = None):
        """A fresh cache with ``packed``/``engine`` overridden (the
        failover path). The stats recorder is shared with this one."""
        return type(self)(
            self.packed if packed is None else packed,
            engine=self.engine if engine is None else engine,
            conv_impl=self.conv_impl, stats=self.stats,
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


__all__ = ["ExecutorCache", "IMAGE_SHAPE", "params_device"]
