"""Continuous-batching scheduler: ragged coalescing over the
variable-extent megakernel (DESIGN.md §9), on one device or a serving
mesh.

The bucket ladder pads every dispatch to a fixed rung (1/8/32/128). This
scheduler instead admits, on each ``step()``, whatever requests are
queued up to a row budget ``max_rows`` and concatenates their real rows
into one batch (the ``Segment`` bookkeeping of the micro-batcher), which
the ragged executor cache runs at its tile-padded extent class
(``executor.extent_for``), never a bucket rung. Inside the megakernel FC
trunk the extent takes the masked-tail path (``ragged=True`` through
``bnn_serve_fn``): the batch pads only to ``RAGGED_TILE_N``.

Policy beyond the ladder's:

* **admission control** — ``max_queue_rows`` bounds queued rows;
  ``submit`` past the bound raises :class:`QueueFull` (counted under
  ``requests.rejected``), so an overload sheds load at the front door.
* **SLO-aware wait** — with ``slo_s`` set, the coalescing wait of a
  non-full batch is ``slo_s * slo_headroom`` less the estimated service
  time of what is pending (an EWMA of seconds per row), clipped to
  ``[0, max_wait_s]``.

Every request served here yields logits bit-identical to its exact-shape
forward: pad rows are zero images and samples are independent, and the
masked tail leaves real columns unchanged (``tests/test_torch_continuous.py``).
On CUDA each extent class is one captured CUDA graph (``serve.executor``),
one a replica on a mesh. On a mesh the extent classes are device
multiples (``extent_for(..., devices=)``), recomputed after an elastic
shrink.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np

from repro_torch.kernels.autotune import AUTO
from repro_torch.serve.engine import ServingEngine
from repro_torch.serve.executor import (RaggedExecutorCache, default_extents,
                                        extent_for)
from repro_torch.serve.queue import MicroBatcher
from repro_torch.serve.stats import ServeStats

DEFAULT_MAX_ROWS = 32  # per-dispatch row budget (the ladder's top rung / 4)


class QueueFull(RuntimeError):
    """Admission control rejected a submit: queued rows would exceed
    ``max_queue_rows``. The request never entered the queue.

    ``retry_after_s`` estimates how long until the overflow clears: the
    service-time EWMA applied to the rows past the bound (the coalescing
    wait before the first observation)."""

    def __init__(self, msg: str, *, retry_after_s: Optional[float] = None):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class ContinuousBatcher(MicroBatcher):
    """Ragged coalescer: FIFO admission up to a row budget, no ladder.

    Every batch it emits has ``bucket == rows``; the executor cache, not
    the queue, picks the padded extent. ``poll`` flushes when pending
    rows reach ``max_rows`` (``"full"``) or the head-of-line request has
    waited out :meth:`current_wait` (``"max_wait"``).
    """

    def __init__(
        self,
        *,
        max_rows: int = DEFAULT_MAX_ROWS,
        max_wait_s: float = 0.002,
        max_queue_rows: Optional[int] = None,
        slo_s: Optional[float] = None,
        slo_headroom: float = 0.5,
        clock: Callable[[], float] = time.monotonic,
    ):
        # The parent's ladder is the single budget rung.
        super().__init__([int(max_rows)], max_wait_s=max_wait_s, clock=clock)
        self.max_rows = int(max_rows)
        if max_queue_rows is not None and max_queue_rows < self.max_rows:
            raise ValueError(
                f"max_queue_rows {max_queue_rows} < max_rows {self.max_rows}: "
                "admission would reject batches the budget could serve")
        self.max_queue_rows = max_queue_rows
        self.slo_s = slo_s
        self.slo_headroom = float(slo_headroom)
        # EWMA of observed seconds per row; None before the first dispatch.
        self._row_s: Optional[float] = None

    def submit(self, images: np.ndarray) -> int:
        images = np.asarray(images)
        n = images.shape[0] if images.ndim >= 1 else 0
        if (self.max_queue_rows is not None
                and self._pending_rows + max(n, 1) > self.max_queue_rows):
            overflow = self._pending_rows + max(n, 1) - self.max_queue_rows
            hint = self.est_service_s(overflow)
            raise QueueFull(
                f"{self._pending_rows} rows queued + {n} > max_queue_rows "
                f"{self.max_queue_rows}",
                retry_after_s=hint if hint > 0.0 else self.max_wait_s)
        return super().submit(images)

    def note_service(self, rows: int, seconds: float) -> None:
        """Fold one dispatch into the per-row EWMA (0.3 smoothing)."""
        if rows < 1 or seconds <= 0.0:
            return
        per_row = seconds / rows
        self._row_s = (per_row if self._row_s is None
                       else 0.7 * self._row_s + 0.3 * per_row)

    def est_service_s(self, rows: int) -> float:
        """Estimated service time of a ``rows``-row dispatch (0.0 before
        the first observation, so cold starts coalesce)."""
        if self._row_s is None:
            return 0.0
        return self._row_s * max(rows, 1)

    def current_wait(self) -> float:
        """The coalescing bound of a non-full batch: ``max_wait_s``, or
        with an SLO the remaining budget ``slo_s * slo_headroom -
        est_service(pending)`` clipped to ``[0, max_wait_s]``."""
        if self.slo_s is None:
            return self.max_wait_s
        budget = self.slo_s * self.slo_headroom
        budget -= self.est_service_s(min(self._pending_rows, self.max_rows))
        return max(0.0, min(self.max_wait_s, budget))

    def poll(self) -> list:
        out = []
        while self._pending_rows >= self.max_rows:
            out.append(self._take(self.max_rows, self.max_rows, "full"))
        if self._pending_rows and self.oldest_wait() >= self.current_wait():
            rows = self._pending_rows
            out.append(self._take(rows, rows, "max_wait"))
        return out

    def drain(self) -> list:
        out = []
        while self._pending_rows >= self.max_rows:
            out.append(self._take(self.max_rows, self.max_rows, "drain"))
        if self._pending_rows:
            rows = self._pending_rows
            out.append(self._take(rows, rows, "drain"))
        return out


class ContinuousServingEngine(ServingEngine):
    """The continuous batcher over the ragged executor cache, with the
    ``submit/step/drain/take/cancel`` surface and the bit-identity
    contract of :class:`~repro_torch.serve.engine.ServingEngine`.

    ``packed_params``/``engine``/``conv_impl``/``blocks`` mean what they
    mean for the bucket engine (``engine="megakernel"`` takes
    ``pack_bnn_params_megakernel`` params); ``max_rows`` bounds one
    dispatch, ``max_queue_rows`` admission (:class:`QueueFull`),
    ``slo_s`` arms the SLO-aware wait and the snapshot's goodput.
    ``warmup`` builds every class of ``default_extents(max_rows)``.

    ``mesh`` shards every dispatch across a serving mesh: the classes
    become ``default_extents(max_rows, devices=k)``, so a 3-row batch on
    8 devices runs at extent 8 and hands back 3 rows; ``mesh`` and
    ``heartbeat_timeout_s`` mean what they mean for the bucket engine.
    """

    def __init__(
        self,
        packed_params: dict,
        *,
        engine: str = "xla",
        conv_impl: str = "im2col",
        blocks: object = AUTO,
        max_rows: int = DEFAULT_MAX_ROWS,
        max_wait_s: float = 0.002,
        max_queue_rows: Optional[int] = None,
        slo_s: Optional[float] = None,
        slo_headroom: float = 0.5,
        mesh: object = None,
        deadline_s: Optional[float] = None,
        retry=None,
        fallback=None,
        faults=None,
        heartbeat_timeout_s: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        # Not super().__init__: the base builds a bucket batcher and cache.
        # Everything else (submit checks, retry/deadline pump, scatter,
        # take/cancel) is inherited over the attributes set here.
        self.stats = ServeStats(scheduler="continuous", slo_s=slo_s)
        self.clock = clock
        self.batcher = ContinuousBatcher(
            max_rows=max_rows, max_wait_s=max_wait_s,
            max_queue_rows=max_queue_rows, slo_s=slo_s,
            slo_headroom=slo_headroom, clock=clock)
        self.executors = RaggedExecutorCache(
            packed_params, engine=engine, conv_impl=conv_impl, blocks=blocks,
            mesh=mesh, stats=self.stats)
        self._on_remesh()
        self._init_resilience(deadline_s, retry, fallback, faults,
                              heartbeat_timeout_s)

    def _warm_shapes(self):
        """Extent classes instead of bucket rungs, for ``warmup`` and
        ``prewarm_fallback`` alike."""
        return self.extents

    def submit(self, images: np.ndarray, *,
               deadline_s: Optional[float] = None) -> int:
        """Enqueue one request; raises :class:`QueueFull` (with a
        ``retry_after_s`` hint, and counting the rejection) when
        admission control turns it away."""
        try:
            return super().submit(images, deadline_s=deadline_s)
        except QueueFull:
            self.stats.on_reject(np.asarray(images).shape[0])
            raise

    def _dispatch(self, batch) -> tuple[np.ndarray, int]:
        """Ragged dispatch: exact rows assembled, padded to the extent
        class in the executor. The service time feeds the SLO-aware
        wait, and the stats record the extent run (pad waste = extent -
        real rows). A faulted dispatch records no service time."""
        x = batch.assemble(self.batcher.requests)
        extent = self.executors.extent_of(x.shape[0])
        t0 = self.clock()
        logits = self._execute_rows(x)
        self.batcher.note_service(extent, self.clock() - t0)
        return logits, extent

    def _on_remesh(self) -> None:
        # The extent classes are device multiples: at construction and
        # after an elastic shrink they are those of the current mesh.
        self.extents = default_extents(
            self.batcher.max_rows, tile=self.executors.tile,
            devices=self.executors.devices)


__all__ = ["ContinuousBatcher", "ContinuousServingEngine", "QueueFull",
           "DEFAULT_MAX_ROWS", "extent_for"]
