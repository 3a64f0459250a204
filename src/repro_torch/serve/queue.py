"""Request queue + micro-batcher: coalesce variable-count image
requests into bucket-sized batches (DESIGN.md §7).

The batcher is deliberately synchronous and clock-injected: ``poll()``
makes every flush decision from an explicit ``clock()`` reading, so the
deterministic tests drive it with a fake clock and production drives it
with ``time.monotonic``. No threads — the engine's dispatch loop is the
only consumer.

Flush rules (checked in this order by ``poll()``):

* **full** — pending rows fill the largest bucket: emit a full batch
  immediately (no reason to wait once a dispatch is maximal).
* **max_wait** — the oldest pending request has waited ``max_wait_s``:
  emit ALL pending rows in one batch at the smallest covering bucket
  (latency bound: no request waits more than one max_wait + one model
  dispatch).
* **drain** — ``drain()`` flushes the remainder regardless of age
  (shutdown / end of a load run).

Invariants: no row is
dropped, no row is duplicated, and rows stay FIFO — requests are packed
into batches in submission order, a request's rows stay in order, and a
request submitted earlier never lands in a later batch than a request
submitted after it. Requests larger than the biggest bucket are split
across consecutive batches (``Segment.offset`` tells the engine where
each slice lands in the request's result).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.serve.buckets import (
    DEFAULT_BUCKETS,
    bucket_for,
    normalize_buckets,
    pad_to_bucket,
)


@dataclasses.dataclass
class Request:
    """One inference request: ``images [n, H, W, C]``."""

    rid: int
    images: np.ndarray
    t_submit: float

    @property
    def n(self) -> int:
        return self.images.shape[0]


@dataclasses.dataclass(frozen=True)
class Segment:
    """A contiguous slice of one request inside one batch."""

    rid: int
    batch_row: int   # first row inside the assembled batch
    length: int      # rows in this slice
    offset: int      # first row inside the request (for split requests)


@dataclasses.dataclass
class Batch:
    """One bucket-shaped unit of work: ``rows <= bucket`` real rows."""

    bucket: int
    segments: list[Segment]
    rows: int
    reason: str  # "full" | "max_wait" | "drain"

    def assemble(self, requests: dict[int, Request]) -> np.ndarray:
        """Concatenate the segment slices and zero-pad to the bucket.

        A segment whose request was cancelled between batching and
        assembly contributes zero rows in place (zero images are valid
        inputs, discarded at scatter time) — the other segments'
        ``batch_row`` offsets stay honest, so one cancellation never
        corrupts its batchmates' logits.
        """
        parts = []
        proto = None
        for s in self.segments:
            req = requests.get(s.rid)
            if req is None:
                parts.append(s)  # placeholder, materialized below
            else:
                part = req.images[s.offset:s.offset + s.length]
                proto = part
                parts.append(part)
        if proto is None:
            raise ValueError(
                "every request in this batch was cancelled; nothing to "
                "assemble"
            )
        parts = [
            np.zeros((p.length,) + proto.shape[1:], proto.dtype)
            if isinstance(p, Segment) else p
            for p in parts
        ]
        return pad_to_bucket(np.concatenate(parts, axis=0), self.bucket)


class MicroBatcher:
    """FIFO request coalescer over a bucket ladder."""

    def __init__(
        self,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        *,
        max_wait_s: float = 0.002,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.buckets = normalize_buckets(buckets)
        self.max_bucket = self.buckets[-1]
        self.max_wait_s = float(max_wait_s)
        self.clock = clock
        self._next_rid = 0
        # (rid, offset) cursors into pending requests, FIFO.
        self._pending: deque[tuple[int, int]] = deque()
        self._pending_rows = 0
        self._row_shape: Optional[tuple[int, ...]] = None
        self.requests: dict[int, Request] = {}

    # -- producer side -----------------------------------------------------
    def submit(self, images: np.ndarray) -> int:
        """Enqueue one request; returns its request id.

        Rejects a mismatched per-row shape HERE, while the request is
        still the caller's problem — once rows are coalesced, a bad
        request would take its whole batch (other requests included)
        down with it at assemble time.
        """
        images = np.asarray(images)
        if images.ndim < 2 or images.shape[0] < 1:
            raise ValueError(f"request needs >= 1 leading rows, got "
                             f"shape {images.shape}")
        if self._row_shape is None:
            self._row_shape = images.shape[1:]
        elif images.shape[1:] != self._row_shape:
            raise ValueError(
                f"request row shape {images.shape[1:]} != this queue's "
                f"{self._row_shape}"
            )
        rid = self._next_rid
        self._next_rid += 1
        self.requests[rid] = Request(rid, images, self.clock())
        self._pending.append((rid, 0))
        self._pending_rows += images.shape[0]
        return rid

    @property
    def pending_rows(self) -> int:
        return self._pending_rows

    def oldest_wait(self) -> float:
        """Seconds the head-of-line request has been pending (0 if none)."""
        if not self._pending:
            return 0.0
        rid, _ = self._pending[0]
        return self.clock() - self.requests[rid].t_submit

    # -- consumer side -----------------------------------------------------
    def _take(self, rows: int, bucket: int, reason: str) -> Batch:
        """Pop ``rows`` rows off the queue head into one batch."""
        segments: list[Segment] = []
        filled = 0
        while filled < rows:
            rid, offset = self._pending.popleft()
            avail = self.requests[rid].n - offset
            take = min(avail, rows - filled)
            segments.append(Segment(rid, filled, take, offset))
            filled += take
            if take < avail:  # split: the rest stays at the queue head
                self._pending.appendleft((rid, offset + take))
        self._pending_rows -= rows
        return Batch(bucket=bucket, segments=segments, rows=rows,
                     reason=reason)

    def poll(self) -> list[Batch]:
        """Apply the flush rules at the current clock; may return []."""
        out: list[Batch] = []
        while self._pending_rows >= self.max_bucket:
            out.append(self._take(self.max_bucket, self.max_bucket, "full"))
        if self._pending_rows and self.oldest_wait() >= self.max_wait_s:
            rows = self._pending_rows
            out.append(self._take(rows, bucket_for(rows, self.buckets),
                                  "max_wait"))
        return out

    def drain(self) -> list[Batch]:
        """Flush everything pending, age notwithstanding."""
        out: list[Batch] = []
        while self._pending_rows >= self.max_bucket:
            out.append(self._take(self.max_bucket, self.max_bucket, "drain"))
        if self._pending_rows:
            rows = self._pending_rows
            out.append(self._take(rows, bucket_for(rows, self.buckets),
                                  "drain"))
        return out

    def forget(self, rid: int) -> Optional[Request]:
        """Drop a request's images — on completion (the engine calls
        this once all of a request's rows have produced logits) or on
        cancellation.

        A cancelled request may still have a pending cursor: after a
        split (one slice already dispatched, the rest at the queue
        head), dropping only the ``requests`` entry would orphan the
        cursor — the next ``_take`` would build a Segment for a ghost
        rid and ``assemble`` would take the whole batch (other requests'
        rows included) down with a KeyError. So the cursor and its
        remaining-row count are retired here too, keeping the
        no-drop/no-dup invariant over the rows that still exist
        """
        req = self.requests.pop(rid, None)
        if req is None:
            return None
        for i, (r, off) in enumerate(self._pending):
            if r == rid:
                del self._pending[i]
                self._pending_rows -= req.n - off
                break
        return req


__all__ = ["Request", "Segment", "Batch", "MicroBatcher"]
