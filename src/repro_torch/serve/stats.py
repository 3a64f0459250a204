"""Serving statistics: one mutable recorder threaded through the queue,
executor cache and engine, plus the snapshot schema every surface
(`launch/serve_bnn.py`, `benchmarks/serving.py`, tests) reads.

Snapshot schema (``ServeStats.snapshot()``)::

    {"scheduler": "bucket" | "continuous",
     "requests": {"submitted": int, "completed": int,
                  "images_submitted": int, "images_completed": int,
                  "rejected": int, "images_rejected": int,
                  "expired": int, "images_expired": int,   # deadline
                  "failed": int, "images_failed": int,     # retries gone
                  "retried": int},        # requests touched by a retry
     "batches": {"dispatched": int, "real_rows": int, "padded_rows": int,
                 "dispatched_rows": int,           # real + padded
                 "padding_overhead": float,        # padded / (real+padded)
                 "pad_row_fraction": float,        # padded / dispatched_rows
                 "per_bucket": {bucket: count},    # dispatch counts per
                                                   # bucket rung / extent
                 "bucket_hit_rate": {bucket: fraction of dispatches},
                 "flush_reasons": {"full"|"max_wait"|"drain": count}},
     "executors": {"compiles": int,                # executors built
                   "hits": int, "misses": int,
                   "keys": [str, ...]},            # cache keys built
     "latency_s": {"count": int, "mean": float,
                   "p50": float, "p95": float, "p99": float, "max": float},
     "throughput": {"images_per_s": float, "wall_s": float},
     "slo": {"slo_s": float | None, "images_within_slo": int,
             "goodput_images_per_s": float},       # within-SLO imgs / wall
     "dispatch": {"retries": int,                  # batch redispatches
                  "fallbacks": int,                # engine demotions
                  "engine_path": ["old->new", ...]},
     "mesh": {"shrinks": int, "devices": int | None},  # None: no shrink
     "degraded": bool}    # any engine fallback or mesh shrink happened

``scheduler`` labels which dispatch policy produced the numbers (the
bucket ladder or the continuous/ragged scheduler, DESIGN.md §7/§9); the
``per_bucket`` map then keys on bucket rungs or tile-padded extent
classes respectively. ``pad_row_fraction`` is the pad-row waste the
continuous scheduler exists to remove — BENCH_serving.json reports it
per scheduler side by side. Goodput counts only images whose request
completed within ``slo_s`` (0.0 goodput and an empty within-SLO count
when no SLO is configured).

Latency is measured request-submit -> request-complete on the engine's
(injectable) clock, so the deterministic tests drive it with a fake
clock and the CLI with ``time.monotonic``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


def percentile(xs: list[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]); 0.0 on empty input."""
    if not xs:
        return 0.0
    ordered = sorted(xs)
    rank = max(0, min(len(ordered) - 1, int(round(q / 100.0 * (len(ordered) - 1)))))
    return ordered[rank]


@dataclasses.dataclass
class ServeStats:
    """Mutable counters; the engine owns one instance per lifetime.

    ``scheduler`` is a label only (snapshot provenance); ``slo_s``, when
    set, makes ``on_complete`` tally within-SLO images for the goodput
    figure.
    """

    scheduler: str = "bucket"
    slo_s: Optional[float] = None
    submitted_requests: int = 0
    submitted_images: int = 0
    completed_requests: int = 0
    completed_images: int = 0
    rejected_requests: int = 0
    rejected_images: int = 0
    expired_requests: int = 0
    expired_images: int = 0
    failed_requests: int = 0
    failed_images: int = 0
    retried_requests: int = 0
    batch_retries: int = 0
    dispatch_fallbacks: int = 0
    engine_path: list = dataclasses.field(default_factory=list)
    mesh_shrinks: int = 0
    mesh_devices: Optional[int] = None
    images_within_slo: int = 0
    dispatched_batches: int = 0
    real_rows: int = 0
    padded_rows: int = 0
    bucket_dispatches: dict = dataclasses.field(default_factory=dict)
    flush_reasons: dict = dataclasses.field(default_factory=dict)
    executor_compiles: int = 0
    executor_hits: int = 0
    executor_misses: int = 0
    executor_keys: list = dataclasses.field(default_factory=list)
    latencies_s: list = dataclasses.field(default_factory=list)
    wall_start: Optional[float] = None
    wall_end: Optional[float] = None

    # -- recording hooks ---------------------------------------------------
    def on_submit(self, n_images: int) -> None:
        self.submitted_requests += 1
        self.submitted_images += n_images

    def on_dispatch(self, bucket: int, real: int, reason: str) -> None:
        self.dispatched_batches += 1
        self.real_rows += real
        self.padded_rows += bucket - real
        self.bucket_dispatches[bucket] = self.bucket_dispatches.get(bucket, 0) + 1
        self.flush_reasons[reason] = self.flush_reasons.get(reason, 0) + 1

    def on_complete(self, n_images: int, latency_s: float) -> None:
        self.completed_requests += 1
        self.completed_images += n_images
        self.latencies_s.append(latency_s)
        if self.slo_s is not None and latency_s <= self.slo_s:
            self.images_within_slo += n_images

    def on_reject(self, n_images: int) -> None:
        """An admission-control rejection (continuous scheduler's
        ``max_queue_rows`` bound): the request never entered the queue."""
        self.rejected_requests += 1
        self.rejected_images += n_images

    def on_expire(self, n_images: int) -> None:
        """A request's deadline passed before its logits did — completed
        as a `DeadlineExceeded` result (DESIGN.md §11)."""
        self.expired_requests += 1
        self.expired_images += n_images

    def on_fail(self, n_images: int) -> None:
        """A request's batch exhausted its retry budget — completed as a
        `RequestFailed` result."""
        self.failed_requests += 1
        self.failed_images += n_images

    def on_retry(self, n_requests: int) -> None:
        """A failed batch was re-enqueued at the queue front; counts one
        batch retry and every live request riding in it."""
        self.batch_retries += 1
        self.retried_requests += n_requests

    def on_fallback(self, old_engine: str, new_engine: str) -> None:
        self.dispatch_fallbacks += 1
        self.engine_path.append(f"{old_engine}->{new_engine}")

    def on_shrink(self, old_devices: int, new_devices: int) -> None:
        self.mesh_shrinks += 1
        self.mesh_devices = new_devices

    def on_executor(self, key: str, *, hit: bool, compiled: bool) -> None:
        if hit:
            self.executor_hits += 1
        else:
            self.executor_misses += 1
            self.executor_keys.append(key)
        if compiled:
            self.executor_compiles += 1

    def mark_wall(self, t: float) -> None:
        if self.wall_start is None:
            self.wall_start = t
        self.wall_end = t

    # -- snapshot ----------------------------------------------------------
    def snapshot(self) -> dict:
        total_rows = self.real_rows + self.padded_rows
        wall = (
            (self.wall_end - self.wall_start)
            if self.wall_start is not None and self.wall_end is not None
            else 0.0
        )
        lat = self.latencies_s
        return {
            "scheduler": self.scheduler,
            "requests": {
                "submitted": self.submitted_requests,
                "completed": self.completed_requests,
                "images_submitted": self.submitted_images,
                "images_completed": self.completed_images,
                "rejected": self.rejected_requests,
                "images_rejected": self.rejected_images,
                "expired": self.expired_requests,
                "images_expired": self.expired_images,
                "failed": self.failed_requests,
                "images_failed": self.failed_images,
                "retried": self.retried_requests,
            },
            "batches": {
                "dispatched": self.dispatched_batches,
                "real_rows": self.real_rows,
                "padded_rows": self.padded_rows,
                "dispatched_rows": total_rows,
                "padding_overhead": (
                    self.padded_rows / total_rows if total_rows else 0.0
                ),
                "pad_row_fraction": (
                    self.padded_rows / total_rows if total_rows else 0.0
                ),
                "per_bucket": dict(sorted(self.bucket_dispatches.items())),
                "bucket_hit_rate": {
                    b: c / self.dispatched_batches
                    for b, c in sorted(self.bucket_dispatches.items())
                } if self.dispatched_batches else {},
                "flush_reasons": dict(sorted(self.flush_reasons.items())),
            },
            "executors": {
                "compiles": self.executor_compiles,
                "hits": self.executor_hits,
                "misses": self.executor_misses,
                "keys": list(self.executor_keys),
            },
            "latency_s": {
                "count": len(lat),
                "mean": sum(lat) / len(lat) if lat else 0.0,
                "p50": percentile(lat, 50),
                "p95": percentile(lat, 95),
                "p99": percentile(lat, 99),
                "max": max(lat) if lat else 0.0,
            },
            "throughput": {
                "images_per_s": (
                    self.completed_images / wall if wall > 0 else 0.0
                ),
                "wall_s": wall,
            },
            "slo": {
                "slo_s": self.slo_s,
                "images_within_slo": self.images_within_slo,
                "goodput_images_per_s": (
                    self.images_within_slo / wall
                    if wall > 0 and self.slo_s is not None else 0.0
                ),
            },
            "dispatch": {
                "retries": self.batch_retries,
                "fallbacks": self.dispatch_fallbacks,
                "engine_path": list(self.engine_path),
            },
            "mesh": {
                "shrinks": self.mesh_shrinks,
                "devices": self.mesh_devices,
            },
            "degraded": bool(self.dispatch_fallbacks or self.mesh_shrinks),
        }


__all__ = ["ServeStats", "percentile"]
