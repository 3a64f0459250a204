"""The serving engine: queue + executor cache + stats in one dispatch
loop (DESIGN.md §7), on one device.

Synchronous by construction — ``submit()`` enqueues, ``step()`` applies
the micro-batcher's flush rules and runs every ready batch, ``drain()``
finishes the tail. The caller owns the loop (the CLI's load generator,
the benchmark, the tests); there is no background thread to make timing
nondeterministic. Results are per-request float logits, bit-identical
to calling ``bnn_apply_fused`` on the request's images alone — padding
to a bucket never perturbs real rows (``tests/test_torch_serve.py``).

Resilience (DESIGN.md §11): dispatch is wrapped in a bounded
retry-with-backoff loop, so an executor failure completes requests with
`RequestFailed` results after exhaustion instead of killing the engine
and stranding the queue. Per-request deadlines (``submit(...,
deadline_s=)``) are enforced before every dispatch — an expired request
completes as `DeadlineExceeded`, never silently late. A
`FallbackPolicy` demotes the engine down the bit-identical
`SERVE_FALLBACKS` ladder on repeated kernel failure; it is off unless
the caller passes one. A `FaultPlan` injects deterministic failures for
tests. All of it is observable through `ServeStats`
(``snapshot()["dispatch"|"degraded"]``) — resilience is never silent.
The JAX engine's mesh, heartbeat and elastic shrink are not ported.
``serve.continuous`` builds the ragged scheduler on this engine.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.serve.buckets import DEFAULT_BUCKETS
from repro_torch.serve.executor import IMAGE_SHAPE, ExecutorCache
from repro_torch.serve.faults import (DeadlineExceeded, FallbackPolicy,
                                      FaultPlan, InjectedFault, NaNLogits,
                                      RequestFailed, RetryPolicy)
from repro_torch.serve.queue import MicroBatcher
from repro_torch.serve.stats import ServeStats


@dataclasses.dataclass
class _Work:
    """One assembled batch awaiting (re)dispatch.  ``attempts`` counts
    dispatches burned; ``not_before`` is the engine-clock time before
    which a retried batch must not redispatch (backoff)."""

    batch: object
    attempts: int = 0
    not_before: float = 0.0


class ServingEngine:
    """Batched inference over the packed BNN.

    ``packed_params`` comes from ``core.bnn.pack_bnn_params_fused``
    (``pack_bnn_params_megakernel`` for the megakernel engines), on the
    device the engine serves on. ``engine``/``conv_impl``
    select the kernel path exactly as in ``bnn_serve_fn``;
    ``buckets``/``max_wait_s`` shape the batching policy; ``clock`` is
    injectable for deterministic tests.

    Resilience knobs (DESIGN.md §11): ``deadline_s`` is the default
    per-request deadline (``submit`` can override per request);
    ``retry`` is the `RetryPolicy` bounding redispatch of failed
    batches; ``fallback`` is an optional `FallbackPolicy` arming engine
    demotion; ``faults`` is an optional `FaultPlan` injecting
    deterministic failures.
    """

    def __init__(
        self,
        packed_params: dict,
        *,
        engine: str = "xla",
        conv_impl: str = "im2col",
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        max_wait_s: float = 0.002,
        deadline_s: Optional[float] = None,
        retry: Optional[RetryPolicy] = None,
        fallback: Optional[FallbackPolicy] = None,
        faults: Optional[FaultPlan] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.stats = ServeStats()
        self.clock = clock
        self.batcher = MicroBatcher(
            buckets, max_wait_s=max_wait_s, clock=clock,
        )
        self.executors = ExecutorCache(
            packed_params, engine=engine, conv_impl=conv_impl,
            stats=self.stats,
        )
        self._init_resilience(deadline_s, retry, fallback, faults)

    def _init_resilience(self, deadline_s, retry, fallback, faults) -> None:
        """Result buffers and resilience state. The continuous engine
        builds its own batcher and executors instead of calling
        ``__init__``, and calls this."""
        # rid -> [n, 10] float logits being filled segment by segment
        self._partial: dict[int, np.ndarray] = {}
        self._filled: dict[int, int] = {}
        self.results: dict[int, object] = {}
        self.deadline_s = deadline_s
        self.retry = retry if retry is not None else RetryPolicy()
        self.fallback = fallback
        self.faults = faults
        # rid -> (absolute deadline on the engine clock, deadline_s, n)
        self._deadline: dict[int, tuple] = {}
        self._inflight: deque[_Work] = deque()
        self._dispatch_seq = 0
        self._retry_events = 0
        self._engine_failures = 0
        self._standby = None

    # -- lifecycle ---------------------------------------------------------
    def _warm_shapes(self) -> Sequence[int]:
        """The batch shapes ``warmup`` builds: the bucket rungs here,
        the extent classes in the continuous engine."""
        return self.batcher.buckets

    def warmup(self) -> int:
        """Build and run the executor of every shape in the ladder before
        taking traffic. Returns the number of executors built."""
        return self.executors.warmup(self._warm_shapes())

    def prewarm_fallback(self) -> int:
        """Build and warm a HOT-STANDBY executor cache one rung down
        the fallback ladder, so a later demotion swaps in warmed
        executors instead of stalling traffic behind a first run.
        Returns the executors built (0 when no fallback
        is armed or the ladder is exhausted)."""
        if self.fallback is None:
            return 0
        nxt = self.fallback.next_engine(self.executors.engine)
        if nxt is None:
            return 0
        self._standby = self.executors.rebuild(
            packed=self.fallback.params_for(nxt), engine=nxt)
        return self._standby.warmup(self._warm_shapes())

    def submit(self, images: np.ndarray, *,
               deadline_s: Optional[float] = None) -> int:
        """Enqueue one request of ``[n, 32, 32, 3]`` images.

        The per-image shape is checked against the model's fixed input
        HERE — the queue's own consistency check pins itself to the
        FIRST request it sees, so without this a wrong-shaped first
        request would be accepted, blow up mid-dispatch, and poison the
        queue for every later (valid) request.

        ``deadline_s`` (falling back to the engine default) bounds how
        long the request may wait: past it, the request completes as a
        `DeadlineExceeded` result instead of being served late.
        """
        images = np.asarray(images)
        if images.shape[1:] != IMAGE_SHAPE:
            raise ValueError(
                f"request rows must be {IMAGE_SHAPE} images, got "
                f"{images.shape[1:]}"
            )
        rid = self.batcher.submit(images)
        self.stats.on_submit(self.batcher.requests[rid].n)
        self.stats.mark_wall(self.clock())
        d = deadline_s if deadline_s is not None else self.deadline_s
        if d is not None:
            self._deadline[rid] = (self.clock() + d, float(d),
                                   self.batcher.requests[rid].n)
        return rid

    def step(self) -> list[int]:
        """Run the flush rules once; dispatch any ready batches.
        Returns the request ids resolved by this call (completed,
        expired, or failed)."""
        resolved = self._expire()
        return resolved + self._run(self.batcher.poll())

    def drain(self) -> list[int]:
        """Flush and run everything still pending — including retried
        batches whose backoff has not elapsed yet (a drain must leave
        nothing unresolved)."""
        resolved = self._expire()
        return resolved + self._run(self.batcher.drain(), force=True)

    def take(self, rid: int):
        """Pop a resolved request's result: its ``[n, 10]`` logits, or a
        `DeadlineExceeded`/`RequestFailed` marker (``faults.is_error``
        distinguishes). None if not resolved yet."""
        return self.results.pop(rid, None)

    def cancel(self, rid: int) -> bool:
        """Cancel a request: drop its queued rows, any partially filled
        logits, and any unread result. Returns whether anything was
        dropped. Rows of the request already inside an assembled batch
        simply compute and are discarded at scatter time (the engine
        guards on the request still existing) — other requests in that
        batch are untouched.
        """
        req = self.batcher.forget(rid)
        partial = self._partial.pop(rid, None)
        self._filled.pop(rid, None)
        self._deadline.pop(rid, None)
        result = self.results.pop(rid, None)
        return req is not None or partial is not None or result is not None

    def _expire(self) -> list[int]:
        """Complete every past-deadline request as `DeadlineExceeded`.
        Runs before each dispatch, so a request never computes after its
        deadline passed (rows already inside an assembled batch are
        dropped at scatter time by the forget guard)."""
        now = self.clock()
        out: list[int] = []
        for rid in [r for r, (t, _, _) in self._deadline.items()
                    if now >= t]:
            t, d, n = self._deadline.pop(rid)
            self.batcher.forget(rid)
            self._partial.pop(rid, None)
            self._filled.pop(rid, None)
            self.results[rid] = DeadlineExceeded(
                rid=rid, deadline_s=d, waited_s=now - (t - d))
            self.stats.on_expire(n)
            out.append(rid)
        if out:
            self.stats.mark_wall(now)
        return out

    def _execute_rows(self, x: np.ndarray) -> np.ndarray:
        """One executor run, through the fault plan and the NaN guard.
        Each call burns one monotone dispatch index — the unit the
        `FaultPlan` schedules on — whether or not it succeeds."""
        idx = self._dispatch_seq
        self._dispatch_seq += 1
        engine = self.executors.engine
        spec = None
        if self.faults is not None:
            spec = self.faults.match(idx, x.shape[0], engine)
            if spec is not None:
                self.faults.on_fire(idx, spec, x.shape[0], engine)
                if spec.kind == "latency":
                    self.faults.sleep(spec.latency_s)
                elif spec.kind == "raise":
                    raise InjectedFault(f"injected fault at dispatch {idx}")
        logits = self.executors.run(x)
        if spec is not None and spec.kind == "nan":
            logits = np.full_like(logits, np.nan)
        # Always-on guard: a silently corrupted kernel becomes a
        # retryable failure, never poisoned results.
        if not np.isfinite(logits).all():
            raise NaNLogits(f"non-finite logits at dispatch {idx} "
                            f"(engine {engine})")
        return logits

    def _dispatch(self, batch) -> tuple[np.ndarray, int]:
        """Assemble + execute one batch; returns ``(logits,
        dispatched_rows)`` — the rows the accelerator actually ran
        (the bucket size), which is what the pad-waste accounting records."""
        x = batch.assemble(self.batcher.requests)
        logits = self._execute_rows(x)
        return logits, x.shape[0]

    def _run(self, batches, force: bool = False) -> list[int]:
        """Enqueue freshly coalesced batches behind any retried work and
        pump the in-flight queue in FIFO order."""
        for batch in batches:
            self._inflight.append(_Work(batch))
        return self._pump(force=force)

    def _pump(self, *, force: bool = False) -> list[int]:
        """Process the in-flight queue head-first.  A retried batch in
        backoff blocks the queue (head-of-line on purpose: dispatching
        around it would break FIFO among successes); ``force`` ignores
        backoff so ``drain()`` always runs dry."""
        resolved: list[int] = []
        while self._inflight:
            resolved.extend(self._expire())
            work = self._inflight[0]
            if not force and work.not_before > self.clock():
                break
            self._inflight.popleft()
            resolved.extend(self._process(work))
        return resolved

    def _process(self, work: _Work) -> list[int]:
        batch = work.batch
        if all(
            seg.rid not in self.batcher.requests
            for seg in batch.segments
        ):
            return []  # every request cancelled/expired since batching
        try:
            logits, dispatched = self._dispatch(batch)
        except Exception as err:  # noqa: BLE001 — resilience boundary
            return self._on_failure(work, err)
        self._engine_failures = 0
        self.stats.on_dispatch(dispatched, batch.rows, batch.reason)
        now = self.clock()
        self.stats.mark_wall(now)
        done: list[int] = []
        for seg in batch.segments:
            req = self.batcher.requests.get(seg.rid)
            if req is None:
                # Cancelled/expired between assembly and scatter: its
                # rows computed as dead weight; drop them.
                continue
            buf = self._partial.get(seg.rid)
            if buf is None:
                buf = np.empty((req.n, logits.shape[-1]), logits.dtype)
                self._partial[seg.rid] = buf
                self._filled[seg.rid] = 0
            buf[seg.offset:seg.offset + seg.length] = (
                logits[seg.batch_row:seg.batch_row + seg.length]
            )
            self._filled[seg.rid] += seg.length
            if self._filled[seg.rid] == req.n:
                self.results[seg.rid] = self._partial.pop(seg.rid)
                del self._filled[seg.rid]
                self._deadline.pop(seg.rid, None)
                self.stats.on_complete(req.n, now - req.t_submit)
                self.batcher.forget(seg.rid)
                done.append(seg.rid)
        return done

    def _on_failure(self, work: _Work, err: Exception) -> list[int]:
        """Route one failed dispatch: it burns an attempt, may demote the
        engine, and either backs off at the queue front (FIFO preserved)
        or — budget exhausted — completes every rider as
        `RequestFailed`."""
        self._engine_failures += 1
        self._maybe_demote()
        work.attempts += 1
        if work.attempts >= self.retry.max_attempts:
            return self._fail_batch(work, err)
        live = sum(1 for seg in work.batch.segments
                   if seg.rid in self.batcher.requests)
        self._retry_events += 1
        self.stats.on_retry(live)
        work.not_before = self.clock() + self.retry.delay_s(
            work.attempts, self._retry_events)
        self._inflight.appendleft(work)
        return []

    def _fail_batch(self, work: _Work, err: Exception) -> list[int]:
        failed: list[int] = []
        for seg in work.batch.segments:
            req = self.batcher.forget(seg.rid)
            if req is None:
                continue  # cancelled/expired already
            self._partial.pop(seg.rid, None)
            self._filled.pop(seg.rid, None)
            self._deadline.pop(seg.rid, None)
            self.results[seg.rid] = RequestFailed(
                rid=seg.rid, error=f"{type(err).__name__}: {err}",
                attempts=work.attempts)
            self.stats.on_fail(req.n)
            failed.append(seg.rid)
        self.stats.mark_wall(self.clock())
        return failed

    def _maybe_demote(self) -> None:
        """After ``failures_before_demote`` consecutive failures, rebuild
        the executor cache one rung down the bit-identical fallback
        ladder (logit-exact by the bedrock invariant)."""
        if self.fallback is None:
            return
        if self._engine_failures < self.fallback.failures_before_demote:
            return
        nxt = self.fallback.next_engine(self.executors.engine)
        if nxt is None:
            return
        old = self.executors.engine
        if self._standby is not None and self._standby.engine == nxt:
            # Hot standby (prewarm_fallback): swap in warmed executors.
            self.executors = self._standby
            self._standby = None
            self._engine_failures = 0
            self.stats.on_fallback(old, nxt)
            return
        self.executors = self.executors.rebuild(
            packed=self.fallback.params_for(nxt), engine=nxt)
        self._engine_failures = 0
        self.stats.on_fallback(old, nxt)
        if self.fallback.warm:
            self.warmup()

    def snapshot(self) -> dict:
        return self.stats.snapshot()


__all__ = ["ServingEngine"]
