"""Fault model for the serving engines (DESIGN.md §11).

This module is the resilience vocabulary shared by both serving
engines: terminal *result markers* (`DeadlineExceeded`,
`RequestFailed`) that `take()` hands back in place of logits, the
exception types a dispatch can die with, the `RetryPolicy` backoff
schedule, the `FallbackPolicy` engine-demotion ladder, and the
deterministic `FaultPlan` injection harness the chaos benchmark and
tests drive.

Everything here is deterministic and clock-free by construction:

- `FaultPlan` decides whether dispatch *i* faults from a stateless
  per-index RNG (`np.random.default_rng((seed, i))`), so the schedule
  is a pure function of the seed — independent of retries, wall time,
  and call order.  Latency faults go through an injectable ``sleep``
  hook (the fake-clock tests pass ``clk.advance``).
- `RetryPolicy` jitter is seeded per retry event, so backoff delays
  replay exactly.

Nothing in this file touches torch; it is pure policy.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "DeadlineExceeded",
    "RequestFailed",
    "is_error",
    "InjectedFault",
    "NaNLogits",
    "DeviceLost",
    "FaultSpec",
    "FaultPlan",
    "RetryPolicy",
    "FallbackPolicy",
]


# ---------------------------------------------------------------------------
# terminal result markers — returned by ``take()``, never raised
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DeadlineExceeded:
    """Result marker: the request's deadline passed before dispatch
    completed.  The engine never serves a request late and silent — it
    completes it with this marker instead."""

    rid: int
    deadline_s: float
    waited_s: float


@dataclasses.dataclass(frozen=True)
class RequestFailed:
    """Result marker: every retry attempt for the request's batch was
    exhausted.  ``error`` records the final exception, ``attempts`` how
    many dispatches were burned."""

    rid: int
    error: str
    attempts: int


def is_error(result) -> bool:
    """True when a ``take()`` result is a terminal error marker rather
    than a logits array."""
    return isinstance(result, (DeadlineExceeded, RequestFailed))


# ---------------------------------------------------------------------------
# dispatch-time exceptions
# ---------------------------------------------------------------------------


class InjectedFault(RuntimeError):
    """A fault raised by a `FaultPlan` (kind="raise")."""


class NaNLogits(RuntimeError):
    """The executor produced non-finite logits.  The engines guard
    every dispatch with this check, so a silently corrupted kernel is
    converted into a retryable failure instead of poisoned results."""


class DeviceLost(RuntimeError):
    """A device of the serving mesh died mid-dispatch. Carries the
    device's position in the mesh; a meshed engine shrinks the mesh past
    it (DESIGN.md §11) and does not charge the batch's retry budget."""

    def __init__(self, device: int = 0):
        super().__init__(f"device {device} lost")
        self.device = int(device)


# ---------------------------------------------------------------------------
# deterministic fault injection
# ---------------------------------------------------------------------------


_KINDS = ("raise", "nan", "latency", "device_loss")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One explicitly scheduled fault.

    Fires on dispatch indices ``at <= i < at + count`` whose extent /
    engine match (``None`` is a wildcard).  ``kind`` is one of
    ``raise`` (executor raises `InjectedFault`), ``nan`` (logits come
    back all-NaN), ``latency`` (dispatch sleeps ``latency_s`` through
    the plan's sleep hook before running), ``device_loss`` (raises
    `DeviceLost` for ``device``, a position in the serving mesh).
    """

    kind: str
    at: int = 0
    count: int = 1
    extent: Optional[int] = None
    engine: Optional[str] = None
    latency_s: float = 0.0
    device: int = 0

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {_KINDS}")

    def matches(self, index: int, extent: int, engine: str) -> bool:
        if not (self.at <= index < self.at + self.count):
            return False
        if self.extent is not None and self.extent != extent:
            return False
        if self.engine is not None and self.engine != engine:
            return False
        return True


class FaultPlan:
    """A deterministic, seeded schedule of injected faults.

    Two layers compose:

    - ``specs``: explicit `FaultSpec` entries, checked first (first
      match wins) — for pinning a failure to an exact dispatch index /
      extent / engine in tests and the chaos gate.
    - random mode: with ``rate`` > 0, dispatch *i* additionally faults
      with probability ``rate``, the kind drawn uniformly from
      ``kinds``.  The draw uses ``np.random.default_rng((seed, i))`` —
      a *stateless* per-index stream, so the schedule is identical no
      matter how many times a batch is retried or in what order
      indices are consulted.

    ``sleep`` is the hook latency faults go through; production uses
    ``time.sleep``, fake-clock tests pass ``clk.advance``.  Every fault
    that fires is appended to ``fired`` (index, kind, extent, engine)
    so benches can report the realized schedule.
    """

    def __init__(self, specs: Sequence[FaultSpec] = (), *,
                 rate: float = 0.0,
                 kinds: Tuple[str, ...] = ("raise", "nan", "latency"),
                 latency_s: float = 0.0,
                 seed: int = 0,
                 sleep: Callable[[float], None] = time.sleep):
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {rate}")
        for k in kinds:
            if k not in _KINDS:
                raise ValueError(f"unknown fault kind {k!r}")
        self.specs = tuple(specs)
        self.rate = float(rate)
        self.kinds = tuple(kinds)
        self.latency_s = float(latency_s)
        self.seed = int(seed)
        self.sleep = sleep
        self.fired: list = []

    def match(self, index: int, extent: int,
              engine: str) -> Optional[FaultSpec]:
        """The fault dispatch ``index`` should suffer, or None."""
        for spec in self.specs:
            if spec.matches(index, extent, engine):
                return spec
        if self.rate > 0.0:
            rng = np.random.default_rng((self.seed, index))
            if rng.random() < self.rate:
                kind = self.kinds[int(rng.integers(len(self.kinds)))]
                return FaultSpec(kind, at=index, latency_s=self.latency_s)
        return None

    def on_fire(self, index: int, spec: FaultSpec, extent: int,
                engine: str) -> None:
        self.fired.append({"index": index, "kind": spec.kind,
                           "extent": extent, "engine": engine})


# ---------------------------------------------------------------------------
# retry backoff
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Capped exponential backoff with deterministic jitter.

    ``delay_s(attempt, event)`` returns
    ``min(cap, base * 2**(attempt-1)) * (1 + jitter * u)`` with
    ``u ~ U[-1, 1]`` drawn from ``default_rng((seed, event))`` — the
    engine feeds a monotone retry-event counter, so delays replay
    exactly under a fixed seed.
    """

    max_attempts: int = 3
    backoff_base_s: float = 0.05
    backoff_cap_s: float = 1.0
    jitter: float = 0.25
    seed: int = 0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if not 0.0 <= self.jitter < 1.0:
            raise ValueError("jitter must be in [0, 1)")

    def delay_s(self, attempt: int, event: int) -> float:
        base = min(self.backoff_cap_s,
                   self.backoff_base_s * 2.0 ** max(0, attempt - 1))
        if self.jitter == 0.0:
            return base
        u = 2.0 * np.random.default_rng((self.seed, event)).random() - 1.0
        return base * (1.0 + self.jitter * u)


# ---------------------------------------------------------------------------
# engine failover
# ---------------------------------------------------------------------------


class FallbackPolicy:
    """Demotion ladder across serving engines.

    After ``failures_before_demote`` *consecutive* dispatch failures,
    the engine rebuilds its executor cache one rung down
    `SERVE_FALLBACKS` (megakernel → xnor → xla; megakernel_xla → xla).
    Every rung is bit-identical, so failover is logit-exact.

    The megakernel engines take ``pack_bnn_params_megakernel`` params,
    the fused ones ``pack_bnn_params_fused``: the policy holds both sets
    and skips the rungs it has no params for.
    """

    def __init__(self, *, fused_params=None, mega_params=None,
                 failures_before_demote: int = 2, warm: bool = True):
        if failures_before_demote < 1:
            raise ValueError("failures_before_demote must be >= 1")
        self.fused_params = fused_params
        self.mega_params = mega_params
        self.failures_before_demote = int(failures_before_demote)
        self.warm = warm

    def _params(self, engine: str):
        if engine.startswith("megakernel"):
            return self.mega_params
        return self.fused_params

    def params_for(self, engine: str):
        params = self._params(engine)
        if params is None:
            raise ValueError(f"no packed params for engine {engine!r}")
        return params

    def next_engine(self, current: str) -> Optional[str]:
        """The first ladder rung below ``current`` this policy holds
        params for, or None when there is nowhere left to demote."""
        from repro_torch.core.bnn import SERVE_FALLBACKS

        for rung in SERVE_FALLBACKS.get(current, ()):
            if self._params(rung) is not None:
                return rung
        return None
