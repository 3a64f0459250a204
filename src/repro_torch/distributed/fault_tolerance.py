"""Fault tolerance, as ``repro.distributed.fault_tolerance``: heartbeats,
straggler detection, the elastic shrink of a mesh and the recovery loop,
on injectable clocks, for the serving engines and the resilient trainer
(``train/resilience.py``).

* ``HeartbeatMonitor`` marks a host (a mesh position) dead after
  ``timeout`` seconds without a beat. The serving engines poll it at the
  top of every ``step()`` and shrink the mesh past a dead device, as they
  do for a ``serve.faults.DeviceLost`` raised mid-dispatch.
* ``StragglerDetector`` flags hosts whose step time stays above the
  fleet's EMA by ``z`` robust sigmas (the MAD) for ``patience`` steps.
* ``serving_shrink_plan`` and ``shrink_serving_mesh`` choose the survivor
  mesh: the first survivors, in mesh order, up to the largest power of
  two. ``MeshPlan`` / ``plan_mesh_for`` give the (pod, data, model) shape
  the JAX package's elastic LM mesh would take for a device count, and
  ``make_elastic_mesh`` lays a device list out on it.
* ``run_with_recovery`` is the driver loop: step, heartbeat, checkpoint
  cadence, and on a ``WorkerFailure`` rebuild, restore and go on.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.launch.mesh import ServingMesh


class WorkerFailure(RuntimeError):
    def __init__(self, hosts: Sequence[int]):
        super().__init__(f"workers failed: {sorted(hosts)}")
        self.hosts = sorted(hosts)


class Preemption(WorkerFailure):
    """The scheduler killed this process (spot or preemptible capacity).

    A preemption loses the in-memory state but no device: ``hosts`` is
    empty, so ``run_with_recovery`` takes the plain restart path (restore
    from the latest valid checkpoint, no mesh rebuild). The resilient
    trainer raises it to simulate a process kill in-process."""

    def __init__(self, step: Optional[int] = None):
        RuntimeError.__init__(
            self, "preempted" if step is None else f"preempted at step {step}")
        self.hosts: list[int] = []
        self.step = step


class HeartbeatMonitor:
    """Last beat of each of ``num_hosts`` hosts (mesh positions) on
    ``clock``; a host is dead once ``timeout`` seconds pass without one."""

    def __init__(self, num_hosts: int, *, timeout: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout = timeout
        self.clock = clock
        now = clock()
        self.last_beat = {h: now for h in range(num_hosts)}

    def beat(self, host: int) -> None:
        self.last_beat[host] = self.clock()

    def dead_hosts(self) -> list[int]:
        now = self.clock()
        return [h for h, t in self.last_beat.items()
                if now - t > self.timeout]

    def check(self) -> None:
        dead = self.dead_hosts()
        if dead:
            raise WorkerFailure(dead)


class StragglerDetector:
    """Flags hosts whose step time is persistently more than ``z`` sigmas
    above the fleet's EMA. ``observe`` takes ``{host: step_seconds}`` each
    step and returns the hosts with ``patience`` strikes in a row. The
    statistics are the JAX package's float64 numpy ones, so the flags
    agree on the same streams."""

    def __init__(self, *, alpha: float = 0.2, z: float = 3.0,
                 patience: int = 5):
        self.alpha = alpha
        self.z = z
        self.patience = patience
        self.ema: dict[int, float] = {}
        self.strikes: dict[int, int] = {}

    def observe(self, step_times: dict[int, float]) -> list[int]:
        for h, t in step_times.items():
            prev = self.ema.get(h, t)
            self.ema[h] = (1 - self.alpha) * prev + self.alpha * t
        vals = np.array(list(self.ema.values()))
        mu = float(np.median(vals))
        # A robust sigma (the MAD): one straggler must not inflate the
        # threshold that is meant to catch it.
        sigma = float(1.4826 * np.median(np.abs(vals - mu)) + 1e-3 * mu + 1e-9)
        flagged = []
        for h, t in step_times.items():
            if t > mu + self.z * sigma and t > 1.05 * mu:
                self.strikes[h] = self.strikes.get(h, 0) + 1
            else:
                self.strikes[h] = 0
            if self.strikes[h] >= self.patience:
                flagged.append(h)
        return flagged


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    shape: tuple[int, ...]
    axes: tuple[str, ...]

    @property
    def num_devices(self) -> int:
        return int(np.prod(self.shape))


def plan_mesh_for(num_devices: int, *, model_parallel: int = 16,
                  multi_pod_at: int = 512) -> MeshPlan:
    """The largest usable mesh for a surviving device count: the model
    axis stays fixed (param shardings stay valid) and the data axis
    shrinks to the largest fit; below one model-parallel group, a 1-D
    data mesh."""
    if num_devices >= multi_pod_at and num_devices % (model_parallel * 2) == 0:
        per_pod = num_devices // 2 // model_parallel
        return MeshPlan((2, per_pod, model_parallel), ("pod", "data", "model"))
    if num_devices >= model_parallel:
        data = num_devices // model_parallel
        return MeshPlan((data, model_parallel), ("data", "model"))
    return MeshPlan((num_devices,), ("data",))


def make_elastic_mesh(devices: Sequence, *, model_parallel: int = 16
                      ) -> tuple[np.ndarray, tuple[str, ...]]:
    """The JAX package's elastic LM mesh as a pure function: the first
    ``plan.num_devices`` of ``devices`` as a numpy object array of shape
    ``plan.shape``, in order, and ``plan.axes``, for ``plan =
    plan_mesh_for(len(devices))``."""
    devices = list(devices)
    plan = plan_mesh_for(len(devices), model_parallel=model_parallel)
    grid = np.empty(plan.num_devices, dtype=object)
    grid[:] = devices[:plan.num_devices]
    return grid.reshape(plan.shape), plan.axes


def serving_shrink_plan(n_surviving: int) -> int:
    """Device count the serving mesh shrinks to: the largest power of
    two <= ``n_surviving``. The serving ladders round every rung up to a
    device multiple (``serve.buckets.mesh_buckets``,
    ``serve.executor.default_extents``), so a power-of-two successor keeps
    every rung of a power-of-two predecessor divisible: losing 1 of 8
    devices lands on 4, not 7."""
    if n_surviving < 1:
        return 0
    return 1 << (int(n_surviving).bit_length() - 1)


def shrink_serving_mesh(mesh: ServingMesh,
                        dead: Sequence[int]) -> Optional[ServingMesh]:
    """The largest surviving serving mesh after losing ``dead`` (positions
    in ``mesh``): the first ``serving_shrink_plan(survivors)`` survivors,
    in mesh order. None when no index of ``dead`` is valid or nothing
    would survive."""
    devices = list(mesh.devices)
    dead_set = {int(d) for d in dead if 0 <= int(d) < len(devices)}
    if not dead_set:
        return None
    survivors = [d for i, d in enumerate(devices) if i not in dead_set]
    n = serving_shrink_plan(len(survivors))
    if n < 1:
        return None
    return ServingMesh(tuple(survivors[:n]))


def run_with_recovery(
    *,
    num_steps: int,
    step_fn: Callable[[int], dict],
    save_fn: Callable[[int], None],
    restore_fn: Callable[[], int],
    monitor: HeartbeatMonitor,
    rebuild_fn: Optional[Callable[[Sequence[int]], None]] = None,
    checkpoint_every: int = 50,
    max_restarts: int = 3,
    on_failure: Optional[Callable[[WorkerFailure, int], None]] = None,
) -> dict:
    """Run ``step_fn`` for steps ``restore_fn() .. num_steps - 1`` with a
    heartbeat check before each and ``save_fn`` every ``checkpoint_every``
    steps; on a ``WorkerFailure``, ``on_failure(failure, step)`` (before
    anything else: the hook that counts replayed work), then
    ``rebuild_fn(failure.hosts)``, the failed hosts dropped from the
    monitor, and a resume from ``restore_fn()``. Past ``max_restarts``
    failures the last one propagates. Returns the last step's metrics."""
    restarts = 0
    step = restore_fn()
    metrics: dict = {}
    while step < num_steps:
        try:
            monitor.check()
            metrics = step_fn(step)
            step += 1
            if step % checkpoint_every == 0:
                save_fn(step)
        except WorkerFailure as failure:
            restarts += 1
            if restarts > max_restarts:
                raise
            if on_failure is not None:
                on_failure(failure, step)
            if rebuild_fn is not None:
                rebuild_fn(failure.hosts)
            for h in failure.hosts:   # evicted hosts stop being monitored
                monitor.last_beat.pop(h, None)
            step = restore_fn()
    return metrics


__all__ = ["HeartbeatMonitor", "MeshPlan", "Preemption", "StragglerDetector",
           "WorkerFailure", "plan_mesh_for", "run_with_recovery",
           "serving_shrink_plan", "shrink_serving_mesh"]
