"""The serving half of the JAX package's fault tolerance: heartbeats and
the elastic shrink of a serving mesh.

``HeartbeatMonitor`` marks a device dead after ``timeout`` seconds without
a beat, on an injectable clock; the serving engines poll it at the top of
every ``step()`` and shrink the mesh past a dead device, as they do for a
``serve.faults.DeviceLost`` raised mid-dispatch. ``serving_shrink_plan``
and ``shrink_serving_mesh`` choose the survivor mesh: the first survivors,
in mesh order, up to the largest power of two.

The training half (``Preemption``, ``StragglerDetector``, ``MeshPlan``,
``plan_mesh_for``, ``make_elastic_mesh``, ``run_with_recovery``) waits for
the resilient trainer (ROADMAP A3).
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Sequence

from repro_torch.launch.mesh import ServingMesh


class WorkerFailure(RuntimeError):
    def __init__(self, hosts: Sequence[int]):
        super().__init__(f"workers failed: {sorted(hosts)}")
        self.hosts = sorted(hosts)


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


__all__ = ["HeartbeatMonitor", "WorkerFailure", "serving_shrink_plan",
           "shrink_serving_mesh"]
