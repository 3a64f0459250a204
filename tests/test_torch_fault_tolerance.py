"""The training half of the port's fault tolerance
(``distributed.fault_tolerance``) against the JAX package's: the
straggler detector's flags and strikes on seeded step-time streams,
``plan_mesh_for`` over every device count up to 1024, ``Preemption``, and
``run_with_recovery`` driven by one scripted failure sequence in both
packages; then the JAX package's own tests of these pieces, ported
(``tests/test_distributed.py``). All exact: the detector's statistics
are the same float64 numpy arithmetic."""

import numpy as np
import pytest

from repro.distributed import fault_tolerance as jft
from repro_torch.distributed import fault_tolerance as tft
from repro_torch.distributed.fault_tolerance import (HeartbeatMonitor,
                                                     Preemption,
                                                     StragglerDetector,
                                                     WorkerFailure,
                                                     plan_mesh_for,
                                                     run_with_recovery)


def step_time_stream(seed: int, hosts: int, steps: int):
    """Lognormal step times around 1 s, with bursts where one host runs
    2-12x slower for a few steps, and now and then a host drops out."""
    rng = np.random.default_rng(seed)
    slow_host, slow_left = None, 0
    for _ in range(steps):
        times = {h: float(np.exp(0.05 * rng.normal())) for h in range(hosts)
                 if rng.random() > 0.03}
        if slow_left == 0 and rng.random() < 0.2:
            slow_host, slow_left = int(rng.integers(hosts)), int(rng.integers(1, 7))
        if slow_left and slow_host in times:
            times[slow_host] *= float(rng.uniform(2, 12))
        slow_left = max(0, slow_left - 1)
        yield times


@pytest.mark.parametrize("seed,hosts,alpha,z,patience", [
    (0, 8, 0.2, 3.0, 3), (1, 8, 0.2, 3.0, 5), (2, 4, 0.5, 2.0, 2),
    (3, 16, 0.1, 4.0, 3)])
def test_straggler_detector_matches_jax(seed, hosts, alpha, z, patience):
    kw = dict(alpha=alpha, z=z, patience=patience)
    got, want = StragglerDetector(**kw), jft.StragglerDetector(**kw)
    flagged_any = 0
    for times in step_time_stream(seed, hosts, 200):
        a, b = got.observe(dict(times)), want.observe(dict(times))
        assert a == b
        assert got.strikes == want.strikes and got.ema == want.ema
        flagged_any += bool(a)
    assert flagged_any  # the streams do flag someone


def test_plan_mesh_for_matches_jax():
    for n in range(1, 1025):
        for kw in ({}, {"model_parallel": 8, "multi_pod_at": 256}):
            got, want = plan_mesh_for(n, **kw), jft.plan_mesh_for(n, **kw)
            assert (got.shape, got.axes, got.num_devices) == (
                want.shape, want.axes, want.num_devices), (n, kw)


def test_preemption_is_a_failure_of_no_host():
    for step in (None, 7):
        got, want = Preemption(step), jft.Preemption(step)
        assert isinstance(got, WorkerFailure)
        assert (str(got), got.hosts, got.step) == (str(want), want.hosts,
                                                   want.step)


def scripted_run(ft, script: dict, *, num_steps: int, hosts: int,
                 max_restarts: int = 3):
    """``ft.run_with_recovery`` with failures raised at scripted steps (one
    each); the trace of every call, or the failure that ended it."""
    trace, saved, pending = [], {"step": 0}, dict(script)

    def step_fn(step):
        trace.append(("step", step))
        if step in pending:
            hosts_failed = pending.pop(step)
            raise (ft.Preemption(step) if hosts_failed is None
                   else ft.WorkerFailure(hosts_failed))
        return {"step": step}

    def save_fn(step):
        trace.append(("save", step))
        saved["step"] = step

    def restore_fn():
        trace.append(("restore", saved["step"]))
        return saved["step"]

    mon = ft.HeartbeatMonitor(num_hosts=hosts, timeout=1e9)
    try:
        out = ft.run_with_recovery(
            num_steps=num_steps, step_fn=step_fn, save_fn=save_fn,
            restore_fn=restore_fn, monitor=mon, checkpoint_every=3,
            max_restarts=max_restarts,
            rebuild_fn=lambda h: trace.append(("rebuild", list(h))),
            on_failure=lambda f, s: trace.append(("failure", f.hosts, s)))
    except RuntimeError as err:
        return trace, type(err).__name__, sorted(mon.last_beat)
    return trace, out, sorted(mon.last_beat)


@pytest.mark.parametrize("script,max_restarts", [
    ({4: [1], 7: None, 10: [2, 0]}, 3),
    ({2: None, 3: [3], 5: [1], 8: None}, 3),
    ({1: [0]}, 0)])
def test_run_with_recovery_matches_jax(script, max_restarts):
    got = scripted_run(tft, script, num_steps=12, hosts=4,
                       max_restarts=max_restarts)
    want = scripted_run(jft, script, num_steps=12, hosts=4,
                        max_restarts=max_restarts)
    assert got == want


# --- the JAX package's tests of these pieces (tests/test_distributed.py) ---


def test_straggler_detector_flags_persistent_outlier():
    det = StragglerDetector(patience=3)
    flagged = []
    for _ in range(6):
        flagged = det.observe({0: 1.0, 1: 1.0, 2: 1.0, 3: 1.0, 4: 5.0})
    assert 4 in flagged


def test_straggler_detector_uniform_fleet_never_flags():
    det = StragglerDetector(patience=2)
    for _ in range(20):
        assert det.observe({h: 1.0 for h in range(8)}) == []


def test_straggler_detector_recovery_resets_strikes():
    det = StragglerDetector(patience=3)
    fleet = {0: 1.0, 1: 1.0, 2: 1.0, 3: 1.0}
    for _ in range(10):
        assert det.observe({**fleet, 4: 5.0}) == []   # 1 strike
        assert det.observe({**fleet, 4: 1.0}) == []   # recovered: reset
    assert det.strikes[4] == 0


def test_plan_mesh_shrinks_elastically():
    assert plan_mesh_for(512).shape == (2, 16, 16)
    assert plan_mesh_for(256).shape == (16, 16)
    assert plan_mesh_for(240).shape == (15, 16)   # lost a host: data shrinks
    assert plan_mesh_for(8).shape == (8,)


def test_run_with_recovery_restores_after_failure():
    state = {"step": 0, "saved": 0, "failures_left": 1}

    def step_fn(step):
        if step == 3 and state["failures_left"]:
            state["failures_left"] -= 1
            raise WorkerFailure([1])
        state["step"] = step
        return {"step": step}

    def save_fn(step):
        state["saved"] = step

    def restore_fn():
        return state["saved"]

    mon = HeartbeatMonitor(num_hosts=2, timeout=1e9)
    out = run_with_recovery(
        num_steps=6, step_fn=step_fn, save_fn=save_fn,
        restore_fn=restore_fn, monitor=mon, checkpoint_every=2)
    assert out["step"] == 5
    assert state["failures_left"] == 0


def test_run_with_recovery_gives_up_after_max_restarts():
    def step_fn(step):
        raise WorkerFailure([0])

    mon = HeartbeatMonitor(num_hosts=1, timeout=1e9)
    with pytest.raises(WorkerFailure):
        run_with_recovery(
            num_steps=4, step_fn=step_fn, save_fn=lambda s: None,
            restore_fn=lambda: 0, monitor=mon, max_restarts=2)


def test_run_with_recovery_rebuilds_and_stops_monitoring_dead_hosts():
    state = {"failures_left": 1, "rebuilt_with": None}

    def step_fn(step):
        if step == 1 and state["failures_left"]:
            state["failures_left"] -= 1
            raise WorkerFailure([2, 1])
        return {"step": step}

    mon = HeartbeatMonitor(num_hosts=3, timeout=1e9)
    out = run_with_recovery(
        num_steps=3, step_fn=step_fn, save_fn=lambda s: None,
        restore_fn=lambda: 0, monitor=mon,
        rebuild_fn=lambda hosts: state.update(rebuilt_with=hosts))
    assert out["step"] == 2
    assert state["rebuilt_with"] == [1, 2]   # sorted by WorkerFailure
    assert set(mon.last_beat) == {0}


def test_run_with_recovery_checkpoint_cadence():
    saves = []
    mon = HeartbeatMonitor(num_hosts=1, timeout=1e9)
    run_with_recovery(
        num_steps=10, step_fn=lambda s: {"step": s},
        save_fn=saves.append, restore_fn=lambda: 0, monitor=mon,
        checkpoint_every=3)
    assert saves == [3, 6, 9]


def test_run_with_recovery_heartbeat_failure_restarts():
    """A host silent past the timeout fails the check before the step; the
    driver evicts it and goes on with the rest."""
    t = [0.0]
    mon = HeartbeatMonitor(num_hosts=3, timeout=10.0, clock=lambda: t[0])
    ran = []

    def step_fn(step):
        ran.append(step)
        t[0] += 4.0
        for h in (0, 1):
            mon.beat(h)
        return {"step": step}

    out = run_with_recovery(num_steps=5, step_fn=step_fn,
                            save_fn=lambda s: None, restore_fn=lambda: 0,
                            monitor=mon, checkpoint_every=100)
    assert out["step"] == 4
    assert ran == [0, 1, 2, 0, 1, 2, 3, 4]   # host 2 timed out before step 3
    assert set(mon.last_beat) == {0, 1}
