"""Chaos-hardened elastic BNN training, as ``repro.train.resilience``.

The training half of fault tolerance: the machinery of
``distributed.fault_tolerance`` (``HeartbeatMonitor``,
``StragglerDetector``, ``run_with_recovery``, ``plan_mesh_for``) wired
into the BNN trainer, so a long STE run survives an injected fault and
loses nothing.

* :func:`train_bnn_resilient`, the driver. It runs ``train_bnn``'s exact
  step on one device and ``make_dp_train_step`` on a mesh of several
  (``launch.mesh.ServingMesh``, repeats of one card allowed) under
  ``run_with_recovery``: heartbeats each step, straggler eviction, a
  checkpoint every ``cfg.checkpoint_every`` steps of params, Adam state
  and the per-shard error-feedback residuals, and on any failure a
  restore from the latest *valid* checkpoint. Batch ``i`` is a function
  of ``(data_seed, i)`` alone (``data.pipeline.cifar_batch_at``), so a
  replayed step recomputes the same update, and a recovered run's params
  equal an uninterrupted run's bit for bit.
* **Elastic shrink.** On a ``WorkerFailure`` (a lost device, an evicted
  straggler) the mesh shrinks to the largest power of two of survivors
  (``serving_shrink_plan``; powers of two keep the batch divisible), the
  first survivors in mesh order, as ``shrink_serving_mesh`` keeps them,
  and the run restores from its checkpoint. The dead shards'
  error-feedback residuals fold into survivor 0
  (:func:`fold_error_feedback`), the conservation checked in float64.
* :class:`LossSentinel`: NaN/inf and z-score spikes of the loss, and a
  non-finite gradient norm. A trip raises :class:`SentinelRollback`: the
  poisoned update is dropped and the run replays from the last valid
  checkpoint. A step that trips ``max_rollbacks_per_step`` times has its
  batch skipped, and the skip is recorded.
* :class:`TrainFaultPlan`: deterministic faults keyed on step indices
  (``preempt``, ``device_loss``, ``nan_batch``, ``loss_spike``,
  ``straggler``, ``torn_ckpt``), one-shot unless ``sticky``; every
  firing lands in ``plan.fired``.

The sentinel's and the detector's statistics are the JAX package's float64
numpy ones, and the fold sums its rows in the JAX package's order, so on
the same streams both packages take the same decisions and fold to the
same bits.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from collections import deque
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch import tree
from repro_torch.checkpoint import manager as ckpt_manager
from repro_torch.core.bnn import init_bnn_params, update_bn_stats
from repro_torch.data.pipeline import DataConfig, cifar_batch_at
from repro_torch.distributed.fault_tolerance import (
    HeartbeatMonitor, Preemption, StragglerDetector, WorkerFailure,
    plan_mesh_for, run_with_recovery, serving_shrink_plan)
from repro_torch.launch.mesh import ServingMesh, make_serving_mesh
from repro_torch.train.bnn_trainer import (BNNTrainerConfig, _BNNTask,
                                           bnn_clip_predicate, evaluate_bnn,
                                           init_dp_error_feedback,
                                           make_dp_train_step)
from repro_torch.train.step import init_opt_state, make_train_step

__all__ = [
    "TRAIN_FAULT_KINDS",
    "TrainFaultSpec",
    "TrainFaultPlan",
    "LossSentinel",
    "SentinelRollback",
    "ResilienceConfig",
    "ResilientTrainResult",
    "fold_error_feedback",
    "train_bnn_resilient",
]


# ---------------------------------------------------------------------------
# deterministic fault injection (serve/faults.py::FaultPlan, step-keyed)
# ---------------------------------------------------------------------------

TRAIN_FAULT_KINDS = (
    "preempt",       # simulated process kill before executing the step
    "device_loss",   # WorkerFailure([host]) -> elastic shrink
    "nan_batch",     # the step's batch is poisoned to all-NaN images
    "loss_spike",    # the step's images are scaled by `scale`
    "straggler",     # host `host` reports 10x step times for `count` steps
    "torn_ckpt",     # the checkpoint written at step `at` is corrupted
)

_TORN_FLAVORS = ("torn", "corrupt")


@dataclasses.dataclass(frozen=True)
class TrainFaultSpec:
    """One scheduled training fault, pinned to an exact step index.

    Step-time faults fire on ``at <= step < at + count``; ``torn_ckpt``
    fires on the checkpoint *written at* step ``at`` (``flavor="torn"``
    deletes the MANIFEST, a crash mid-write; ``"corrupt"`` appends junk to
    the shard, bit rot the checksum catches). A ``sticky`` fault fires
    again when its step is replayed after a rollback; by default a fault
    is transient and the replay sees clean data.
    """

    kind: str
    at: int
    count: int = 1
    host: int = 0
    scale: float = 64.0
    sticky: bool = False
    flavor: str = "torn"

    def __post_init__(self):
        if self.kind not in TRAIN_FAULT_KINDS:
            raise ValueError(f"unknown train fault kind {self.kind!r}; "
                             f"expected one of {TRAIN_FAULT_KINDS}")
        if self.flavor not in _TORN_FLAVORS:
            raise ValueError(f"unknown torn_ckpt flavor {self.flavor!r}; "
                             f"expected one of {_TORN_FLAVORS}")
        if self.at < 0 or self.count < 1:
            raise ValueError("need at >= 0 and count >= 1")


class TrainFaultPlan:
    """A deterministic schedule of :class:`TrainFaultSpec` entries.

    ``match(step)`` returns the first step-time spec covering ``step``
    that has not fired there yet (a non-``sticky`` (spec, step) pair fires
    at most once, so a rollback replay sees the clean step);
    ``match_save(step)`` the same for ``torn_ckpt`` specs, keyed on the
    save step. Every firing is appended to ``fired``.
    """

    def __init__(self, specs: Sequence[TrainFaultSpec] = ()):
        self.specs = tuple(specs)
        self.fired: list[dict] = []
        self._consumed: set[tuple[int, int]] = set()

    def _match(self, step: int, *, save: bool) -> Optional[TrainFaultSpec]:
        for j, spec in enumerate(self.specs):
            if (spec.kind == "torn_ckpt") != save:
                continue
            if not spec.at <= step < spec.at + spec.count:
                continue
            key = (j, step)
            if not spec.sticky and key in self._consumed:
                continue
            self._consumed.add(key)
            return spec
        return None

    def match(self, step: int) -> Optional[TrainFaultSpec]:
        return self._match(step, save=False)

    def match_save(self, step: int) -> Optional[TrainFaultSpec]:
        return self._match(step, save=True)

    def on_fire(self, step: int, spec: TrainFaultSpec) -> None:
        self.fired.append({"step": step, "kind": spec.kind,
                           "host": spec.host})

    def steps_of(self, kind: str) -> list[int]:
        """Every step index a spec of ``kind`` is scheduled to fire at."""
        return sorted(
            s for spec in self.specs if spec.kind == kind
            for s in range(spec.at, spec.at + spec.count))


# ---------------------------------------------------------------------------
# loss sentinel
# ---------------------------------------------------------------------------


class SentinelRollback(WorkerFailure):
    """The :class:`LossSentinel` tripped: the update just applied is
    poisoned (NaN/inf or a loss spike) and rolls back to the last valid
    checkpoint. No device died, so ``hosts`` is empty and
    ``run_with_recovery`` takes the plain restore path."""

    def __init__(self, step: int, verdict: str):
        RuntimeError.__init__(
            self, f"loss sentinel tripped at step {step}: {verdict}")
        self.hosts: list[int] = []
        self.step = step
        self.verdict = verdict


class LossSentinel:
    """NaN/inf and z-score loss-spike detection on the metrics stream.

    ``check(step, loss, grad_norm)`` returns ``"nan"`` for a non-finite
    loss or gradient norm, ``"spike"`` when ``loss > mean + z *
    max(std, rel_floor * |mean|, 1e-3)`` over the trailing ``window`` of
    accepted losses (once ``min_history`` are in), else None. Only a clean
    loss joins the history, so a poisoned step cannot drag the baseline
    toward itself. Every trip is recorded in ``events``.
    """

    def __init__(self, *, window: int = 16, z: float = 8.0,
                 min_history: int = 4, rel_floor: float = 0.05):
        self.window = int(window)
        self.z = float(z)
        self.min_history = int(min_history)
        self.rel_floor = float(rel_floor)
        self._hist: deque = deque(maxlen=self.window)
        self.events: list[dict] = []

    def check(self, step: int, loss: float,
              grad_norm: Optional[float] = None) -> Optional[str]:
        verdict = None
        if not np.isfinite(loss):
            verdict = "nan"
        elif grad_norm is not None and not np.isfinite(grad_norm):
            # The loss alone is blind here: the BNN's sign maps NaN
            # activations to -1, so a NaN batch gives a finite loss (~log C)
            # while the backward pass is NaN. The gradient norm sees it.
            verdict = "nan"
        elif len(self._hist) >= self.min_history:
            vals = np.asarray(self._hist, dtype=np.float64)
            mu = float(vals.mean())
            sd = float(vals.std())
            floor = max(sd, self.rel_floor * abs(mu), 1e-3)
            if loss > mu + self.z * floor:
                verdict = "spike"
        if verdict is not None:
            self.events.append({
                "step": int(step), "kind": verdict, "loss": float(loss),
                "grad_norm": None if grad_norm is None else float(grad_norm),
            })
            return verdict
        self._hist.append(float(loss))
        return None


# ---------------------------------------------------------------------------
# error-feedback folding across an elastic resize
# ---------------------------------------------------------------------------


def _fold_rows(e: torch.Tensor, n_new: int) -> torch.Tensor:
    # The dead rows one after another, in row order, then into row 0: the
    # order XLA sums the JAX package's ``jnp.sum(e[n_new:], axis=0)`` in.
    # ``torch.sum(dim=0)`` pairs them otherwise and rounds apart.
    dead = e[n_new]
    for j in range(n_new + 1, e.shape[0]):
        dead = dead + e[j]
    return torch.cat([(e[0] + dead)[None], e[1:n_new]])


def fold_error_feedback(err, n_new: int):
    """Resize a stacked ``[n_old, ...]`` error-feedback residual tree to
    ``n_new`` shards, conserving the residual mass.

    Shrink: the dead shards' rows (``n_new:``) are summed and folded into
    survivor 0, so the quantization error they were still owed re-enters
    the reduce through the survivor's next round. Grow: new shards start
    with zero residual.

    Returns ``(folded, report)``; ``report`` checks conservation in
    float64: each leaf's ``|sum(folded) - sum(err)|`` and the largest
    relative to the leaf's L1 mass (only the float32 rounding of the fold
    itself moves it).
    """
    err = tree.tree_map(torch.as_tensor, err)
    leaves = tree.leaves(err)
    n_old = int(leaves[0].shape[0]) if leaves else int(n_new)
    if n_new < 1:
        raise ValueError(f"n_new must be >= 1, got {n_new}")

    if n_old == n_new:
        folded = err
    elif n_new > n_old:
        folded = tree.tree_map(
            lambda e: torch.cat(
                [e, e.new_zeros((n_new - n_old,) + tuple(e.shape[1:]))]), err)
    else:
        folded = tree.tree_map(lambda e: _fold_rows(e, n_new), err)

    max_abs = 0.0
    max_rel = 0.0
    mass_l1 = 0.0
    for old_leaf, new_leaf in zip(tree.leaves(err), tree.leaves(folded)):
        old64 = old_leaf.detach().cpu().numpy().astype(np.float64)
        new64 = new_leaf.detach().cpu().numpy().astype(np.float64)
        delta = abs(float(new64.sum()) - float(old64.sum()))
        l1 = float(np.abs(old64).sum())
        mass_l1 += l1
        max_abs = max(max_abs, delta)
        max_rel = max(max_rel, delta / max(l1, 1e-12))
    report = {
        "n_old": n_old,
        "n_new": int(n_new),
        "mass_l1": mass_l1,
        "max_abs_delta": max_abs,
        "max_rel_delta": max_rel,
    }
    return folded, report


def _fingerprint(params) -> str:
    """sha256 over the tree's path-joined leaf keys and raw bytes, as the
    JAX package's: the bit-identity currency of the chaos gates (two runs
    agree iff every leaf is bit-for-bit equal), equal across packages for
    bit-equal params."""
    h = hashlib.sha256()
    for path, leaf in tree.leaves_with_path(params):
        h.update(ckpt_manager._key(path).encode())
        h.update(leaf.detach().cpu().numpy().tobytes())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# the resilient driver
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    max_restarts: int = 16
    keep_checkpoints: int = 8
    sentinel_window: int = 16
    sentinel_z: float = 8.0
    sentinel_min_history: int = 4
    # a step that trips the sentinel this many times is a sticky poison:
    # skip its batch (recorded) instead of rolling back forever
    max_rollbacks_per_step: int = 2
    straggler_z: float = 3.0
    straggler_patience: int = 3
    heartbeat_timeout_s: float = 3600.0
    ef_conservation_rtol: float = 1e-5


@dataclasses.dataclass
class ResilientTrainResult:
    params: Any
    opt_state: Any
    err: Any                    # EF residual tree, [n_devices, ...] leaves
    history: dict               # {"loss": [...], "acc": [...], "lr_scale": [...]}
    events: list                # faults, rollbacks, shrinks, folds, skips
    fingerprints: dict          # checkpoint step -> params sha256
    restore_points: list        # [{"step", "params_sha"}] per restore
    recomputed_steps: int       # replayed work across all recoveries
    device_trajectory: list     # [(step, n_devices)] incl. the start
    n_devices: int              # final mesh size
    skipped_steps: list         # sticky-poison batches dropped
    eval_loss: Optional[float]
    eval_acc: Optional[float]


def _run_mesh(n_devices: Optional[int], mesh: Optional[ServingMesh],
              device) -> ServingMesh:
    """The run's starting mesh: the first ``n_devices`` of ``mesh`` (all
    of it by default), else ``make_serving_mesh(n_devices)`` (1 device by
    default) of ``device``'s kind."""
    if mesh is None:
        n = 1 if n_devices is None else int(n_devices)
        if n < 1:
            raise ValueError(f"n_devices must be >= 1, got {n}")
        return make_serving_mesh(n, device=device)
    n = len(mesh) if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"n_devices must be >= 1, got {n}")
    if n > len(mesh):
        raise ValueError(f"n_devices={n} but the mesh holds {len(mesh)} "
                         "devices")
    return ServingMesh(mesh.devices[:n])


def train_bnn_resilient(
    cfg: BNNTrainerConfig,
    *,
    resilience: ResilienceConfig = ResilienceConfig(),
    faults: Optional[TrainFaultPlan] = None,
    n_devices: Optional[int] = None,
    mesh: Optional[ServingMesh] = None,
    grad_compression: str = "signsgd",
    verbose: bool = False,
    device=None,
) -> ResilientTrainResult:
    """Train the CIFAR BNN under ``run_with_recovery``: heartbeat checks
    and straggler eviction each step, a checkpoint every
    ``cfg.checkpoint_every`` steps (params + Adam state + EF residuals),
    the loss sentinel with rollback, and the elastic shrink on a device
    loss.

    The mesh is ``mesh`` (its first ``n_devices``, all by default), else
    ``launch.mesh.make_serving_mesh(n_devices)`` on ``device`` (CUDA
    unless given; it raises when fewer cards are visible; on the CPU,
    ``cpu:0 .. cpu:n-1``); ``n_devices`` defaults to 1. Params, optimizer
    state and residuals live on the mesh's first device. One device runs
    ``train_bnn``'s exact step, so a fault-free resilient run is
    bit-identical to ``train_bnn``; several run ``make_dp_train_step``
    with ``grad_compression``. A fresh process pointed at the same
    ``checkpoint_dir`` resumes from its latest valid checkpoint.
    """
    if not cfg.checkpoint_dir:
        raise ValueError(
            "train_bnn_resilient needs cfg.checkpoint_dir: rollback and "
            "preemption recovery restore from checkpoints, so a run "
            "without a checkpoint directory cannot be made resilient")
    mesh0 = _run_mesh(n_devices, mesh, device)
    n_devices = len(mesh0)
    if cfg.batch % n_devices:
        raise ValueError(f"global batch {cfg.batch} is not divisible by "
                         f"n_devices={n_devices}")

    task = _BNNTask(cfg.model_config())
    tcfg = cfg.train_config()
    data_cfg = DataConfig(seed=cfg.data_seed, global_batch=cfg.batch)
    cadence = max(1, int(cfg.checkpoint_every))

    sentinel = LossSentinel(
        window=resilience.sentinel_window, z=resilience.sentinel_z,
        min_history=resilience.sentinel_min_history)
    detector = StragglerDetector(z=resilience.straggler_z,
                                 patience=resilience.straggler_patience)
    monitor = HeartbeatMonitor(num_hosts=n_devices,
                               timeout=resilience.heartbeat_timeout_s)

    def fresh_state(n: int) -> dict:
        params = init_bnn_params(cfg.seed, device=mesh0.devices[0])
        return {"params": params, "opt": init_opt_state(params),
                "err": init_dp_error_feedback(params, n)}

    st = {
        "state": fresh_state(n_devices),
        "live": list(range(n_devices)),
        "n": n_devices,
        "mesh": mesh0,
        "fail_step": None,
        "rollbacks_at": {},
    }
    history: dict[int, dict] = {}
    events: list[dict] = []
    fingerprints: dict[int, str] = {}
    restore_points: list[dict] = []
    skip_steps: set[int] = set()
    device_trajectory: list[tuple[int, int]] = [(0, n_devices)]
    recomputed = {"steps": 0}

    def step_fn(step: int) -> dict:
        spec = faults.match(step) if faults is not None else None
        if spec is not None and spec.kind == "preempt":
            faults.on_fire(step, spec)
            events.append({"kind": "preempt", "step": step})
            raise Preemption(step)
        if spec is not None and spec.kind == "device_loss":
            faults.on_fire(step, spec)
            events.append({"kind": "device_loss", "step": step,
                           "host": spec.host})
            raise WorkerFailure([spec.host])

        if step in skip_steps:
            events.append({"kind": "skipped_batch", "step": step})
            return {"skipped": True, "step": step}

        home = st["mesh"].devices[0]
        batch = cifar_batch_at(data_cfg, step)
        feed = {"images": batch["images"].to(home),
                "labels": batch["labels"].to(home)}
        if spec is not None and spec.kind == "nan_batch":
            faults.on_fire(step, spec)
            events.append({"kind": "nan_batch", "step": step})
            feed["images"] = torch.full_like(feed["images"], float("nan"))
        elif spec is not None and spec.kind == "loss_spike":
            faults.on_fire(step, spec)
            events.append({"kind": "loss_spike", "step": step,
                           "scale": spec.scale})
            # BatchNorm absorbs a pure image rescale exactly (the conv is
            # linear and normalizes with the poisoned batch's own
            # statistics), so the poison that moves the loss is mislabeled
            # signal: every label rotated half the class circle. The
            # rescale rides along as a corruption artifact.
            half = data_cfg.num_classes // 2
            feed["images"] = feed["images"] * spec.scale
            feed["labels"] = (feed["labels"] + half) % data_cfg.num_classes

        state = st["state"]
        if st["n"] == 1:
            step_call = make_train_step(task, tcfg,
                                        clip_predicate=bnn_clip_predicate)
            params, opt, metrics = step_call(state["params"], state["opt"],
                                             feed)
            err = state["err"]
        else:
            step_call = make_dp_train_step(
                task, tcfg, st["mesh"], grad_compression=grad_compression,
                clip_predicate=bnn_clip_predicate)
            params, opt, err, metrics = step_call(
                state["params"], state["opt"], state["err"], feed)
        params = update_bn_stats(params, metrics.pop("bn_stats"),
                                 momentum=cfg.bn_momentum)
        st["state"] = {"params": params, "opt": opt, "err": err}
        loss = float(metrics["loss"])

        # Straggler eviction: each live host reports a step time; an
        # injected straggler reports 10x until the detector's patience runs
        # out, then it is evicted like a dead worker. One process drives
        # every host, so the wall clock carries no per-host signal (and its
        # noise can exceed the detector's 5% band for the whole fleet at
        # once): healthy hosts report a unit time, the detector's contract
        # being relative per-host times.
        times = {h: 1.0 for h in st["live"]}
        if spec is not None and spec.kind == "straggler":
            faults.on_fire(step, spec)
            times[spec.host] = 10.0
        flagged = detector.observe(times)
        if flagged:
            events.append({"kind": "straggler_evicted", "step": step,
                           "hosts": sorted(flagged)})
            raise WorkerFailure(flagged)

        for h in st["live"]:
            monitor.beat(h)

        verdict = sentinel.check(step, loss,
                                 grad_norm=float(metrics["grad_norm"]))
        if verdict is not None:
            count = st["rollbacks_at"].get(step, 0) + 1
            st["rollbacks_at"][step] = count
            events.append({"kind": f"sentinel_{verdict}", "step": step,
                           "loss": loss, "rollback": count})
            if count >= resilience.max_rollbacks_per_step:
                skip_steps.add(step)
                events.append({"kind": "poisoned_window_skipped",
                               "step": step})
            raise SentinelRollback(step, verdict)

        history[step] = {"loss": loss, "acc": float(metrics["acc"]),
                         "lr_scale": float(metrics["lr_scale"])}
        if verbose and (step % cfg.log_every == 0 or step == cfg.steps - 1):
            print(f"step {step:4d} loss {loss:.4f} "
                  f"acc {history[step]['acc']:.3f} n_dev {st['n']}")
        return {"loss": loss, "step": step}

    def save_fn(step: int) -> None:
        # Behind the sentinel: a poisoned update that kept loss and
        # grad_norm finite must still never reach disk, or every later
        # rollback would restore the poison itself.
        bad = [ckpt_manager._key(path)
               for path, leaf in tree.leaves_with_path(st["state"]["params"])
               if not bool(torch.isfinite(leaf).all())]
        if bad:
            events.append({"kind": "poisoned_checkpoint_averted",
                           "step": step, "leaves": bad[:8]})
            raise SentinelRollback(step, "nonfinite_params")
        fingerprints[step] = _fingerprint(st["state"]["params"])
        path = ckpt_manager.save(cfg.checkpoint_dir, step, st["state"])
        spec = faults.match_save(step) if faults is not None else None
        if spec is not None:
            faults.on_fire(step, spec)
            events.append({"kind": "torn_ckpt", "step": step,
                           "flavor": spec.flavor})
            if spec.flavor == "torn":
                os.remove(os.path.join(path, "MANIFEST.json"))
            else:
                with open(os.path.join(path, "shard_00000.npz"), "ab") as f:
                    f.write(b"\x00corruption")
        ckpt_manager.retain(cfg.checkpoint_dir,
                            keep=resilience.keep_checkpoints)

    def restore_fn() -> int:
        home = st["mesh"].devices[0]
        latest = ckpt_manager.latest_valid_step(cfg.checkpoint_dir)
        if latest is None:
            st["state"] = tree.tree_map(lambda t: t.to(home),
                                        fresh_state(st["n"]))
            restored = 0
            if st["fail_step"] is not None:
                events.append({"kind": "restored_fresh", "step": 0})
        else:
            loaded = ckpt_manager.restore(cfg.checkpoint_dir, latest,
                                          st["state"])
            loaded = tree.tree_map(lambda t: t.to(home), loaded)
            err = loaded["err"]
            n_saved = int(tree.leaves(err)[0].shape[0])
            if n_saved != st["n"]:
                err, report = fold_error_feedback(err, st["n"])
                if report["max_rel_delta"] > resilience.ef_conservation_rtol:
                    raise RuntimeError(
                        f"error-feedback mass NOT conserved folding "
                        f"{n_saved} -> {st['n']} shards: relative delta "
                        f"{report['max_rel_delta']:.3e} exceeds "
                        f"{resilience.ef_conservation_rtol:.1e} "
                        f"(report: {report})")
                events.append({"kind": "ef_folded", "step": latest,
                               **report})
            st["state"] = {"params": loaded["params"], "opt": loaded["opt"],
                           "err": err}
            restored = latest
            restore_points.append({
                "step": latest,
                "params_sha": _fingerprint(loaded["params"]),
            })
        if st["fail_step"] is not None:
            recomputed["steps"] += max(0, st["fail_step"] - restored)
            st["fail_step"] = None
        for s in [s for s in history if s >= restored]:
            del history[s]
        return restored

    def on_failure(failure: WorkerFailure, step: int) -> None:
        st["fail_step"] = step

    def rebuild_fn(dead_hosts: Sequence[int]) -> None:
        if not dead_hosts:
            return  # preemption / sentinel rollback: no mesh change
        st["live"] = [h for h in st["live"] if h not in set(dead_hosts)]
        if not st["live"]:
            raise RuntimeError("no surviving devices to rebuild a mesh")
        n_new = serving_shrink_plan(len(st["live"]))
        plan = plan_mesh_for(n_new)
        n_new = plan.num_devices
        if cfg.batch % n_new:
            raise RuntimeError(
                f"cannot shrink to {n_new} devices: global batch "
                f"{cfg.batch} is not divisible")
        events.append({"kind": "elastic_shrink", "step": st["fail_step"],
                       "from": st["n"], "to": n_new,
                       "survivors": len(st["live"]),
                       "plan": {"shape": list(plan.shape),
                                "axes": list(plan.axes)}})
        st["n"] = n_new
        # The first survivors in mesh order, as shrink_serving_mesh keeps.
        st["mesh"] = ServingMesh(
            tuple(mesh0.devices[h] for h in st["live"])[:n_new])

    run_with_recovery(
        num_steps=cfg.steps,
        step_fn=step_fn,
        save_fn=save_fn,
        restore_fn=restore_fn,
        monitor=monitor,
        rebuild_fn=rebuild_fn,
        checkpoint_every=cadence,
        max_restarts=resilience.max_restarts,
        on_failure=on_failure,
    )  # per-step metrics live in `history`
    if cfg.steps % cadence != 0:
        save_fn(cfg.steps)
    else:
        fingerprints.setdefault(cfg.steps,
                                _fingerprint(st["state"]["params"]))
    for step, n in [(e["step"], e["to"]) for e in events
                    if e["kind"] == "elastic_shrink"]:
        device_trajectory.append((step, n))

    eval_loss = eval_acc = None
    if cfg.eval_batches > 0:
        eval_iter = (cifar_batch_at(data_cfg, s)
                     for s in range(cfg.steps, cfg.steps + cfg.eval_batches))
        eval_loss, eval_acc = evaluate_bnn(
            st["state"]["params"], eval_iter, batches=cfg.eval_batches,
            use_scale=cfg.use_scale)

    ordered = sorted(history)
    return ResilientTrainResult(
        params=st["state"]["params"],
        opt_state=st["state"]["opt"],
        err=st["state"]["err"],
        history={key: [history[s][key] for s in ordered]
                 for key in ("loss", "acc", "lr_scale")},
        events=events,
        fingerprints=fingerprints,
        restore_points=restore_points,
        recomputed_steps=recomputed["steps"],
        device_trajectory=device_trajectory,
        n_devices=st["n"],
        skipped_steps=sorted(skip_steps),
        eval_loss=eval_loss,
        eval_acc=eval_acc,
    )
