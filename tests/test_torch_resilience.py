"""The port's resilient, data-parallel BNN trainer against the JAX
package's: the fault plan and the loss sentinel on seeded streams, the
error-feedback fold and its report, one data-parallel step of each
compression on a 4-entry CPU mesh against ``make_dp_train_step`` jitted
on 4 of the host devices ``tests/conftest.py`` forces, and a checkpoint
the JAX package wrote restored into the port's driver. Then, on the port
alone, the resilient scenarios, each held to its control.

Tolerances. Fault plan, sentinel, fold and fold report: exact (the same
float64 numpy statistics; the fold sums its rows in XLA's order). The DP
step: loss, accuracy, BN statistics and the gradient norm within rtol
1e-4 / atol 1e-5 (``METRIC_TOL``, as ``test_torch_bnn_train.py``); the
new params within rtol 1e-5 / atol 1e-5 (``PARAM_TOL``; an ulp of the
sign scale moves every element by about an ulp), except a share of the
elements, each of which must trace to a shard whose corrected gradient
(``g + err``) is roundoff, at most ``ROUNDOFF`` of the tree's largest, or,
for int8, lies within the packages' gradient agreement (rtol 1e-4) of a
rounding boundary of the common scale. Adam's first step moves an element
by ``lr * g / (|g| + eps)``, so a roundoff-sized gradient that the two
packages round apart moves it apart by up to 2 lr (PR 22's standing
divergence), and the sign makes it visible: in training BatchNorm a
weight whose input has one sign over a shard's images has a gradient of
0 exactly, to roundoff, and sign-SGD sends that roundoff's sign on at the
full scale. From zero residuals (the run's first step, 4 images a shard)
that is 29% of the params (``FIRST_STEP_SIGN_SHARE``, fc0 almost all);
from a shared nonzero residual state (every later step) the residual
decides those signs and the share is under ``PARAM_SHARE`` for all three.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.checkpoint import manager as jckpt
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import cifar_batch_at as j_batch_at
from repro.train import bnn_trainer as jtrainer
from repro.train import resilience as jres
from repro.train.step import init_opt_state as j_init_opt_state
from repro_torch import tree
from repro_torch.convert import params_from_numpy
from repro_torch.launch.mesh import ServingMesh, make_serving_mesh
from repro_torch.train import bnn_trainer as ttrainer
from repro_torch.train.resilience import (LossSentinel, ResilienceConfig,
                                          TrainFaultPlan, TrainFaultSpec,
                                          _fingerprint, fold_error_feedback,
                                          train_bnn_resilient)
from repro_torch.train.step import init_opt_state

from test_torch_bnn_train import numpy_params
from torch_parity import t

METRIC_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_TOL = dict(rtol=1e-5, atol=1e-5)
ROUNDOFF = 1e-7
GRAD_RTOL = 1e-4
PARAM_SHARE = 5e-3
FIRST_STEP_SIGN_SHARE = 0.35   # measured: 0.289
DP_DEVICES, DP_BATCH = 4, 16


@pytest.fixture(autouse=True)
def _drop_checkpoints(tmp_path):
    """Remove a test's checkpoints when it ends: an 8-shard checkpoint is
    620 MB, and pytest keeps the temporary directories of its last runs."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _cfg(tmp, **kw):
    base = dict(steps=6, batch=2, checkpoint_every=2, eval_batches=0,
                warmup_steps=1, checkpoint_dir=str(tmp))
    base.update(kw)
    return ttrainer.BNNTrainerConfig(**base)


def _identical(a, b) -> bool:
    la, lb = tree.leaves(a), tree.leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def _finite(params) -> bool:
    return all(bool(torch.isfinite(x).all()) for x in tree.leaves(params))


def _kinds(result) -> list:
    return [e["kind"] for e in result.events]


# ------------------------------ fault plan ------------------------------------


def test_fault_plan_matches_jax():
    """Seeded specs and a seeded sequence of step and save queries
    (replays included): the same spec matches in both, and the same
    firings are recorded."""
    rng = np.random.default_rng(0)
    kinds = ("preempt", "nan_batch", "loss_spike", "straggler", "torn_ckpt",
             "device_loss")
    specs = [dict(kind=kinds[int(rng.integers(len(kinds)))],
                  at=int(rng.integers(0, 20)), count=int(rng.integers(1, 4)),
                  host=int(rng.integers(0, 8)), sticky=bool(rng.random() < 0.3))
             for _ in range(12)]
    got = TrainFaultPlan([TrainFaultSpec(**s) for s in specs])
    want = jres.TrainFaultPlan([jres.TrainFaultSpec(**s) for s in specs])
    for _ in range(300):
        step = int(rng.integers(0, 24))
        save = bool(rng.random() < 0.3)
        a = got.match_save(step) if save else got.match(step)
        b = want.match_save(step) if save else want.match(step)
        assert (a is None) == (b is None)
        if a is not None:
            assert dataclass_dict(a) == dataclass_dict(b)
            got.on_fire(step, a)
            want.on_fire(step, b)
    assert got.fired == want.fired and got.fired
    for kind in kinds:
        assert got.steps_of(kind) == want.steps_of(kind)


def dataclass_dict(spec) -> dict:
    return {f: getattr(spec, f) for f in ("kind", "at", "count", "host",
                                          "scale", "sticky", "flavor")}


def test_fault_plan_one_shot_consumption():
    plan = TrainFaultPlan([TrainFaultSpec("nan_batch", at=3)])
    assert plan.match(2) is None
    assert plan.match(3) is not None
    assert plan.match(3) is None        # the replay sees the clean step
    assert plan.steps_of("nan_batch") == [3]


def test_fault_plan_sticky_refires():
    plan = TrainFaultPlan([TrainFaultSpec("nan_batch", at=3, sticky=True)])
    assert plan.match(3) is not None
    assert plan.match(3) is not None


def test_fault_plan_torn_only_matches_saves():
    plan = TrainFaultPlan([TrainFaultSpec("torn_ckpt", at=4)])
    assert plan.match(4) is None
    assert plan.match_save(4) is not None


def test_fault_plan_rejects_unknown_kind_and_flavor():
    with pytest.raises(ValueError, match="unknown train fault kind"):
        TrainFaultSpec("meteor", at=0)
    with pytest.raises(ValueError, match="flavor"):
        TrainFaultSpec("torn_ckpt", at=0, flavor="scorched")
    with pytest.raises(ValueError, match="count"):
        TrainFaultSpec("preempt", at=0, count=0)


# ------------------------------ loss sentinel ---------------------------------


@pytest.mark.parametrize("seed,kw", [
    (0, {}), (1, dict(window=8, z=3.0, min_history=4)),
    (2, dict(window=4, z=2.0, min_history=2, rel_floor=0.01))])
def test_sentinel_matches_jax(seed, kw):
    """A falling noisy loss with NaN, inf and spikes, and gradient norms
    with NaN and inf among them (or None): the same verdicts, events and
    history in both."""
    rng = np.random.default_rng(seed)
    got, want = LossSentinel(**kw), jres.LossSentinel(**kw)
    for step in range(400):
        loss = float(2.5 * np.exp(-step / 150) + 0.1 * rng.normal())
        u = rng.random()
        if u < 0.03:
            loss = float("nan")
        elif u < 0.05:
            loss = float("inf")
        elif u < 0.10:
            loss *= float(rng.uniform(1.5, 40))
        v = rng.random()
        grad_norm = (None if v < 0.2 else float("nan") if v < 0.23
                     else float("-inf") if v < 0.25 else float(rng.uniform(0, 3)))
        assert got.check(step, loss, grad_norm) == want.check(step, loss,
                                                               grad_norm)
    assert list(got._hist) == list(want._hist)
    assert [{k: v for k, v in e.items() if k != "loss"} for e in got.events] \
        == [{k: v for k, v in e.items() if k != "loss"} for e in want.events]
    assert {e["kind"] for e in got.events} == {"nan", "spike"}


def test_sentinel_classifies_nan_and_spike():
    s = LossSentinel(window=8, z=3.0, min_history=4)
    for i, loss in enumerate([2.0, 1.9, 1.85, 1.8, 1.75, 1.7]):
        assert s.check(i, loss) is None
    assert s.check(6, float("nan")) == "nan"
    assert s.check(7, 50.0) == "spike"
    assert [e["kind"] for e in s.events] == ["nan", "spike"]


def test_sentinel_poisoned_loss_never_enters_baseline():
    s = LossSentinel(window=8, z=3.0, min_history=4)
    clean = [2.0, 1.9, 1.85, 1.8]
    for i, loss in enumerate(clean):
        s.check(i, loss)
    s.check(4, 1e9)                     # a spike must not drag the mean up
    assert s.check(5, 1e9) == "spike"   # ... so the same value trips again
    assert list(s._hist) == clean


def test_sentinel_waits_for_min_history():
    s = LossSentinel(window=8, z=3.0, min_history=4)
    assert s.check(0, 100.0) is None    # too little history to judge
    assert s.check(1, 0.1) is None


# ------------------------------ EF folding ------------------------------------


@pytest.fixture(scope="module")
def ef_tree():
    """Residual rows of a wide and a narrow leaf: where ``torch.sum(dim=0)``
    would round apart from XLA's row-by-row sum."""
    rng = np.random.default_rng(7)
    return {"w": (rng.normal(size=(8, 512, 300)) * 1e-3).astype(np.float32),
            "b": {"x": rng.normal(size=(8, 77)).astype(np.float32)}}


@pytest.mark.parametrize("n_old,n_new", [(8, 4), (8, 2), (8, 1), (4, 2),
                                         (4, 8), (4, 4)])
def test_fold_error_feedback_matches_jax(ef_tree, n_old, n_new):
    err = jax.tree.map(lambda e: e[:n_old], ef_tree)
    want, want_report = jres.fold_error_feedback(err, n_new)
    got, got_report = fold_error_feedback(tree.tree_map(t, err), n_new)
    assert got_report == want_report
    for a, b in zip(tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_fold_error_feedback_conserves_mass():
    rng = np.random.default_rng(0)
    err = {"w": t(rng.normal(size=(8, 4, 3)).astype(np.float32)),
           "b": t(rng.normal(size=(8, 5)).astype(np.float32))}
    folded, report = fold_error_feedback(err, 4)
    assert tree.leaves(folded)[0].shape[0] == 4
    assert report["n_old"] == 8 and report["n_new"] == 4
    assert report["max_rel_delta"] <= 1e-5
    for k in err:
        np.testing.assert_allclose(folded[k].sum().item(), err[k].sum().item(),
                                   rtol=1e-5)


def test_fold_error_feedback_grow_pads_zeros():
    folded, report = fold_error_feedback({"w": torch.ones((2, 3))}, 4)
    assert folded["w"].shape == (4, 3)
    assert not folded["w"][2:].any()
    assert report["max_rel_delta"] == 0.0
    with pytest.raises(ValueError, match="n_new"):
        fold_error_feedback({"w": torch.ones((2, 3))}, 0)


# ------------------------------ the DP step -----------------------------------


def _np(x):
    return tree.tree_map(lambda v: v.numpy(), x)


def _traced(c_shards: list, compression: str, treemax: float):
    """Elements of one leaf whose divergence a shard's corrected gradient
    explains: roundoff-sized, or (int8) at a rounding boundary of the
    common scale."""
    c = np.stack(c_shards)
    ok = (np.abs(c) <= ROUNDOFF * treemax).any(0)
    if compression == "int8":
        x = np.abs(c) / (np.abs(c).max() / 127)
        ok |= (np.abs(x - np.floor(x) - 0.5) <= GRAD_RTOL * 127).any(0)
    return ok


def _check_dp_step(compression, state, feed, jstep, step_index, shard_grads,
                   record_property):
    """One DP step of both packages from ``state`` (the port's tensors),
    held as the module docstring says; returns the port's new state."""
    params, opt, err = state
    jp, _, _, jm = jstep(_np(params), _np(opt), _np(err),
                            {k: v.numpy() for k, v in feed.items()})
    cfg = ttrainer.BNNTrainerConfig(steps=10, batch=DP_BATCH, warmup_steps=2)
    step = ttrainer.make_dp_train_step(
        ttrainer._BNNTask(cfg.model_config()), cfg.train_config(),
        make_serving_mesh(DP_DEVICES, device="cpu"),
        grad_compression=compression,
        clip_predicate=ttrainer.bnn_clip_predicate)
    shard_grads.clear()
    tp, topt, terr, tm = step(params, opt, err, feed)
    assert len(shard_grads) == DP_DEVICES

    for key in ("loss", "acc", "grad_norm", "lr_scale"):
        np.testing.assert_allclose(tm[key].item(), float(jm[key]), **METRIC_TOL,
                                   err_msg=key)
    for a, b in zip(tree.leaves(tm["bn_stats"]), jax.tree.leaves(jm["bn_stats"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **METRIC_TOL)

    # Each shard's corrected gradient, as the step computed it.
    corrected = [[(g + e[i]).numpy() for g, e in zip(tree.leaves(grads),
                                                     tree.leaves(err))]
                 for i, grads in enumerate(shard_grads)]
    treemax = max(np.abs(c).max() for cs in corrected for c in cs)
    apart, total = 0, 0
    for j, ((path, a), b) in enumerate(zip(tree.leaves_with_path(tp),
                                           jax.tree.leaves(jp))):
        a, b = a.numpy(), np.asarray(b)
        bad = ~np.isclose(a, b, **PARAM_TOL)
        apart += int(bad.sum())
        total += a.size
        if bad.any():
            traced = _traced([c[j] for c in corrected], compression, treemax)
            assert traced[bad].all(), (path, int((bad & ~traced).sum()))
    share = apart / total
    record_property(f"step{step_index}_param_share_apart", share)
    print(f"{compression} step {step_index}: {apart} of {total} param "
          f"elements apart ({share:.2e})")
    bound = (FIRST_STEP_SIGN_SHARE if compression == "signsgd" and step_index == 0
             else PARAM_SHARE)
    assert share <= bound
    if compression == "none":
        assert terr is err
    return tp, topt, terr


@pytest.mark.parametrize("compression", ttrainer.DP_COMPRESSIONS)
def test_dp_step_matches_jax(compression, monkeypatch, record_property):
    """From zero residuals, then (int8, signsgd) both packages from the
    port's state after that step: params, Adam state and residuals."""
    if jax.device_count() < DP_DEVICES:
        pytest.skip("needs the host devices tests/conftest.py forces")
    kw = dict(steps=10, batch=DP_BATCH, warmup_steps=2)
    jcfg = jtrainer.BNNTrainerConfig(**kw)
    mesh = Mesh(np.asarray(jax.devices()[:DP_DEVICES]), ("data",))
    jstep = jax.jit(jtrainer.make_dp_train_step(
        jtrainer._BNNTask(jcfg.model_config()), jcfg.train_config(), mesh,
        grad_compression=compression,
        clip_predicate=jtrainer.bnn_clip_predicate))
    shard_grads = []
    inner = ttrainer._grads_of

    def recording(task, p, batch):
        out = inner(task, p, batch)
        shard_grads.append(out[2])
        return out

    monkeypatch.setattr(ttrainer, "_grads_of", recording)
    params = params_from_numpy(numpy_params(), device="cpu")
    state = (params, init_opt_state(params),
             ttrainer.init_dp_error_feedback(params, DP_DEVICES))
    steps = 1 if compression == "none" else 2
    for s in range(steps):
        b = j_batch_at(JDataConfig(seed=11, global_batch=DP_BATCH), s)
        feed = {"images": t(b["images"]), "labels": t(b["labels"])}
        state = _check_dp_step(compression, state, feed, jstep, s,
                               shard_grads, record_property)
    assert int(state[1]["adam"]["count"]) == steps


def test_dp_error_feedback_layout_and_compressions():
    params = {"w": torch.ones((3, 2)), "b": [torch.ones(4)]}
    err = ttrainer.init_dp_error_feedback(params, 8)
    assert err["w"].shape == (8, 3, 2) and err["b"][0].shape == (8, 4)
    assert not err["w"].any()
    assert ttrainer.DP_COMPRESSIONS == jtrainer.DP_COMPRESSIONS
    with pytest.raises(ValueError, match="grad_compression"):
        ttrainer.make_dp_train_step(None, None, ServingMesh(("cpu",)),
                                    grad_compression="fp8")


# ------------------------------ resilient driver ------------------------------


@pytest.fixture(scope="module")
def baseline():
    """One uninterrupted single-device ``train_bnn`` run (``_cfg``, 3 steps
    at batch 2) that single-device recoveries are held to."""
    return ttrainer.train_bnn(_cfg(None, steps=3, checkpoint_dir=None),
                              device="cpu")


def test_resilient_requires_checkpoint_dir_and_a_mesh_that_fits(tmp_path):
    with pytest.raises(ValueError, match="checkpoint_dir"):
        train_bnn_resilient(ttrainer.BNNTrainerConfig(steps=2,
                                                      checkpoint_dir=None),
                            device="cpu")
    with pytest.raises(ValueError, match="mesh holds 2"):
        train_bnn_resilient(_cfg(tmp_path), n_devices=4,
                            mesh=make_serving_mesh(2, device="cpu"))
    with pytest.raises(ValueError, match="divisible"):
        train_bnn_resilient(_cfg(tmp_path, batch=6), n_devices=4, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            train_bnn_resilient(_cfg(tmp_path))     # CUDA by default


def test_fault_free_resilient_matches_train_bnn(baseline, tmp_path):
    r = train_bnn_resilient(_cfg(tmp_path, steps=3), device="cpu")
    assert _identical(baseline.params, r.params)
    assert _identical(baseline.opt_state, r.opt_state)
    assert r.history == baseline.history
    assert r.recomputed_steps == 0 and r.events == []
    assert r.device_trajectory == [(0, 1)] and r.n_devices == 1
    assert sorted(r.fingerprints) == [2, 3]
    assert r.fingerprints[3] == _fingerprint(r.params)


def test_torn_checkpoint_falls_back_to_fresh_init(baseline, tmp_path):
    """The only checkpoint (step 2) is corrupt when the preemption at step
    2 comes: the run replays from the init, bit-identical still."""
    plan = TrainFaultPlan([TrainFaultSpec("torn_ckpt", at=2, flavor="corrupt"),
                           TrainFaultSpec("preempt", at=2)])
    r = train_bnn_resilient(_cfg(tmp_path, steps=3), faults=plan,
                            device="cpu")
    assert _identical(baseline.params, r.params)
    assert r.history == baseline.history
    assert r.recomputed_steps == 2
    assert _kinds(r) == ["torn_ckpt", "preempt", "restored_fresh"]


def test_sticky_nan_poison_skips_the_batch(tmp_path):
    plan = TrainFaultPlan([TrainFaultSpec("nan_batch", at=2, sticky=True)])
    r = train_bnn_resilient(
        _cfg(tmp_path, steps=3), faults=plan, device="cpu",
        resilience=ResilienceConfig(max_rollbacks_per_step=2))
    assert r.skipped_steps == [2]
    assert _finite(r.params)
    assert _kinds(r) == ["nan_batch", "sentinel_nan", "nan_batch",
                         "sentinel_nan", "poisoned_window_skipped",
                         "skipped_batch"]
    assert len(r.history["loss"]) == 2               # all but the skip


def test_chaos_on_a_mesh_is_bit_identical_to_its_control(tmp_path):
    """Two shards, sign-SGD, a checkpoint every step: a preemption, a torn
    checkpoint (which sends the next rollback past it) and a NaN batch,
    against the fault-free run: the same params and residuals, every
    restore at a fingerprint of the control's."""
    mesh = make_serving_mesh(2, device="cpu")
    kw = dict(steps=3, checkpoint_every=1)
    control = train_bnn_resilient(_cfg(tmp_path / "control", **kw), mesh=mesh)
    plan = TrainFaultPlan([TrainFaultSpec("preempt", at=1),
                           TrainFaultSpec("torn_ckpt", at=2),
                           TrainFaultSpec("nan_batch", at=2)])
    chaos = train_bnn_resilient(_cfg(tmp_path / "chaos", **kw), mesh=mesh,
                                faults=plan)
    assert _identical(control.params, chaos.params)
    assert _identical(control.err, chaos.err)
    assert chaos.history == control.history and len(chaos.history["loss"]) == 3
    assert _kinds(chaos) == ["preempt", "torn_ckpt", "nan_batch",
                             "sentinel_nan"]
    assert [p["step"] for p in chaos.restore_points] == [1, 1]
    assert all(p["params_sha"] == control.fingerprints[p["step"]]
               for p in chaos.restore_points)
    assert chaos.recomputed_steps == 0 + 1 <= len(plan.fired)
    assert control.events == [] and control.n_devices == 2


def test_device_loss_shrinks_8_to_4_and_folds_ef(tmp_path):
    plan = TrainFaultPlan([TrainFaultSpec("device_loss", at=1, host=5)])
    r = train_bnn_resilient(_cfg(tmp_path, steps=2, batch=8,
                                 checkpoint_every=1),
                            faults=plan, n_devices=8, device="cpu",
                            grad_compression="signsgd")
    assert r.n_devices == 4
    assert r.device_trajectory == [(0, 8), (1, 4)]
    assert tree.leaves(r.err)[0].shape[0] == 4
    assert _kinds(r) == ["device_loss", "elastic_shrink", "ef_folded"]
    shrink, fold = r.events[1], r.events[2]
    assert (shrink["from"], shrink["to"], shrink["survivors"]) == (8, 4, 7)
    assert shrink["plan"] == {"shape": [4], "axes": ["data"]}
    assert (fold["n_old"], fold["n_new"], fold["step"]) == (8, 4, 1)
    assert 0.0 < fold["max_rel_delta"] <= 1e-5       # mass conserved
    assert _finite(r.params) and len(r.history["loss"]) == 2
    for group in ("conv", "fc"):      # the latent clip survives recovery
        for layer in r.params[group]:
            assert float(layer["w"].abs().max()) <= 1.0


def test_straggler_eviction_triggers_shrink(tmp_path):
    """Host 3 of 4 reports 10x step times at steps 0-1; after ``patience``
    strikes the detector evicts it like a dead worker: 4 -> 2."""
    plan = TrainFaultPlan([TrainFaultSpec("straggler", at=0, count=2,
                                          host=3)])
    r = train_bnn_resilient(
        _cfg(tmp_path, steps=2, batch=4, checkpoint_every=1), faults=plan,
        n_devices=4, device="cpu",
        resilience=ResilienceConfig(straggler_patience=2))
    assert r.n_devices == 2
    assert _kinds(r) == ["straggler_evicted", "elastic_shrink", "ef_folded"]
    assert r.events[0] == {"kind": "straggler_evicted", "step": 1,
                           "hosts": [3]}
    assert (r.events[1]["from"], r.events[1]["to"]) == (4, 2)
    assert r.device_trajectory == [(0, 4), (1, 2)]
    assert _finite(r.params) and len(r.history["loss"]) == 2


def test_jax_checkpoint_with_8_ef_rows_restores_on_4(tmp_path):
    """A checkpoint the JAX package wrote (params, Adam state, 8 residual
    rows) restores into the port's driver on a 4-entry mesh: the folded
    rows and the report are the JAX package's, and the restored params
    fingerprint as the JAX package fingerprints them."""
    params = numpy_params(seed=3)
    rng = np.random.default_rng(4)
    err = jax.tree.map(lambda p: rng.standard_normal(
        (8,) + p.shape, dtype=np.float32) * np.float32(1e-3), params)
    jckpt.save(str(tmp_path), 2, {"params": params,
                                  "opt": j_init_opt_state(params), "err": err})
    want_folded, want_report = jres.fold_error_feedback(err, 4)
    want_sha = jres._fingerprint(jax.tree.map(jnp.asarray, params))
    del err

    r = train_bnn_resilient(_cfg(tmp_path, steps=2, batch=4), n_devices=4,
                            device="cpu")
    assert r.events == [{"kind": "ef_folded", "step": 2, **want_report}]
    assert r.restore_points == [{"step": 2, "params_sha": want_sha}]
    assert r.fingerprints == {2: want_sha} and r.history["loss"] == []
    for a, b in zip(tree.leaves(r.params), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a.numpy(), b)
    for a, b in zip(tree.leaves(r.err), jax.tree.leaves(want_folded)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
