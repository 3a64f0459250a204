"""The port's optimizer pieces and train step against the JAX package's
(``repro.optim``, ``repro.train.step``) on the same numpy inputs, and
the toy-task cases of ``tests/test_train.py`` on the port.

Tolerances: ``cosine_schedule`` within 1 float32 ulp (the two ``cos``
may round apart); ``clip_by_global_norm`` rtol 1e-6 (the sums run in
other orders inside each leaf); one ``adamw_update`` on identical
gradients rtol 1e-6 / atol 1e-8 (``sqrt`` and ``pow`` of two libraries).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.bnn import CONV_CHANNELS, FC_SIZES
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.optim.adamw import adamw_init as j_adamw_init
from repro.optim.adamw import adamw_update as j_adamw_update
from repro.optim.clip import clip_by_global_norm as j_clip
from repro.optim.schedules import cosine_schedule as j_cosine
from repro.train.bnn_trainer import bnn_clip_predicate as j_clip_predicate
from repro_torch import tree
from repro_torch.convert import params_from_numpy
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.clip import clip_by_global_norm
from repro_torch.optim.schedules import cosine_schedule
from repro_torch.train.bnn_trainer import bnn_clip_predicate
from repro_torch.train.step import (TrainConfig, _split_microbatches,
                                    init_opt_state, make_decode_step,
                                    make_prefill, make_train_step)

from torch_parity import ulp_distance

OPT_TOL = dict(rtol=1e-6, atol=1e-8)


def bnn_shaped_tree(rng, scale=1.0, width=4):
    """A tree with the BNN params' keys and nesting at narrow widths."""
    def bn(c):
        return {k: (rng.normal(size=c) * scale).astype(np.float32)
                for k in ("gamma", "beta", "mean", "var")}
    return {
        "conv": [{"w": (rng.normal(size=(width, 3, 3, width)) * scale).astype(np.float32),
                  "b": (rng.normal(size=width) * scale).astype(np.float32)}
                 for _ in CONV_CHANNELS[:3]],
        "bn_conv": [bn(width) for _ in CONV_CHANNELS[:3]],
        "fc": [{"w": (rng.normal(size=(width, width)) * scale).astype(np.float32),
                "b": (rng.normal(size=width) * scale).astype(np.float32)}
               for _ in FC_SIZES],
        "bn_fc": [bn(width) for _ in FC_SIZES],
    }


def np_leaves(t):
    return [np.asarray(x) for x in jax.tree.leaves(t)]


def test_leaves_walk_the_jax_order():
    t = bnn_shaped_tree(np.random.default_rng(0))
    want = jax.tree_util.tree_flatten_with_path(t)[0]
    got = list(tree.leaves_with_path(params_from_numpy(t, device="cpu")))
    assert [tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p)
            for p, _ in want] == [p for p, _ in got]
    for (_, w), (_, g) in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), w)
    assert got[0][0] == ("bn_conv", 0, "beta")


@pytest.mark.parametrize("warmup,total", [(10, 200), (4, 100), (1, 3), (10, 20)])
def test_cosine_schedule_matches_jax(warmup, total):
    """Steps 0 to total + 2. Warm-up and the floor past ``total`` are
    equal. In the decay the two ``cos`` of float32 differ by up to 1 ulp
    (XLA's CPU ``cos`` is not correctly rounded: at pi * 0.8 it gives
    -0.80901706 for -0.8090170164), and ``1 + cos`` near cos = -1 turns
    that into up to 2 ulp of the result; so the decay's ``cos`` is held
    within 1 ulp of XLA's, the result within 2 ulp, and the port's op
    order exactly: its result equals the JAX formula, run in numpy
    float32, on the port's own ``cos``."""
    steps = np.arange(0, total + 3)
    want = np.asarray([j_cosine(s, warmup_steps=warmup, total_steps=total)
                       for s in steps], np.float32)
    got = np.asarray([cosine_schedule(int(s), warmup_steps=warmup,
                                      total_steps=total).item()
                      for s in steps], np.float32)
    assert got.dtype == want.dtype
    flat = (steps < warmup) | (steps >= total)
    np.testing.assert_array_equal(got[flat], want[flat])
    assert got[0] == 0.0
    np.testing.assert_array_equal(got[total:], np.float32(0.1))

    t = np.clip((steps.astype(np.float32) - np.float32(warmup))
                / np.float32(max(1.0, total - warmup)), 0, 1).astype(np.float32)
    arg = np.float32(np.pi) * t
    t_cos = torch.cos(torch.from_numpy(arg)).numpy()
    j_cos = np.asarray(jnp.cos(arg))
    assert ulp_distance(t_cos, j_cos).max() <= 1
    formula = (np.float32(0.1) + np.float32(0.45) * (np.float32(1) + t_cos)).astype(np.float32)
    np.testing.assert_array_equal(got[~flat], formula[~flat])
    assert ulp_distance(got, want).max() <= 2


def test_clip_by_global_norm_matches_jax():
    rng = np.random.default_rng(1)
    for scale, max_norm in ((0.01, 5.0), (3.0, 5.0), (1.0, 1.0)):
        g = bnn_shaped_tree(rng, scale)
        want, want_norm = j_clip(g, max_norm)
        got, got_norm = clip_by_global_norm(params_from_numpy(g, device="cpu"),
                                            max_norm)
        np.testing.assert_allclose(got_norm.item(), float(want_norm), rtol=1e-6)
        for a, b in zip(tree.leaves(got), np_leaves(want)):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6)


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
@pytest.mark.parametrize("latent_clip", [False, True])
def test_adamw_update_matches_jax(weight_decay, latent_clip):
    """Two updates (bias corrections at counts 1 and 2), each on the same
    gradients in both packages; latent weights near +-1 so the clip
    bites."""
    rng = np.random.default_rng(2)
    p = bnn_shaped_tree(rng, 0.9)
    kw = dict(lr=3e-3, weight_decay=weight_decay, latent_clip=latent_clip)
    jcfg, tcfg = JAdamWConfig(**kw), AdamWConfig(**kw)
    jp, jstate = p, j_adamw_init(p)
    tp = params_from_numpy(p, device="cpu")
    tstate = adamw_init(tp)
    for lr_scale in (0.5, np.float32(0.8)):
        g = bnn_shaped_tree(rng, 0.1)
        jp, jstate = j_adamw_update(g, jstate, jp, jcfg, lr_scale=lr_scale,
                                    clip_predicate=j_clip_predicate)
        tp, tstate = adamw_update(
            params_from_numpy(g, device="cpu"), tstate, tp, tcfg,
            lr_scale=torch.tensor(lr_scale) if isinstance(lr_scale, np.floating)
            else lr_scale, clip_predicate=bnn_clip_predicate)
    assert tstate["count"].dtype == torch.int32 and int(tstate["count"]) == 2
    for got, want in ((tp, jp), (tstate["mu"], jstate["mu"]),
                      (tstate["nu"], jstate["nu"])):
        for a, b in zip(tree.leaves(got), np_leaves(want)):
            np.testing.assert_allclose(a.numpy(), b, **OPT_TOL)
    clipped = [w for path, w in tree.leaves_with_path(tp) if bnn_clip_predicate(path)]
    assert all(float(w.abs().max()) <= 1.0 for w in clipped) == latent_clip
    if latent_clip:
        # Leaves the predicate skips are never clipped.
        assert max(float(t.abs().max()) for path, t in tree.leaves_with_path(tp)
                   if not bnn_clip_predicate(path)) > 1.0


# ------------- the toy-task cases of tests/test_train.py, on the port -------------


@dataclasses.dataclass(frozen=True)
class _ToyTask:
    """Quadratic ``model.loss``: mean((x @ w - y)^2)."""

    def loss(self, params, batch):
        pred = batch["x"] @ params["w"]
        loss = torch.mean((pred - batch["y"]) ** 2)
        return loss, {"mae": torch.mean(torch.abs(pred - batch["y"]))}


def _toy_setup(batch=8, din=4):
    rng = np.random.default_rng(0)
    params = {"w": torch.from_numpy(rng.normal(size=(din, 1)).astype(np.float32))}
    data = {"x": torch.from_numpy(rng.normal(size=(batch, din)).astype(np.float32)),
            "y": torch.from_numpy(rng.normal(size=(batch, 1)).astype(np.float32))}
    return params, data


def test_first_step_has_nonzero_lr():
    """The schedule takes the post-increment step: ``cosine_schedule(0)``
    is 0.0, so the pre-increment count would make step 1 a no-op."""
    assert float(cosine_schedule(0, warmup_steps=10, total_steps=100)) == 0.0
    params, batch = _toy_setup()
    tcfg = TrainConfig(adamw=AdamWConfig(lr=0.1), warmup_steps=10,
                       total_steps=100)
    new_params, _, metrics = make_train_step(_ToyTask(), tcfg)(
        params, init_opt_state(params), batch)
    assert float(metrics["lr_scale"]) > 0.0
    assert not torch.equal(new_params["w"], params["w"])


def test_warmup_schedule_is_linear_in_post_increment_step():
    params, batch = _toy_setup()
    tcfg = TrainConfig(adamw=AdamWConfig(lr=0.1), warmup_steps=4, total_steps=100)
    step = make_train_step(_ToyTask(), tcfg)
    opt = init_opt_state(params)
    scales = []
    for _ in range(4):
        params, opt, metrics = step(params, opt, batch)
        scales.append(float(metrics["lr_scale"]))
    np.testing.assert_allclose(scales, [0.25, 0.5, 0.75, 1.0], rtol=1e-6)


def test_microbatch_indivisible_batch_raises_actionable():
    params, batch = _toy_setup(batch=6)
    step = make_train_step(_ToyTask(), TrainConfig(microbatches=4))
    with pytest.raises(ValueError, match=r"batch size 6.*microbatches=4"):
        step(params, init_opt_state(params), batch)


def test_microbatch_scalar_leaf_raises_actionable():
    params, batch = _toy_setup(batch=8)
    batch = dict(batch, step=torch.tensor(3))
    step = make_train_step(_ToyTask(), TrainConfig(microbatches=2))
    with pytest.raises(ValueError, match=r"scalar bookkeeping keys"):
        step(params, init_opt_state(params), batch)


def test_microbatch_mismatched_leading_dims_raise():
    batch = {"x": torch.zeros((8, 3)), "y": torch.zeros((4, 1))}
    with pytest.raises(ValueError, match="leading"):
        _split_microbatches(batch, 2)


def test_split_microbatches_shape():
    batch = {"x": torch.zeros((8, 3)), "y": torch.zeros((8, 1))}
    out = _split_microbatches(batch, 4)
    assert out["x"].shape == (4, 2, 3)
    assert out["y"].shape == (4, 2, 1)


def test_model_metrics_ride_along():
    params, batch = _toy_setup()
    _, _, metrics = make_train_step(_ToyTask(), TrainConfig())(
        params, init_opt_state(params), batch)
    assert set(metrics) >= {"mae", "loss", "grad_norm", "lr_scale"}
    assert np.isfinite(float(metrics["mae"]))


def test_microbatch_metrics_average_matches_full_batch():
    """Equal microbatches: the mean of their losses and MAEs is the
    full batch's (within float32 rounding)."""
    params, batch = _toy_setup(batch=8)
    full = make_train_step(_ToyTask(), TrainConfig())
    micro = make_train_step(_ToyTask(), TrainConfig(microbatches=4))
    _, _, m_full = full(params, init_opt_state(params), batch)
    _, _, m_micro = micro(params, init_opt_state(params), batch)
    np.testing.assert_allclose(float(m_micro["loss"]), float(m_full["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m_micro["mae"]), float(m_full["mae"]),
                               rtol=1e-5)


def test_microbatch_step_matches_jax():
    """Accumulation in order from zeros, then the mean: the port's
    microbatched toy step against the JAX package's."""
    from repro.train.step import TrainConfig as JTrainConfig
    from repro.train.step import init_opt_state as j_init_opt_state
    from repro.train.step import make_train_step as j_make_train_step

    class JToy:
        def loss(self, params, batch):
            pred = batch["x"] @ params["w"]
            return (jnp.mean((pred - batch["y"]) ** 2),
                    {"mae": jnp.mean(jnp.abs(pred - batch["y"]))})

    params, batch = _toy_setup(batch=8)
    jparams = {k: v.numpy() for k, v in params.items()}
    jbatch = {k: v.numpy() for k, v in batch.items()}
    kw = dict(microbatches=4, warmup_steps=2, total_steps=10)
    jp, _, jm = j_make_train_step(JToy(), JTrainConfig(**kw))(
        jparams, j_init_opt_state(jparams), jbatch)
    tp, _, tm = make_train_step(_ToyTask(), TrainConfig(**kw))(
        params, init_opt_state(params), batch)
    for key in ("loss", "mae", "grad_norm", "lr_scale"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-6)
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]), **OPT_TOL)


def test_prefill_and_decode_wrappers_call_the_model():
    calls = []

    class Stub:
        def prefill(self, params, state, batch):
            calls.append(("prefill", params, state, batch))
            return "logits", state

        def decode_step(self, params, state, batch):
            calls.append(("decode", params, state, batch))
            return "next", state

    assert make_prefill(Stub())("p", "s", "b") == ("logits", "s")
    assert make_decode_step(Stub())("p", "s", "b") == ("next", "s")
    assert calls == [("prefill", "p", "s", "b"), ("decode", "p", "s", "b")]
