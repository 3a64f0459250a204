"""The train half of the BNN against the JAX package's, at full width and
batch 4, on numpy-drawn params and a synthetic-CIFAR batch: the STE
training loss and its gradients, the BN running-statistics update, one
whole train step and a 3-step ``train_bnn``; then, on the port alone,
resume and the export (``pack_trained_params``).

Tolerances. ``bnn_train_loss``: loss and BN batch variances rtol 1e-5,
accuracy equal, batch means within ``MEAN_TOL`` of the rms of the values
they average (float32 sums in other orders); gradients against ``jax.grad``
rtol 1e-4 / atol 1e-5 (the bounds of ``test_torch_binarize_grad.py``).
``update_bn_stats``: exact (the same elementwise ops). One train step:
metrics as above, params rtol 1e-4 / atol 1e-5 but where both gradients
are roundoff (``ROUNDOFF``), on at most ``ADAM_ROUNDOFF_SHARE`` of the
elements: Adam's first step moves an element by ``lr * g / (|g| +
eps)``, so a roundoff-sized gradient whose sign or size differs between
the packages moves a weight apart by up to ``2 * lr``. ``train_bnn``:
``lr_scale`` within 1 ulp, losses within 1e-3.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bnn as jbnn
from repro.core.binarize import QuantMode as JQuantMode
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import cifar_batch_at as j_batch_at
from repro.train import bnn_trainer as jtrainer
from repro.train.step import init_opt_state as j_init_opt_state
from repro.train.step import make_train_step as j_make_train_step
from repro_torch import tree
from repro_torch.checkpoint import manager as ckpt_manager
from repro_torch.convert import params_from_numpy
from repro_torch.core import bnn as tbnn
from repro_torch.core.binarize import QuantMode
from repro_torch.train import bnn_trainer as ttrainer
from repro_torch.train.step import init_opt_state, make_train_step

from torch_parity import CKPT, ulp_distance

LOSS_TOL = dict(rtol=1e-5)
# A float32 sum of n terms may be off by n * 2^-24 of their magnitude
# (2.4e-4 at the first conv's n = 4096); measured: 1.4e-5.
MEAN_TOL = 1e-4
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
# A gradient below this share of the tree's largest is roundoff: Adam
# may move its element either way. At most this share of the elements
# may end a step apart. Measured: 21,059 of 14,041,266 (1.5e-3) against
# the jitted JAX step, 8,619 against the eager one, most of them fc0
# weights whose input is one sign over the 4 images (1/8 of the inputs):
# training BatchNorm makes their gradient 0 exactly, and one package sums
# it to 0 where the other gets ~1e-10.
ROUNDOFF = 1e-7
ADAM_ROUNDOFF_SHARE = 5e-3
BATCH = 4


def numpy_params(seed: int = 0, margin: float = 0.0) -> dict:
    """Full-width BNN latents from numpy: weights at the init's scale,
    biases and BN buffers away from their init values. ``margin`` draws
    every latent weight instead with a magnitude uniform in [margin,
    1 - margin], so no weight changes sign in steps of less than
    ``margin`` in all."""
    rng = np.random.default_rng(seed)
    f32 = np.float32

    def latent(shape, std):
        w = rng.normal(size=shape) * std
        if margin:
            w = np.sign(w) * rng.uniform(margin, 1 - margin, size=shape)
        return w.astype(f32)

    def bn(c):
        return {"gamma": (1 + 0.1 * rng.normal(size=c)).astype(f32),
                "beta": (0.1 * rng.normal(size=c)).astype(f32),
                "mean": (0.1 * rng.normal(size=c)).astype(f32),
                "var": (1 + 0.1 * np.abs(rng.normal(size=c))).astype(f32)}

    p = {"conv": [], "bn_conv": [], "fc": [], "bn_fc": []}
    for cin, cout in jbnn.CONV_CHANNELS:
        p["conv"].append({"w": latent((cout, 3, 3, cin), (2.0 / (9 * cin)) ** 0.5),
                          "b": (0.01 * rng.normal(size=cout)).astype(f32)})
        p["bn_conv"].append(bn(cout))
    for fin, fout in jbnn.FC_SIZES:
        p["fc"].append({"w": latent((fout, fin), (2.0 / fin) ** 0.5),
                        "b": (0.01 * rng.normal(size=fout)).astype(f32)})
        p["bn_fc"].append(bn(fout))
    return p


@pytest.fixture(scope="module")
def setup():
    params = numpy_params()
    b = j_batch_at(JDataConfig(seed=11, global_batch=BATCH), 0)
    images, labels = np.asarray(b["images"]), np.asarray(b["labels"])
    return params, images, labels


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _record_activations(monkeypatch, module):
    """Wrap ``module.binarize_activations`` to keep its inputs: the
    pre-sign activations after each conv and hidden FC."""
    seen = []
    inner = module.binarize_activations

    def wrapped(x, *a, **kw):
        seen.append(x)
        return inner(x, *a, **kw)

    monkeypatch.setattr(module, "binarize_activations", wrapped)
    return seen


def test_bnn_train_loss_and_gradients_match_jax(setup, monkeypatch, record_property):
    params, images, labels = setup
    jcfg = jbnn.BNNConfig(mode=JQuantMode.FAKE_QUANT)
    tcfg = tbnn.BNNConfig(mode=QuantMode.FAKE_QUANT)
    j_seen = _record_activations(monkeypatch, jbnn)

    def j_loss(p, x, y):
        j_seen.clear()
        loss, aux = jbnn.bnn_train_loss(p, x, y, jcfg)
        return loss, (aux, list(j_seen))

    (j_loss, (j_aux, j_acts)), j_grads = jax.jit(jax.value_and_grad(
        j_loss, has_aux=True))(params, images, labels)
    tp = tree.tree_map(lambda x: x.requires_grad_(True),
                       params_from_numpy(params, device="cpu"))
    t_acts = _record_activations(monkeypatch, tbnn)
    t_loss, t_aux = tbnn.bnn_train_loss(tp, _t(images), _t(labels), tcfg)
    t_grads = torch.autograd.grad(t_loss, tree.leaves(tp), allow_unused=True)
    j_acts = [np.asarray(a) for a in j_acts]
    t_acts = [a.detach().numpy() for a in t_acts]

    flips = [int(((a >= 0) != (b >= 0)).sum()) for a, b in zip(j_acts, t_acts)]
    record_property("activation_sign_differences", flips)
    print(f"activation signs differing per binarized layer: {flips} of "
          f"{[a.size for a in j_acts]}")
    assert len(flips) == len(jbnn.CONV_CHANNELS) + len(jbnn.FC_SIZES) - 1

    np.testing.assert_allclose(t_loss.item(), float(j_loss), **LOSS_TOL)
    assert t_aux["acc"].item() == float(j_aux["acc"])
    for group in ("bn_conv", "bn_fc"):
        for got, want in zip(t_aux["bn_stats"][group], j_aux["bn_stats"][group]):
            mean, var = np.asarray(want["mean"]), np.asarray(want["var"])
            np.testing.assert_allclose(got["var"].detach().numpy(), var, **LOSS_TOL)
            # A batch mean of values that cancel is held to the scale of
            # the values (their rms), not to itself.
            rms = np.sqrt(var + mean**2)
            assert (np.abs(got["mean"].detach().numpy() - mean)
                    <= MEAN_TOL * rms).all(), group
    for (path, _), g, w in zip(tree.leaves_with_path(tp), t_grads,
                               jax.tree.leaves(j_grads)):
        if path[-1] in ("mean", "var"):
            # Training mode never reads the buffers: no gradient reaches them.
            assert g is None and not np.asarray(w).any(), path
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL,
                                   err_msg=str(path))


def test_update_bn_stats_matches_jax_exactly(setup):
    params, _, _ = setup
    rng = np.random.default_rng(5)
    stats = {g: [{"mean": rng.normal(size=bn["mean"].shape).astype(np.float32),
                  "var": np.abs(rng.normal(size=bn["var"].shape)).astype(np.float32)}
                 for bn in params[g]] for g in ("bn_conv", "bn_fc")}
    want = jbnn.update_bn_stats(params, stats, momentum=0.9)
    got = tbnn.update_bn_stats(params_from_numpy(params, device="cpu"),
                               params_from_numpy(stats, device="cpu"),
                               momentum=0.9)
    for a, b in zip(tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_one_train_step_matches_jax(setup, record_property):
    params, images, labels = setup
    cfg = ttrainer.BNNTrainerConfig(steps=10, batch=BATCH, warmup_steps=2)
    jstep = jax.jit(j_make_train_step(jtrainer._BNNTask(
        jbnn.BNNConfig(mode=JQuantMode.FAKE_QUANT)),
        jtrainer.BNNTrainerConfig(steps=10, batch=BATCH,
                                  warmup_steps=2).train_config(),
        clip_predicate=jtrainer.bnn_clip_predicate))
    jp, jopt, jm = jstep(params, j_init_opt_state(params),
                         {"images": images, "labels": labels})
    tparams = params_from_numpy(params, device="cpu")
    tstep = make_train_step(ttrainer._BNNTask(cfg.model_config()),
                            cfg.train_config(),
                            clip_predicate=ttrainer.bnn_clip_predicate)
    tp, topt, tm = tstep(tparams, init_opt_state(tparams),
                         {"images": _t(images), "labels": _t(labels)})

    np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), **LOSS_TOL)
    np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]),
                               rtol=1e-4)
    assert tm["lr_scale"].item() == float(jm["lr_scale"])
    assert tm["acc"].item() == float(jm["acc"])
    assert int(topt["adam"]["count"]) == int(jopt["adam"]["count"]) == 1

    # The first moment after one step is (1 - b1) * g: the clipped
    # gradients of both packages.
    g_t = [m.numpy() for m in tree.leaves(topt["adam"]["mu"])]
    g_j = [np.asarray(m) for m in jax.tree.leaves(jopt["adam"]["mu"])]
    roundoff = ROUNDOFF * max(np.abs(g).max() for g in g_j)
    apart, total = 0, 0
    for (path, a), b, gt, gj in zip(tree.leaves_with_path(tp),
                                    jax.tree.leaves(jp), g_t, g_j):
        a, b = a.numpy(), np.asarray(b)
        bad = ~np.isclose(a, b, **PARAM_TOL)
        apart += int(bad.sum())
        total += a.size
        # Apart only where both gradients are roundoff, and by at most
        # the 2 lr of two opposite Adam steps.
        assert np.abs(gt[bad]).max(initial=0) <= roundoff, path
        assert np.abs(gj[bad]).max(initial=0) <= roundoff, path
        assert np.abs(a - b)[bad].max(initial=0) <= 2 * cfg.lr, path
    record_property("param_elements_apart", apart)
    print(f"param elements apart after one step: {apart} of {total}")
    assert apart <= ADAM_ROUNDOFF_SHARE * total


def test_train_bnn_matches_jax_for_three_steps(setup):
    """The loop's wiring (schedule, EMA of the BN statistics, the held-out
    batches) against the JAX package's. Adam moves an element whose
    gradient is roundoff by up to lr either way (see the one-step test),
    and a latent weight that crosses 0 in one package only is another
    binary network: the runs then part by O(1) in loss (at lr 3e-3 from
    the default init: 2.73 against 3.42 at step 2). So the latents start
    at least 0.05 from 0, more than 3 steps of lr can move them, and both
    runs keep one binary network."""
    params = numpy_params(margin=0.05)
    _, images, _ = setup
    kw = dict(steps=3, batch=BATCH, warmup_steps=1, eval_batches=1)
    want = jtrainer.train_bnn(jtrainer.BNNTrainerConfig(**kw), params=params)
    got = ttrainer.train_bnn(ttrainer.BNNTrainerConfig(**kw),
                             params=params_from_numpy(params, device="cpu"),
                             device="cpu")
    assert got.start_step == want.start_step == 0
    assert ulp_distance(np.asarray(got.history["lr_scale"], np.float32),
                        np.asarray(want.history["lr_scale"], np.float32)).max() <= 1
    np.testing.assert_allclose(got.history["loss"], want.history["loss"], atol=1e-3)
    np.testing.assert_allclose(got.history["acc"], want.history["acc"])
    np.testing.assert_allclose(got.eval_loss, want.eval_loss, atol=1e-3)
    for path, w in tree.leaves_with_path(got.params):
        if ttrainer.bnn_clip_predicate(path):
            want_w = params[path[0]][path[1]][path[2]]
            assert torch.equal(torch.sign(w), _t(np.sign(want_w))), path
    # The running statistics moved as the JAX run's did.
    for (path, a), b in zip(tree.leaves_with_path(got.params),
                            jax.tree.leaves(want.params)):
        if path[-1] in ("mean", "var"):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **PARAM_TOL,
                                       err_msg=str(path))


def test_train_bnn_resumes_bit_identically(tmp_path):
    """Run the whole job with checkpoints, delete the last one (a process
    that died after step 2) and rerun the same config: the cosine horizon
    stays ``steps``, so the resumed run replays the rest exactly."""
    cfg = ttrainer.BNNTrainerConfig(steps=4, batch=BATCH, warmup_steps=1,
                                    eval_batches=1, checkpoint_dir=str(tmp_path),
                                    checkpoint_every=2)
    full = ttrainer.train_bnn(cfg, device="cpu")
    assert full.start_step == 0
    assert ckpt_manager.latest_valid_step(str(tmp_path)) == cfg.steps
    for group in ("conv", "fc"):
        for layer in full.params[group]:
            assert float(layer["w"].abs().max()) <= 1.0
    shutil.rmtree(tmp_path / f"step_{cfg.steps:08d}")
    assert ckpt_manager.latest_valid_step(str(tmp_path)) == 2
    resumed = ttrainer.train_bnn(cfg, device="cpu")
    assert resumed.start_step == 2
    assert resumed.history["loss"] == full.history["loss"][2:]
    for a, b in zip(tree.leaves((full.params, full.opt_state)),
                    tree.leaves((resumed.params, resumed.opt_state))):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def trained():
    return tbnn.load_binary_checkpoint(CKPT, device="cpu")


@pytest.mark.parametrize("use_scale", [False, True])
def test_pack_trained_params_verifies_every_engine(trained, use_scale):
    images = _t(np.random.default_rng(5).normal(size=(2, 32, 32, 3)).astype(np.float32))
    out = tbnn.pack_trained_params(trained, use_scale=use_scale,
                                   probe_images=images)
    assert set(out) == {"packed", "fused", "megakernel"}
    assert ("alpha" in out["packed"]["fc"][0]) == use_scale


def test_pack_trained_params_detects_corruption(trained):
    """A NaN final BN variance drives every forward to NaN, and NaN !=
    NaN: the probe raises and names the engines. A flipped latent sign is
    another model, not a corrupt one: it still exports."""
    images = _t(np.random.default_rng(7).normal(size=(2, 32, 32, 3)).astype(np.float32))
    var = trained["bn_fc"][-1]["var"].clone()
    var[0] = -1.0
    forged = {**trained, "bn_fc": trained["bn_fc"][:-1]
              + [{**trained["bn_fc"][-1], "var": var}]}
    with pytest.raises(ValueError, match="bit-identity") as err:
        tbnn.pack_trained_params(forged, probe_images=images)
    for engine in ("packed/xla", "fused/xnor/direct", "megakernel_xla"):
        assert engine in str(err.value)
    w = trained["fc"][0]["w"].clone()
    w[0, 0] = -w[0, 0]
    flipped = {**trained, "fc": [{**trained["fc"][0], "w": w}] + trained["fc"][1:]}
    tbnn.pack_trained_params(flipped, probe_images=images)


def test_pack_trained_params_takes_params_that_require_grad(trained):
    live = tree.tree_map(lambda t: t.clone().requires_grad_(True), trained)
    images = _t(np.random.default_rng(8).normal(size=(1, 32, 32, 3)).astype(np.float32))
    tbnn.pack_trained_params(live, probe_images=images, probe_conv_impls=("direct",))


def test_binarize_activations_splits_ties_as_jnp_clip():
    """At ``x == ±1`` the Htanh's gradient is 1/2 in the JAX package
    (``jnp.clip`` is a max then a min, and ties split); every FAKE_QUANT
    layer re-binarizes its ±1 input, so each binary layer's input
    gradient passes through such a tie."""
    from repro.core.binarize import binarize_activations as j_binarize

    from repro_torch.core.binarize import binarize_activations

    x = np.asarray([-2.0, -1.0, -0.5, 0.0, 1.0, 1.5], np.float32)
    up = np.arange(1.0, 7.0, dtype=np.float32)
    want = jax.grad(lambda v: jnp.sum(j_binarize(v) * up))(x)
    tx = _t(x).requires_grad_(True)
    (got,) = torch.autograd.grad((binarize_activations(tx) * _t(up)).sum(), tx)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.tolist() == [0.0, 1.0, 3.0, 4.0, 2.5, 0.0]


def test_maxpool_gradient_takes_the_first_maximum():
    """``lax.reduce_window``'s max sends a window's gradient to its first
    maximal element in row-major order; ties are common after the binary
    convs (equal integer dots normalize to equal floats)."""
    rng = np.random.default_rng(9)
    x = rng.integers(-2, 3, size=(2, 6, 4, 3)).astype(np.float32)
    up = rng.normal(size=(2, 3, 2, 3)).astype(np.float32)
    want = jax.grad(lambda v: jnp.sum(jbnn._maxpool2(v) * up))(x)
    tx = _t(x).requires_grad_(True)
    y = tbnn._maxpool2(tx)
    assert torch.equal(y, _t(jbnn._maxpool2(x)))
    (got,) = torch.autograd.grad((y * _t(up)).sum(), tx)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bnn_eval_logits_takes_use_scale():
    """The float-boundary forward with the XNOR-Net alpha, against the
    JAX package's (rtol 1e-6 / atol 1e-5: its BatchNorm's ``rsqrt``
    rounds apart from torch's by up to 2 ulp). Latents of many
    magnitudes: a sign-form checkpoint's alpha is 1."""
    images = np.random.default_rng(10).normal(size=(3, 32, 32, 3)).astype(np.float32)
    params = numpy_params(3)
    tp = params_from_numpy(params, device="cpu")
    got = {}
    for use_scale in (False, True):
        want = jax.jit(jbnn.bnn_eval_logits, static_argnames="use_scale")(
            params, images, use_scale=use_scale)
        got[use_scale] = tbnn.bnn_eval_logits(tp, _t(images), use_scale=use_scale)
        np.testing.assert_allclose(got[use_scale].numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-5)
    assert not torch.equal(got[False], got[True])
