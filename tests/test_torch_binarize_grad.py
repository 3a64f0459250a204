"""FAKE_QUANT gradients: ``torch.autograd.grad`` of the port against
``jax.grad`` of the JAX package on the same numpy inputs.

The JAX package binarizes through ``ste_sign`` (a custom VJP: sign
forward, ``g * (|x| <= 1)`` backward) and stops the gradient of the
XNOR-Net alpha; the port's ``ste_sign`` is a ``torch.autograd.Function``
with the same backward and its alpha is detached. Cases: one FAKE_QUANT
``bit_linear`` and ``bit_conv2d`` with alpha on and off, activations
binarized or not; the FAKE_QUANT MoE expert path of ``models/ffn.py``;
and ``Model.loss`` of the smoke smollm, xlstm and jamba under
``train_policy()`` (weight-only FAKE_QUANT with alpha on every
projection), with respect to every parameter.

Tolerance as ``tests/test_torch_loss_grad.py``: float32 sums in other
orders, rtol 1e-4 / atol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.configs import train_policy as j_train_policy
from repro.core import layers as jl
from repro.core.binarize import QuantMode as JQuantMode
from repro.models import ffn as jffn
from repro.models.model_factory import build_model as j_build_model
from repro_torch.configs.base import smoke_config, train_policy
from repro_torch.convert import params_from_numpy
from repro_torch.core import layers as tl
from repro_torch.core.binarize import QuantMode, ste_sign
from repro_torch.models import ffn as tffn
from repro_torch.models.model_factory import build_model

from test_torch_loss_grad import BATCH, SEQ, leaves, numpy_params

GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _close(got, want, what):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **GRAD_TOL, err_msg=what)


def _cfgs(use_scale, binarize_acts):
    kw = dict(use_scale=use_scale, binarize_acts=binarize_acts)
    return (jl.BitLinearConfig(mode=JQuantMode.FAKE_QUANT, **kw),
            tl.BitLinearConfig(mode=QuantMode.FAKE_QUANT, **kw))


def test_ste_sign_forward_and_backward():
    x = torch.tensor([-2.0, -1.0, -0.5, -0.0, 0.0, 0.5, 1.0, 1.5],
                     requires_grad=True)
    y = ste_sign(x)
    assert y.tolist() == [-1.0, -1.0, -1.0, 1.0, 1.0, 1.0, 1.0, 1.0]
    (g,) = torch.autograd.grad((y * torch.arange(1.0, 9.0)).sum(), x)
    assert g.tolist() == [0.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 0.0]


@pytest.mark.parametrize("use_scale", [False, True])
@pytest.mark.parametrize("binarize_acts", [False, True])
def test_bit_linear_gradient_matches_jax(use_scale, binarize_acts):
    rng = np.random.default_rng(400)
    w = rng.normal(size=(24, 40)).astype(np.float32) * 0.6
    b = rng.normal(size=24).astype(np.float32)
    x = (rng.normal(size=(6, 40)) * 1.3).astype(np.float32)
    up = rng.normal(size=(6, 24)).astype(np.float32)
    jcfg, tcfg = _cfgs(use_scale, binarize_acts)

    def j_loss(w_, b_, x_):
        return jnp.sum(jl.bit_linear({"w": w_, "b": b_}, x_, jcfg) * up)

    want = jax.jit(jax.grad(j_loss, argnums=(0, 1, 2)))(w, b, x)
    tw, tb, tx = (torch.from_numpy(a.copy()).requires_grad_() for a in (w, b, x))
    y = tl.bit_linear({"w": tw, "b": tb}, tx, tcfg)
    got = torch.autograd.grad((y * torch.from_numpy(up)).sum(), (tw, tb, tx))
    for name, g, jg in zip(("w", "b", "x"), got, want):
        _close(g, jg, f"d / d {name}")


@pytest.mark.parametrize("use_scale", [False, True])
@pytest.mark.parametrize("binarize_acts", [False, True])
def test_bit_conv2d_gradient_matches_jax(use_scale, binarize_acts):
    rng = np.random.default_rng(401)
    w = rng.normal(size=(8, 3, 3, 5)).astype(np.float32) * 0.6
    b = rng.normal(size=8).astype(np.float32)
    x = (rng.normal(size=(2, 6, 6, 5)) * 1.3).astype(np.float32)
    up = rng.normal(size=(2, 6, 6, 8)).astype(np.float32)
    jcfg, tcfg = _cfgs(use_scale, binarize_acts)

    def j_loss(w_, b_, x_):
        y = jl.bit_conv2d({"w": w_, "b": b_}, x_, jcfg, stride=1, pad=1)
        return jnp.sum(y * up)

    want = jax.jit(jax.grad(j_loss, argnums=(0, 1, 2)))(w, b, x)
    tw, tb, tx = (torch.from_numpy(a.copy()).requires_grad_() for a in (w, b, x))
    y = tl.bit_conv2d({"w": tw, "b": tb}, tx, tcfg, stride=1, pad=1)
    got = torch.autograd.grad((y * torch.from_numpy(up)).sum(), (tw, tb, tx))
    for name, g, jg in zip(("w", "b", "x"), got, want):
        _close(g, jg, f"d / d {name}")


def test_weight_only_bit_linear_gap_is_closed():
    """The case that exposed the fault: a [8, 16] weight-only FAKE_QUANT
    ``bit_linear`` with alpha. A sign without the STE passes no gradient
    to the weights but through alpha, which the JAX package stops, so
    the two disagreed in every weight's gradient."""
    rng = np.random.default_rng(402)
    w = rng.normal(size=(8, 16)).astype(np.float32)
    x = rng.normal(size=(4, 16)).astype(np.float32)
    jcfg, tcfg = _cfgs(True, False)
    want = jax.grad(lambda w_: jnp.sum(jl.bit_linear({"w": w_}, x, jcfg) ** 2))(w)
    tw = torch.from_numpy(w.copy()).requires_grad_()
    y = tl.bit_linear({"w": tw}, torch.from_numpy(x), tcfg)
    (got,) = torch.autograd.grad((y ** 2).sum(), tw)
    _close(got, want, "d / d w")


@pytest.mark.parametrize("use_scale", [False, True])
def test_moe_expert_gradient_matches_jax(use_scale):
    """The FAKE_QUANT expert path (``_expert_matmul`` under ``moe_ffn``):
    router, expert weights and input gradients of the smoke jamba MoE,
    of a mean over the outputs as a loss is (a sum over a thousand
    outputs gives weight gradients in the hundreds, where float32 sums
    in another order differ past atol)."""
    arch = "jamba-1.5-large-398b"
    j_cfg, t_cfg = j_smoke_config(arch), smoke_config(arch)
    jpol = dataclasses.replace(j_train_policy(), use_scale=use_scale)
    tpol = dataclasses.replace(train_policy(), use_scale=use_scale)
    rng = np.random.default_rng(403)
    shapes = jax.eval_shape(lambda k: jffn.init_moe(k, j_cfg),
                            jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(
        lambda s: (rng.normal(size=s.shape) / np.sqrt(s.shape[-1])).astype(s.dtype),
        shapes)
    x = rng.normal(size=(2, 8, j_cfg.d_model)).astype(np.float32)
    up = rng.normal(size=(2, 8, j_cfg.d_model)).astype(np.float32)

    def j_loss(p, x_):
        out, aux = jffn.moe_ffn(p, x_, j_cfg, jpol)
        return jnp.mean(out * up) + aux

    want_p, want_x = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(params, x)
    tparams = params_from_numpy(params, device="cpu")
    tleaves = [t.requires_grad_() for t in leaves(tparams)]
    tx = torch.from_numpy(x.copy()).requires_grad_()
    out, aux = tffn.moe_ffn(tparams, tx, t_cfg, tpol)
    got = torch.autograd.grad((out * torch.from_numpy(up)).mean() + aux,
                              tleaves + [tx])
    want = jax.tree_util.tree_leaves(want_p) + [want_x]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, f"leaf {i}")


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "smollm-360m",
                                  "xlstm-1.3b"])
def test_train_policy_loss_gradient_matches_jax(arch):
    rng = np.random.default_rng(404)
    j_cfg = j_smoke_config(arch)
    jm = j_build_model(j_cfg, j_train_policy())
    params = numpy_params(jm, rng)
    tokens = rng.integers(0, j_cfg.vocab_size, size=(BATCH, SEQ), dtype=np.int32)
    labels = rng.integers(0, j_cfg.vocab_size, size=(BATCH, SEQ), dtype=np.int32)

    def j_total(p):
        return jm.loss(p, {"tokens": jnp.asarray(tokens),
                           "labels": jnp.asarray(labels)})[0]

    want_total, want = jax.jit(jax.value_and_grad(j_total))(params)
    names = [jax.tree_util.keystr(path)
             for path, _ in jax.tree_util.tree_flatten_with_path(want)[0]]
    model = build_model(smoke_config(arch), train_policy())
    tparams = params_from_numpy(params, device="cpu")
    tleaves = [t.requires_grad_() for t in leaves(tparams)]
    total, _ = model.loss(tparams, {"tokens": torch.from_numpy(tokens).long(),
                                    "labels": torch.from_numpy(labels).long()})
    got = torch.autograd.grad(total, tleaves)
    np.testing.assert_allclose(float(total.detach()), float(want_total),
                               rtol=1e-5, atol=1e-5)
    want_leaves = jax.tree_util.tree_leaves(want)
    assert len(got) == len(want_leaves) == len(names)
    for name, g, w in zip(names, got, want_leaves):
        _close(g, w, f"{arch} d loss / d {name}")
