"""The port's layers against ``repro.core.layers`` on the same numpy
inputs.

Packing is exact. ``fold_bn_params`` is held to a few ulp, not to bit
identity: ``torch.rsqrt`` and XLA's ``rsqrt`` round differently in some
channels (on the committed trained checkpoint, in about a third of the
BN channels, by up to 2 ulp), so the folded ``(a, b)`` may differ in the
last bits. The fused layers are therefore held to the JAX package
exactly on ``(a, b)`` carried across from it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bnn as jbnn
from repro.core import layers as jl
from repro_torch.core import bnn as tbnn
from repro_torch.core import layers as tl
from repro_torch.core.binarize import QuantMode

from torch_parity import CKPT, pm1, t, ulp_distance


def _latent_conv(rng, d, c):
    return {"w": rng.normal(size=(d, 3, 3, c)).astype(np.float32),
            "b": rng.normal(size=d).astype(np.float32)}


def _bn(rng, d):
    return {"gamma": rng.uniform(0.5, 2.0, d).astype(np.float32),
            "beta": rng.normal(size=d).astype(np.float32),
            "mean": rng.normal(size=d).astype(np.float32),
            "var": rng.uniform(0.1, 3.0, d).astype(np.float32)}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _t(tree):
    return {k: t(v) for k, v in tree.items()}


@pytest.mark.parametrize("d,c", [(40, 32), (32, 45)])
def test_pack_conv_params_match_jax(d, c):
    p = _latent_conv(np.random.default_rng(20), d, c)
    for fn in ("pack_conv_params", "pack_conv_aligned"):
        want = getattr(jl, fn)(_j(p))
        got = getattr(tl, fn)(_t(p))
        assert set(got) == set(want)
        np.testing.assert_array_equal(got["w_packed"].numpy(),
                                      np.asarray(want["w_packed"]))
        np.testing.assert_array_equal(got["b"].numpy(), np.asarray(want["b"]))


@pytest.mark.parametrize("k", [1024, 45])
def test_pack_linear_params_match_jax(k):
    rng = np.random.default_rng(21)
    p = {"w": rng.normal(size=(10, k)).astype(np.float32),
         "b": rng.normal(size=10).astype(np.float32)}
    np.testing.assert_array_equal(
        tl.pack_linear_params(_t(p))["w_packed"].numpy(),
        np.asarray(jl.pack_linear_params(_j(p))["w_packed"]))


def test_rsqrt_gap_on_trained_checkpoint():
    """``torch.rsqrt`` against ``lax.rsqrt`` on every BN ``var + eps`` of
    the committed checkpoint: they disagree in some channels, never by
    more than 2 ulp. (1316 of 3850 channels with jax 0.9.0 and torch
    2.13 on x86 CPU.)"""
    from jax import lax

    jp = jbnn.load_binary_checkpoint(str(CKPT))
    differ = total = 0
    for bn in jp["bn_conv"] + jp["bn_fc"]:
        v = np.asarray(bn["var"]) + np.float32(jl.BN_EPS)
        d = ulp_distance(np.asarray(lax.rsqrt(jnp.asarray(v))),
                         torch.rsqrt(t(v)).numpy())
        assert d.max() <= 2
        differ += int((d > 0).sum())
        total += v.size
    assert total == 3850 and 0 < differ < total


def test_fold_bn_params_within_2_ulp_of_jax_on_trained_checkpoint():
    """The rsqrt gap, stated: ``a`` within 2 ulp and ``b`` within 4 ulp
    of its larger term, on every folded layer of the committed trained
    checkpoint."""
    jp = jbnn.load_binary_checkpoint(str(CKPT))
    tp = tbnn.load_binary_checkpoint(CKPT, device="cpu")
    worst = 0
    for group, bn_group in (("conv", "bn_conv"), ("fc", "bn_fc")):
        for i in range(len(jp[group])):
            ja, jb = jl.fold_bn_params(jp[bn_group][i], bias=jp[group][i]["b"])
            ta, tb = tl.fold_bn_params(tp[bn_group][i], bias=tp[group][i]["b"])
            d_a = ulp_distance(ta.numpy(), np.asarray(ja))
            # b = s*(bias - mean) + beta can cancel to near 0, so its gap
            # is measured in ulp of its larger term: a 2-ulp gap in s is at
            # most 3 ulp after the product rounds and 4 after the add does.
            bn = jp[bn_group][i]
            term = np.maximum(
                np.abs(np.asarray(ja) * np.asarray(jp[group][i]["b"] - bn["mean"])),
                np.abs(np.asarray(bn["beta"])))
            d_b = np.abs(tb.numpy() - np.asarray(jb)) / np.spacing(term)
            assert d_a.max() <= 2 and d_b.max() <= 4, (group, i, d_a.max(),
                                                       d_b.max())
            worst = max(worst, int(d_a.max()))
    assert worst >= 1, "expected the rsqrt gap to show on this checkpoint"


def _fused_inputs(rng, d, c, n=2, h=6):
    p, bn = _latent_conv(rng, d, c), _bn(rng, d)
    jpk = jl.pack_conv_fused(_j(p), _j(bn))
    carried = {k: t(v) for k, v in jpk.items()}
    xp = np.asarray(jl.pack_linear_params(
        {"w": jnp.asarray(pm1(rng, (n * h * h, c)))})["w_packed"]).reshape(
        n, h, h, c // 32)
    return jpk, carried, xp


@pytest.mark.parametrize("conv_impl", ["direct", "im2col"])
@pytest.mark.parametrize("engine", ["xla", "xnor"])
def test_fused_bit_conv2d_exact_on_carried_affine(conv_impl, engine):
    rng = np.random.default_rng(22)
    jpk, carried, xp = _fused_inputs(rng, d=40, c=64)
    kw = dict(kh=3, kw=3, stride=1, pad=1, conv_impl=conv_impl)
    want = jl.fused_bit_conv2d(jpk, jnp.asarray(xp), 9 * 64, engine="xla", **kw)
    got = tl.fused_bit_conv2d(carried, t(xp), 9 * 64, engine=engine, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("engine", ["xla", "xnor"])
def test_fused_bit_linear_and_head_exact_on_carried_affine(engine):
    rng = np.random.default_rng(23)
    k, m = 96, 45
    p = {"w": rng.normal(size=(m, k)).astype(np.float32),
         "b": rng.normal(size=m).astype(np.float32)}
    jpk = jl.pack_linear_fused(_j(p), _j(_bn(rng, m)))
    carried = {kk: t(v) for kk, v in jpk.items()}
    xp = np.asarray(jl.pack_linear_params(
        {"w": jnp.asarray(pm1(rng, (5, k)))})["w_packed"])
    want = jl.fused_bit_linear(jpk, jnp.asarray(xp), k, engine="xla")
    got = tl.fused_bit_linear(carried, t(xp), k, engine=engine)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    head = jl.pack_linear_params(_j(p))
    np.testing.assert_array_equal(
        tl.packed_act_linear({kk: t(v) for kk, v in head.items()}, t(xp), k,
                             engine=engine).numpy(),
        np.asarray(jl.packed_act_linear(head, jnp.asarray(xp), k, engine="xla")))


def test_first_conv_fake_quant_matches_jax():
    """The float first conv: an fp32 matmul on both sides, summed in a
    different order, so the outputs agree to float32 rounding."""
    rng = np.random.default_rng(24)
    p = {"w": rng.normal(size=(16, 3, 3, 3)).astype(np.float32),
         "b": rng.normal(size=16).astype(np.float32)}
    x = rng.normal(size=(2, 8, 8, 3)).astype(np.float32)
    want = jl.bit_conv2d(_j(p), jnp.asarray(x), jl.BitLinearConfig(
        mode=jl.QuantMode.FAKE_QUANT, binarize_acts=False), stride=1, pad=1)
    got = tl.bit_conv2d(_t(p), t(x), tl.BitLinearConfig(
        mode=QuantMode.FAKE_QUANT, binarize_acts=False), stride=1, pad=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-5)
    with pytest.raises(ValueError, match="kh and kw"):
        tl.bit_conv2d(_t(p), t(x), tl.BitLinearConfig(mode=QuantMode.PACKED))
