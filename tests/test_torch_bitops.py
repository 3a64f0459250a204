"""The port's plain-torch bit ops against the JAX package's, exactly.

Inputs come from ``np.random.default_rng`` and go through both
``repro.core.bitops`` and ``repro_torch.core.bitops``; every packed word
and integer dot must be equal. Shapes are deliberately not multiples of
32, and the random words cover bit 31 set (negative int32 words).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import bitops as jbit
from repro_torch.core import bitops as tbit
from torch_parity import t, words


def j(x):
    return np.asarray(x)


@pytest.mark.parametrize("shape,axis", [((5, 64), -1), ((96, 7), 0),
                                        ((2, 3, 32, 4), 2)])
def test_pack_bits_matches_jax(shape, axis):
    rng = np.random.default_rng(0)
    x = rng.normal(size=shape).astype(np.float32)
    x.reshape(-1)[::7] = 0.0  # sign(0) := +1 on both sides
    want = j(jbit.pack_bits(jnp.asarray(x), axis=axis))
    got = tbit.pack_bits(t(x), axis=axis).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert (got < 0).any(), "no word with bit 31 set was exercised"


@pytest.mark.parametrize("c", [32, 45, 77])
def test_pack_channels_matches_jax(c):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 3, 3, c)).astype(np.float32)
    np.testing.assert_array_equal(
        tbit.pack_channels(t(x)).numpy(), j(jbit.pack_channels(jnp.asarray(x))))


@pytest.mark.parametrize("axis", [0, -1])
def test_unpack_bits_matches_jax(axis):
    w = words(np.random.default_rng(2), (6, 5))
    np.testing.assert_array_equal(
        tbit.unpack_bits(t(w), axis=axis).numpy(),
        j(jbit.unpack_bits(jnp.asarray(w), axis=axis)))


def test_popcount_matches_jax_on_edge_words():
    edge = np.array([0, -1, -(2**31), 2**31 - 1, 1, -2], np.int32)
    w = np.concatenate([edge, words(np.random.default_rng(3), (200,))])
    np.testing.assert_array_equal(
        tbit.popcount(t(w)).numpy(),
        j(jbit.popcount(jnp.asarray(w))).astype(np.int64))


@pytest.mark.parametrize("m,kw,n,k_bits", [(37, 5, 19, 150), (10, 32, 3, 1024),
                                           (64, 1, 1, 32)])
def test_xnor_popcount_matmul_matches_jax(m, kw, n, k_bits):
    rng = np.random.default_rng(4)
    w, x = words(rng, (m, kw)), words(rng, (kw, n))
    got = tbit.xnor_popcount_matmul(t(w), t(x), k_bits).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(
        got, j(jbit.xnor_popcount_matmul(jnp.asarray(w), jnp.asarray(x), k_bits)))


@pytest.mark.parametrize("m", [45, 64, 10])
def test_fused_xnor_layer_matches_jax(m):
    rng = np.random.default_rng(5)
    kw, n, k_bits = 4, 13, 120
    w, x = words(rng, (m, kw)), words(rng, (kw, n))
    a = rng.normal(size=m).astype(np.float32)
    b = (rng.normal(size=m) * 8).astype(np.float32)
    np.testing.assert_array_equal(
        tbit.fused_xnor_layer(t(w), t(x), k_bits, t(a), t(b)).numpy(),
        j(jbit.fused_xnor_layer(jnp.asarray(w), jnp.asarray(x), k_bits,
                                jnp.asarray(a), jnp.asarray(b))))


@pytest.mark.parametrize("stride,pad,d", [(1, 1, 40), (2, 0, 32), (1, 0, 7)])
def test_direct_conv_matches_jax(stride, pad, d):
    rng = np.random.default_rng(6)
    cw, k_bits = 2, 9 * 50
    x, w = words(rng, (2, 5, 6, cw)), words(rng, (d, 9 * cw))
    a = rng.normal(size=d).astype(np.float32)
    b = (rng.normal(size=d) * 10).astype(np.float32)
    kw = dict(kh=3, kw=3, stride=stride, pad=pad)
    np.testing.assert_array_equal(
        tbit.direct_conv_dot(t(w), t(x), k_bits, **kw).numpy(),
        j(jbit.direct_conv_dot(jnp.asarray(w), jnp.asarray(x), k_bits, **kw)))
    np.testing.assert_array_equal(
        tbit.direct_conv_oracle(t(w), t(x), k_bits, t(a), t(b), **kw).numpy(),
        j(jbit.direct_conv_oracle(jnp.asarray(w), jnp.asarray(x), k_bits,
                                  jnp.asarray(a), jnp.asarray(b), **kw)))


def test_maxpool2_packed_matches_jax():
    x = words(np.random.default_rng(7), (2, 4, 6, 3))
    np.testing.assert_array_equal(
        tbit.maxpool2_packed(t(x)).numpy(),
        j(jbit.maxpool2_packed(jnp.asarray(x))))
