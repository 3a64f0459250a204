"""The three conv kernels that run on the 1-bit tensor cores, as plain
references of the way they compute (``kernels/ref.py``):
``direct_conv_tc``, the implicit GEMM of ``fused_direct_conv`` (window
words in tap-major K order, all-ones border words, zeros past K, counts
from the and-popc identity, the pixel-major packed epilogue),
``direct_conv_dot_tc``, the same GEMM with the int32 epilogue of
``direct_conv_dot`` (``2 * count - k_bits``, pixel-major), and
``conv_stage_tc``, the cluster of ``megakernel_conv_stage`` (per-CTA
channel slices, 16-pixel chunks, OR-pool). Each is held exactly to the
port's twins (``bitops.direct_conv_oracle``, ``bitops.conv_stage_xla``)
and to the JAX package's, on inputs drawn with numpy: C not a multiple
of 32, CW of 1 to 3 and 16, stride 2, D not a multiple of 32, odd
batches; and to the JAX package's Pallas kernels in interpret mode
(``fused_direct_conv`` once, ``direct_conv_dot`` at every case). The kernels themselves are held to the twins on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitops as jbits
from repro.kernels.direct_conv import direct_conv_dot as pallas_direct_conv_dot
from repro.kernels.direct_conv import fused_direct_conv as pallas_fused_direct_conv
from repro_torch.core import bitops, layers
from repro_torch.kernels import ref

from torch_parity import pm1, t


def conv_operands(rng, c, d, h, w, n):
    """Tap-aligned packed filters, a channel-packed map and an affine whose
    sign threshold lies inside the dot's spread (numpy)."""
    wp = layers.pack_conv_aligned({"w": t(pm1(rng, (d, 3, 3, c)))})["w_packed"].numpy()
    xp = bitops.pack_channels(t(pm1(rng, (n, h, w, c)))).numpy()
    a = rng.normal(size=d).astype(np.float32)
    b = (rng.normal(size=d) * np.sqrt(9 * c) * np.abs(a) * 0.5).astype(np.float32)
    return wp, xp, a, b


# (C, D, H, W, N, stride, pad): CW 2 with D 40 and an odd batch, CW 1 at
# stride 2 without padding and D 7, CW 3 at stride 2, CW 16 with D 33.
CONV_CASES = [(45, 40, 5, 6, 3, 1, 1), (32, 7, 6, 7, 1, 2, 0),
              (96, 64, 7, 5, 3, 2, 1), (512, 33, 3, 4, 1, 1, 1)]


@pytest.mark.parametrize("c,d,h,w,n,stride,pad", CONV_CASES)
def test_direct_conv_tc_equals_both_oracles(c, d, h, w, n, stride, pad):
    rng = np.random.default_rng(180)
    wp, xp, a, b = conv_operands(rng, c, d, h, w, n)
    kw = dict(kh=3, kw=3, stride=stride, pad=pad)
    got = ref.direct_conv_tc(t(wp), t(xp), 9 * c, t(a), t(b), **kw)
    assert got.shape == (n, (h + 2 * pad - 3) // stride + 1,
                         (w + 2 * pad - 3) // stride + 1, -(-d // 32))
    np.testing.assert_array_equal(
        got.numpy(), bitops.direct_conv_oracle(t(wp), t(xp), 9 * c, t(a), t(b),
                                               **kw).numpy())
    want = jbits.direct_conv_oracle(jnp.asarray(wp), jnp.asarray(xp), 9 * c,
                                    jnp.asarray(a), jnp.asarray(b), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_direct_conv_tc_equals_the_pallas_kernel():
    """D 40 padded to the Pallas kernel's 32-row blocks (a = 0, b = +1),
    its map padded with all-ones words, as its wrapper does."""
    rng = np.random.default_rng(181)
    c, d = 45, 40
    wp, xp, a, b = conv_operands(rng, c, d, 5, 6, 3)
    got = ref.direct_conv_tc(t(wp), t(xp), 9 * c, t(a), t(b), kh=3, kw=3, pad=1)
    fill = -d % 32
    want = pallas_fused_direct_conv(
        jnp.pad(jnp.asarray(wp), ((0, fill), (0, 0))),
        jnp.pad(jnp.asarray(xp), ((0, 0), (1, 1), (1, 1), (0, 0)), constant_values=-1),
        9 * c, jnp.pad(jnp.asarray(a), (0, fill))[:, None],
        jnp.pad(jnp.asarray(b), (0, fill), constant_values=1.0)[:, None],
        kh=3, kw=3, block_d=32, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("c,d,h,w,n,stride,pad", CONV_CASES)
def test_direct_conv_dot_tc_equals_both_oracles(c, d, h, w, n, stride, pad):
    """The int32 epilogue of the same implicit GEMM (``direct_conv_dot``)
    against the port's twin and the JAX package's, exactly."""
    rng = np.random.default_rng(184)
    wp, xp, _, _ = conv_operands(rng, c, d, h, w, n)
    kw = dict(kh=3, kw=3, stride=stride, pad=pad)
    got = ref.direct_conv_dot_tc(t(wp), t(xp), 9 * c, **kw)
    assert got.dtype == torch.int32 and got.shape == (
        n, (h + 2 * pad - 3) // stride + 1, (w + 2 * pad - 3) // stride + 1, d)
    np.testing.assert_array_equal(
        got.numpy(), bitops.direct_conv_dot(t(wp), t(xp), 9 * c, **kw).numpy())
    want = jbits.direct_conv_dot(jnp.asarray(wp), jnp.asarray(xp), 9 * c, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("c,d,h,w,n,stride,pad", CONV_CASES)
def test_direct_conv_dot_tc_equals_the_pallas_kernel(c, d, h, w, n, stride, pad):
    """The Pallas ``direct_conv_dot`` in interpret mode as its wrapper calls
    it: the map padded with all-ones words, D padded to its 32-row block
    with zero filters, the rows past D sliced off."""
    rng = np.random.default_rng(185)
    wp, xp, _, _ = conv_operands(rng, c, d, h, w, n)
    got = ref.direct_conv_dot_tc(t(wp), t(xp), 9 * c, kh=3, kw=3, stride=stride,
                                 pad=pad)
    want = pallas_direct_conv_dot(
        jnp.pad(jnp.asarray(wp), ((0, -d % 32), (0, 0))),
        jnp.pad(jnp.asarray(xp), ((0, 0), (pad, pad), (pad, pad), (0, 0)),
                constant_values=-1),
        9 * c, kh=3, kw=3, stride=stride, block_d=32, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want)[..., :d])


def test_zeros_past_k_add_nothing():
    """The tiles load K past its end as zero words in both operands: the
    count over the real words is unchanged, and counting the zero words
    as real (32 xnor matches each) would not be."""
    rng = np.random.default_rng(182)
    wp, xp, _, _ = conv_operands(rng, 45, 40, 4, 4, 1)
    patches = ref.window_words(t(xp), kh=3, kw=3, stride=1, pad=1).reshape(-1, 18)
    want = bitops.xnor_popcount_matmul(t(wp), patches.T.contiguous(), 9 * 45)
    wk = np.pad(wp, ((0, 0), (0, 14)))
    xk = np.pad(patches.numpy(), ((0, 0), (0, 14))).T
    got = ref.xnor_dot_and_popc(t(wk), t(xk), 9 * 45, real_words=18)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert not np.array_equal(
        ref.xnor_dot_and_popc(t(wk), t(xk), 9 * 45).numpy(), want.numpy())


# (channels of each conv, H, W, N, pool): D 50 and 70 (cluster 1, CW 2 and
# 2), 64 -> 96 (CW 2, 3), a four-conv stage with CW 1, 2, 4, 6 (cluster
# 2), CW 16 with D 512 (cluster 8) at an odd batch; pixel counts not a
# multiple of the 16-pixel chunk.
STAGE_CASES = [((40, 50, 70), 6, 6, 3, True), ((64, 96), 5, 7, 1, False),
               ((32, 64, 128, 192, 64), 3, 5, 2, False),
               ((512, 512), 2, 2, 3, True)]


@pytest.mark.parametrize("chans,h,w,n,pool", STAGE_CASES)
def test_conv_stage_tc_equals_both_oracles(chans, h, w, n, pool):
    rng = np.random.default_rng(183)
    weights, a, b, k_bits = [], [], [], []
    for cin, cout in zip(chans[:-1], chans[1:]):
        wl, _, al, bl = conv_operands(rng, cin, cout, 1, 1, 1)
        weights.append(wl)
        a.append(al)
        b.append(bl)
        k_bits.append(9 * cin)
    xp = bitops.pack_channels(t(pm1(rng, (n, h, w, chans[0])))).numpy()
    got = ref.conv_stage_tc(t(xp), [t(x) for x in weights], [t(x) for x in a],
                            [t(x) for x in b], k_bits, pool=pool)
    np.testing.assert_array_equal(
        got.numpy(), bitops.conv_stage_xla(
            t(xp), [t(x) for x in weights], [t(x) for x in a], [t(x) for x in b],
            k_bits, pool=pool).numpy())
    want = jbits.conv_stage_xla(jnp.asarray(xp), tuple(map(jnp.asarray, weights)),
                                tuple(map(jnp.asarray, a)), tuple(map(jnp.asarray, b)),
                                tuple(k_bits), pool=pool)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
