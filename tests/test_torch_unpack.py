"""The float32 split behind the ``unpack_gemm`` kernel's bf16 tensor-core
products, and the wrapper's CPU path against the JAX package.

The kernel multiplies a float32 input as three bf16 pieces against the
same ±1 weights (``kernels.ref.split_bf16_pieces``: each piece cut by
truncation). The pieces must sum back to the input exactly and each must
be a bf16 value, so every product is exact and the float32 accumulation
is the only rounding: checked here at ±0, the clipped activations in
[-1, 1], float32's largest values and magnitudes down to 2^-110. A split
whose high piece rounds to nearest overflows to inf at float32's largest
values, which is why the kernel truncates. On CPU tensors
``ops.unpack_gemm`` is the plain twin; it is held to the JAX
``unpack_gemm`` run in interpret mode at a ragged shape: exactly on ±1/0
input, within the JAX package's tolerance (rtol 1e-5, atol 1e-4) on real
input.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops
from repro_torch.kernels.ref import split_bf16_pieces

from torch_parity import t, words

FLOAT32_MAX = float(np.finfo(np.float32).max)


def special_values() -> torch.Tensor:
    rng = np.random.default_rng(160)
    clipped = rng.uniform(-1, 1, size=4096)
    tiny = np.ldexp(rng.uniform(1, 2, size=1024), rng.integers(-110, -60, size=1024))
    huge = np.ldexp(rng.uniform(1, 2, size=1024), rng.integers(100, 127, size=1024))
    signs = np.where(rng.random(2048) < 0.5, -1.0, 1.0)
    edges = [0.0, -0.0, 1.0, -1.0, 2.0**-110, -(2.0**-110), FLOAT32_MAX, -FLOAT32_MAX,
             np.nextafter(np.float32(FLOAT32_MAX), np.float32(0))]
    values = np.concatenate([clipped, np.concatenate([tiny, huge]) * signs, edges])
    return torch.from_numpy(values.astype(np.float32))


def test_three_bf16_pieces_sum_back_exactly():
    x = special_values()
    hi, mid, lo = split_bf16_pieces(x)
    assert torch.equal(hi + mid + lo, x)
    # -0.0 keeps its sign in hi; the sum of the pieces is +0.0, equal to it
    assert torch.equal(torch.signbit(hi), torch.signbit(x))
    for piece in (hi, mid, lo):
        assert torch.isfinite(piece).all()
        assert torch.equal(piece.to(torch.bfloat16).float(), piece)


def test_clipped_binarized_activations_are_their_own_high_piece():
    """±1 and ±0, the binary layers' activations: mid and lo are 0, so the
    kernel runs one bf16 product per K tile, not three."""
    x = torch.tensor([1.0, -1.0, 0.0, -0.0])
    hi, mid, lo = split_bf16_pieces(x)
    assert torch.equal(hi, x) and not mid.any() and not lo.any()


def test_round_to_nearest_split_overflows_where_truncation_does_not():
    x = torch.tensor([FLOAT32_MAX, -FLOAT32_MAX])
    nearest_hi = x.to(torch.bfloat16).float()
    assert torch.isinf(nearest_hi).all()
    assert torch.isnan(nearest_hi + (x - nearest_hi)).all()
    hi, mid, lo = split_bf16_pieces(x)
    assert torch.isfinite(hi).all() and torch.equal(hi + mid + lo, x)


# Ragged M, N and KW (not multiples of the kernel's 128 x 64 tile or of its
# two-word K tile).
@pytest.mark.parametrize("m,kw,n", [(13, 5, 9), (131, 3, 66)])
def test_cpu_unpack_gemm_is_the_twin_of_the_pallas_kernel(m, kw, n):
    rng = np.random.default_rng(161)
    wp = words(rng, (m, kw))
    jw = jnp.asarray(wp)
    before = ops.LAUNCHES["unpack_gemm"]
    ternary = rng.integers(-1, 2, size=(32 * kw, n)).astype(np.float32)
    got = ops.unpack_gemm(t(wp), t(ternary).T.contiguous().T)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jops.unpack_gemm(jw, jnp.asarray(ternary), interpret=True)))
    real = rng.uniform(-1, 1, size=(32 * kw, n)).astype(np.float32)
    got = ops.unpack_gemm(t(wp), t(real))
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jops.unpack_gemm(jw, jnp.asarray(real), interpret=True)),
        rtol=1e-5, atol=1e-4)
    assert ops.LAUNCHES["unpack_gemm"] == before   # the twin on the CPU
