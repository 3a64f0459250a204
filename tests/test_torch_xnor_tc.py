"""The identity behind ``fused_xnor_gemm``'s tensor-core product, as a
plain function (``ref.xnor_dot_and_popc``): the 1-bit ``mma.sync`` counts
``popc(w & x)``, and the xnor count follows from the row and column
popcounts. Held exactly to the JAX package's and the port's
``xnor_popcount_matmul`` and, through the kernel's epilogue (``a*dot``
then ``+ b``, sign, repacked along M with +1 rows past M), to both
packages' ``fused_xnor_layer``: random words, a ragged last word
(``k_bits`` below ``32*KW``, its pad bits xnor-neutral), whole pad words,
and all-ones / all-zeros words."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitops as jbits
from repro_torch.core import bitops
from repro_torch.kernels.ref import xnor_dot_and_popc

from torch_parity import t, words


def operands(rng, m, kw, n, k_bits, fill=None):
    """Packed W [M, KW], X [KW, N]; bits past k_bits xnor-neutral (W 0,
    X 1); ``fill`` ("ones", "zeros") sets every real bit of both."""
    w, x = words(rng, (m, kw)), words(rng, (kw, n))
    if fill is not None:
        w[:] = x[:] = -1 if fill == "ones" else 0
    bit = np.arange(32 * kw).reshape(kw, 32)
    pad = (bit >= k_bits).astype(np.uint64)
    pad_word = (pad << np.arange(32, dtype=np.uint64)).sum(1).astype(
        np.uint32).view(np.int32)                     # 1 where a bit is pad
    return w & ~pad_word[None, :], x | pad_word[:, None]


def fused_from_dot(dot, a, b):
    """The kernel's epilogue on an int32 dot: y = (a*dot) + b, sign,
    repacked along M, rows past M +1."""
    y = a[:, None] * dot.float() + b[:, None]
    pad = -y.shape[0] % 32
    if pad:
        y = torch.nn.functional.pad(y, (0, 0, 0, pad), value=1.0)
    return bitops.pack_bits(y, axis=0)


@pytest.mark.parametrize("m,kw,n,k_bits,fill", [
    (45, 3, 7, 96, None),          # random words
    (33, 9, 129, 9 * 32 - 5, None),  # ragged last word
    (40, 5, 6, 3 * 32, None),      # two whole pad words
    (8, 2, 3, 64, "ones"), (8, 2, 3, 50, "zeros"),
    (1, 1, 1, 1, None)])
def test_and_popc_identity_equals_the_xnor_dot(m, kw, n, k_bits, fill):
    rng = np.random.default_rng(170)
    w, x = operands(rng, m, kw, n, k_bits, fill)
    got = xnor_dot_and_popc(t(w), t(x), k_bits)
    assert torch.equal(got, bitops.xnor_popcount_matmul(t(w), t(x), k_bits))
    want = np.asarray(jbits.xnor_popcount_matmul(jnp.asarray(w), jnp.asarray(x),
                                                 k_bits))
    np.testing.assert_array_equal(got.numpy(), want)

    a = (rng.normal(size=m) + 0.1).astype(np.float32)
    b = (rng.normal(size=m) * np.sqrt(k_bits)).astype(np.float32)
    fused = fused_from_dot(got, t(a), t(b))
    assert torch.equal(fused, bitops.fused_xnor_layer(t(w), t(x), k_bits, t(a), t(b)))
    want = jbits.fused_xnor_layer(jnp.asarray(w), jnp.asarray(x), k_bits,
                                  jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(fused.numpy(), np.asarray(want))
