"""The CUDA kernels against their plain-torch twins on the card, at
ragged shapes the main path does not reach (M, N, D and C not multiples
of 32, stride 2, no padding). Bit-exact. Every test here needs a GPU and
``nvcc`` and skips without them; run on the card with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

(``chip_smoke.py`` checks the main path's shapes.) This file imports no
JAX, so it runs where only the port is installed."""

import numpy as np
import pytest
import torch

from repro_torch.core import bitops, layers
from repro_torch.kernels import ops

from torch_parity import pm1, words

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def cu(x, dev):
    return torch.from_numpy(np.array(x, copy=True)).to(dev)


@pytest.mark.parametrize("m,kw,n", [(10, 32, 33), (70, 40, 5), (1, 1, 1),
                                    (33, 65, 31)])
def test_xnor_gemm_matches_twin(dev, m, kw, n):
    rng = np.random.default_rng(30)
    w, x = cu(words(rng, (m, kw)), dev), cu(words(rng, (kw, n)), dev)
    before = ops.LAUNCHES["xnor_gemm"]
    got = ops.xnor_gemm(w, x, 32 * kw - 5)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["xnor_gemm"] == before + 1
    assert torch.equal(got, bitops.xnor_popcount_matmul(w, x, 32 * kw - 5))


@pytest.mark.parametrize("m,kw,n", [(45, 3, 7), (1024, 32, 3), (10, 70, 40)])
def test_fused_xnor_gemm_matches_twin(dev, m, kw, n):
    rng = np.random.default_rng(31)
    w, x = cu(words(rng, (m, kw)), dev), cu(words(rng, (kw, n)), dev)
    a = cu(rng.normal(size=m).astype(np.float32), dev)
    b = cu((rng.normal(size=m) * 6).astype(np.float32), dev)
    got = ops.fused_xnor_gemm(w, x, 32 * kw, a, b)
    assert torch.equal(got, bitops.fused_xnor_layer(w, x, 32 * kw, a, b))


@pytest.mark.parametrize("c,d,h,stride,pad", [(45, 40, 7, 1, 1), (32, 7, 6, 2, 0),
                                              (96, 64, 5, 2, 1)])
def test_fused_direct_conv_matches_twin(dev, c, d, h, stride, pad):
    rng = np.random.default_rng(32)
    wp = layers.pack_conv_aligned({"w": cu(pm1(rng, (d, 3, 3, c)), dev)})["w_packed"]
    xp = bitops.pack_channels(cu(pm1(rng, (3, h, h + 1, c)), dev))
    a = cu(rng.normal(size=d).astype(np.float32), dev)
    b = cu((rng.normal(size=d) * 8).astype(np.float32), dev)
    kw = dict(kh=3, kw=3, stride=stride, pad=pad)
    got = ops.fused_direct_conv(wp, xp, 9 * c, a, b, **kw)
    assert torch.equal(got, bitops.direct_conv_oracle(wp, xp, 9 * c, a, b, **kw))


def test_cuda_wrappers_refuse_transposed_views(dev):
    rng = np.random.default_rng(33)
    w, x = cu(words(rng, (10, 4)), dev), cu(words(rng, (6, 4)), dev)
    with pytest.raises(ValueError, match="contiguous"):
        ops.xnor_gemm(w, x.T, 128)
