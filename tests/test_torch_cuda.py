"""The CUDA kernels against their plain-torch twins on the card, at
ragged shapes the main path does not reach (M, N, D and C not multiples
of 32, stride 2, no padding; for the megakernels odd batches, masked
tails inside a tile and cluster sizes other than 8). Bit-exact. Every test here needs a GPU and
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


def _stage_inputs(rng, chans, h, w, n, dev):
    """Per-conv tap-aligned filters and affines of a conv stage, and a
    channel-packed input map, on ``dev``."""
    weights, a, b, k_bits = [], [], [], []
    for cin, cout in zip(chans[:-1], chans[1:]):
        weights.append(layers.pack_conv_aligned(
            {"w": cu(pm1(rng, (cout, 3, 3, cin)), dev)})["w_packed"])
        a.append(cu(rng.normal(size=cout).astype(np.float32), dev))
        b.append(cu((rng.normal(size=cout) * 8).astype(np.float32), dev))
        k_bits.append(9 * cin)
    xp = bitops.pack_channels(cu(pm1(rng, (n, h, w, chans[0])), dev))
    return weights, a, b, k_bits, xp


# D of 50, 70, 96 and 192 channels (not multiples of 256; cluster sizes
# 1, 2 and 8), odd batches, non-square maps, one to four convs (four:
# an intermediate buffer is reused at another width).
@pytest.mark.parametrize("chans,h,w,n,pool", [
    ((40, 50, 70), 8, 8, 3, True), ((40, 50, 70), 7, 9, 1, False),
    ((64, 96), 6, 10, 5, True), ((32, 64, 128, 192, 64), 5, 6, 2, False),
    ((256, 256), 4, 4, 3, True)])
def test_megakernel_conv_stage_matches_twin(dev, chans, h, w, n, pool):
    rng = np.random.default_rng(34)
    weights, a, b, k_bits, xp = _stage_inputs(rng, chans, h, w, n, dev)
    before = ops.LAUNCHES["megakernel_conv_stage"]
    got = ops.megakernel_conv_stage(xp, weights, a, b, k_bits, pool=pool)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["megakernel_conv_stage"] == before + 1
    want = bitops.conv_stage_xla(xp, weights, a, b, k_bits, pool=pool)
    assert torch.equal(got, want)


def _chain_inputs(rng, dims, n, dev):
    """Stacked fused layers of a ragged chain and packed activations."""
    fused = []
    for k, m in zip(dims[:-1], dims[1:]):
        kw = -(-k // 32)
        w = np.concatenate([rng.normal(size=(m, k)),
                            -np.ones((m, 32 * kw - k))], axis=1)
        fused.append({"w_packed": bitops.pack_bits(cu(w.astype(np.float32), dev)),
                      "a": cu(rng.normal(size=m).astype(np.float32), dev),
                      "b": cu((rng.normal(size=m) * 4).astype(np.float32), dev)})
    x = np.concatenate([rng.normal(size=(dims[0], n)),
                        np.ones((-dims[0] % 32, n))], axis=0)
    xp = bitops.pack_bits(cu(x.astype(np.float32), dev), axis=0).contiguous()
    return layers.stack_chain_layers(fused), xp


# n_real inside a tile (13 of 16, 1 of 8), odd N, a head of 10 rows, and
# M of 50/40/33 rows (not multiples of 256; cluster sizes 1 and 2).
@pytest.mark.parametrize("dims,n,n_real,head", [
    ((70, 50, 40, 33), 16, 13, False), ((70, 50, 40, 33), 8, 1, True),
    ((100, 64, 64), 5, None, True), ((300, 1024, 1024), 3, None, True)])
def test_megakernel_chain_matches_twin(dev, dims, n, n_real, head):
    rng = np.random.default_rng(35)
    stack, xp = _chain_inputs(rng, dims, n, dev)
    k_bits = tuple(dims[:-1])
    fin = dict(final_wp=cu(words(rng, (10, -(-dims[-1] // 32))), dev),
               final_k_bits=dims[-1]) if head else {}
    before = ops.LAUNCHES["megakernel_chain"]
    if n_real is None:
        got = ops.megakernel_chain(stack["w"], stack["a"], stack["b"], k_bits,
                                   xp, dims[-1], **fin)
        want = bitops.megakernel_chain_xla(stack["w"], stack["a"], stack["b"],
                                           k_bits, xp, dims[-1], **fin)
    else:
        got = ops.megakernel_chain(stack["w"], stack["a"], stack["b"], k_bits,
                                   xp, dims[-1], ragged_tile=ops.RAGGED_TILE_N,
                                   n_real=n_real, **fin)
        want = bitops.megakernel_chain_ragged_xla(
            stack["w"], stack["a"], stack["b"], k_bits, xp, dims[-1], n_real,
            **fin)
        assert not got[:, n_real:].any()
    torch.cuda.synchronize()
    assert ops.LAUNCHES["megakernel_chain"] == before + 1
    assert torch.equal(got, want)


def test_megakernel_wrappers_raise_rather_than_fall_back(dev):
    rng = np.random.default_rng(36)
    weights, a, b, k_bits, xp = _stage_inputs(rng, (32, 32), 5, 5, 1, dev)
    with pytest.raises(ValueError, match="even output map"):
        ops.megakernel_conv_stage(xp, weights, a, b, k_bits, pool=True)
    stack, xp = _chain_inputs(rng, (64, 64), 4, dev)
    with pytest.raises(ValueError, match="n_real needs ragged_tile"):
        ops.megakernel_chain(stack["w"], stack["a"], stack["b"], (64,), xp, 64,
                             n_real=2)
