"""The CUDA kernels against their plain-torch twins on the card, at
ragged shapes the main path does not reach (M, N, D and C not multiples
of 32, stride 2, no padding; for the megakernels odd batches, masked
tails inside a tile and cluster sizes other than 8, the chain at every
served batch with every masked tail, clusters of 1 to 16 CTAs and 1 to 8
layers; ``xnor_gemm`` at Table 2's eight batch-64 products and with K
split; for the unfused
PACKED kernels strided and offset inputs, -0.0 and NaN, bfloat16 and
K not a multiple of the tile; for the scan ragged chunks, channels and
states, and chunk views, and its backward at every state width, chunk
length and ragged di (one launch, two calls bit-identical, states padded
by the caller exactly 0); for flash attention ragged and unequal Sq and
Skv, odd BH, every compiled head width, bf16 and float32; for the mLSTM
chunks of 16 to 256 steps, dk and dv not multiples of the tile).
The BNN's train-to-serve loop on the card: a 20-step ``train_bnn`` that
resumes bit for bit, its export verified on every engine, and every eval
forward computing the first conv alike at batches 1 to 128. The
data-parallel step on replicas sharing the card: one shard equals the
single-device step bit for bit, and sign-SGD over 4 shards replays bit
for bit.
Bit-exact, but for ``unpack_gemm`` on real input, the scan, flash
attention and the mLSTM (tolerances at the tests). The grad guard of the
wrappers and the smoke LM losses on the card against the CPU are here
too, with the three LM kernels differentiated on the card against their
twins on the CPU and the LM launcher's smoke run. Every test here needs a GPU and
``nvcc`` and skips without them; run on the card with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

(``chip_smoke.py`` checks the main path's shapes.) This file imports no
JAX, so it runs where only the port is installed."""

import numpy as np
import pytest
import torch

from repro_torch.core import bitops, layers
from repro_torch.kernels import ops

from torch_parity import CKPT, bf16_ulp, pm1, words

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def cu(x, dev):
    return torch.from_numpy(np.array(x, copy=True)).to(dev)


# The eight products of Table 2's PAPER_KERNEL forward at batch 64 (the
# five im2col convs, fc0 with K split, fc1, the head), the served head at
# batch 32, and ragged ones: K split with M, N and KW off every multiple
# (4-byte loads and stores), M and N of 1, N past a tile by 1, a ragged
# last word (k_bits below 32 KW). Two calls give the same words.
@pytest.mark.parametrize("m,kw,n,short", [
    (128, 36, 65536, 0), (256, 36, 16384, 0), (256, 72, 16384, 0),
    (512, 72, 4096, 0), (512, 144, 4096, 0), (1024, 256, 64, 0),
    (1024, 32, 64, 0), (10, 32, 64, 0), (10, 32, 32, 0), (1000, 250, 61, 7),
    (10, 32, 33, 5), (70, 40, 5, 5), (1, 1, 1, 5), (33, 65, 31, 5),
    (33, 9, 129, 5), (300, 257, 33, 7), (1, 3, 1, 31), (130, 70, 131, 0)])
def test_xnor_gemm_matches_twin(dev, m, kw, n, short):
    from repro_torch.kernels import build

    rng = np.random.default_rng(30)
    w, x = cu(words(rng, (m, kw)), dev), cu(words(rng, (kw, n)), dev)
    k_bits = 32 * kw - short
    if (m, kw, n) in ((1024, 256, 64), (1000, 250, 61)):
        assert build.load("repro_xnor_gemm_splits")(m, kw, n) > 1
    before = ops.LAUNCHES["xnor_gemm"]
    got = ops.xnor_gemm(w, x, k_bits)
    again = ops.xnor_gemm(w, x, k_bits)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["xnor_gemm"] == before + 2
    assert torch.equal(got, bitops.xnor_popcount_matmul(w, x, k_bits))
    assert torch.equal(again, got)


# The seven shapes of the batch-32 forward (fc0, fc1 split K; the five
# im2col convs), a ragged last word (k_bits below 32*KW), and the tile's
# edges (M = 33, N = 1, N = 129, N not a multiple of 4).
@pytest.mark.parametrize("m,kw,n,short", [
    (45, 3, 7, 0), (1024, 32, 3, 0), (10, 70, 40, 0),
    (1024, 256, 32, 0), (1024, 32, 32, 0), (128, 36, 32768, 0),
    (256, 36, 8192, 0), (256, 72, 8192, 0), (512, 72, 2048, 0),
    (512, 144, 2048, 0), (256, 72, 8192, 13), (33, 9, 129, 5), (33, 40, 1, 31),
    (300, 257, 33, 7)])
def test_fused_xnor_gemm_matches_twin(dev, m, kw, n, short):
    rng = np.random.default_rng(31)
    w, x = cu(words(rng, (m, kw)), dev), cu(words(rng, (kw, n)), dev)
    k_bits = 32 * kw - short
    a = cu(rng.normal(size=m).astype(np.float32), dev)
    b = cu((rng.normal(size=m) * 6).astype(np.float32), dev)
    before = ops.LAUNCHES["fused_xnor_gemm"]
    got = ops.fused_xnor_gemm(w, x, k_bits, a, b)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fused_xnor_gemm"] == before + 1
    assert torch.equal(got, bitops.fused_xnor_layer(w, x, k_bits, a, b))


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


def _conv_inputs(rng, c, d, h, w, n, dev):
    wp = layers.pack_conv_aligned({"w": cu(pm1(rng, (d, 3, 3, c)), dev)})["w_packed"]
    xp = bitops.pack_channels(cu(pm1(rng, (n, h, w, c)), dev))
    a = cu(rng.normal(size=d).astype(np.float32), dev)
    b = cu((rng.normal(size=d) * np.sqrt(9 * c) * 0.3).astype(np.float32), dev)
    return wp, xp, a, b


# The tensor-core implicit GEMM: the five convs of the main path at batch
# 3 (CW 4, 4, 8, 8, 16; 128-, 64-wide tiles), a pixel count that is not a
# multiple of any tile width (3 x 7 x 9 = 189), stride 2 with CW % 4 == 0
# and with CW 3, D of 7 (one partial word) and 40.
@pytest.mark.parametrize("c,d,h,w,n,stride,pad", [
    (128, 128, 32, 32, 3, 1, 1), (128, 256, 16, 16, 3, 1, 1),
    (256, 256, 16, 16, 3, 1, 1), (256, 512, 8, 8, 3, 1, 1),
    (512, 512, 8, 8, 3, 1, 1), (128, 96, 7, 9, 3, 1, 1),
    (256, 64, 9, 11, 3, 2, 1), (96, 7, 10, 9, 1, 2, 0), (64, 40, 5, 33, 2, 1, 1)])
def test_fused_direct_conv_tc_shapes(dev, c, d, h, w, n, stride, pad):
    rng = np.random.default_rng(38)
    wp, xp, a, b = _conv_inputs(rng, c, d, h, w, n, dev)
    kw = dict(kh=3, kw=3, stride=stride, pad=pad)
    before = ops.LAUNCHES["fused_direct_conv"]
    got = ops.fused_direct_conv(wp, xp, 9 * c, a, b, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fused_direct_conv"] == before + 1
    want = bitops.direct_conv_oracle(wp, xp, 9 * c, a, b, **kw)
    assert torch.equal(got, want)
    assert got.unique().numel() > 2   # both bit values occur


def test_redesigned_conv_kernels_repeat_exactly(dev):
    """Repeated calls give identical words (no race between the cp.async
    ring, the gather's plain stores, the cluster's exchange and the
    epilogue)."""
    rng = np.random.default_rng(39)
    wp, xp, a, b = _conv_inputs(rng, 256, 512, 8, 8, 8, dev)
    first = ops.fused_direct_conv(wp, xp, 9 * 256, a, b, kh=3, kw=3, pad=1)
    weights, sa, sb, k_bits, sx = _stage_inputs(rng, (128, 256, 256), 16, 16, 8, dev)
    stage = ops.megakernel_conv_stage(sx, weights, sa, sb, k_bits)
    for _ in range(20):
        assert torch.equal(ops.fused_direct_conv(wp, xp, 9 * 256, a, b, kh=3, kw=3,
                                                 pad=1), first)
        assert torch.equal(ops.megakernel_conv_stage(sx, weights, sa, sb, k_bits),
                           stage)
    torch.cuda.synchronize()


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


# D of 50, 70, 96 and 192 channels (not multiples of 256; channel groups
# of 1, 2, 4 and 8 CTAs), odd batches, non-square maps, one to four convs (four:
# an intermediate buffer is reused at another width); the main path's
# three stages at batch 3, a four-conv stage of CW 4 (ldmatrix B
# fragments throughout) and pixel counts that are not a multiple of the
# 16-pixel unit (7 x 9, 5 x 6, 6 x 10).
@pytest.mark.parametrize("chans,h,w,n,pool", [
    ((40, 50, 70), 8, 8, 3, True), ((40, 50, 70), 7, 9, 1, False),
    ((64, 96), 6, 10, 5, True), ((32, 64, 128, 192, 64), 5, 6, 2, False),
    ((256, 256), 4, 4, 3, True), ((128, 128), 32, 32, 3, True),
    ((128, 256, 256), 16, 16, 3, True), ((256, 512, 512), 8, 8, 3, True),
    ((128, 128, 128, 128, 128), 6, 10, 3, True), ((256, 256, 512), 7, 9, 2, False)])
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


def _chain_case(rng, dims, n, head_words, dev):
    stack, xp = _chain_inputs(rng, dims, n, dev)
    fin = {}
    if head_words:
        fin = dict(final_wp=cu(words(rng, (10, head_words)), dev),
                   final_k_bits=32 * head_words - 3)
    return stack, xp, fin


def _chain_check(stack, xp, dims, n_real, fin):
    k_bits = tuple(dims[:-1])
    got = ops.megakernel_chain(stack["w"], stack["a"], stack["b"], k_bits, xp,
                               dims[-1], ragged_tile=ops.RAGGED_TILE_N,
                               n_real=n_real, **fin)
    want = bitops.megakernel_chain_ragged_xla(stack["w"], stack["a"], stack["b"],
                                              k_bits, xp, dims[-1], n_real, **fin)
    torch.cuda.synchronize()
    assert torch.equal(got, want), n_real
    return got


# The CIFAR trunk (fc0 8192 -> 1024, fc1 1024 -> 1024, head [10, 32]) at
# every served batch and 64 (two clusters), each with every masked tail of
# its last n tile.
@pytest.mark.parametrize("n", [8, 16, 24, 32, 64])
def test_megakernel_chain_every_tail(dev, n):
    rng = np.random.default_rng(38)
    dims = (8192, 1024, 1024)
    stack, xp, fin = _chain_case(rng, dims, n, 32, dev)
    before = ops.LAUNCHES["megakernel_chain"]
    for n_real in range(n - 7, n + 1):
        got = _chain_check(stack, xp, dims, n_real, fin)
        assert not got[:, n_real:].any()
    assert ops.LAUNCHES["megakernel_chain"] == before + 8


# M_max of 32 to 2048 words-of-32 rows: clusters of 1, 2, 4, 8 and 16
# CTAs (1024 and 2048: 64 and 128 rows a CTA), 3 words (a cluster of 1
# with 96 rows); heads over the computed words, fewer of them, or past
# M_max/32 (all-ones words); 24 columns and 64 (two clusters).
@pytest.mark.parametrize("dims,head", [
    ((100, 32), 1), ((300, 64, 64), 2), ((200, 128), 0), ((500, 256, 256), 8),
    ((700, 512), 16), ((1000, 2048, 2048), 64), ((70, 96, 40), 2),
    ((700, 64), 22), ((2000, 1024, 1000), 30)])
@pytest.mark.parametrize("n,n_real", [(24, 21), (64, 64)])
def test_megakernel_chain_cluster_shapes(dev, dims, head, n, n_real):
    rng = np.random.default_rng(39)
    stack, xp, fin = _chain_case(rng, dims, n, head, dev)
    _chain_check(stack, xp, dims, n_real, fin)


# 1 to 8 stacked layers of ragged widths, with and without the head.
@pytest.mark.parametrize("n_layers", range(1, 9))
def test_megakernel_chain_every_depth(dev, n_layers):
    rng = np.random.default_rng(40 + n_layers)
    dims = (300,) + tuple(int(d) for d in rng.integers(40, 600, size=n_layers))
    for head in (0, -(-dims[-1] // 32)):
        stack, xp, fin = _chain_case(rng, dims, 16, head, dev)
        _chain_check(stack, xp, dims, 13, fin)


def test_megakernel_chain_repeats_exactly(dev):
    rng = np.random.default_rng(48)
    dims = (8192, 1024, 1024)
    stack, xp, fin = _chain_case(rng, dims, 32, 32, dev)
    first = _chain_check(stack, xp, dims, 32, fin)
    for _ in range(3):
        assert torch.equal(_chain_check(stack, xp, dims, 32, fin), first)
    stack, xp, _ = _chain_case(rng, dims, 32, 0, dev)
    words_first = _chain_check(stack, xp, dims, 30, {})
    assert torch.equal(_chain_check(stack, xp, dims, 30, {}), words_first)


def test_megakernel_wrappers_raise_rather_than_fall_back(dev):
    rng = np.random.default_rng(36)
    weights, a, b, k_bits, xp = _stage_inputs(rng, (32, 32), 5, 5, 1, dev)
    with pytest.raises(ValueError, match="even output map"):
        ops.megakernel_conv_stage(xp, weights, a, b, k_bits, pool=True)
    stack, xp = _chain_inputs(rng, (64, 64), 4, dev)
    with pytest.raises(ValueError, match="n_real needs ragged_tile"):
        ops.megakernel_chain(stack["w"], stack["a"], stack["b"], (64,), xp, 64,
                             n_real=2)


# pack_rows on the K-contiguous transposed patch matrix: odd N, K of one
# word and K not a multiple of the kernel's 8 words per warp, a sliced
# view with a storage offset and a row stride past K.
@pytest.mark.parametrize("k,n,layout", [
    (32, 1, "transposed"), (96, 33, "transposed"), (1056, 5, "transposed"),
    (32, 7, "transposed"), (288, 333, "transposed"), (8192, 3, "transposed"),
    (160, 40, "sliced")])
def test_pack_rows_matches_twin(dev, k, n, layout):
    rng = np.random.default_rng(37)
    base = rng.normal(size=(n + 3, k + 64)).astype(np.float32)
    base.reshape(-1)[::11] = 0.0
    base.reshape(-1)[::13] = -0.0    # sets the bit, as x >= 0 does
    base.reshape(-1)[::17] = np.nan  # clears it
    x = cu(base, dev)
    if layout == "transposed":
        x = x[:n, :k].contiguous().T          # [K, N] view, K-contiguous
    else:
        x = x[1:n + 1, 32:32 + k].T           # offset view, row stride K+64
    before = ops.LAUNCHES["pack_rows"]
    got = ops.pack_rows(x)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["pack_rows"] == before + 1
    assert got.is_contiguous() and got.shape == (k // 32, n)
    assert torch.equal(got, bitops.pack_bits(x, axis=0))


# direct_conv: D < 32 and D not a multiple of 32, C not a multiple of 32,
# stride 2, no padding.
@pytest.mark.parametrize("c,d,h,stride,pad", [(32, 7, 6, 1, 1), (45, 40, 7, 2, 0),
                                              (96, 70, 5, 1, 1)])
def test_direct_conv_matches_twin(dev, c, d, h, stride, pad):
    rng = np.random.default_rng(38)
    wp = layers.pack_conv_aligned({"w": cu(pm1(rng, (d, 3, 3, c)), dev)})["w_packed"]
    xp = bitops.pack_channels(cu(pm1(rng, (3, h, h + 1, c)), dev))
    kw = dict(kh=3, kw=3, stride=stride, pad=pad)
    before = ops.LAUNCHES["direct_conv"]
    got = ops.direct_conv(wp, xp, 9 * c, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["direct_conv"] == before + 1
    assert torch.equal(got, bitops.direct_conv_dot(wp, xp, 9 * c, **kw))


# direct_conv on the tensor-core implicit GEMM: the five convs of Table 2's
# DIRECT_KERNEL forward at its batch of 64 (128-wide tiles, 16-byte
# stores), and a map 1200 pixels wide at CW 16, whose three padded rows
# (230 KB) the popc kernel staged in shared memory and so refused.
@pytest.mark.parametrize("c,d,h,w,n", [
    (128, 128, 32, 32, 64), (128, 256, 16, 16, 64), (256, 256, 16, 16, 64),
    (256, 512, 8, 8, 64), (512, 512, 8, 8, 64), (512, 40, 3, 1200, 1)])
def test_direct_conv_tc_shapes(dev, c, d, h, w, n):
    rng = np.random.default_rng(43)
    wp = layers.pack_conv_aligned({"w": cu(pm1(rng, (d, 3, 3, c)), dev)})["w_packed"]
    xp = bitops.pack_channels(cu(pm1(rng, (n, h, w, c)), dev))
    kw = dict(kh=3, kw=3, stride=1, pad=1)
    before = ops.LAUNCHES["direct_conv"]
    got = ops.direct_conv(wp, xp, 9 * c, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["direct_conv"] == before + 1
    assert torch.equal(got, bitops.direct_conv_dot(wp, xp, 9 * c, **kw))


def test_direct_conv_repeats_exactly(dev):
    """Repeated calls give identical dots (no race between the cp.async
    ring, the gather's plain stores and the epilogue's reads of the staged
    counts), at conv1's shape, the widest output."""
    rng = np.random.default_rng(44)
    wp = layers.pack_conv_aligned({"w": cu(pm1(rng, (128, 3, 3, 128)), dev)})["w_packed"]
    xp = bitops.pack_channels(cu(pm1(rng, (64, 32, 32, 128)), dev))
    first = ops.direct_conv(wp, xp, 9 * 128, kh=3, kw=3, pad=1)
    for _ in range(20):
        assert torch.equal(ops.direct_conv(wp, xp, 9 * 128, kh=3, kw=3, pad=1), first)
    torch.cuda.synchronize()


# unpack_gemm: M and N not multiples of the 128 x 64 tile, one K word, odd KW;
# ±1/0 input exact; real float32 input within the JAX package's tolerance
# for its kernel (tests/test_kernels.py, rtol 1e-5, atol 1e-4); bfloat16
# within its bfloat16 tolerance (rtol 2e-2, atol 2e-1) against the float32
# dot of the same bfloat16 values.
@pytest.mark.parametrize("m,kw,n,layout", [(10, 32, 33, "rows"),
                                           (70, 3, 5, "transposed"),
                                           (1, 1, 1, "rows"),
                                           (130, 9, 200, "transposed")])
def test_unpack_gemm_matches_twin(dev, m, kw, n, layout):
    rng = np.random.default_rng(39)
    wp = cu(words(rng, (m, kw)), dev)
    k = 32 * kw

    def operand(a):
        x = cu(a.astype(np.float32), dev)
        return x.T.contiguous().T if layout == "transposed" else x

    ternary = operand(rng.integers(-1, 2, size=(k, n)))
    got = ops.unpack_gemm(wp, ternary)
    torch.cuda.synchronize()
    assert torch.equal(got, bitops.packed_matmul_unpack(
        wp, ternary, compute_dtype=torch.float32))
    real = operand(rng.normal(size=(k, n)))
    torch.testing.assert_close(
        ops.unpack_gemm(wp, real),
        bitops.packed_matmul_unpack(wp, real, compute_dtype=torch.float32),
        rtol=1e-5, atol=1e-4)
    half = real.to(torch.bfloat16)
    before = ops.LAUNCHES["unpack_gemm"]
    got = ops.unpack_gemm(wp, half)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["unpack_gemm"] == before + 1
    torch.testing.assert_close(
        got, bitops.packed_matmul_unpack(wp, half, compute_dtype=torch.bfloat16),
        rtol=2e-2, atol=2e-1)


# unpack_gemm at the split-K shapes (the output tiles cannot fill the
# card): fc0 at batch 64 (packed W [1024, 256], float32 X [8192, 64]) and
# jamba's decode (packed W [8192, 256], bf16 X [8192, 4]), each as the
# layers pass X (the transposed activations, unit stride along K) and
# contiguous. ±1/0 input exact; real input within rtol 1e-5 / atol 1e-4 of
# the float64 dot of the same values (the bf16 products are exact).
@pytest.mark.parametrize("m,kw,n,dtype", [(1024, 256, 64, torch.float32),
                                          (8192, 256, 4, torch.bfloat16)])
@pytest.mark.parametrize("layout", ["transposed", "rows"])
def test_unpack_gemm_split_k_shapes(dev, m, kw, n, dtype, layout):
    rng = np.random.default_rng(42)
    wp = cu(words(rng, (m, kw)), dev)
    k = 32 * kw

    def operand(a):
        x = cu(a.astype(np.float32), dev).to(dtype)
        return x.T.contiguous().T if layout == "transposed" else x

    ternary = operand(rng.integers(-1, 2, size=(k, n)))
    before = ops.LAUNCHES["unpack_gemm"]
    got = ops.unpack_gemm(wp, ternary)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["unpack_gemm"] == before + 1
    assert torch.equal(got, bitops.packed_matmul_unpack(
        wp, ternary, compute_dtype=dtype))
    real = operand(rng.uniform(-1, 1, size=(k, n)))
    want = bitops.packed_matmul_unpack(wp, real, compute_dtype=dtype,
                                       accum_dtype=torch.float64)
    torch.testing.assert_close(ops.unpack_gemm(wp, real).double(), want,
                               rtol=1e-5, atol=1e-4)


# Two calls on the same real input give bit-equal results: the split-K
# partials are added in a fixed order, no atomics.
@pytest.mark.parametrize("m,kw,n", [(1024, 256, 64), (10, 32, 64),
                                    (256, 72, 4096)])
def test_unpack_gemm_is_deterministic(dev, m, kw, n):
    rng = np.random.default_rng(43)
    wp = cu(words(rng, (m, kw)), dev)
    x = cu(rng.normal(size=(n, 32 * kw)).astype(np.float32), dev).T
    first = ops.unpack_gemm(wp, x)
    second = ops.unpack_gemm(wp, x)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


# The unfused PACKED layers on the card against the same layers on the
# CPU: K not a multiple of 32 (n_pad > 0: the xnor engine's +1 pad and
# correction, the unpack engine's zero pad), every engine and conv_impl.
@pytest.mark.parametrize("engine,conv_impl", [("xnor", "im2col"),
                                              ("xnor", "direct"),
                                              ("unpack", "im2col"),
                                              ("xla", "im2col")])
def test_packed_layers_match_the_cpu(dev, engine, conv_impl):
    from repro_torch.core.binarize import QuantMode

    rng = np.random.default_rng(40)
    cfg = layers.BitLinearConfig(mode=QuantMode.PACKED, engine=engine,
                                 conv_impl=conv_impl)
    lin = {"w": rng.normal(size=(45, 70)).astype(np.float32),
           "b": rng.normal(size=45).astype(np.float32)}
    conv = {"w": rng.normal(size=(40, 3, 3, 32)).astype(np.float32),
            "b": rng.normal(size=40).astype(np.float32)}
    x_lin = rng.normal(size=(9, 70)).astype(np.float32)
    x_conv = rng.normal(size=(2, 6, 7, 32)).astype(np.float32)
    for params, x, run in (
            (layers.pack_linear_params, x_lin,
             lambda p, x: layers.bit_linear(p, x, cfg)),
            (layers.pack_conv_params, x_conv,
             lambda p, x: layers.bit_conv2d(p, x, cfg, stride=1, pad=1, kh=3,
                                            kw=3))):
        want = run(params({k: torch.from_numpy(v) for k, v in
                           (lin if x is x_lin else conv).items()}),
                   torch.from_numpy(x))
        got = run(params({k: cu(v, dev) for k, v in
                          (lin if x is x_lin else conv).items()}), cu(x, dev))
        assert torch.equal(got.cpu(), want)


def test_unfused_wrappers_raise_rather_than_fall_back(dev):
    rng = np.random.default_rng(41)
    with pytest.raises(TypeError, match="float32"):
        ops.pack_rows(cu(rng.normal(size=(64, 4)), dev))       # float64
    with pytest.raises(ValueError, match="multiple of 32"):
        ops.pack_rows(cu(rng.normal(size=(48, 4)).astype(np.float32), dev))
    with pytest.raises(ValueError, match="unit stride along K"):
        ops.pack_rows(cu(rng.normal(size=(64, 4)).astype(np.float32), dev))
    wp = cu(words(rng, (8, 2)), dev)
    with pytest.raises(ValueError, match="rows, expected KW"):
        ops.unpack_gemm(wp, cu(rng.normal(size=(63, 4)).astype(np.float32), dev))
    with pytest.raises(ValueError, match="different devices"):
        ops.unpack_gemm(wp, torch.zeros((64, 4)))


# The selective-scan chunk: C of 1, 37 and 256 steps, batch 1 and 3, di
# not a multiple of the 128-lane block, ds of 5 to 32 (padded to the
# kernel's width), h0 != 0, and chunk views of a longer sequence (batch
# stride S*di) with B, C as column slices, read in place. The state
# update rounds as the twin's; y sums over n in another order: rtol/atol
# 1e-5.
@pytest.mark.parametrize("b,c,di,ds,view", [
    (1, 1, 200, 16, False), (3, 37, 16480, 16, True), (1, 256, 300, 8, True),
    (3, 256, 129, 5, False), (3, 37, 64, 32, True)])
def test_ssm_scan_chunk_matches_twin(dev, b, c, di, ds, view):
    from repro_torch.kernels.ref import ssm_scan_chunk_ref

    rng = np.random.default_rng(42)

    def normal(*shape, scale=1.0):
        return cu((rng.normal(size=shape) * scale).astype(np.float32), dev)

    s = 2 * c + 3 if view else c
    sl = slice(c, 2 * c) if view else slice(0, c)
    dt = torch.nn.functional.softplus(normal(b, s, di))[:, sl]
    xh = normal(b, s, di)[:, sl]
    bc = normal(b, s, 7 + 2 * ds)[:, sl]
    bm, cm = bc[..., 7:7 + ds], bc[..., 7 + ds:]
    a = -torch.exp(normal(di, ds, scale=0.5))
    h0 = normal(b, di, ds, scale=0.1)
    before = ops.LAUNCHES["ssm_scan_chunk"]
    y, h = ops.ssm_scan_chunk(dt, xh, bm, cm, a, h0)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ssm_scan_chunk"] == before + 1
    y_ref, h_ref = ssm_scan_chunk_ref(dt, xh, bm, cm, a, h0)
    torch.testing.assert_close(y, y_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(h, h_ref, rtol=1e-5, atol=1e-5)


# Every compiled state width (ds 5 and 8 on one lane a channel, 16 on 2,
# 32 on 4) at C 1, 37 and 256, di 330 (not a multiple of any block's 64 to
# 256 channels), B and C column slices at an odd column offset (4-byte
# copies) or a 16-byte aligned one.
@pytest.mark.parametrize("ds", [5, 8, 16, 32])
@pytest.mark.parametrize("c", [1, 37, 256])
def test_ssm_scan_chunk_every_width(dev, c, ds):
    from repro_torch.kernels.ref import ssm_scan_chunk_ref

    rng = np.random.default_rng(45 + ds + c)

    def normal(*shape, scale=1.0):
        return cu((rng.normal(size=shape) * scale).astype(np.float32), dev)

    b, di, off = 2, 330, 3 if c % 2 else 4
    dt = torch.nn.functional.softplus(normal(b, c, di))
    xh = normal(b, c, di)
    bc = normal(b, c, off + 2 * ds)
    bm, cm = bc[..., off:off + ds], bc[..., off + ds:]
    a = -torch.exp(normal(di, ds, scale=0.5))
    h0 = normal(b, di, ds, scale=0.1)
    y, h = ops.ssm_scan_chunk(dt, xh, bm, cm, a, h0)
    torch.cuda.synchronize()
    y_ref, h_ref = ssm_scan_chunk_ref(dt, xh, bm, cm, a, h0)
    torch.testing.assert_close(y, y_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(h, h_ref, rtol=1e-5, atol=1e-5)


def test_scan_wrapper_raises_rather_than_fall_back(dev):
    x = torch.zeros((1, 4, 8), device=dev)
    with pytest.raises(ValueError, match="at most 32 states"):
        ops.ssm_scan_chunk(x, x, torch.zeros((1, 4, 33), device=dev),
                           torch.zeros((1, 4, 33), device=dev),
                           torch.zeros((8, 33), device=dev),
                           torch.zeros((1, 8, 33), device=dev))
    with pytest.raises(ValueError, match="unit stride"):
        ops.ssm_scan_chunk(x.transpose(1, 2).contiguous().transpose(1, 2), x,
                           x[..., :4], x[..., :4], torch.zeros((8, 4), device=dev),
                           torch.zeros((1, 8, 4), device=dev))
    # and its backward, called directly
    dy, wide = torch.zeros((1, 4, 8), device=dev), torch.zeros((1, 4, 33), device=dev)
    with pytest.raises(ValueError, match="at most 32 states"):
        ops.ssm_scan_chunk_bwd(x, x, wide, wide, torch.zeros((8, 33), device=dev),
                               torch.zeros((1, 8, 33), device=dev), dy,
                               torch.zeros((1, 8, 33), device=dev))
    narrow = torch.zeros((1, 8, 4), device=dev)
    with pytest.raises(ValueError, match="unit stride"):
        ops.ssm_scan_chunk_bwd(x.transpose(1, 2).contiguous().transpose(1, 2), x,
                               x[..., :4], x[..., :4], torch.zeros((8, 4), device=dev),
                               narrow, dy, narrow)
    with pytest.raises(ValueError, match="unit stride"):
        ops.ssm_scan_chunk_bwd(x, x, x[..., ::2], x[..., ::2],
                               torch.zeros((8, 4), device=dev), narrow, dy, narrow)


def test_jamba_smoke_serving_matches_the_cpu(dev):
    """The smoke jamba (float32) served on the card, through the scan
    kernel, against the CPU (its twin) on the same packed params: a
    2 x 512 prefill (two chunks) and two decode steps teacher-forced
    with the CPU's tokens; float32 sums in other orders through 4
    layers: logits within rtol/atol 1e-4."""
    from repro_torch.configs.base import serve_policy, smoke_config
    from repro_torch.models.model_factory import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    model = build_model(smoke_config("jamba-1.5-large-398b"), serve_policy())
    params = model.init_packed(torch.Generator().manual_seed(5))

    def to(tree, d):
        if isinstance(tree, dict):
            return {k: to(v, d) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, d) for v in tree]
        return tree.to(d)

    prompts = torch.randint(0, 512, (2, 512), generator=torch.Generator().manual_seed(5))
    out = {}
    tokens = []
    for d in ("cpu", dev):
        p = to(params, d)
        state = model.init_state(2, 515, dtype=torch.float32, device=d)
        before = ops.LAUNCHES["ssm_scan_chunk"]
        with torch.inference_mode():
            logits, state = model.prefill(p, state, {"tokens": prompts.to(d)})
            steps = [logits.cpu()]
            for i in range(2):
                if d == "cpu":
                    tokens.append(logits.argmax(-1)[:, None])
                logits, state = model.decode_step(p, state,
                                                  {"tokens": tokens[i].to(d)})
                steps.append(logits.cpu())
        out[str(d)] = steps
        launched = ops.LAUNCHES["ssm_scan_chunk"] - before
        assert launched == (0 if d == "cpu" else 2 * state["mamba"]["h"].shape[0])
    for got, want in zip(out[str(dev)], out["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


# Flash attention against its twin with the kernel's KV tile (block_kv =
# FLASH_TILE), which rounds where the kernel rounds: float32 within
# rtol/atol 1e-5 (dot products and sums in another order); bf16 within
# one bf16 ulp of the largest output of its row. Not of each element: a
# score that moves by a float32 ulp (the tensor cores sum q . k in
# another order than cuBLAS) can flip p's rounding to bf16, which moves
# the row by up to 2^-8 p_j |v_j| / l, a step at the scale of the row's
# values, not of an output element that cancels to near 0. Each output is
# also held within 32 bf16 ulps of its own (taken at 2^-8 below it), and
# at most 0.1% of the outputs may be past one: chip_smoke.py's
# FLASH_ELEM_ULPS and FLASH_PAST_SHARE.
@pytest.mark.parametrize("bh,sq,skv,dh,dtype,causal", [
    (3, 100, 100, 64, torch.bfloat16, True),
    (2, 256, 256, 128, torch.bfloat16, True),
    (1, 64, 192, 32, torch.bfloat16, False),
    (5, 130, 130, 16, torch.float32, True),
    (2, 64, 128, 64, torch.float32, True),
    (3, 77, 45, 32, torch.float32, False),
    (60, 512, 512, 64, torch.bfloat16, True),
    # one row past and one short of the bf16 kernel's 128-row block
    (2, 129, 129, 64, torch.bfloat16, True),
    (2, 255, 255, 64, torch.bfloat16, True),
    # Skv != Sq, full attention, Dh 128
    (3, 200, 333, 128, torch.bfloat16, False),
    # several key tiles per block, every block crossing the diagonal
    (60, 1024, 1024, 64, torch.bfloat16, True)])
def test_flash_attention_matches_twin(dev, bh, sq, skv, dh, dtype, causal):
    from repro_torch.kernels.ref import flash_attention_ref

    rng = np.random.default_rng(50)
    q, k, v = (cu(rng.normal(size=(bh, s, dh)).astype(np.float32), dev).to(dtype)
               for s in (sq, skv, skv))
    before = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    want = flash_attention_ref(q, k, v, causal=causal, block_kv=ops.FLASH_TILE)
    assert got.dtype == dtype and got.shape == want.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        diff = (got.float() - want.float()).abs()
        ulp = bf16_ulp(want.float().abs().amax(-1, keepdim=True))
        assert bool((diff <= ulp).all()), float((diff / ulp).max())
        own = diff / bf16_ulp(want.float())
        assert float(own.max()) <= 32, float(own.max())
        assert int((own > 1).sum()) <= 1e-3 * own.numel(), int((own > 1).sum())


# The mLSTM against its twin: float32 sums in other orders over dk and the
# chunk (y, C, n within rtol/atol 1e-4); the stabilizer m takes the same
# float operations in the same order (a sequential cumsum, maxima, one
# add per chunk): equal.
def mlstm_inputs(dev, bh, s, dk, dv, seed=51):
    rng = np.random.default_rng(seed)
    q = cu((rng.normal(size=(bh, s, dk)) * dk ** -0.5).astype(np.float32), dev)
    k = cu(rng.normal(size=(bh, s, dk)).astype(np.float32), dev)
    v = cu(rng.normal(size=(bh, s, dv)).astype(np.float32), dev)
    logi = cu(rng.normal(size=(bh, s)).astype(np.float32), dev)
    logf = torch.nn.functional.logsigmoid(
        cu((rng.normal(size=(bh, s)) + 2).astype(np.float32), dev))
    return q, k, v, logi, logf


# Besides the narrow cases: several chunks at full width (the states
# buffer and every tile), 12 chunks of 8 steps at narrow dims, a dv that
# is not a multiple of the kernel's 128-column tile, a chunk between 128
# and 256 (ragged diagonal tiles past the first row tile) and a dk past
# 1024 that is not a multiple of the 128-row tile.
@pytest.mark.parametrize("bh,s,dk,dv,chunk", [
    (2, 64, 32, 32, 16), (3, 96, 48, 20, 32), (1, 512, 64, 96, 256),
    (2, 512, 1024, 64, 256), (1, 40, 36, 44, 8), (2, 1024, 1024, 1024, 256),
    (1, 96, 40, 12, 8), (1, 512, 200, 1000, 256), (1, 384, 64, 72, 192),
    (1, 128, 1100, 36, 64)])
def test_mlstm_chunked_matches_twin(dev, bh, s, dk, dv, chunk):
    from repro_torch.kernels.ref import mlstm_chunked_ref

    q, k, v, logi, logf = mlstm_inputs(dev, bh, s, dk, dv)
    before = ops.LAUNCHES["mlstm_chunked"]
    got = ops.mlstm_chunked(q, k, v, logi, logf, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["mlstm_chunked"] == before + 1
    want = mlstm_chunked_ref(q, k, v, logi, logf, chunk=chunk)
    for g, w in zip(got[:3], want[:3]):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    assert torch.equal(got[3], want[3])


def test_mlstm_chunked_is_deterministic(dev):
    """No atomics, no order that depends on scheduling: two calls on the
    same input give the same bits."""
    args = mlstm_inputs(dev, 2, 1024, 256, 384, seed=52)
    first = ops.mlstm_chunked(*args, chunk=256)
    second = ops.mlstm_chunked(*args, chunk=256)
    for g, w in zip(first, second):
        assert torch.equal(g, w)


# The two backward kernels against their twins on the card, on the saved
# tensors the forward kernel gives (flash's output and row log-sum-exp,
# the mLSTM's chunk states): float32 within rtol 1e-4 of each element plus
# atol 2e-5 of the gradient's largest magnitude, bf16 within 2 bf16 ulps
# of it (chip_smoke.py's BWD_F32_TOL, BWD_BF16_ULPS: sums in other
# orders; a p or dS that rounds to the neighbouring bf16 value). Two calls
# on the same inputs give the same bits (no atomics; fixed-order sums).
def _bwd_within(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert bool(torch.isfinite(g).all())
        diff = (g.float() - w.float()).abs()
        scale = float(w.float().abs().max()) or 1.0
        if g.dtype == torch.bfloat16:
            limit = 2 * float(bf16_ulp(torch.tensor(scale)))
            assert float(diff.max()) <= limit, (float(diff.max()), limit)
        else:
            bad = diff > 1e-4 * w.abs() + 2e-5 * scale
            assert not bool(bad.any()), (float(diff.max()), scale)


def _repeats_exactly(run):
    first = [t.clone() for t in run()]
    for a, b in zip(first, run()):
        assert torch.equal(a, b)


# Every compiled head width, causal and full, bf16 and float32, at Sq ==
# Skv off every tile (200), Sq < Skv and Sq > Skv, ragged against the
# 32-, 64- and 128-row tiles of both types.
@pytest.mark.parametrize("bh,sq,skv", [(3, 200, 200), (2, 100, 260), (2, 330, 70)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
def test_flash_attention_bwd_matches_twin(dev, bh, sq, skv, dh, dtype, causal):
    from repro_torch.kernels.ref import flash_attention_bwd_ref

    rng = np.random.default_rng(55)
    q, k, v = (cu(rng.normal(size=(bh, s, dh)).astype(np.float32), dev).to(dtype)
               for s in (sq, skv, skv))
    do = cu(rng.normal(size=(bh, sq, dh)).astype(np.float32), dev).to(dtype)
    o, lse = ops._flash_forward(q, k, v, causal)
    before = ops.LAUNCHES["flash_attention_bwd"]

    def run():
        return ops.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)

    got = run()
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention_bwd"] == before + 1
    _bwd_within(got, flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal))
    _repeats_exactly(run)


# Chunks of 8, 64 and 256 steps, one chunk and several, dk != dv (and
# neither a multiple of the 128-wide tile), with the final state's dC, dn
# given and absent.
@pytest.mark.parametrize("bh,s,dk,dv,chunk", [
    (2, 8, 16, 12, 8), (2, 96, 20, 36, 8), (1, 64, 48, 64, 64),
    (2, 256, 72, 40, 64), (1, 256, 132, 96, 256), (1, 768, 64, 200, 256)])
@pytest.mark.parametrize("final", [True, False])
def test_mlstm_chunked_bwd_matches_twin(dev, bh, s, dk, dv, chunk, final):
    from repro_torch.kernels.ref import mlstm_chunked_bwd_ref

    q, k, v, logi, logf = mlstm_inputs(dev, bh, s, dk, dv, seed=56)
    y, _, _, _, states, nstates = ops._mlstm_forward(q, k, v, logi, logf, chunk)
    rng = np.random.default_rng(57)
    dy = cu(rng.normal(size=(bh, s, dv)).astype(np.float32), dev)
    dC = dn = None
    if final:
        dC = cu((1e-2 * rng.normal(size=(bh, dk, dv))).astype(np.float32), dev)
        dn = cu((1e-2 * rng.normal(size=(bh, 1, dk))).astype(np.float32), dev)
    args = (q, k, v, logi, logf, y, states, nstates, dy, dC, dn)
    before = ops.LAUNCHES["mlstm_chunked_bwd"]

    def run():
        return ops.mlstm_chunked_bwd(*args, chunk=chunk)

    got = run()
    torch.cuda.synchronize()
    assert ops.LAUNCHES["mlstm_chunked_bwd"] == before + 1
    _bwd_within(got, mlstm_chunked_bwd_ref(*args, chunk=chunk))
    _repeats_exactly(run)


# The scan's backward at B 1 and 3, C 1, 37, 64 and 256 (segments of the
# kernel's K steps, a short last one, and one step), every state width up
# to 32 (ds 1, 8, 13 and 24 padded to the compiled 16 or 32), di of 1000,
# 300 and 50 (under one block; 50 also breaks the 16-byte copies), read as
# the mamba layer hands the operands over: dt and x chunk views of a longer
# sequence, B and C column slices of an x_proj output (at an odd column
# offset for odd C: 4-byte copies), h0 != 0. Each case: within
# _bwd_within of the twin, one launch, two calls bit-identical; and with
# A, B, C, h0 and dh_last zero-padded to the compiled width by the caller,
# the padded states' gradients exactly 0 and the others the same bits.
@pytest.mark.parametrize("di", [1000, 300, 50])
@pytest.mark.parametrize("ds", [1, 8, 13, 16, 24, 32])
@pytest.mark.parametrize("c", [1, 37, 64, 256])
@pytest.mark.parametrize("b", [1, 3])
def test_ssm_scan_chunk_bwd_matches_twin(dev, b, c, di, ds):
    from repro_torch.kernels.ref import ssm_scan_chunk_bwd_ref

    rng = np.random.default_rng(58 + b + c + di + ds)

    def normal(*shape, scale=1.0):
        return cu((rng.normal(size=shape) * scale).astype(np.float32), dev)

    seq, r = c + 5, 7 if c % 2 else 8
    dt = torch.nn.functional.softplus(normal(b, seq, di))[:, 5:]
    xh = normal(b, seq, di)[:, 5:]
    bc = normal(b, seq, r + 2 * ds)[:, 5:]
    bm, cm = bc[..., r:r + ds], bc[..., r + ds:]
    a = -torch.arange(1, ds + 1, dtype=torch.float32, device=dev).expand(di, ds) * (
        1 + 0.1 * normal(di, ds).abs())
    h0 = normal(b, di, ds, scale=0.1)
    dy, dh_last = normal(b, c, di), normal(b, di, ds)
    args = (dt, xh, bm, cm, a.contiguous(), h0)
    before = ops.LAUNCHES["ssm_scan_chunk_bwd"]

    def run():
        return ops.ssm_scan_chunk_bwd(*args, dy, dh_last)

    got = run()
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ssm_scan_chunk_bwd"] == before + 1
    _bwd_within(got, ssm_scan_chunk_bwd_ref(*args, dy, dh_last))
    _repeats_exactly(run)
    width = 16 if ds <= 16 else 32
    if ds == width:
        return
    padded = [torch.nn.functional.pad(x, (0, width - ds))
              for x in (bm, cm, args[4], h0, dh_last)]
    out = ops.ssm_scan_chunk_bwd(dt, xh, *padded[:4], dy, padded[4])
    for g, p in zip(got, out):
        assert torch.equal(p[..., :g.shape[-1]], g)
    for p in out[2:]:
        assert not bool(p[..., ds:].any())


# The scan backward writes nothing outside its outputs and its scratch: the
# launcher called on buffers between guard regions of a sentinel, at both
# compiled widths, one step, a chunk whose last segment is short (37) and
# whole segments (64), B 3 (the batch rows' d a in the scratch).
@pytest.mark.parametrize("ds", [8, 24])
@pytest.mark.parametrize("c", [1, 37, 64])
def test_ssm_scan_chunk_bwd_writes_only_its_buffers(dev, c, ds):
    import ctypes

    from repro_torch.kernels import build

    rng = np.random.default_rng(59 + c + ds)
    b, di, guard, mark = 3, 300, 4096, 12345.5

    def normal(*shape):
        return cu(rng.normal(size=shape).astype(np.float32), dev)

    dt = torch.nn.functional.softplus(normal(b, c, di))
    xh, bm, cm = normal(b, c, di), normal(b, c, ds), normal(b, c, ds)
    a = -torch.exp(normal(di, ds))
    h0, dy, dh_last = normal(b, di, ds), normal(b, c, di), normal(b, di, ds)
    floats = (ctypes.c_longlong * 1)()
    assert build.load("repro_ssm_scan_chunk_bwd_scratch")(b, c, di, ds, floats) == 0
    sizes = (b * c * di, b * c * di, b * c * ds, b * c * ds, di * ds, b * di * ds, floats[0])
    bufs = [torch.full((n + 2 * guard,), mark, device=dev) for n in sizes]
    rc = build.load("repro_ssm_scan_chunk_bwd")(
        *(t.data_ptr() for t in (dt, xh, bm, cm, a, h0, dy, dh_last)),
        *(buf[guard:].data_ptr() for buf in bufs), b, c, di, ds, dt.stride(0), dt.stride(1),
        xh.stride(0), xh.stride(1), bm.stride(0), bm.stride(1), cm.stride(0), cm.stride(1),
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0
    for n, buf in zip(sizes, bufs):
        assert bool((buf[:guard] == mark).all()) and bool((buf[guard + n:] == mark).all()), n


def test_flash_and_mlstm_wrappers_raise_rather_than_fall_back(dev):
    q = torch.zeros((1, 64, 48), device=dev)
    with pytest.raises(ValueError, match="compiled for Dh"):
        ops.flash_attention(q, q, q)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        ops.flash_attention(q.half(), q.half(), q.half())
    x = torch.zeros((1, 60, 8), device=dev)
    g = torch.zeros((1, 60), device=dev)
    with pytest.raises(ValueError, match="multiple of 8"):
        ops.mlstm_chunked(x, x, x, g, g, chunk=12)
    x = torch.zeros((1, 8 * 1025, 8), device=dev)
    g = torch.zeros((1, 8 * 1025), device=dev)
    with pytest.raises(ValueError, match="at most 1024 chunks"):
        ops.mlstm_chunked(x, x, x, g, g, chunk=8)


def test_wrappers_refuse_cuda_operands_that_require_grad(dev):
    """The BNN kernels and ``unpack_gemm`` have no backward: a CUDA operand
    that requires grad, in grad mode, is refused by each of them (those
    that take a float operand); under no_grad the same call launches. The
    three LM kernels have one: under grad their forward launches, and a
    backward through them launches their backward kernel."""
    rng = np.random.default_rng(52)
    q = cu(rng.normal(size=(1, 64, 32)).astype(np.float32), dev)
    qg = q.clone().requires_grad_()
    g = cu(rng.normal(size=(1, 64)).astype(np.float32), dev)
    wp = cu(words(rng, (8, 2)), dev)
    x = cu(rng.normal(size=(64, 4)).astype(np.float32), dev)
    dt = torch.nn.functional.softplus(cu(rng.normal(size=(1, 8, 16)).astype(np.float32), dev))
    scan = (dt, dt.clone(), dt[..., :4].contiguous(), dt[..., :4].contiguous(),
            -torch.ones((16, 4), device=dev), torch.zeros((1, 16, 4), device=dev))
    refused = {
        "unpack_gemm": (lambda t: ops.unpack_gemm(wp, t), x.clone().requires_grad_()),
        "pack_rows": (lambda t: ops.pack_rows(t.T), x.T.contiguous().requires_grad_()),
    }
    for name, (call, arg) in refused.items():
        with pytest.raises(RuntimeError, match=f"{name}: an operand requires grad"):
            call(arg)
        before = ops.LAUNCHES[name]
        with torch.no_grad():
            call(arg)
        torch.cuda.synchronize()
        assert ops.LAUNCHES[name] == before + 1, name
    differentiated = {
        "flash_attention": (lambda t: ops.flash_attention(t, q, q), qg),
        "mlstm_chunked": (lambda t: ops.mlstm_chunked(t, q, q, g, g, chunk=16)[0], qg),
        "ssm_scan_chunk": (lambda t: ops.ssm_scan_chunk(t, *scan[1:])[0],
                           dt.clone().requires_grad_()),
    }
    for name, (call, arg) in differentiated.items():
        before = dict(ops.LAUNCHES)
        (grad,) = torch.autograd.grad(call(arg).sum(), (arg,))
        torch.cuda.synchronize()
        assert ops.LAUNCHES[name] == before[name] + 1, name
        assert ops.LAUNCHES[name + "_bwd"] == before[name + "_bwd"] + 1, name
        assert bool(torch.isfinite(grad).all()), name


# The three LM wrappers differentiated on the card (their forward and
# backward kernels) against the same on the CPU (their twins, forward and
# backward): float32 within rtol 1e-4 plus atol 2e-5 of each gradient's
# largest magnitude (chip_smoke.py's BWD_F32_TOL: sums in other orders;
# the flash twin on the CPU tiles keys by 512, the kernel by 64); bf16
# flash within 2 bf16 ulps of the largest magnitude (BWD_BF16_ULPS) and of
# the largest output for the forward.
def _lm_grad_case(kind, rng, dtype):
    def arr(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.normal(size=shape)).astype(np.float32))

    if kind == "flash_causal":
        args = [arr(3, 300, 64) for _ in range(3)]
        return (lambda q, k, v: ops.flash_attention(q, k, v)), [a.to(dtype) for a in args]
    if kind == "flash_full":
        args = [arr(2, 100, 32), arr(2, 150, 32), arr(2, 150, 32)]
        return (lambda q, k, v: ops.flash_attention(q, k, v, causal=False)), \
            [a.to(dtype) for a in args]
    if kind == "ssm":
        dt = torch.nn.functional.softplus(arr(2, 37, 300))
        a = -torch.arange(1, 17, dtype=torch.float32).expand(300, 16).contiguous()
        args = [dt, arr(2, 37, 300), arr(2, 37, 16), arr(2, 37, 16), a,
                arr(2, 300, 16, scale=0.1)]
        return (lambda *xs: ops.ssm_scan_chunk(*xs)), args
    logf = torch.nn.functional.logsigmoid(arr(2, 512) + 2)
    args = [arr(2, 512, 64, scale=0.125), arr(2, 512, 64), arr(2, 512, 48), arr(2, 512),
            logf]
    return (lambda *xs: ops.mlstm_chunked(*xs, chunk=128)[:3]), args


@pytest.mark.parametrize("kind,dtype", [
    ("flash_causal", torch.float32), ("flash_causal", torch.bfloat16),
    ("flash_full", torch.float32), ("ssm", torch.float32), ("mlstm", torch.float32)])
def test_lm_kernel_gradients_match_the_twins(dev, kind, dtype):
    rng = np.random.default_rng(53)
    fn, args = _lm_grad_case(kind, rng, dtype)
    results = {}
    for where in ("cpu", dev):
        live = [a.to(where).requires_grad_() for a in args]
        outs = fn(*live)
        outs = outs if isinstance(outs, tuple) else (outs,)
        cts = [torch.from_numpy(np.random.default_rng(54 + i).normal(
            size=tuple(o.shape)).astype(np.float32)).to(where).to(o.dtype)
            for i, o in enumerate(outs)]
        total = sum((o.float() * c.float()).sum() for o, c in zip(outs, cts))
        results[str(where)] = [g.cpu() for g in torch.autograd.grad(total, live)]
    for got, want in zip(results[str(dev)], results["cpu"]):
        diff = (got.float() - want.float()).abs()
        scale = float(want.float().abs().max())
        if dtype == torch.bfloat16:
            limit = 2 * float(bf16_ulp(torch.tensor(scale)))
            assert float(diff.max()) <= limit, (float(diff.max()), limit)
        else:
            assert bool((diff <= 1e-4 * want.abs() + 2e-5 * scale).all()), (
                float(diff.max()), scale)


def test_train_runs_on_the_card_and_refuses_two(dev, tmp_path, monkeypatch):
    """``launch.train.train`` on the card: the smoke xlstm takes a few
    steps through the mLSTM's forward and backward kernels, resumes from
    its checkpoint; with two CUDA devices visible it raises (ROADMAP
    A6d)."""
    from repro_torch.launch.train import train

    before = dict(ops.LAUNCHES)
    kw = dict(smoke=True, batch=4, seq=64, lr=1e-3, ckpt_dir=str(tmp_path),
              ckpt_every=3, log_every=100)
    out = train("xlstm-1.3b", steps=4, **kw)
    assert len(out["losses"]) == 4 and np.isfinite(out["losses"]).all()
    assert ops.LAUNCHES["mlstm_chunked_bwd"] - before["mlstm_chunked_bwd"] == 4 * 2
    assert len(train("xlstm-1.3b", steps=5, **kw)["losses"]) == 2
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(NotImplementedError, match="A6d"):
        train("smollm-360m", steps=1)


@pytest.mark.parametrize("arch,seq", [("smollm-360m", 4096), ("xlstm-1.3b", 512)])
def test_smoke_lm_loss_matches_the_cpu(dev, arch, seq):
    """``Model.loss`` of the smoke config (float32) on the card, through
    the flash kernel (smollm at S 4096) or the mLSTM kernel (xlstm, two
    chunks), against the CPU (their twins) on the same params and batch:
    float32 sums in other orders through the layers; loss within
    rtol/atol 1e-4."""
    from repro_torch.configs.base import smoke_config, train_policy
    from repro_torch.data.pipeline import DataConfig, synthetic_lm_batches
    from repro_torch.models.model_factory import build_model
    from repro_torch.models.transformer import num_periods, period_spec

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = smoke_config(arch)
    mixer = "attn" if arch == "smollm-360m" else "mlstm"
    per_forward = num_periods(cfg) * sum(k.mixer == mixer for k in period_spec(cfg))
    model = build_model(cfg, train_policy())
    params = model.init(torch.Generator().manual_seed(6))
    batch = next(synthetic_lm_batches(DataConfig(
        seed=6, global_batch=2, seq_len=seq, vocab_size=cfg.vocab_size)))

    def to(tree, d):
        if isinstance(tree, dict):
            return {k: to(v, d) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, d) for v in tree]
        return tree.to(d) if isinstance(tree, torch.Tensor) else tree

    name = "flash_attention" if arch == "smollm-360m" else "mlstm_chunked"
    losses = {}
    for d in ("cpu", dev):
        before = ops.LAUNCHES[name]
        with torch.no_grad():
            total, parts = model.loss(to(params, d), to(batch, d))
        losses[str(d)] = (float(total), float(parts["loss"]))
        launched = ops.LAUNCHES[name] - before
        assert launched == (0 if d == "cpu" else per_forward)
    assert np.allclose(losses[str(dev)], losses["cpu"], rtol=1e-4, atol=1e-4), losses


# ------------------------- the BNN train-to-serve loop -------------------------


@pytest.fixture(scope="module")
def bnn_run(tmp_path_factory):
    """A 20-step ``train_bnn`` at batch 32 on the card with checkpoints
    every 10 steps, and its rerun after the last checkpoint is deleted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import shutil

    from repro_torch.train.bnn_trainer import BNNTrainerConfig, train_bnn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    d = tmp_path_factory.mktemp("bnn_ckpt")
    cfg = BNNTrainerConfig(steps=20, batch=32, warmup_steps=2, eval_batches=1,
                           checkpoint_dir=str(d), checkpoint_every=10)
    full = train_bnn(cfg, device="cuda")
    shutil.rmtree(d / f"step_{cfg.steps:08d}")
    resumed = train_bnn(cfg, device="cuda")
    return cfg, full, resumed


def test_train_bnn_on_the_card_learns_and_resumes_bit_identically(bnn_run):
    """As ``tests/test_train.py``'s trainer cases: step 1 is live, the loss
    falls, latents stay in [-1, 1], running BN statistics move, the last
    checkpoint validates; and a run resumed from step 10 ends with every
    param and optimizer leaf bit-identical."""
    from repro_torch import tree

    cfg, full, resumed = bnn_run
    assert full.start_step == 0 and resumed.start_step == 10
    assert full.history["lr_scale"][0] > 0.0
    assert np.mean(full.history["loss"][10:]) < full.history["loss"][0] - 0.5
    for group in ("conv", "fc"):
        for layer in full.params[group]:
            assert layer["w"].is_cuda and float(layer["w"].abs().max()) <= 1.0
    assert bool((full.params["bn_conv"][0]["mean"] != 0).any())
    assert resumed.history["loss"] == full.history["loss"][10:]
    for a, b in zip(tree.leaves((full.params, full.opt_state)),
                    tree.leaves((resumed.params, resumed.opt_state))):
        assert torch.equal(a, b)


def test_export_of_weights_trained_on_the_card(bnn_run):
    """``pack_trained_params`` on the card's trained latents: every engine
    (the kernels: fused xnor both convs, the megakernels) bit-identical
    to the float-boundary forward on 64 held-out images, with and without
    the XNOR-Net alpha; each kernel of those paths launched."""
    from repro_torch.core.bnn import pack_trained_params
    from repro_torch.data.pipeline import DataConfig, cifar_batch_at

    cfg, full, _ = bnn_run
    probe = cifar_batch_at(DataConfig(seed=cfg.data_seed, global_batch=64),
                           cfg.steps + 1)["images"].cuda()
    for use_scale in (False, True):
        ops.reset_launches()
        out = pack_trained_params(full.params, use_scale=use_scale,
                                  probe_images=probe)
        assert set(out) == {"packed", "fused", "megakernel"}
        for name in ("fused_xnor_gemm", "fused_direct_conv", "xnor_gemm",
                     "megakernel_conv_stage", "megakernel_chain"):
            assert ops.LAUNCHES[name] > 0, name


@pytest.mark.parametrize("weights", ["random", "trained"])
def test_eval_forwards_compute_the_first_conv_alike(dev, weights):
    """On CUDA every eval forward runs the first conv as the engines do
    (``core.bnn._first_conv``: its GEMM in fixed chunks of images), so
    the float-boundary forward, PACKED ``bnn_apply`` and the fused and
    megakernel engines give equal logits on 256 images served in batches
    of 1, 8, 32 and 128. One GEMM of the whole batch rounds its sums by
    shape: on these images and the random weights (``chip_smoke.py``
    phase 4a's) it flips 4 of their 1,048,576 first-conv words at
    batches 8, 32 and 128."""
    from repro_torch.core.binarize import QuantMode
    from repro_torch.core.bnn import (BNNConfig, bnn_apply, bnn_apply_fused,
                                      bnn_apply_megakernel, bnn_eval_logits,
                                      init_bnn_params, load_binary_checkpoint,
                                      pack_bnn_params, pack_bnn_params_fused,
                                      pack_bnn_params_megakernel)

    torch.backends.cuda.matmul.allow_tf32 = False
    latent = (init_bnn_params(0, device=dev) if weights == "random"
              else load_binary_checkpoint(CKPT, device=dev))
    packed, fused = pack_bnn_params(latent), pack_bnn_params_fused(latent)
    mega = pack_bnn_params_megakernel(latent)
    images = cu(np.random.default_rng(42).normal(size=(256, 32, 32, 3)).astype(
        np.float32), dev)
    with torch.no_grad():
        for n, i in ((n, i) for n in (1, 8, 32, 128) for i in range(0, 256, n)):
            x = images[i:i + n]
            want = bnn_eval_logits(latent, x)
            got = {
                "packed/xla": bnn_apply(packed, x, BNNConfig(
                    mode=QuantMode.PACKED, engine="xla")),
                "packed/xnor": bnn_apply(packed, x, BNNConfig(
                    mode=QuantMode.PACKED, engine="xnor")),
                "fused/xnor": bnn_apply_fused(fused, x, engine="xnor",
                                              conv_impl="direct"),
                "fused/xla": bnn_apply_fused(fused, x, engine="xla"),
                "megakernel": bnn_apply_megakernel(mega, x),
            }
            bad = {k: int((v != want).sum()) for k, v in got.items()
                   if not torch.equal(v, want)}
            assert not bad, f"batch {n} at image {i}: logits differing {bad}"


def _dp_setup(dev, batch: int):
    from repro_torch.core.bnn import init_bnn_params
    from repro_torch.data.pipeline import DataConfig, cifar_batch_at
    from repro_torch.train.bnn_trainer import BNNTrainerConfig, _BNNTask
    from repro_torch.train.step import init_opt_state

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = BNNTrainerConfig(steps=10, batch=batch, warmup_steps=1)
    params = init_bnn_params(0, device=dev)
    feeds = [{k: cifar_batch_at(DataConfig(seed=11, global_batch=batch), s)[k]
              .to(dev) for k in ("images", "labels")} for s in range(3)]
    return cfg, _BNNTask(cfg.model_config()), params, init_opt_state(params), feeds


def test_dp_step_on_one_shard_is_the_single_device_step(dev):
    from repro_torch import tree
    from repro_torch.launch.mesh import ServingMesh
    from repro_torch.train.bnn_trainer import (bnn_clip_predicate,
                                               init_dp_error_feedback,
                                               make_dp_train_step)
    from repro_torch.train.step import make_train_step

    cfg, task, params, opt, feeds = _dp_setup(dev, 16)
    single = make_train_step(task, cfg.train_config(),
                             clip_predicate=bnn_clip_predicate)
    dp = make_dp_train_step(task, cfg.train_config(), ServingMesh((dev,)),
                            grad_compression="none",
                            clip_predicate=bnn_clip_predicate)
    a = (params, opt)
    b = (params, opt, init_dp_error_feedback(params, 1))
    for feed in feeds:
        pa, oa, ma = single(*a, feed)
        pb, ob, eb, mb = dp(*b, feed)
        for x, y in zip(tree.leaves((pa, oa, ma)), tree.leaves((pb, ob, mb))):
            assert torch.equal(x, y)
        a, b = (pa, oa), (pb, ob, eb)


def test_signsgd_dp_step_replays_bit_for_bit(dev):
    from repro_torch import tree
    from repro_torch.launch.mesh import ServingMesh
    from repro_torch.train.bnn_trainer import (bnn_clip_predicate,
                                               init_dp_error_feedback,
                                               make_dp_train_step)

    cfg, task, params, opt, feeds = _dp_setup(dev, 32)
    for compression in ("int8", "signsgd"):
        dp = make_dp_train_step(task, cfg.train_config(),
                                ServingMesh((dev,) * 4),
                                grad_compression=compression,
                                clip_predicate=bnn_clip_predicate)
        runs = []
        for _ in range(2):
            state = (params, opt, init_dp_error_feedback(params, 4))
            for feed in feeds:
                *state, metrics = dp(*state, feed)
            runs.append(tree.leaves((state, metrics)))
        assert all(torch.equal(x, y) for x, y in zip(*runs)), compression
        assert bool(torch.isfinite(runs[0][0]).all())
