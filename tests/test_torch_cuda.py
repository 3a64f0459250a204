"""The CUDA kernels against their plain-torch twins on the card, at
ragged shapes the main path does not reach (M, N, D and C not multiples
of 32, stride 2, no padding; for the megakernels odd batches, masked
tails inside a tile and cluster sizes other than 8; for the unfused
PACKED kernels strided and offset inputs, -0.0 and NaN, bfloat16 and
K not a multiple of the tile; for the scan ragged chunks, channels and
states, and chunk views; for flash attention ragged and unequal Sq and
Skv, odd BH, every compiled head width, bf16 and float32; for the mLSTM
chunks of 16 to 256 steps, dk and dv not multiples of the tile).
Bit-exact, but for ``unpack_gemm`` on real input, the scan, flash
attention and the mLSTM (tolerances at the tests). The grad guard of the
wrappers and the smoke LM losses on the card against the CPU are here
too. Every test here needs a GPU and
``nvcc`` and skips without them; run on the card with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

(``chip_smoke.py`` checks the main path's shapes.) This file imports no
JAX, so it runs where only the port is installed."""

import numpy as np
import pytest
import torch

from repro_torch.core import bitops, layers
from repro_torch.kernels import ops

from torch_parity import bf16_ulp, pm1, words

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
    """No kernel has a backward: a CUDA operand that requires grad, in
    grad mode, is refused by every wrapper that takes a float operand;
    under no_grad the same call launches."""
    rng = np.random.default_rng(52)
    q = cu(rng.normal(size=(1, 64, 32)).astype(np.float32), dev)
    qg = q.clone().requires_grad_()
    g = cu(rng.normal(size=(1, 64)).astype(np.float32), dev)
    wp = cu(words(rng, (8, 2)), dev)
    x = cu(rng.normal(size=(64, 4)).astype(np.float32), dev)
    dt = torch.nn.functional.softplus(cu(rng.normal(size=(1, 8, 16)).astype(np.float32), dev))
    scan = (dt, dt.clone(), dt[..., :4].contiguous(), dt[..., :4].contiguous(),
            -torch.ones((16, 4), device=dev), torch.zeros((1, 16, 4), device=dev))
    calls = {
        "flash_attention": lambda t: ops.flash_attention(t, q, q),
        "mlstm_chunked": lambda t: ops.mlstm_chunked(t, q, q, g, g, chunk=16),
        "unpack_gemm": lambda t: ops.unpack_gemm(wp, t),
        "pack_rows": lambda t: ops.pack_rows(t.T),
        "ssm_scan_chunk": lambda t: ops.ssm_scan_chunk(t, *scan[1:]),
    }
    args = {"flash_attention": qg, "mlstm_chunked": qg,
            "unpack_gemm": x.clone().requires_grad_(),
            "pack_rows": x.T.contiguous().requires_grad_(),
            "ssm_scan_chunk": dt.clone().requires_grad_()}
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=f"{name}: an operand requires grad"):
            call(args[name])
        before = ops.LAUNCHES[name]
        with torch.no_grad():
            call(args[name])
        torch.cuda.synchronize()
        assert ops.LAUNCHES[name] == before + 1, name


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
