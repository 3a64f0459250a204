"""The port's kernel wrappers (``repro_torch.kernels.ops``) on CPU
tensors, against the JAX package's Pallas kernels in interpret mode and
its ground-truth oracles (``repro.kernels.ref``), exactly.

On the CPU a wrapper returns its kernel's plain twin; the CUDA kernels
themselves are held to those twins on the card by ``chip_smoke.py`` and
``tests/test_torch_cuda.py``. The shapes cover the 10-row head, D not a
multiple of 32, and C not a multiple of 32 via ``pack_conv_aligned``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import layers as jl
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import layers as tl
from repro_torch.core.bitops import pack_channels
from repro_torch.kernels import autotune, build, ops

from torch_parity import pm1, t, words


@pytest.mark.parametrize("m,kw,n", [(10, 32, 4), (37, 3, 9), (64, 8, 33)])
def test_xnor_gemm_matches_pallas_and_ref(m, kw, n):
    rng = np.random.default_rng(10)
    w, x = words(rng, (m, kw)), words(rng, (kw, n))
    k_bits = 32 * kw
    got = ops.xnor_gemm(t(w), t(x), k_bits).numpy()
    np.testing.assert_array_equal(got, np.asarray(jops.xnor_gemm(
        jnp.asarray(w), jnp.asarray(x), k_bits, interpret=True)))
    np.testing.assert_array_equal(got, np.asarray(jref.xnor_gemm_ref(
        jnp.asarray(w), jnp.asarray(x), k_bits)))


@pytest.mark.parametrize("m,k,n", [(10, 64, 5), (45, 96, 7), (96, 40, 3)])
def test_fused_xnor_gemm_matches_pallas_and_ref(m, k, n):
    rng = np.random.default_rng(11)
    w_pm1, x_pm1 = pm1(rng, (m, k)), pm1(rng, (k, n))
    a = rng.normal(size=m).astype(np.float32)
    b = (rng.normal(size=m) * 4).astype(np.float32)
    # Packing with xnor-neutral K pads: weights -1, activations +1.
    pad = -k % 32
    wp = np.asarray(jl.pack_linear_params({"w": jnp.asarray(w_pm1)})["w_packed"])
    xp = np.asarray(jl.pack_linear_params(
        {"w": jnp.pad(jnp.asarray(x_pm1.T), ((0, 0), (0, pad)),
                      constant_values=1.0)})["w_packed"]).T.copy()
    got = ops.fused_xnor_gemm(t(wp), t(xp), k, t(a), t(b)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jops.fused_xnor_gemm(
        jnp.asarray(wp), jnp.asarray(xp), k, jnp.asarray(a), jnp.asarray(b),
        interpret=True)))
    np.testing.assert_array_equal(got, np.asarray(jref.fused_layer_ref(
        jnp.asarray(w_pm1), jnp.asarray(x_pm1), jnp.asarray(a), jnp.asarray(b))))


@pytest.mark.parametrize("c,d,stride,pad", [(32, 40, 1, 1), (45, 32, 1, 1),
                                            (20, 7, 2, 0)])
def test_fused_direct_conv_matches_pallas_and_ref(c, d, stride, pad):
    rng = np.random.default_rng(12)
    w_pm1 = pm1(rng, (d, 3, 3, c))
    x_pm1 = pm1(rng, (2, 5, 6, c))
    a = rng.normal(size=d).astype(np.float32)
    b = (rng.normal(size=d) * 6).astype(np.float32)
    wp = tl.pack_conv_aligned({"w": t(w_pm1)})["w_packed"]
    xp = pack_channels(t(x_pm1))
    k_bits = 9 * c
    kw = dict(kh=3, kw=3, stride=stride, pad=pad)
    got = ops.fused_direct_conv(wp, xp, k_bits, t(a), t(b), **kw).numpy()
    np.testing.assert_array_equal(got, np.asarray(jops.fused_direct_conv(
        jnp.asarray(wp.numpy()), jnp.asarray(xp.numpy()), k_bits,
        jnp.asarray(a), jnp.asarray(b), interpret=True, **kw)))
    np.testing.assert_array_equal(got, np.asarray(jref.fused_direct_conv_ref(
        jnp.asarray(w_pm1), jnp.asarray(x_pm1), jnp.asarray(a), jnp.asarray(b),
        stride=stride, pad=pad)))


def test_wrappers_refuse_transposed_views():
    """A transposed view (``x.T``) has strides the kernels do not take:
    the wrapper raises instead of reading it wrongly."""
    rng = np.random.default_rng(13)
    w, x = t(words(rng, (10, 4))), t(words(rng, (6, 4)))
    with pytest.raises(ValueError, match="contiguous"):
        ops.xnor_gemm(w, x.T, 128)
    a, b = torch.ones(10), torch.zeros(10)
    with pytest.raises(ValueError, match="contiguous"):
        ops.fused_xnor_gemm(w, x.T, 128, a, b)
    assert ops.xnor_gemm(w, x.T.contiguous(), 128).shape == (10, 6)


def test_wrappers_check_dtype_shape_and_device():
    rng = np.random.default_rng(14)
    w, x = t(words(rng, (10, 4))), t(words(rng, (4, 6)))
    with pytest.raises(TypeError):
        ops.xnor_gemm(w.to(torch.int64), x, 128)
    with pytest.raises(ValueError, match="contraction"):
        ops.xnor_gemm(w, x[:3].contiguous(), 128)
    with pytest.raises(ValueError, match="rows"):
        ops.fused_xnor_gemm(w, x, 128, torch.ones(9), torch.zeros(9))
    with pytest.raises(ValueError, match="tap-aligned"):
        ops.fused_direct_conv(t(words(rng, (32, 10))), t(words(rng, (1, 4, 4, 2))),
                              64, torch.ones(32), torch.zeros(32), kh=3, kw=3)
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.xnor_gemm(w.to("meta"), x.to("meta"), 128)


def test_cuda_path_raises_without_cuda_and_never_falls_back(monkeypatch):
    """Operands the wrapper takes for CUDA tensors go to the kernel or
    raise; the plain twin is reached only through the CPU check."""
    monkeypatch.setattr(ops, "_on_cuda", lambda *ts: True)
    monkeypatch.setattr(ops.bitops, "xnor_popcount_matmul",
                        lambda *a, **k: pytest.fail("fell back to the twin"))
    monkeypatch.setattr(ops.bitops, "fused_xnor_layer",
                        lambda *a, **k: pytest.fail("fell back to the twin"))
    monkeypatch.setattr(ops.bitops, "direct_conv_oracle",
                        lambda *a, **k: pytest.fail("fell back to the twin"))
    ops.reset_launches()
    rng = np.random.default_rng(15)
    w, x = t(words(rng, (32, 9))), t(words(rng, (9, 4)))
    a, b = torch.ones(32), torch.zeros(32)
    xm = t(words(rng, (1, 3, 3, 1)))
    for call in (lambda: ops.xnor_gemm(w, x, 288),
                 lambda: ops.fused_xnor_gemm(w, x, 288, a, b),
                 lambda: ops.fused_direct_conv(w, xm, 288, a, b, kh=3, kw=3,
                                               pad=1)):
        with pytest.raises((RuntimeError, ValueError, AssertionError)):
            call()
    assert ops.LAUNCHES == {k: 0 for k in ops.LAUNCHES}


def test_grad_guard_refuses_only_operands_autograd_would_track():
    """No kernel has a backward: ``_check_no_grad``, which ``_on_cuda``
    runs for CUDA operands before any launch, refuses an operand that
    requires grad while grad mode is on, and nothing else. CPU operands
    go to the plain twins, which differentiate as torch code does."""
    x = torch.randn(2, 64, 16, requires_grad=True)
    with pytest.raises(RuntimeError, match="flash_attention: an operand requires grad"):
        ops._check_no_grad("flash_attention", x.detach(), x)
    with torch.no_grad():
        ops._check_no_grad("flash_attention", x)
    ops._check_no_grad("flash_attention", x.detach(), torch.ones(3))
    assert ops._on_cuda("flash_attention", x) is False
    ops.flash_attention(x, x, x).sum().backward()
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())
    logi, logf = torch.zeros(2, 64), torch.full((2, 64), -0.1)
    q = torch.randn(2, 64, 16, requires_grad=True)
    ops.mlstm_chunked(q, q, q, logi, logf, chunk=16)[0].sum().backward()
    assert q.grad is not None and bool(torch.isfinite(q.grad).all())

def test_build_needs_nvcc_here(monkeypatch):
    """Without nvcc the build raises with the reason; the
    sources hash into the build directory name."""
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.nvcc()
    assert build.build_dir().name == build.source_hash()
    assert len(build.source_hash()) == 16


def test_block_kwargs_accepts_only_the_compiled_tiling():
    """``block_kwargs`` hands each kernel the fields it reads; the tile's
    fixed dimensions take no other value, and ``unpack_gemm`` and
    ``pack_rows``, which compile one tiling, refuse any request."""
    auto, cfg = autotune.AUTO, autotune.BlockConfig
    assert autotune.block_kwargs(auto, "xnor_gemm") == {}
    assert autotune.block_kwargs(cfg(), "unpack_gemm") == {}
    assert autotune.block_kwargs(cfg(block_n=64, k_splits=2), "xnor_gemm") == {
        "tile_n": 64, "k_splits": 2}
    assert autotune.block_kwargs(cfg(block_n=64, k_splits=2),
                                 "direct_conv") == {"tile_n": 64}
    assert autotune.block_kwargs(cfg(block_n=64, chain_cluster=16),
                                 "megakernel_chain") == {"cluster": 16}
    assert autotune.block_kwargs(cfg(stage_cluster=4),
                                 "megakernel_conv_stage") == {"cluster": 4}
    for kernel in ("unpack_gemm", "pack_rows"):
        with pytest.raises(ValueError, match="compiles one tiling"):
            autotune.block_kwargs(cfg(block_n=64), kernel)
    for bad in (dict(block_m=64), dict(block_kw=16), dict(block_n=96),
                dict(k_splits=0), dict(stage_cluster=16), dict(chain_cluster=3)):
        with pytest.raises(ValueError):
            cfg(**bad)
    with pytest.raises(ValueError):
        autotune.block_kwargs("fast", "xnor_gemm")
