"""The unfused PACKED slice (the paper's Table 2 path) against the JAX
package, on the same numpy inputs.

* Kernel wrappers on CPU tensors (their plain twins) against the JAX
  Pallas kernels in interpret mode: ``pack_rows`` and ``direct_conv``
  exactly; ``unpack_gemm`` exactly on ±1/0 input, on real input within
  the JAX package's own tolerances for its kernel (float32: rtol 1e-5,
  atol 1e-4; bfloat16: rtol 2e-2, atol 2e-1, ``tests/test_kernels.py``).
* ``bit_linear``/``bit_conv2d`` in every mode: PACKED (each engine and
  ``conv_impl``, K not a multiple of 32) and FAKE_QUANT on binarized
  input give integer-valued dots plus the same bias, so they are exact;
  FLOAT and FAKE_QUANT on real input sum float32 products in different
  orders (rtol 1e-5, atol 1e-5).
* ``bnn_apply`` at batch 2 for every preset on the trained checkpoint,
  against the JAX package's ``engine="xla"`` forward (the JAX ``xnor``
  and ``unpack`` engines run Pallas in interpret mode, too slow for
  whole networks), jitted: eager JAX compiles op by op for some 20 s.
  Under ``jit`` XLA contracts the BN affine into FMAs, which moves the
  logits by up to 1 ulp, so they are held to rtol 1e-6 / atol 1e-5 with
  equal argmax, as in ``test_torch_bnn.py``. Against the eager JAX
  forward the port is exact: ``test_torch_golden.py``.
* The port's PACKED logits equal its fused logits bit for bit (the JAX
  invariant ``test_bnn_fused_matches_packed_bit_exact``), and each preset
  calls exactly the kernel wrappers ``chip_smoke.py`` holds the card to.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import bnn_cifar as jcfg
from repro.core import bnn as jbnn
from repro.core import layers as jl
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.configs import bnn_cifar as tcfg
from repro_torch.core import bitops as tbit
from repro_torch.core import bnn as tbnn
from repro_torch.core import layers as tl
from repro_torch.core.binarize import QuantMode
from repro_torch.kernels import ops

from torch_parity import CKPT, pm1, t, words

ROOT = pathlib.Path(__file__).resolve().parents[1]
N_IMAGES = 2
FLOAT_TOL = dict(rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- kernels

@pytest.mark.parametrize("k,n", [(32, 128), (64, 100), (256, 1), (1024, 333),
                                 (32, 129)])
def test_pack_rows_matches_pallas_and_ref(k, n):
    rng = np.random.default_rng(50)
    x = rng.normal(size=(k, n)).astype(np.float32)
    x.reshape(-1)[::7] = 0.0
    x.reshape(-1)[::11] = -0.0   # x >= 0: the bit is set for -0.0
    # The layers hand over a transposed view (x2d.T): read in place.
    got = ops.pack_rows(t(x.T.copy()).T)
    assert got.is_contiguous() and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jops.pack_rows(jnp.asarray(x), interpret=True)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jref.pack_ref(jnp.asarray(x), axis=0)))


def test_pack_rows_clears_the_bit_for_nan():
    x = np.array([[np.nan], [-0.0], [0.0], [-1.0]] * 8, np.float32)
    want = np.asarray(jops.pack_rows(jnp.asarray(x), interpret=True))
    np.testing.assert_array_equal(ops.pack_rows(t(x)).numpy(), want)
    assert want[0, 0] == 0x66666666   # bits (nan, -0.0, 0.0, -1.0) = 0110


@pytest.mark.parametrize("c,d,h,stride,pad", [(32, 40, 5, 1, 1), (64, 7, 6, 2, 0),
                                              (32, 70, 7, 2, 1), (96, 33, 4, 1, 0)])
def test_direct_conv_matches_pallas_and_ref(c, d, h, stride, pad):
    rng = np.random.default_rng(51)
    w_pm1 = pm1(rng, (d, 3, 3, c))
    x_pm1 = pm1(rng, (2, h, h + 1, c))
    wp = tl.pack_conv_params({"w": t(w_pm1)})["w_packed"]
    xp = tbit.pack_channels(t(x_pm1))
    kw = dict(kh=3, kw=3, stride=stride, pad=pad)
    got = ops.direct_conv(wp, xp, 9 * c, **kw)
    assert got.shape[-1] == d and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jops.direct_conv(
        jnp.asarray(wp.numpy()), jnp.asarray(xp.numpy()), 9 * c,
        interpret=True, **kw)))
    # Ground truth: the float conv of the ±1 map, the border padded +1.
    xf = np.pad(x_pm1, ((0, 0), (pad, pad), (pad, pad), (0, 0)),
                constant_values=1.0)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(xf), jnp.asarray(w_pm1.transpose(1, 2, 3, 0)),
        (stride, stride), "VALID", dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int32))


# Ragged M, N and KW (3, 5 and 9 words: not multiples of the JAX tile).
@pytest.mark.parametrize("m,kw,n", [(10, 3, 7), (70, 5, 33), (130, 9, 200)])
def test_unpack_gemm_matches_pallas(m, kw, n):
    rng = np.random.default_rng(52)
    wp = words(rng, (m, kw))
    jw = jnp.asarray(wp)
    ternary = rng.integers(-1, 2, size=(32 * kw, n)).astype(np.float32)
    got = ops.unpack_gemm(t(wp), t(ternary)).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jops.unpack_gemm(jw, jnp.asarray(ternary), interpret=True)))
    real = rng.normal(size=(32 * kw, n)).astype(np.float32)
    got = ops.unpack_gemm(t(wp), t(real.T.copy()).T).numpy()   # strided view
    np.testing.assert_allclose(got, np.asarray(
        jops.unpack_gemm(jw, jnp.asarray(real), interpret=True)),
        rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(jref.unpack_gemm_ref(
        jw, jnp.asarray(real))), rtol=1e-5, atol=1e-4)
    half = t(real).to(torch.bfloat16)
    got = ops.unpack_gemm(t(wp), half)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jops.unpack_gemm(
        jw, jnp.asarray(real).astype(jnp.bfloat16), interpret=True),
        np.float32), rtol=2e-2, atol=2e-1)


def test_unfused_wrappers_check_their_operands():
    rng = np.random.default_rng(53)
    with pytest.raises(ValueError, match="multiple of 32"):
        ops.pack_rows(torch.zeros(48, 3))
    with pytest.raises(TypeError):
        ops.pack_rows(torch.zeros(64, 3, dtype=torch.float64))
    with pytest.raises(ValueError, match="unit stride along K"):
        ops.pack_rows(torch.zeros(64, 3))                 # N-contiguous
    with pytest.raises(ValueError, match="tap-aligned"):
        ops.direct_conv(t(words(rng, (32, 10))), t(words(rng, (1, 4, 4, 2))),
                        64, kh=3, kw=3)
    with pytest.raises(ValueError, match="KW"):
        ops.unpack_gemm(t(words(rng, (8, 2))), torch.zeros(63, 4))
    with pytest.raises(ValueError, match="contiguous"):
        ops.unpack_gemm(t(words(rng, (8, 2))).T, torch.zeros(256, 4))


def test_cuda_path_raises_without_cuda_and_never_falls_back(monkeypatch):
    """On operands the wrapper takes for CUDA tensors, the three kernels
    launch or raise; their twins are reached only through the CPU check."""
    monkeypatch.setattr(ops, "_on_cuda", lambda *ts: True)
    for twin in ("pack_bits", "direct_conv_dot", "packed_matmul_unpack"):
        monkeypatch.setattr(ops.bitops, twin,
                            lambda *a, **k: pytest.fail("fell back to the twin"))
    ops.reset_launches()
    rng = np.random.default_rng(54)
    w, xm = t(words(rng, (32, 9))), t(words(rng, (1, 3, 3, 1)))
    for call in (lambda: ops.pack_rows(torch.zeros(3, 64).T),
                 lambda: ops.direct_conv(w, xm, 288, kh=3, kw=3, pad=1),
                 lambda: ops.unpack_gemm(w, torch.zeros(288, 3))):
        with pytest.raises((RuntimeError, ValueError)):
            call()
    assert ops.LAUNCHES == {k: 0 for k in ops.LAUNCHES}


# ---------------------------------------------------------------- layers

def _cfgs(mode, binarize_acts=True):
    kw = dict(mode=mode, binarize_acts=binarize_acts)
    return jl.BitLinearConfig(**kw), tl.BitLinearConfig(**kw)


PACKED_ENGINES = [("xnor", "im2col"), ("unpack", "im2col"), ("xla", "im2col"),
                  ("xnor", "direct"), ("xla", "direct")]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("engine", ["xnor", "unpack", "xla"])
def test_bit_linear_packed_matches_jax(engine, dtype):
    """K = 70: n_pad = 26 pad bits, on a batch of 5 and a leading dim. In
    ``compute_dtype`` bfloat16 the ±1 dot (|dot| <= 70) is exact and the
    bias add rounds alike in both packages: exact too."""
    rng = np.random.default_rng(55)
    p = {"w": rng.normal(size=(45, 70)).astype(np.float32),
         "b": rng.normal(size=45).astype(np.float32)}
    x = rng.normal(size=(5, 3, 70)).astype(np.float32)
    x.reshape(-1)[::9] = 0.0
    kw = dict(mode=QuantMode.PACKED, engine=engine)
    want = jl.bit_linear(jl.pack_linear_params({k: jnp.asarray(v) for k, v in p.items()}),
                         jnp.asarray(x), jl.BitLinearConfig(
                             **kw, compute_dtype=getattr(jnp, dtype)))
    got = tl.bit_linear(tl.pack_linear_params({k: t(v) for k, v in p.items()}),
                        t(x), tl.BitLinearConfig(
                            **kw, compute_dtype=getattr(torch, dtype)))
    assert got.shape == (5, 3, 45) and got.dtype == getattr(torch, dtype)
    assert want.dtype == getattr(jnp, dtype)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("engine,conv_impl", PACKED_ENGINES)
def test_bit_conv2d_packed_matches_jax(engine, conv_impl):
    """C = 32 for direct; C = 5 (K = 45, n_pad = 19) for im2col."""
    rng = np.random.default_rng(56)
    c = 32 if conv_impl == "direct" else 5
    p = {"w": rng.normal(size=(40, 3, 3, c)).astype(np.float32),
         "b": rng.normal(size=40).astype(np.float32)}
    x = rng.normal(size=(2, 6, 7, c)).astype(np.float32)
    kw = dict(mode=QuantMode.PACKED, engine=engine, conv_impl=conv_impl)
    conv = dict(stride=1, pad=1, kh=3, kw=3)
    want = jl.bit_conv2d(jl.pack_conv_params({k: jnp.asarray(v) for k, v in p.items()}),
                         jnp.asarray(x), jl.BitLinearConfig(**kw), **conv)
    got = tl.bit_conv2d(tl.pack_conv_params({k: t(v) for k, v in p.items()}),
                        t(x), tl.BitLinearConfig(**kw), **conv)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode,binarize_acts", [(QuantMode.FLOAT, True),
                                                (QuantMode.FAKE_QUANT, True),
                                                (QuantMode.FAKE_QUANT, False)])
def test_float_modes_match_jax(mode, binarize_acts):
    rng = np.random.default_rng(57)
    lin = {"w": rng.normal(size=(45, 70)).astype(np.float32),
           "b": rng.normal(size=45).astype(np.float32)}
    conv = {"w": rng.normal(size=(40, 3, 3, 5)).astype(np.float32),
            "b": rng.normal(size=40).astype(np.float32)}
    x_lin = rng.normal(size=(5, 70)).astype(np.float32)
    x_conv = rng.normal(size=(2, 6, 7, 5)).astype(np.float32)
    jcfg_, tcfg_ = _cfgs(mode, binarize_acts)
    exact = mode == QuantMode.FAKE_QUANT and binarize_acts
    pairs = [
        (jl.bit_linear({k: jnp.asarray(v) for k, v in lin.items()},
                       jnp.asarray(x_lin), jcfg_),
         tl.bit_linear({k: t(v) for k, v in lin.items()}, t(x_lin), tcfg_)),
        (jl.bit_conv2d({k: jnp.asarray(v) for k, v in conv.items()},
                       jnp.asarray(x_conv), jcfg_, stride=2, pad=1),
         tl.bit_conv2d({k: t(v) for k, v in conv.items()}, t(x_conv), tcfg_,
                       stride=2, pad=1)),
    ]
    for want, got in pairs:
        if exact:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **FLOAT_TOL)


def test_direct_bit_conv2d_refuses_what_jax_refuses():
    p = tl.pack_conv_params({"w": torch.ones(8, 3, 3, 5)})
    for engine, c, match in (("xnor", 5, "C % 32"), ("unpack", 32, "no engine")):
        cfg = tl.BitLinearConfig(mode=QuantMode.PACKED, engine=engine,
                                 conv_impl="direct")
        with pytest.raises(ValueError, match=match):
            tl.bit_conv2d(p, torch.ones(1, 4, 4, c), cfg, pad=1, kh=3, kw=3)


# ---------------------------------------------------------------- network

@pytest.fixture(scope="module")
def latent():
    return {"jax": jbnn.load_binary_checkpoint(str(CKPT)),
            "port": tbnn.load_binary_checkpoint(CKPT, device="cpu")}


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(2024).normal(
        size=(N_IMAGES, 32, 32, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_logits(latent, images):
    """The JAX package's jitted forward per mode (PACKED: engine "xla")."""
    x, jp = jnp.asarray(images), latent["jax"]

    def run(params, cfg):
        return np.asarray(jax.jit(lambda p, x: jbnn.bnn_apply(p, x, cfg))(params, x))

    return {
        QuantMode.PACKED: run(jbnn.pack_bnn_params(jp), jcfg.XLA_PACKED),
        QuantMode.FLOAT: run(jp, jcfg.CONTROL_GROUP),
        QuantMode.FAKE_QUANT: run(jp, jcfg.SIMULATION),
    }


def _forward(latent_port, name, images):
    cfg = tcfg.PRESETS[name]
    params = (tbnn.pack_bnn_params(latent_port) if cfg.mode == QuantMode.PACKED
              else latent_port)
    return tbnn.bnn_apply(params, t(images), cfg)


@pytest.mark.parametrize("name", list(tcfg.PRESETS))
def test_every_preset_matches_jax(latent, images, jax_logits, name):
    got = _forward(latent["port"], name, images).numpy()
    want = jax_logits[tcfg.PRESETS[name].mode]
    assert got.shape == (N_IMAGES, 10) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


def test_packed_equals_fused_and_eval_logits(latent, images):
    """The JAX invariants, in the port: PACKED logits bit-identical to
    the fused pipeline's and to the FAKE_QUANT eval forward."""
    x = t(images)
    fused = tbnn.bnn_apply_fused(tbnn.pack_bnn_params_fused(latent["port"]), x,
                                 engine="xla")
    packed = _forward(latent["port"], "XLA_PACKED", images)
    np.testing.assert_array_equal(packed.numpy(), fused.numpy())
    np.testing.assert_array_equal(
        tbnn.bnn_eval_logits(latent["port"], x).numpy(), fused.numpy())


def test_presets_mirror_the_jax_package():
    import dataclasses

    for name, cfg in tcfg.PRESETS.items():
        jc = getattr(jcfg, name)
        assert (cfg.mode.value, cfg.engine, cfg.conv_impl, cfg.num_classes) == (
            jc.mode.value, jc.engine, jc.conv_impl, jc.num_classes), name
    port_fields = {f.name for f in dataclasses.fields(tbnn.BNNConfig)}
    assert port_fields <= {f.name for f in dataclasses.fields(jbnn.BNNConfig)}
    assert tcfg.BNNExperiment("t") == tcfg.BNNExperiment("t", batch=64,
                                                         num_batches=16)
    assert tl.BitLinearConfig().engine == jl.BitLinearConfig().engine
    assert tl.BitLinearConfig().conv_impl == jl.BitLinearConfig().conv_impl


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# Kernel wrappers one batch-1 forward of each preset calls: PAPER_KERNEL
# encodes every binary layer's input (5 convs, 3 FCs) and runs its
# xnor GEMM; DIRECT_KERNEL convolves the packed maps directly and packs
# only the FC inputs; MXU_KERNEL runs one unpack GEMM per binary layer;
# the plain-torch and float presets launch nothing.
PRESET_CALLS = {
    "PAPER_KERNEL": {"pack_rows": 8, "xnor_gemm": 8},
    "DIRECT_KERNEL": {"direct_conv": 5, "pack_rows": 3, "xnor_gemm": 3},
    "MXU_KERNEL": {"unpack_gemm": 8},
    "XLA_PACKED": {}, "CONTROL_GROUP": {}, "SIMULATION": {},
}


@pytest.mark.parametrize("name", list(tcfg.PRESETS))
def test_each_preset_calls_its_own_kernels(latent, images, name, monkeypatch):
    calls = dict.fromkeys(ops.LAUNCHES, 0)

    def counted(name):
        fn = getattr(ops, name)

        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    for kernel in calls:
        monkeypatch.setattr(ops, kernel, counted(kernel))
    _forward(latent["port"], name, images[:1])
    want = {**dict.fromkeys(ops.LAUNCHES, 0), **PRESET_CALLS[name]}
    assert calls == want
    assert _chip_smoke().launches_per_forward(name) == want
