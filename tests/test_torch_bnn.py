"""The slice as a whole: the port's fused packed CIFAR BNN against the
JAX package's ``bnn_apply_fused(engine="xla")`` on the committed trained
checkpoint, at batch 2, for both ``conv_impl``s.

* Packed words are exact at every stage boundary (after conv 1-5 with
  their pools, fc0 and fc1), walking both packages from the JAX
  package's own first-conv words with its folded ``(a, b)`` carried
  across.
* From images, the float first conv (an fp32 matmul on both sides,
  summed in different orders) flips no sign bit on this seed.
* Logits from the port's own packing agree within rtol 1e-6 / atol 1e-5
  with equal argmax: the gap is ``torch.rsqrt`` against XLA's in the
  folded and the final BN.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import bitops as jbit
from repro.core import bnn as jbnn
from repro.core import layers as jl
from repro_torch.convert import params_from_numpy
from repro_torch.core import bitops as tbit
from repro_torch.core import bnn as tbnn
from repro_torch.core import layers as tl

from torch_parity import CKPT, t

N_IMAGES = 2


@pytest.fixture(scope="module")
def models():
    jp = jbnn.load_binary_checkpoint(str(CKPT))
    jf = jbnn.pack_bnn_params_fused(jp)
    tp = tbnn.load_binary_checkpoint(CKPT, device="cpu")
    return {
        "jax_latent": jp,
        "jax": jf,
        "carried": params_from_numpy(jax.tree_util.tree_map(np.asarray, jf),
                                     device="cpu"),
        "port_latent": tp,
        "port": tbnn.pack_bnn_params_fused(tp),
    }


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(2024).normal(
        size=(N_IMAGES, 32, 32, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_first_words(models, images):
    jf = models["jax"]
    cfg = jl.BitLinearConfig(mode=jbnn.QuantMode.FAKE_QUANT,
                             binarize_acts=False)
    x = jl.bit_conv2d(jf["conv"][0], jnp.asarray(images), cfg, stride=1, pad=1)
    x = jbnn._batchnorm(jf["bn_conv0"], x, training=False)
    return np.asarray(jbit.pack_bits(x, axis=-1))


def test_both_loaders_read_the_same_checkpoint(models):
    jp, tp = models["jax_latent"], models["port_latent"]
    for group in ("conv", "fc", "bn_conv", "bn_fc"):
        assert len(jp[group]) == len(tp[group])
        for jd, td in zip(jp[group], tp[group]):
            assert set(jd) == set(td)
            for k in jd:
                np.testing.assert_array_equal(td[k].numpy(), np.asarray(jd[k]))


def test_packed_weights_equal_and_carried_params_convert(models):
    for key in ("conv", "fc"):
        for jd, own, car in zip(models["jax"][key], models["port"][key],
                                models["carried"][key]):
            for k in ("w_packed", "w"):
                if k in jd:
                    np.testing.assert_array_equal(own[k].numpy(), np.asarray(jd[k]))
                    np.testing.assert_array_equal(car[k].numpy(), np.asarray(jd[k]))
            assert all(car[k].dtype == own[k].dtype for k in car)


def test_first_conv_flips_no_bit_from_images(models, images, jax_first_words):
    got = tbnn.first_conv_packed(models["port"], t(images)).numpy()
    flipped = int(np.unpackbits((got ^ jax_first_words).view(np.uint8)).sum())
    assert flipped == 0, f"{flipped} sign bits flipped in the float first conv"


@pytest.mark.parametrize("conv_impl", ["direct", "im2col"])
def test_packed_words_exact_at_every_stage_boundary(models, jax_first_words,
                                                    conv_impl):
    jf, tf = models["jax"], models["carried"]
    jx, tx = jnp.asarray(jax_first_words), t(jax_first_words)
    for i in range(1, len(jbnn.CONV_CHANNELS)):
        k = 9 * jbnn.CONV_CHANNELS[i][0]
        kw = dict(kh=3, kw=3, stride=1, pad=1, conv_impl=conv_impl)
        jx = jl.fused_bit_conv2d(jf["conv"][i], jx, k, engine="xla", **kw)
        tx = tl.fused_bit_conv2d(tf["conv"][i], tx, k, engine="xnor", **kw)
        if i in jbnn.POOL_AFTER:
            jx, tx = jbit.maxpool2_packed(jx), tbit.maxpool2_packed(tx)
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx),
                                      err_msg=f"after conv{i}")
    jx, tx = jx.reshape(N_IMAGES, -1), tx.reshape(N_IMAGES, -1)
    for j in range(len(jbnn.FC_SIZES) - 1):
        k = jbnn.FC_SIZES[j][0]
        jx = jl.fused_bit_linear(jf["fc"][j], jx, k, engine="xla")
        tx = tl.fused_bit_linear(tf["fc"][j], tx, k, engine="xnor")
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx),
                                      err_msg=f"after fc{j}")
    # Bit 31 is set somewhere on the path (negative words travel too).
    assert (tx.numpy() < 0).any()


@pytest.mark.parametrize("conv_impl", ["direct", "im2col"])
def test_logits_match_jax(models, images, conv_impl):
    want = np.asarray(jbnn.bnn_apply_fused(models["jax"], jnp.asarray(images),
                                           engine="xla", conv_impl=conv_impl))
    for params in ("port", "carried"):
        got = tbnn.bnn_apply_fused(models[params], t(images), engine="xnor",
                                   conv_impl=conv_impl).numpy()
        assert got.shape == (N_IMAGES, 10) and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5,
                                   err_msg=params)
        np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


def test_engines_and_conv_impls_agree_bit_for_bit(models, images):
    x = t(images[:1])
    ref = tbnn.bnn_apply_fused(models["port"], x, engine="xla",
                               conv_impl="direct").numpy()
    for engine in ("xla", "xnor"):
        for conv_impl in ("direct", "im2col"):
            np.testing.assert_array_equal(
                tbnn.bnn_apply_fused(models["port"], x, engine=engine,
                                     conv_impl=conv_impl).numpy(), ref)


def test_entry_points_run_on_cuda_unless_told_otherwise():
    import torch

    if torch.cuda.is_available():
        assert tbnn.resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tbnn.load_binary_checkpoint(CKPT)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tbnn.init_bnn_params(0)
    assert tbnn.resolve_device("cpu").type == "cpu"


def test_configs_mirror_the_jax_package():
    import dataclasses

    from repro.core.layers import BitLinearConfig as JaxLayerCfg

    names = lambda cls: [f.name for f in dataclasses.fields(cls)]  # noqa: E731
    assert set(names(tl.BitLinearConfig)) <= set(names(JaxLayerCfg))
    assert tl.BitLinearConfig().mode == JaxLayerCfg().mode
    assert tl.BitLinearConfig().binarize_acts == JaxLayerCfg().binarize_acts


# Kernel wrappers one forward of each conv_impl calls: the direct path
# runs its five binary convs through fused_direct_conv, im2col through
# fused_xnor_gemm; fc0/fc1 are fused GEMMs and the head an xnor_gemm;
# neither calls a megakernel, a kernel of the unfused PACKED path nor
# the LM stack's kernels. chip_smoke.py holds each served path's launch
# counts to this table.
NO_MEGAKERNEL = {"megakernel_conv_stage": 0, "megakernel_chain": 0,
                 "pack_rows": 0, "direct_conv": 0, "unpack_gemm": 0,
                 "ssm_scan_chunk": 0, "flash_attention": 0,
                 "mlstm_chunked": 0}
WRAPPER_CALLS = {
    "direct": {"xnor_gemm": 1, "fused_xnor_gemm": 2, "fused_direct_conv": 5,
               **NO_MEGAKERNEL},
    "im2col": {"xnor_gemm": 1, "fused_xnor_gemm": 7, "fused_direct_conv": 0,
               **NO_MEGAKERNEL},
}


@pytest.mark.parametrize("conv_impl", ["direct", "im2col"])
def test_each_conv_impl_calls_its_own_kernels(models, images, conv_impl,
                                              monkeypatch):
    from repro_torch.kernels import ops

    calls = dict.fromkeys(ops.LAUNCHES, 0)

    def counted(name):
        fn = getattr(ops, name)

        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    for name in calls:
        monkeypatch.setattr(ops, name, counted(name))
    tbnn.bnn_apply_fused(models["port"], t(images[:1]), engine="xnor",
                         conv_impl=conv_impl)
    assert calls == WRAPPER_CALLS[conv_impl]
