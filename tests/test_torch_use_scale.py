"""The packed BNN with the XNOR-Net alpha (``use_scale``) and with a
kernel tiling (``blocks``), against the JAX package on the same numpy
latent params, at batch 2 on the CPU.

Random latent weights (not the ±1 trained checkpoint, whose alpha is 1
everywhere). Packed words are exact. ``alpha`` is a float32 mean summed
in another order than XLA's, and the folded ``a = s * alpha`` carries
the ``rsqrt`` gap of ``tests/test_torch_layers.py`` too, so both are
held within rtol 1e-6 (the folded ``b``, which cancels, within 1e-6 of
its layer's largest). Logits are held within that file's rtol 1e-6 /
atol 1e-5 with the JAX package's packed params carried across, and from
the port's own packing, where no sign bit flips on this seed.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bnn as jbnn
from repro.core.binarize import QuantMode as JQuantMode
from repro_torch.convert import params_from_numpy
from repro_torch.core import bnn as tbnn
from repro_torch.core.binarize import QuantMode
from repro_torch.kernels.autotune import BlockConfig

from torch_parity import t

LOGIT_TOL = dict(rtol=1e-6, atol=1e-5)


def _latent(rng) -> dict:
    """Latent params of the CIFAR BNN drawn from ``rng``: He-normal
    weights, small biases, BN statistics spread over the dots' range so
    every layer's signs mix."""
    p = {"conv": [], "bn_conv": [], "fc": [], "bn_fc": []}

    def bn(d, k):
        return {"gamma": rng.uniform(0.5, 2.0, d), "beta": rng.normal(size=d),
                "mean": rng.normal(size=d) * 0.3 * np.sqrt(k),
                "var": rng.uniform(0.5, 2.0, d) * k}

    for cin, cout in jbnn.CONV_CHANNELS:
        k = 9 * cin
        p["conv"].append({"w": rng.normal(size=(cout, 3, 3, cin)) * np.sqrt(2 / k),
                          "b": rng.normal(size=cout) * 0.1})
        p["bn_conv"].append(bn(cout, k))
    for fin, fout in jbnn.FC_SIZES:
        p["fc"].append({"w": rng.normal(size=(fout, fin)) * np.sqrt(2 / fin),
                        "b": rng.normal(size=fout) * 0.1})
        p["bn_fc"].append(bn(fout, fin))
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), p)


@pytest.fixture(scope="module")
def latent():
    return _latent(np.random.default_rng(70))


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(71).normal(size=(2, 32, 32, 3)).astype(np.float32)


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _compare_packed(got, want, path=""):
    """Words exact, floats (alpha, a, b, BN) within rtol 1e-6."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _compare_packed(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _compare_packed(g, w, f"{path}[{i}]")
    elif np.asarray(want).dtype == np.int32:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=path)
    else:
        # b = s*(bias - mean) + beta cancels: its gap scales with the
        # layer's largest b, not with each b
        want = np.asarray(want)
        atol = 1e-6 * np.abs(want).max() if path.endswith("/b") else 0.0
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=atol,
                                   err_msg=path)


PACKERS = ["pack_bnn_params", "pack_bnn_params_fused",
           "pack_bnn_params_megakernel"]


@pytest.mark.parametrize("packer", PACKERS)
def test_use_scale_packers_match_jax(latent, packer):
    want = getattr(jbnn, packer)(_jax(latent), use_scale=True)
    got = getattr(tbnn, packer)(params_from_numpy(latent, device="cpu"),
                                use_scale=True)
    _compare_packed(got, want)
    assert "alpha" in (got["fc"][-1] if packer != "pack_bnn_params_megakernel"
                       else got["fc_final"])


def _forwards(packer):
    """(JAX forward, port forward) of the packing's serving path with
    alpha, both as plain-engine / twin forwards."""
    if packer == "pack_bnn_params":
        jcfg = jbnn.BNNConfig(mode=JQuantMode.PACKED, engine="xla",
                              use_scale=True)
        tcfg = tbnn.BNNConfig(mode=QuantMode.PACKED, engine="xnor",
                              use_scale=True)
        return (lambda p, x: jbnn.bnn_apply(p, x, jcfg),
                lambda p, x: tbnn.bnn_apply(p, x, tcfg))
    if packer == "pack_bnn_params_fused":
        return (lambda p, x: jbnn.bnn_apply_fused(p, x, engine="xla",
                                                  use_scale=True),
                lambda p, x: tbnn.bnn_apply_fused(p, x, engine="xnor",
                                                  use_scale=True))
    return (lambda p, x: jbnn.bnn_apply_megakernel(p, x, engine="xla",
                                                   use_scale=True),
            lambda p, x: tbnn.bnn_apply_megakernel(p, x, engine="xnor",
                                                   use_scale=True))


@pytest.mark.parametrize("packer", PACKERS)
def test_use_scale_logits_match_jax(latent, images, packer):
    jfwd, tfwd = _forwards(packer)
    jfwd = jax.jit(jfwd)
    jpacked = getattr(jbnn, packer)(_jax(latent), use_scale=True)
    want = np.asarray(jfwd(jpacked, jnp.asarray(images)))
    carried = params_from_numpy(jax.tree_util.tree_map(np.asarray, jpacked),
                                device="cpu")
    own = getattr(tbnn, packer)(params_from_numpy(latent, device="cpu"),
                                use_scale=True)
    for name, params in (("carried", carried), ("own", own)):
        with torch.inference_mode():
            got = tfwd(params, t(images)).numpy()
        assert got.shape == (2, 10) and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, **LOGIT_TOL, err_msg=name)
    # alpha moves the logits: the same params without it give others
    plain = np.asarray(jfwd(getattr(jbnn, packer)(_jax(latent)), jnp.asarray(images)))
    assert not np.allclose(plain, want, **LOGIT_TOL)


def test_serving_paths_agree_with_alpha(latent, images):
    """With alpha the fused and megakernel forwards stay bit-identical to
    each other on both engines, as without it."""
    tp = params_from_numpy(latent, device="cpu")
    fused = tbnn.pack_bnn_params_fused(tp, use_scale=True)
    mega = tbnn.pack_bnn_params_megakernel(tp, use_scale=True)
    x = t(images)
    with torch.inference_mode():
        ref = tbnn.bnn_apply_fused(fused, x, engine="xla", use_scale=True)
        for engine in ("xla", "xnor"):
            for conv_impl in ("direct", "im2col"):
                assert torch.equal(tbnn.bnn_apply_fused(
                    fused, x, engine=engine, conv_impl=conv_impl,
                    use_scale=True), ref)
            assert torch.equal(tbnn.bnn_apply_megakernel(
                mega, x, engine=engine, use_scale=True, ragged=True), ref)


BLOCKS = [BlockConfig(block_n=32, k_splits=1), BlockConfig(block_n=128),
          BlockConfig(stage_cluster=4, chain_cluster=8)]


@pytest.mark.parametrize("blocks", BLOCKS, ids=lambda b: b.key())
def test_blocks_reach_every_kernel_and_leave_logits_alone(latent, images,
                                                          blocks, monkeypatch):
    """A tiling reaches the wrapper of every kernel that reads it (and no
    other), and the twins give the same logits under it."""
    from repro_torch.kernels import ops

    seen = []
    for name in ("xnor_gemm", "fused_xnor_gemm", "fused_direct_conv",
                 "megakernel_conv_stage", "megakernel_chain"):
        real = getattr(ops, name)

        def spy(*args, _real=real, _name=name, **kwargs):
            seen.append((_name, tuple(sorted(kwargs.items()))))
            return _real(*args, **kwargs)
        monkeypatch.setattr(ops, name, spy)
    tp = params_from_numpy(latent, device="cpu")
    fused = tbnn.pack_bnn_params_fused(tp)
    mega = tbnn.pack_bnn_params_megakernel(tp)
    x = t(images[:1])
    with torch.inference_mode():
        ref = tbnn.bnn_apply_fused(fused, x, engine="xla")
        for conv_impl in ("direct", "im2col"):
            fn = tbnn.bnn_serve_fn(engine="xnor", conv_impl=conv_impl,
                                   blocks=blocks)
            assert torch.equal(fn(fused, x), ref)
        fn = tbnn.bnn_serve_fn(engine="megakernel", blocks=blocks, ragged=True)
        assert torch.equal(fn(mega, x), ref)
    from repro_torch.kernels.autotune import block_kwargs

    for name, kwargs in seen:
        want = block_kwargs(blocks, name)
        assert {k: v for k, v in kwargs if k in ("tile_n", "k_splits",
                                                 "cluster")} == want, name
    assert {name for name, _ in seen} == {
        "xnor_gemm", "fused_xnor_gemm", "fused_direct_conv",
        "megakernel_conv_stage", "megakernel_chain"}


def test_bnn_config_mirrors_the_jax_package():
    names = lambda cls: {f.name for f in dataclasses.fields(cls)}  # noqa: E731
    assert names(tbnn.BNNConfig) == names(jbnn.BNNConfig)
    cfg = tbnn.BNNConfig(use_scale=True, blocks=BlockConfig(block_n=64))
    lcfg = cfg.layer_cfg(binarize_acts=True)
    assert lcfg.use_scale and lcfg.blocks == BlockConfig(block_n=64)
