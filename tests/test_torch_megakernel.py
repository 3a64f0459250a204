"""The megakernel path of the port against the JAX package's.

* The plain-torch twins ``conv_stage_xla``, ``megakernel_chain_xla`` and
  ``megakernel_chain_ragged_xla`` equal the JAX package's oracles bit for
  bit at the CIFAR net's three stage shapes and its FC trunk (batch 2),
  masked-tail pad columns included; at one tiny shape they equal the JAX
  Pallas kernels run in interpret mode.
* ``stack_chain_layers`` and ``pack_bnn_params_megakernel`` build the
  JAX package's operands.
* On the trained checkpoint, ``bnn_apply_megakernel`` gives packed words
  exact to JAX's at every stage boundary (walking from JAX's first-conv
  words with its folded ``(a, b)`` carried across), logits within rtol
  1e-6 / atol 1e-5 of JAX's (the rsqrt gap of ``fold_bn_params``), and
  logits bit-identical to the port's own ``bnn_apply_fused``.

Inputs are drawn with numpy from fixed seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitops as jbit
from repro.core import bnn as jbnn
from repro.core import layers as jl
from repro.kernels import megakernel as jmega
from repro.kernels import ops as jops
from repro_torch.convert import params_from_numpy
from repro_torch.core import bitops as tbit
from repro_torch.core import bnn as tbnn
from repro_torch.core import layers as tl
from repro_torch.kernels import ops as tops

from torch_parity import CKPT, pm1, t, words

N_IMAGES = 2

# (H of the stage's input, channels in, channels out of each conv)
STAGES = {"stage1": (32, (128, 128)), "stage2": (16, (128, 256, 256)),
          "stage3": (8, (256, 512, 512))}


def affine(rng, m, k_bits):
    """A folded affine whose sign threshold lands inside the dot's
    spread, so the packed outputs carry both bit values."""
    a = rng.normal(size=m).astype(np.float32)
    b = (rng.normal(size=m) * np.sqrt(k_bits) * np.abs(a)).astype(np.float32)
    return a, b


def stage_operands(rng, h, chans, n=N_IMAGES):
    weights, a, b, k_bits = [], [], [], []
    for cin, cout in zip(chans[:-1], chans[1:]):
        weights.append(words(rng, (cout, 9 * cin // 32)))
        ai, bi = affine(rng, cout, 9 * cin)
        a.append(ai)
        b.append(bi)
        k_bits.append(9 * cin)
    return words(rng, (n, h, h, chans[0] // 32)), weights, a, b, k_bits


@pytest.mark.parametrize("stage", list(STAGES))
def test_conv_stage_twin_matches_jax(stage):
    h, chans = STAGES[stage]
    xp, weights, a, b, k_bits = stage_operands(np.random.default_rng(40), h,
                                               chans)
    want = jbit.conv_stage_xla(jnp.asarray(xp), tuple(map(jnp.asarray, weights)),
                               tuple(map(jnp.asarray, a)),
                               tuple(map(jnp.asarray, b)), tuple(k_bits))
    got = tbit.conv_stage_xla(t(xp), tuple(map(t, weights)), tuple(map(t, a)),
                              tuple(map(t, b)), tuple(k_bits))
    assert got.shape == (N_IMAGES, h // 2, h // 2, chans[-1] // 32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def trunk(rng, dims=(8192, 1024, 1024)):
    """Random fused FC layers of the CIFAR trunk, as numpy dicts."""
    layers = []
    for k, m in zip(dims[:-1], dims[1:]):
        a, b = affine(rng, m, k)
        layers.append({"w_packed": words(rng, (m, k // 32)), "a": a, "b": b})
    return layers


def test_stack_chain_layers_matches_jax():
    # Ragged layers: rows and words pad differently per layer.
    rng = np.random.default_rng(41)
    layers = [{"w_packed": words(rng, (m, kw)),
               "a": rng.normal(size=m).astype(np.float32),
               "b": rng.normal(size=m).astype(np.float32)}
              for m, kw in ((50, 3), (33, 2), (64, 1))]
    want = jl.stack_chain_layers(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in layers])
    got = tl.stack_chain_layers([{k: t(v) for k, v in p.items()} for p in layers])
    for key in ("w", "a", "b"):
        assert got[key].dtype == (tbit.PACKED_DTYPE if key == "w"
                                  else torch.float32)
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


@pytest.mark.parametrize("head", [False, True])
def test_chain_twin_matches_jax_on_the_fc_trunk(head):
    rng = np.random.default_rng(42)
    layers = trunk(rng)
    stack_j = jl.stack_chain_layers(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in layers])
    stack_t = tl.stack_chain_layers([{k: t(v) for k, v in p.items()}
                                     for p in layers])
    assert tuple(stack_t["w"].shape) == (2, 1024, 256)
    xp = words(rng, (256, 3))
    fin = words(rng, (10, 32))
    kw_j = dict(final_wp=jnp.asarray(fin), final_k_bits=1024) if head else {}
    kw_t = dict(final_wp=t(fin), final_k_bits=1024) if head else {}
    want = jbit.megakernel_chain_xla(stack_j["w"], stack_j["a"], stack_j["b"],
                                     (8192, 1024), jnp.asarray(xp), 1024, **kw_j)
    got = tbit.megakernel_chain_xla(stack_t["w"], stack_t["a"], stack_t["b"],
                                    (8192, 1024), t(xp), 1024, **kw_t)
    assert got.shape == ((10, 3) if head else (32, 3))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n_real,head", [(1, True), (3, False), (13, True)])
def test_ragged_chain_twin_matches_jax_pad_columns_included(n_real, head):
    rng = np.random.default_rng(43 + n_real)
    layers = trunk(rng)
    stack_j = jl.stack_chain_layers(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in layers])
    stack_t = tl.stack_chain_layers([{k: t(v) for k, v in p.items()}
                                     for p in layers])
    n_pad = -(-n_real // tops.RAGGED_TILE_N) * tops.RAGGED_TILE_N
    xp = words(rng, (256, n_pad))    # pad columns hold random words too
    fin = words(rng, (10, 32))
    kw_j = dict(final_wp=jnp.asarray(fin), final_k_bits=1024) if head else {}
    kw_t = dict(final_wp=t(fin), final_k_bits=1024) if head else {}
    want = np.asarray(jbit.megakernel_chain_ragged_xla(
        stack_j["w"], stack_j["a"], stack_j["b"], (8192, 1024),
        jnp.asarray(xp), 1024, n_real, **kw_j))
    got = tbit.megakernel_chain_ragged_xla(
        stack_t["w"], stack_t["a"], stack_t["b"], (8192, 1024), t(xp), 1024,
        n_real, **kw_t).numpy()
    assert got.shape[1] == n_pad and not got[:, n_real:].any()
    np.testing.assert_array_equal(got, want)
    # The wrapper's CPU path: the same real columns.
    wrapped = tops.megakernel_chain(
        stack_t["w"], stack_t["a"], stack_t["b"], (8192, 1024), t(xp), 1024,
        ragged_tile=tops.RAGGED_TILE_N, n_real=n_real, **kw_t)
    np.testing.assert_array_equal(wrapped.numpy(), want)


def test_twins_match_the_pallas_kernels_in_interpret_mode():
    """A two-conv stage with ragged channels, and a two-layer chain whose
    last batch tile hangs past n_real (pad columns masked in-kernel)."""
    rng = np.random.default_rng(44)
    chans = (40, 50, 70)
    weights_f = [pm1(rng, (cout, 3, 3, cin))
                 for cin, cout in zip(chans[:-1], chans[1:])]
    a = [rng.normal(size=c).astype(np.float32) for c in chans[1:]]
    b = [(rng.normal(size=c) * 6).astype(np.float32) for c in chans[1:]]
    k_bits = tuple(9 * c for c in chans[:-1])
    x = pm1(rng, (2, 4, 4, chans[0]))
    jw = tuple(jl.pack_conv_aligned({"w": jnp.asarray(w)})["w_packed"]
               for w in weights_f)
    tw = tuple(tl.pack_conv_aligned({"w": t(w)})["w_packed"] for w in weights_f)
    for jwi, twi in zip(jw, tw):
        np.testing.assert_array_equal(twi.numpy(), np.asarray(jwi))
    want = jops.megakernel_conv_stage(
        jbit.pack_channels(jnp.asarray(x)), jw, tuple(map(jnp.asarray, a)),
        tuple(map(jnp.asarray, b)), k_bits, interpret=True)
    got = tbit.conv_stage_xla(tbit.pack_channels(t(x)), tw, tuple(map(t, a)),
                              tuple(map(t, b)), k_bits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    dims, n, block_n = (70, 50, 33), 13, 8     # n_pad 16: tail masks 3
    layers = []
    for k, m in zip(dims[:-1], dims[1:]):
        w = np.concatenate([pm1(rng, (m, k)), -np.ones((m, -k % 32), np.float32)],
                           axis=1)
        layers.append({"w_packed": np.asarray(jbit.pack_bits(jnp.asarray(w))),
                       "a": rng.normal(size=m).astype(np.float32),
                       "b": (rng.normal(size=m) * 4).astype(np.float32)})
    stack_j = jl.stack_chain_layers(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in layers])
    stack_t = tl.stack_chain_layers([{k: t(v) for k, v in p.items()}
                                     for p in layers])
    l_, m_max, kw_max = stack_t["w"].shape
    kw_act = max(kw_max, m_max // 32)
    xp = np.full((kw_act, 16), -1, np.int32)
    xp[:3, :n] = words(rng, (3, n))
    kw_true = [-(-k // 32) for k in dims[:-1]]
    want = jmega.megakernel_chain(
        stack_j["w"], stack_j["a"], stack_j["b"],
        jnp.asarray(dims[:-1], jnp.int32)[:, None],
        jnp.asarray(kw_true, jnp.int32)[:, None], jnp.asarray(xp), None,
        jnp.full((1, 1), n, jnp.int32), block_n=block_n, word_group=1,
        interpret=True)
    got = tbit.megakernel_chain_ragged_xla(stack_t["w"], stack_t["a"],
                                           stack_t["b"], dims[:-1], t(xp),
                                           dims[-1], n)
    rows = -(-dims[-1] // 32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want)[:rows])
    assert not got[:, n:].any()


# --- the trained checkpoint --------------------------------------------------

@pytest.fixture(scope="module")
def models():
    jp = jbnn.load_binary_checkpoint(str(CKPT))
    jm = jbnn.pack_bnn_params_megakernel(jp)
    tp = tbnn.load_binary_checkpoint(CKPT, device="cpu")
    return {
        "jax": jm,
        "carried": params_from_numpy(jax.tree_util.tree_map(np.asarray, jm),
                                     device="cpu"),
        "port": tbnn.pack_bnn_params_megakernel(tp),
        "port_fused": tbnn.pack_bnn_params_fused(tp),
    }


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(2025).normal(
        size=(N_IMAGES, 32, 32, 3)).astype(np.float32)


def test_pack_bnn_params_megakernel_matches_jax(models):
    jm, own, fused = models["jax"], models["port"], models["port_fused"]
    assert set(own) == set(jm)
    # Packed words are exact; the folded affines are the port's own fold
    # (within a few ulp of JAX's, see test_torch_layers), stacked exactly.
    np.testing.assert_array_equal(own["fc_stack"]["w"].numpy(),
                                  np.asarray(jm["fc_stack"]["w"]))
    assert not own["fc_stack"]["w"][1, :, 32:].any()   # fc1's K pad words
    want = tl.stack_chain_layers(fused["fc"][:-1])
    for key in ("a", "b"):
        assert own["fc_stack"][key].shape == jm["fc_stack"][key].shape
        np.testing.assert_array_equal(own["fc_stack"][key].numpy(),
                                      want[key].numpy())
    for jd, td in zip(jm["conv"][1:], own["conv"][1:]):
        np.testing.assert_array_equal(td["w_packed"].numpy(),
                                      np.asarray(jd["w_packed"]))
    np.testing.assert_array_equal(own["fc_final"]["w_packed"].numpy(),
                                  np.asarray(jm["fc_final"]["w_packed"]))
    # Carried across, JAX's own stack is what the port's stacking of the
    # carried fused layers gives.
    carried_fused = params_from_numpy(jax.tree_util.tree_map(
        np.asarray, jbnn.pack_bnn_params_fused(jbnn.load_binary_checkpoint(
            str(CKPT)))), device="cpu")
    restacked = tl.stack_chain_layers(carried_fused["fc"][:-1])
    for key in ("w", "a", "b"):
        np.testing.assert_array_equal(restacked[key].numpy(),
                                      np.asarray(jm["fc_stack"][key]))


def test_packed_words_exact_at_every_stage_boundary(models, images):
    jm, tm = models["jax"], models["carried"]
    cfg = jl.BitLinearConfig(mode=jbnn.QuantMode.FAKE_QUANT,
                             binarize_acts=False)
    x = jl.bit_conv2d(jm["conv"][0], jnp.asarray(images), cfg, stride=1, pad=1)
    x = jbnn._batchnorm(jm["bn_conv0"], x, training=False)
    jx = jbit.pack_bits(x, axis=-1)
    tx = t(np.asarray(jx))
    for stage in jbnn.CONV_STAGES:
        k_bits = tuple(9 * jbnn.CONV_CHANNELS[i][0] for i in stage)
        jx = jl.megakernel_conv_stage([jm["conv"][i] for i in stage], jx,
                                      k_bits, engine="xla")
        tx = tl.megakernel_conv_stage([tm["conv"][i] for i in stage], tx,
                                      k_bits, engine="xnor")
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx),
                                      err_msg=f"after stage {stage}")
    jx, tx = jx.reshape(N_IMAGES, -1), tx.reshape(N_IMAGES, -1)
    k_bits = tuple(fin for fin, _ in jbnn.FC_SIZES[:-1])
    jy = jl.megakernel_fc_chain(jm["fc_stack"], jx, k_bits, 1024, engine="xla")
    ty = tl.megakernel_fc_chain(tm["fc_stack"], tx, k_bits, 1024,
                                engine="xnor", ragged=True)
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy),
                                  err_msg="after fc1")
    assert (ty.numpy() < 0).any()   # bit 31 set somewhere on the path


def test_logits_match_jax_and_the_fused_forward(models, images):
    want = np.asarray(jbnn.bnn_apply_megakernel(models["jax"],
                                                jnp.asarray(images),
                                                engine="xla"))
    fused = tbnn.bnn_apply_fused(models["port_fused"], t(images),
                                 engine="xla", conv_impl="direct").numpy()
    for params in ("port", "carried"):
        for engine in ("xnor", "xla"):
            got = tbnn.bnn_apply_megakernel(models[params], t(images),
                                            engine=engine).numpy()
            assert got.shape == (N_IMAGES, 10) and np.isfinite(got).all()
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5,
                                       err_msg=f"{params}/{engine}")
            np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
            if params == "port":
                np.testing.assert_array_equal(got, fused)


def test_megakernel_forward_calls_one_kernel_per_stage(models, images,
                                                       monkeypatch):
    """Wrapper calls per forward: 3 conv stages and 1 chain, none of the
    per-layer kernels (the table chip_smoke holds the card to)."""
    calls = dict.fromkeys(tops.LAUNCHES, 0)

    def counted(name):
        fn = getattr(tops, name)

        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    for name in calls:
        monkeypatch.setattr(tops, name, counted(name))
    tbnn.bnn_apply_megakernel(models["port"], t(images[:1]), engine="xnor",
                              ragged=True)
    assert calls == {"xnor_gemm": 0, "fused_xnor_gemm": 0,
                     "fused_direct_conv": 0, "megakernel_conv_stage": 3,
                     "megakernel_chain": 1, "pack_rows": 0, "direct_conv": 0,
                     "unpack_gemm": 0, "ssm_scan_chunk": 0,
                     "flash_attention": 0, "mlstm_chunked": 0}
