"""The encoder-decoder family of the port (``models/encdec.py``,
``attention.cross_attention``) against the JAX package, at
``smoke_config("seamless-m4t-large-v2")`` (float32, 2 encoder and 2
decoder layers, d_model 128, 4 heads of 32 with 2 KV heads, LayerNorm,
GeLU).

Params are the JAX package's ``PRNGKey(0)`` init, carried across with
``params_from_numpy``; frames, tokens and labels come from numpy. Module
by module (``cross_attention``, ``encode``, ``decode``), then the model:
its loss under ``float_policy()`` and ``train_policy()``, and its packed
prefill (frames and a token prompt) plus two teacher-forced decode steps
under ``serve_policy()``, the decoder's cache and the encoder's memory
carried in the state. Float32 sums in other orders: rtol/atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as j_configs
from repro.models import attention as j_attn
from repro.models import encdec as j_encdec
from repro.models.model_factory import build_model as j_build_model
from repro_torch import configs as t_configs
from repro_torch import tree
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.launch import serve as launch_serve
from repro_torch.models import attention as t_attn
from repro_torch.models import encdec as t_encdec
from repro_torch.models.model_factory import build_model

from torch_parity import t

ARCH = "seamless-m4t-large-v2"
TOL = dict(rtol=1e-5, atol=1e-5)
BATCH, S_ENC, SEQ, STEPS = 2, 24, 16, 2
J_CFG = j_configs.smoke_config(ARCH)
T_CFG = t_configs.smoke_config(ARCH)
POLICIES = ("float", "train", "serve")


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(281)
    v = J_CFG.vocab_size
    return {"input_embeds": rng.normal(size=(BATCH, S_ENC, 128)).astype(np.float32),
            "tokens": rng.integers(0, v, (BATCH, SEQ)).astype(np.int32),
            "labels": rng.integers(0, v, (BATCH, SEQ)).astype(np.int32),
            "steps": rng.integers(0, v, (BATCH, STEPS)).astype(np.int32)}


@pytest.fixture(scope="module")
def params():
    """The JAX package's float params and their packing."""
    p = j_build_model(J_CFG, j_configs.float_policy()).init(jax.random.PRNGKey(0))
    return {"float": p, "serve": j_build_model(J_CFG, j_configs.serve_policy()).pack(p)}


def policies(name):
    j = getattr(j_configs, f"{name}_policy")()
    return j, getattr(t_configs, f"{name}_policy")()


def torch_params(params, name):
    return params_from_numpy(params["serve" if name == "serve" else "float"],
                             device="cpu")


def jax_params(params, name):
    return params["serve" if name == "serve" else "float"]


def close(got: torch.Tensor, want, what=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, dtype=np.float32), **TOL,
                               err_msg=what)


def test_params_convert_unchanged(params):
    """``encoder`` / ``decoder`` (``layers`` with a leading [L] axis,
    ``final_norm``), ``embed`` and ``lm_head`` carry across unchanged,
    float and packed, and the port's init draws the same tree."""
    for p in params.values():
        tp = params_from_numpy(p, device="cpu")
        leaves_j = jax.tree_util.tree_leaves_with_path(p)
        leaves_t = list(tree.leaves_with_path(tp))
        assert len(leaves_j) == len(leaves_t)
        for (jpath, j), (tpath, got) in zip(leaves_j, leaves_t):
            assert jax.tree_util.keystr(jpath) == "".join(f"[{k!r}]" for k in tpath)
            assert str(np.asarray(j).dtype) == str(got.dtype).removeprefix("torch.")
            np.testing.assert_array_equal(got.numpy(), np.asarray(j))
    mine = build_model(T_CFG, t_configs.float_policy()).init(torch.Generator().manual_seed(0))
    assert [(p, tuple(x.shape)) for p, x in tree.leaves_with_path(mine)] == [
        (p, tuple(x.shape)) for p, x in tree.leaves_with_path(
            params_from_numpy(params["float"], device="cpu"))]
    assert mine["decoder"]["layers"]["norm3"]["scale"].shape == (2, 128)


@pytest.mark.parametrize("name", POLICIES)
def test_cross_attention_matches_jax(params, inputs, name):
    """The first decoder layer's cross-attention: decoder states [2, 16,
    128] into a memory of 24 frames (no RoPE, no mask)."""
    j_pol, t_pol = policies(name)
    rng = np.random.default_rng(282)
    x = rng.normal(size=(BATCH, SEQ, 128)).astype(np.float32)
    memory = rng.normal(size=(BATCH, S_ENC, 128)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], jax_params(params, name)["decoder"]["layers"])
    tp = tree.tree_map(lambda a: a[0],
                       torch_params(params, name)["decoder"]["layers"])
    want = j_attn.cross_attention(jp["cross_attn"], jnp.asarray(x), jnp.asarray(memory),
                                  J_CFG, j_pol)
    close(t_attn.cross_attention(tp["cross_attn"], t(x), t(memory), T_CFG, t_pol), want)


@pytest.mark.parametrize("name", POLICIES)
def test_encode_and_decode_match_jax(params, inputs, name):
    j_pol, t_pol = policies(name)
    jp, tp = jax_params(params, name), torch_params(params, name)
    memory = jax.jit(lambda p, f: j_encdec.encode(p, f, J_CFG, j_pol))(
        jp, inputs["input_embeds"])
    logits, _ = jax.jit(lambda p, tok, m: j_encdec.decode(p, tok, m, J_CFG, j_pol))(
        jp, inputs["tokens"], memory)
    with torch.no_grad():
        t_memory = t_encdec.encode(tp, t(inputs["input_embeds"]), T_CFG, t_pol)
        close(t_memory, memory, "memory")
        t_logits, state = t_encdec.decode(tp, t(inputs["tokens"]).long(),
                                          t(np.asarray(memory)), T_CFG, t_pol)
    assert state is None and t_logits.shape == (BATCH, SEQ, 512)
    close(t_logits, logits, "logits")


@pytest.mark.parametrize("name", ("float", "train"))
def test_loss_matches_jax(params, inputs, name):
    j_pol, t_pol = policies(name)
    batch = {k: inputs[k] for k in ("input_embeds", "tokens", "labels")}
    want = jax.jit(j_build_model(J_CFG, j_pol).loss)(params["float"], batch)
    model = build_model(T_CFG, t_pol)
    with torch.no_grad():
        total, metrics = model.loss(
            torch_params(params, name),
            {k: t(v).long() if v.dtype == np.int32 else t(v) for k, v in batch.items()})
    assert set(metrics) == set(want[1]) == {"loss"}
    np.testing.assert_allclose(float(total), float(want[0]), **TOL)


def test_packed_prefill_and_decode_match_jax(params, inputs):
    """Prefill: frames and a token prompt; ``memory`` rides in the state.
    Then two decode steps, and one more with the memory in the batch."""
    jm = j_build_model(J_CFG, j_configs.serve_policy())
    state = jm.init_state(BATCH, SEQ + STEPS + 1, dtype=jnp.float32)
    prompt = {"input_embeds": inputs["input_embeds"], "tokens": inputs["tokens"]}
    logits, state = jax.jit(jm.prefill)(params["serve"], state, prompt)
    decode = jax.jit(jm.decode_step)
    want = [np.asarray(logits)]
    for i in range(STEPS):
        logits, state = decode(params["serve"], state,
                               {"tokens": inputs["steps"][:, i:i + 1]})
        want.append(np.asarray(logits))
    memory = state.pop("memory")
    logits, _ = decode(params["serve"], state,
                       {"tokens": inputs["steps"][:, :1], "memory": memory})
    want.append(np.asarray(logits))

    model = build_model(T_CFG, t_configs.serve_policy())
    tp = torch_params(params, "serve")
    st = model.init_state(BATCH, SEQ + STEPS + 1, dtype=torch.float32, device="cpu")
    before = dict(ops.LAUNCHES)
    with torch.inference_mode():
        logits, st = model.prefill(tp, st, {"input_embeds": t(inputs["input_embeds"]),
                                            "tokens": t(inputs["tokens"]).long()})
        got = [logits]
        for i in range(STEPS):
            logits, st = model.decode_step(
                tp, st, {"tokens": t(inputs["steps"][:, i:i + 1]).long()})
            got.append(logits)
        assert set(st) == {"kv", "index", "memory"} and st["index"] == SEQ + STEPS
        memory = st.pop("memory")
        logits, st = model.decode_step(
            tp, st, {"tokens": t(inputs["steps"][:, :1]).long(), "memory": memory})
        got.append(logits)
    assert "memory" not in st and ops.LAUNCHES == before
    for step, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape == (BATCH, 512)
        close(g, w, f"step {step}")


def test_init_packed_is_pack_of_init():
    model = build_model(T_CFG, t_configs.serve_policy())
    packed = model.init_packed(torch.Generator().manual_seed(6))
    want = model.pack(model.init(torch.Generator().manual_seed(6)))
    assert len(tree.leaves(packed)) == len(tree.leaves(want))
    for (path, got), w in zip(tree.leaves_with_path(packed), tree.leaves(want)):
        assert torch.equal(got, w), path


def test_serve_runs_on_cpu():
    r = launch_serve.serve(ARCH, batch=2, prompt_len=16, gen=3, device="cpu")
    assert r["tokens"].shape == (2, 3)
    assert set(r["batch"]) == {"input_embeds", "tokens"}
    assert r["batch"]["input_embeds"].shape == (2, 16, 128)
    assert torch.equal(r["batch"]["tokens"], r["prompts"])
