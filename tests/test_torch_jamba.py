"""The LM slice whole: jamba served through the port against the JAX
package, on the JAX package's params.

``build_model(smoke_config("jamba-1.5-large-398b"), policy)`` (float32,
4 layers in 2 hybrid periods of mamba+MoE / attention+dense, 8
experts), ``PRNGKey(0)`` init, packed under ``serve_policy()``; a
2 x 512 prompt (two mamba chunks, so the state crosses a chunk
boundary) from numpy, then 3 greedy decode steps. The port runs the
same params (``params_from_numpy``), teacher-forced with the JAX tokens.
Both sides sum float32 products in other orders (the scan's ``y``: a
sequential recurrence here, an associative scan in JAX on the CPU; the
unpacked-weight matmuls; attention), and the differences pass through 4
layers and the LM head: logits within rtol/atol 1e-4, argmax equal. The
JAX side is jitted once per policy (a module fixture).
"""

import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import float_policy as j_float_policy
from repro.configs import serve_policy as j_serve_policy
from repro.configs import smoke_config as j_smoke_config
from repro.models.model_factory import build_model as j_build_model
from repro_torch.configs.base import float_policy, serve_policy, smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.models.model_factory import build_model

from torch_parity import t

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "jamba-1.5-large-398b"
BATCH, PROMPT, STEPS = 2, 512, 3
TOL = dict(rtol=1e-4, atol=1e-4)
POLICIES = {"serve": (j_serve_policy, serve_policy),
            "float": (j_float_policy, float_policy)}


@pytest.fixture(scope="module")
def prompts():
    return np.random.default_rng(140).integers(
        0, j_smoke_config(ARCH).vocab_size, (BATCH, PROMPT)).astype(np.int32)


@pytest.fixture(scope="module", params=sorted(POLICIES))
def served(request, prompts):
    """The JAX package's prefill and greedy decode logits, its params (as
    torch tensors) and its tokens."""
    j_policy, t_policy = POLICIES[request.param]
    cfg = j_smoke_config(ARCH)
    model = j_build_model(cfg, j_policy())
    params = model.init(jax.random.PRNGKey(0))
    if request.param == "serve":
        params = model.pack(params)
    state = model.init_state(BATCH, PROMPT + STEPS, dtype=jnp.float32)
    logits, state = jax.jit(model.prefill)(params, state,
                                           {"tokens": jnp.asarray(prompts)})
    decode = jax.jit(model.decode_step)
    steps, tokens = [np.asarray(logits)], []
    for _ in range(STEPS):
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        tokens.append(np.asarray(tok))
        logits, state = decode(params, state, {"tokens": tok})
        steps.append(np.asarray(logits))
    return {"policy": t_policy(), "jax_params": params,
            "params": params_from_numpy(params, device="cpu"),
            "logits": steps, "tokens": tokens}


def test_lm_params_convert_unchanged(served):
    """The LM tree (a list over period positions of dicts whose leaves
    carry the periods axis; int32 ``w_packed`` and ``alpha`` when packed)
    carries across with the same structure, dtypes and values."""
    def same(j, p, path):
        if isinstance(j, dict):
            assert isinstance(p, dict) and j.keys() == p.keys(), path
            for k in j:
                same(j[k], p[k], f"{path}/{k}")
        elif isinstance(j, list):
            assert isinstance(p, list) and len(j) == len(p), path
            for i, (a, b) in enumerate(zip(j, p)):
                same(a, b, f"{path}/{i}")
        else:
            a = np.asarray(j)
            assert str(a.dtype) == str(p.dtype).removeprefix("torch."), path
            np.testing.assert_array_equal(p.numpy(), a, err_msg=path)

    same(served["jax_params"], served["params"], "")
    layers = served["params"]["layers"]
    assert len(layers) == 2 and layers[0]["norm1"]["scale"].shape == (2, 128)


def test_prefill_and_decode_match_jax(served, prompts):
    model = build_model(smoke_config(ARCH), served["policy"])
    state = model.init_state(BATCH, PROMPT + STEPS, dtype=torch.float32,
                             device="cpu")
    with torch.inference_mode():
        logits, state = model.prefill(served["params"], state,
                                      {"tokens": t(prompts).long()})
        got = [logits.numpy()]
        for tok in served["tokens"]:
            logits, state = model.decode_step(served["params"], state,
                                              {"tokens": t(tok).long()})
            got.append(logits.numpy())
    assert state["index"] == PROMPT + STEPS
    for step, (g, w) in enumerate(zip(got, served["logits"])):
        assert g.shape == w.shape == (BATCH, 512)
        np.testing.assert_allclose(g, w, **TOL, err_msg=f"step {step}")
        np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1))


def test_packed_init_is_pack_of_init():
    """``init_packed`` draws and packs projection by projection (expert by
    expert): the same params as ``pack(init(...))`` from the same seed."""
    model = build_model(smoke_config(ARCH), serve_policy())
    packed = model.init_packed(torch.Generator().manual_seed(3))
    want = model.pack(model.init(torch.Generator().manual_seed(3)))

    def leaves(tree, path=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{path}/{k}")
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                yield from leaves(v, f"{path}/{i}")
        else:
            yield path, tree

    got, exp = dict(leaves(packed)), dict(leaves(want))
    assert got.keys() == exp.keys()
    assert "/layers/0/moe/up_proj/alpha" in got
    for path, leaf in got.items():
        assert leaf.dtype == exp[path].dtype and torch.equal(leaf, exp[path]), path


def test_prefill_calls_the_scan_once_per_chunk(monkeypatch):
    """The launch table chip_smoke holds the card to: one ``ssm_scan_chunk``
    call per mamba layer and 256-step chunk in the prefill, none in a
    decode step, and no other kernel wrapper."""
    calls = dict.fromkeys(ops.LAUNCHES, 0)

    def counted(name):
        fn = getattr(ops, name)

        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    for name in calls:
        monkeypatch.setattr(ops, name, counted(name))
    cfg = smoke_config(ARCH)
    model = build_model(cfg, serve_policy())
    params = model.init_packed(torch.Generator().manual_seed(0))
    state = model.init_state(1, 520, device="cpu")
    tokens = torch.zeros((1, 512), dtype=torch.long)
    with torch.inference_mode():
        _, state = model.prefill(params, state, {"tokens": tokens})
        mamba_layers = state["mamba"]["h"].shape[0]
        assert calls == {**dict.fromkeys(ops.LAUNCHES, 0),
                         "ssm_scan_chunk": 2 * mamba_layers}
        calls.update(dict.fromkeys(calls, 0))
        model.decode_step(params, state, {"tokens": tokens[:, :1]})
    assert calls == dict.fromkeys(ops.LAUNCHES, 0)


def test_serve_cli_runs_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--batch", "2", "--prompt-len", "16", "--gen", "4"],
        check=True, capture_output=True, text=True, timeout=120, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert "generated shape (2, 4)" in out.stdout


def test_serve_raises_without_cuda_when_asked_for_it():
    from repro_torch.launch.serve import serve

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        serve(ARCH, batch=1, prompt_len=8, gen=2)
