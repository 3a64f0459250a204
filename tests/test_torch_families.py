"""The remaining decoder-only LM families of the port against the JAX
package: the configs, the shape cells, ``input_specs``, and the five
token configs (qwen2.5-3b, qwen2.5-32b, mistral-large-123b,
moonshot-v1-16b-a3b, arctic-480b) and pixtral-12b (fed patch
embeddings) at their smoke sizes.

Every ``ASSIGNED`` config and its ``smoke_config`` equal the JAX
package's field by field (``dtype`` mapped); ``SHAPES``,
``cell_applicable`` (reason strings included) and ``Model.input_specs``
agree on all 40 cells. Each smoke model gets the JAX package's
``PRNGKey(0)`` params (carried across with ``params_from_numpy``) and a
batch of 2 x 16 from numpy: its loss under ``float_policy()`` and
``train_policy()``, and its packed prefill plus two teacher-forced
decode steps under ``serve_policy()``, against the jitted JAX model.
Float32 sums in other orders through 2 layers: rtol/atol 1e-5 (a probe
of these configs saw at most 4.8e-7 on the loss and 3.5e-6 on logits up
to 4.5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as j_configs
from repro.models.model_factory import build_model as j_build_model
from repro_torch import configs as t_configs
from repro_torch import tree
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models.model_factory import build_model

from torch_parity import t

TOL = dict(rtol=1e-5, atol=1e-5)
BATCH, SEQ, STEPS = 2, 16, 2
ARCHS = ["qwen2.5-3b", "qwen2.5-32b", "mistral-large-123b",
         "moonshot-v1-16b-a3b", "arctic-480b", "pixtral-12b"]
DTYPES = {np.dtype(jnp.bfloat16): torch.bfloat16, np.dtype(jnp.float32): torch.float32,
          np.dtype(jnp.int32): torch.int32}
POLICIES = ("float", "train")


def same_tree(j, p, path=""):
    """The JAX tree ``j`` and the port's ``p`` have one structure, and
    equal leaves of one dtype."""
    if isinstance(j, dict):
        assert isinstance(p, dict) and j.keys() == p.keys(), path
        for k in j:
            same_tree(j[k], p[k], f"{path}/{k}")
    elif isinstance(j, (list, tuple)):
        assert type(p) is type(j) and len(j) == len(p), path
        for i, (a, b) in enumerate(zip(j, p)):
            same_tree(a, b, f"{path}/{i}")
    else:
        a = np.asarray(j)
        assert str(a.dtype) == str(p.dtype).removeprefix("torch."), path
        np.testing.assert_array_equal(p.numpy(), a, err_msg=path)


def fields(cfg) -> dict:
    out = dataclasses.asdict(cfg)
    if not isinstance(out["dtype"], torch.dtype):
        out["dtype"] = DTYPES[np.dtype(out["dtype"])]
    return out


# ------------------------------------------------------- configs and cells

def test_assigned_and_package_names_match_jax():
    assert t_configs.ASSIGNED == j_configs.ASSIGNED
    assert set(j_configs.ASSIGNED) <= set(t_configs.list_configs())
    assert set(t_configs.list_configs()) == set(j_configs.list_configs())
    for name in ("SHAPES", "ModelConfig", "ShapeConfig", "cell_applicable",
                 "float_policy", "get_config", "list_configs", "serve_policy",
                 "smoke_config", "train_policy", "bnn_cifar"):
        assert hasattr(t_configs, name) and hasattr(j_configs, name), name


@pytest.mark.parametrize("arch", j_configs.ASSIGNED)
def test_config_and_smoke_config_match_jax(arch):
    assert fields(t_configs.get_config(arch)) == fields(j_configs.get_config(arch))
    assert fields(t_configs.smoke_config(arch)) == fields(j_configs.smoke_config(arch))
    assert t_configs.get_config(arch).padded_vocab == j_configs.get_config(arch).padded_vocab


def test_shapes_match_jax():
    assert list(t_configs.SHAPES) == list(j_configs.SHAPES)
    for name, shape in j_configs.SHAPES.items():
        assert dataclasses.asdict(t_configs.SHAPES[name]) == dataclasses.asdict(shape)


@pytest.mark.parametrize("arch", j_configs.ASSIGNED)
def test_cells_and_input_specs_match_jax(arch):
    """``cell_applicable`` (its reason word for word) and the shapes and
    dtypes of ``input_specs`` for the arch's four cells; the port's specs
    live on the meta device."""
    j_cfg, t_cfg = j_configs.get_config(arch), t_configs.get_config(arch)
    jm = j_build_model(j_cfg, j_configs.serve_policy())
    tm = build_model(t_cfg, t_configs.serve_policy())
    for name, j_shape in j_configs.SHAPES.items():
        t_shape = t_configs.SHAPES[name]
        assert (t_configs.cell_applicable(t_cfg, t_shape)
                == j_configs.cell_applicable(j_cfg, j_shape)), name
        want, got = jm.input_specs(j_shape), tm.input_specs(t_shape)
        assert list(got) == list(want), name
        for k, spec in want.items():
            assert tuple(got[k].shape) == spec.shape, (name, k)
            assert got[k].dtype == DTYPES[np.dtype(spec.dtype)], (name, k)
            assert got[k].device.type == "meta", (name, k)


# ------------------------------------------- the smoke models against JAX

@pytest.fixture(scope="module", params=ARCHS)
def run(request):
    """The JAX package's losses under both policies, and its packed
    prefill and two teacher-forced decode steps, on its ``PRNGKey(0)``
    params and one numpy batch."""
    arch = request.param
    cfg = j_configs.smoke_config(arch)
    rng = np.random.default_rng(280)
    tokens = rng.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
    steps = rng.integers(0, cfg.vocab_size, (BATCH, STEPS)).astype(np.int32)
    batch = {"tokens": tokens, "labels": labels}
    prompt = {"tokens": tokens}
    if cfg.input_kind == "embeddings":
        embeds = rng.normal(size=(BATCH, SEQ, cfg.d_model)).astype(np.float32)
        batch["input_embeds"] = prompt["input_embeds"] = embeds
        del prompt["tokens"]
    params = j_build_model(cfg, j_configs.float_policy()).init(jax.random.PRNGKey(0))
    losses = {}
    for name in POLICIES:
        jm = j_build_model(cfg, getattr(j_configs, f"{name}_policy")())
        losses[name] = float(jax.jit(jm.loss)(params, batch)[0])
    jm = j_build_model(cfg, j_configs.serve_policy())
    packed = jm.pack(params)
    state = jm.init_state(BATCH, SEQ + STEPS, dtype=jnp.float32)
    logits, state = jax.jit(jm.prefill)(packed, state, prompt)
    decode = jax.jit(jm.decode_step)
    served = [np.asarray(logits)]
    for i in range(STEPS):
        logits, state = decode(packed, state, {"tokens": steps[:, i:i + 1]})
        served.append(np.asarray(logits))
    return {"arch": arch, "batch": batch, "prompt": prompt, "steps": steps,
            "params": params, "packed": packed, "losses": losses,
            "served": served}


def torch_batch(batch: dict) -> dict:
    return {k: t(v).long() if v.dtype == np.int32 else t(v) for k, v in batch.items()}


def test_params_convert_unchanged(run):
    """The tree (``in_norm`` beside ``embed`` for pixtral; int32
    ``w_packed`` and ``alpha`` when packed) carries across unchanged."""
    for p in (run["params"], run["packed"]):
        same_tree(p, params_from_numpy(p, device="cpu"))
    assert ("in_norm" in run["params"]) == (run["arch"] == "pixtral-12b")


@pytest.mark.parametrize("policy", POLICIES)
def test_loss_matches_jax(run, policy):
    cfg = t_configs.smoke_config(run["arch"])
    model = build_model(cfg, getattr(t_configs, f"{policy}_policy")())
    params = params_from_numpy(run["params"], device="cpu")
    with torch.no_grad():
        total, _ = model.loss(params, torch_batch(run["batch"]))
    np.testing.assert_allclose(float(total), run["losses"][policy], **TOL)


def test_packed_prefill_and_decode_match_jax(run):
    """Pixtral's prompt is its patch embeddings; its decode feeds tokens."""
    model = build_model(t_configs.smoke_config(run["arch"]), t_configs.serve_policy())
    params = params_from_numpy(run["packed"], device="cpu")
    state = model.init_state(BATCH, SEQ + STEPS, dtype=torch.float32, device="cpu")
    before = dict(ops.LAUNCHES)
    with torch.inference_mode():
        logits, state = model.prefill(params, state, torch_batch(run["prompt"]))
        got = [logits]
        for i in range(STEPS):
            logits, state = model.decode_step(
                params, state, {"tokens": t(run["steps"][:, i:i + 1]).long()})
            got.append(logits)
    assert ops.LAUNCHES == before and state["index"] == SEQ + STEPS
    for step, (g, w) in enumerate(zip(got, run["served"])):
        assert g.shape == w.shape == (BATCH, 512)
        np.testing.assert_allclose(g.numpy(), w, **TOL, err_msg=f"step {step}")


# ------------------------------------------------------ pixtral's launchers

def test_init_packed_is_pack_of_init():
    """Pixtral's ``in_norm`` is drawn nowhere, so ``init_packed`` stays the
    packing of ``init``."""
    model = build_model(t_configs.smoke_config("pixtral-12b"), t_configs.serve_policy())
    packed = model.init_packed(torch.Generator().manual_seed(5))
    want = model.pack(model.init(torch.Generator().manual_seed(5)))
    assert tree.leaves(packed) and len(tree.leaves(packed)) == len(tree.leaves(want))
    for (path, got), w in zip(tree.leaves_with_path(packed), tree.leaves(want)):
        assert torch.equal(got, w), path


def test_training_embeddings_are_the_jax_launchers(monkeypatch):
    """``launch.train`` feeds each step the embeddings the JAX launcher
    derives from the batch's tokens (its formula, bit for bit) beside the
    tokens and labels, and pixtral's smoke config trains on them."""
    fed = []
    made = launch_train.make_train_step

    def recording(model, tcfg):
        step = made(model, tcfg)

        def call(params, opt_state, batch):
            fed.append({k: v.clone() for k, v in batch.items()})
            return step(params, opt_state, batch)
        return call

    monkeypatch.setattr(launch_train, "make_train_step", recording)
    out = launch_train.train("pixtral-12b", steps=2, batch=2, seq=8,
                             log_every=100, device="cpu")
    assert len(fed) == 2 and np.isfinite(out["losses"]).all()
    for b in fed:
        assert set(b) == {"tokens", "labels", "input_embeds"}
        tok = b["tokens"].numpy()
        rng = np.random.default_rng(tok[0, 0] if tok.size else 0)
        emb = rng.normal(0, 1, (*tok.shape, 128)).astype(np.float32)
        assert b["input_embeds"].dtype == torch.float32
        np.testing.assert_array_equal(b["input_embeds"].numpy(), emb)


def test_serve_runs_on_cpu():
    r = launch_serve.serve("pixtral-12b", batch=2, prompt_len=16, gen=3,
                           device="cpu")
    assert r["tokens"].shape == (2, 3) and r["batch"]["input_embeds"].shape == (2, 16, 128)
    assert set(r["batch"]) == {"input_embeds"}
