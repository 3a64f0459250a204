"""Tensor parallelism of the encoder-decoder over the model axis
(``models.encdec`` on ``tensor_parallel`` inputs, ``attention.
_cross_attention_tp``, under ``train.step.make_tp_train_step``) for
seamless-m4t-large-v2's smoke config (4 heads, 2 kv heads: cut mid-head
at 4 ranks), against the single-device step and the JAX package's
sharded step: the shards against the JAX arrays' ``addressable_shards``,
the step on (1, 2), (1, 4) and (2, 2) meshes under both policies, and in
float32 the cross-attention and the encoder over the ranks against the
single device's. Params come from a seeded generator or the JAX init, the
frames, tokens and labels from numpy; the step's tolerances are
``test_torch_lm_dp.py``'s (``assert_same_step``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import sharding as j_sharding
from repro.train import step as j_step
from repro_torch import tree
from repro_torch.configs.base import float_policy, smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.distributed import sharding
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models import attention, encdec
from repro_torch.models.model_factory import build_model
from repro_torch.train.step import (TrainConfig, init_opt_state,
                                    make_tp_train_step, make_train_step)
import torch_parity  # noqa: F401  (one torch thread a pytest-xdist worker)
from test_torch_lm_dp import POLICIES, assert_same_step
from test_torch_tp import BATCH, SEQ, cpu_mesh, j_mesh
from test_torch_tp import j_params_of as _j_params_of

ARCH = "seamless-m4t-large-v2"
MESHES = [(1, 2), (1, 4), (2, 2)]

# The JAX smoke model's init and jit, once a policy.
j_params_of = functools.lru_cache(maxsize=None)(_j_params_of)


def batch_of(cfg, seed: int = 0) -> dict:
    """The encoder's frames ``input_embeds [B, S, D]`` beside the
    decoder's tokens and labels, drawn with numpy."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (BATCH, SEQ + 1)).astype(np.int32)
    frames = rng.normal(0, 1, (BATCH, SEQ, cfg.d_model)).astype(np.float32)
    return {"input_embeds": torch.from_numpy(frames),
            "tokens": torch.from_numpy(tokens[:, :-1].copy()),
            "labels": torch.from_numpy(tokens[:, 1:].copy())}


def _ranked(params, ranks: int) -> tp.RankedTree:
    shards = sharding.shard_params(params, cpu_mesh((1, ranks)))
    live = [tree.tree_map(lambda t: t.detach().requires_grad_(True), t)
            for t in shards.rows()[0]]
    return tp.RankedTree(live, shards.specs)


def _replicated(x: torch.Tensor, ranks: int) -> tp.Ranked:
    return tp.Ranked([x] * ranks, (None,) * x.ndim)


# ------------------------------ layout ----------------------------------------


@pytest.mark.parametrize("shape", [(1, 2), (1, 4)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_shards_are_the_jax_arrays_addressable_shards(shape):
    """Leaf by leaf, each rank's shard of the encoder, the decoder (its
    cross-attention too), the embedding and the head has the shape of the
    JAX array's shard on that device and holds the same numbers."""
    _, jparams = j_params_of(ARCH, "float")
    jm = j_mesh(shape)
    placed = jax.device_put(jparams, j_sharding.params_shardings(jm, jparams))
    params = params_from_numpy(jparams, device="cpu")
    shards = sharding.shard_params(params, cpu_mesh(shape))
    order = {d: i for i, d in enumerate(jm.devices.flat)}
    jleaves = jax.tree_util.tree_leaves(placed)
    assert len(jleaves) == len(tree.leaves(params))
    for i, jleaf in enumerate(jleaves):
        for s in jleaf.addressable_shards:
            got = tree.leaves(shards[order[s.device]])[i]
            np.testing.assert_array_equal(got.numpy(), np.asarray(s.data))


# ------------------------------ the step --------------------------------------


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_tp_step_equals_the_single_device_step(policy, shape):
    """Loss rtol 1e-5, Adam's first moment rtol 1e-3 / atol 1e-8, params
    within 2 lr lr_scale; the pre-clip norm within rtol 1e-5."""
    model = build_model(smoke_config(ARCH), POLICIES[policy]())
    params = model.init(torch.Generator().manual_seed(1))
    opt = init_opt_state(params)
    batch = batch_of(model.cfg)
    one = make_train_step(model, TrainConfig())(params, opt, batch)
    mesh = cpu_mesh(shape)
    p, o, m = make_tp_train_step(model, TrainConfig(), mesh)(
        sharding.shard_params(params, mesh), sharding.shard_params(opt, mesh), batch)
    assert_same_step(one, (sharding.gather_params(p, mesh),
                           sharding.gather_params(o, mesh), m), TrainConfig())


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_tp_step_is_the_jax_sharded_step(policy):
    """The JAX package's ``make_train_step`` jitted with ``in_shardings``
    from ``params_shardings`` under ``activation_mesh`` on a (1, 2) host
    mesh, against one TP step on the same params: loss rtol 1e-5, the
    updated params gathered within 2 lr lr_scale plus the float32 rounding
    of each step's subtraction (rtol 2**-23; ``test_torch_tp_ssm.py``)."""
    jm, jparams = j_params_of(ARCH, policy)
    jopt = j_step.init_opt_state(jparams)
    mesh, jmesh = cpu_mesh((1, 2)), j_mesh((1, 2))
    batch = batch_of(smoke_config(ARCH), seed=5)
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    with jmesh, j_sharding.activation_mesh(jmesh):
        jstep = jax.jit(j_step.make_train_step(jm, j_step.TrainConfig()),
                        in_shardings=(j_sharding.params_shardings(jmesh, jparams),
                                      j_sharding.params_shardings(jmesh, jopt), None))
        jnew, _, jmetrics = jstep(jparams, jopt, jbatch)
    model = build_model(smoke_config(ARCH), POLICIES[policy]())
    params = params_from_numpy(jparams, device="cpu")
    p, _, m = make_tp_train_step(model, TrainConfig(), mesh)(
        sharding.shard_params(params, mesh),
        sharding.shard_params(init_opt_state(params), mesh), batch)
    np.testing.assert_allclose(float(m["loss"]), float(jmetrics["loss"]), rtol=1e-5)
    move = 2 * TrainConfig().adamw.lr * float(m["lr_scale"])
    for a, b in zip(tree.leaves(sharding.gather_params(p, mesh)),
                    jax.tree_util.tree_leaves(jnew)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2.0**-23, atol=move)


# ------------------------------ the pieces ------------------------------------


@pytest.mark.parametrize("ranks", [2, 4])
def test_cross_attention_over_the_ranks_is_cross_attention(ranks):
    """``_cross_attention_tp`` in float32, queries from 16 decoder steps,
    keys and values from 24 encoder frames: every rank's output and the
    gradients of the decoder states, the memory and the projections
    (gathered over the ranks) equal ``cross_attention``'s within rtol 1e-5
    / atol 1e-5; at 4 ranks the 2 kv heads are cut mid-head, so q, k and v
    are all-gathered (site ``"gather heads"``) and every rank attends every
    head, at 2 ranks each attends its own."""
    cfg = smoke_config(ARCH)
    params = attention.init_attention(torch.Generator().manual_seed(3), cfg)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(0, 1, (2, 16, cfg.d_model)).astype(np.float32))
    mem = torch.from_numpy(rng.normal(0, 1, (2, 24, cfg.d_model)).astype(np.float32))
    w = torch.from_numpy(rng.normal(0, 1, x.shape).astype(np.float32))
    live = tree.tree_map(lambda t: t.detach().requires_grad_(True), params)
    xs, ms = x.clone().requires_grad_(True), mem.clone().requires_grad_(True)
    want = attention.cross_attention(live, xs, ms, cfg, float_policy())
    flat = tree.leaves(live)
    g_want = torch.autograd.grad((want * w).sum(), [xs, ms] + flat)
    ranked = _ranked({"cross_attn": params}, ranks)["cross_attn"]
    xr, mr = x.clone().requires_grad_(True), mem.clone().requires_grad_(True)
    tp.reset_bytes()
    got = attention.cross_attention(ranked, _replicated(xr, ranks), _replicated(mr, ranks),
                                    cfg, float_policy())
    assert (("all-gather", "gather heads", "fwd") in tp.BYTES) == (ranks == 4)
    for part in got.parts:
        torch.testing.assert_close(part, want.detach(), rtol=1e-5, atol=1e-5)
    leaves = [tree.leaves(t) for t in ranked.parts]
    g_got = torch.autograd.grad((got.parts[0] * w).sum(),
                                [xr, mr] + [leaf for ls in leaves for leaf in ls])
    torch.testing.assert_close(g_got[0], g_want[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(g_got[1], g_want[1], rtol=1e-5, atol=1e-5)
    mesh, layer = cpu_mesh((1, ranks)), {"cross_attn": params}
    per_rank = [tree.tree_map(lambda _, it=iter(g_got[2 + r * len(flat):]): next(it), layer)
                for r in range(ranks)]
    whole = sharding.gather_params(
        sharding.Shards(per_rank, sharding.model_specs(mesh, layer), mesh), mesh)
    for a, b in zip(tree.leaves(whole["cross_attn"]), g_want[2:]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("ranks", [2, 4])
def test_encoder_memory_is_whole_on_every_rank(ranks):
    """``encode`` over the ranks in float32 (non-causal self-attention
    over the ranks' heads, the FFN split): every rank's memory equals the
    single device's within rtol 1e-5 / atol 1e-5, and the decoder's
    vocab-parallel logits, gathered, equal ``decode``'s likewise."""
    model = build_model(smoke_config(ARCH), float_policy())
    cfg = model.cfg
    params = model.init(torch.Generator().manual_seed(4))
    batch = batch_of(cfg, seed=4)
    with torch.no_grad():
        want = encdec.encode(params, batch["input_embeds"], cfg, float_policy())
        logits, _ = encdec.decode(params, batch["tokens"], want, cfg, float_policy())
        ranked = _ranked(params, ranks)
        mem = encdec.encode(ranked, _replicated(batch["input_embeds"], ranks), cfg,
                            float_policy())
        got, _ = encdec.decode(ranked, _replicated(batch["tokens"], ranks), mem, cfg,
                               float_policy())
    assert mem.spec == (None, None, None) and got.spec == (None, None, "model")
    for part in mem.parts:
        torch.testing.assert_close(part, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(torch.cat(got.parts, -1), logits, rtol=1e-5, atol=1e-5)
