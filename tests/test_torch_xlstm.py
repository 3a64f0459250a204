"""The xLSTM family against the JAX package: the mLSTM kernel's twin,
the mLSTM cell (chunkwise with and without state, and the decode step),
the mLSTM and sLSTM blocks, and the smoke xlstm-1.3b as a whole
(``Model.loss``, and a prefill with two decode steps).

``smoke_config("xlstm-1.3b")``: float32, d_model 128, 4 heads (mLSTM
heads of 64), 4 layers in 2 periods of sLSTM + mLSTM, vocab 512. Inputs
come from numpy; block and model params are the JAX package's
(``jax.random`` init, ``params_from_numpy``). Without state the port's
mLSTM runs ``ops.mlstm_chunked`` (its twin on the CPU, the Pallas
kernel's arithmetic), the JAX package its chunkwise scan: the same
function summed in other orders. Tolerances: the twin against the
Pallas kernel rtol/atol 2e-5 (as ``tests/test_mlstm_kernel.py``); cells
1e-5; blocks and the model 1e-4 (the projections' sums feed the cell's,
and a carried ``C`` sums a chunk's outer products on top).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import float_policy as j_float_policy
from repro.configs import smoke_config as j_smoke_config
from repro.configs import train_policy as j_train_policy
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import synthetic_lm_batches as j_batches
from repro.kernels.mlstm_chunk import mlstm_chunked
from repro.models import xlstm as jx
from repro.models.model_factory import build_model as j_build_model
from repro_torch.configs.base import float_policy, smoke_config, train_policy
from repro_torch.convert import params_from_numpy
from repro_torch.data.pipeline import DataConfig, synthetic_lm_batches
from repro_torch.kernels import ops
from repro_torch.kernels.ref import mlstm_chunked_ref, mlstm_chunked_states_ref
from repro_torch.models import xlstm as tx
from repro_torch.models.model_factory import build_model

from torch_parity import t

ARCH = "xlstm-1.3b"
TOL = dict(rtol=1e-5, atol=1e-5)
J_CFG = j_smoke_config(ARCH)
T_CFG = smoke_config(ARCH)
POLICIES = {"train": (j_train_policy, train_policy),
            "float": (j_float_policy, float_policy)}


def normal(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def gates(rng, *shape):
    """(logi, logf): input-gate pre-activations and log-sigmoid forget
    gates near 1."""
    logf = -np.log1p(np.exp(-(rng.normal(size=shape) + 1.5)))
    return normal(rng, *shape), logf.astype(np.float32)


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32)
                               if not isinstance(got, torch.Tensor)
                               else got.float().numpy(),
                               np.asarray(want, dtype=np.float32), **(tol or TOL))


def cell_state(rng, b, h, dh):
    return {"C": normal(rng, b, h, dh, dh, scale=0.3),
            "n": normal(rng, b, h, dh, scale=0.3),
            "m": normal(rng, b, h)}


@pytest.mark.parametrize("bh,s,dk,dv,chunk", [
    (2, 128, 64, 64, 32), (1, 256, 32, 32, 64), (3, 64, 128, 128, 64),
    (2, 96, 32, 16, 32)])
def test_mlstm_twin_matches_the_pallas_kernel(bh, s, dk, dv, chunk):
    rng = np.random.default_rng(160)
    q = normal(rng, bh, s, dk, scale=dk ** -0.5)
    k, v = normal(rng, bh, s, dk), normal(rng, bh, s, dv)
    logi, logf = gates(rng, bh, s)
    args = (q, k, v, logi, logf)
    want = mlstm_chunked(*map(jnp.asarray, args), chunk=chunk, interpret=True)
    got = mlstm_chunked_ref(*map(t, args), chunk=chunk)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        close(g, w, rtol=2e-5, atol=2e-5)


# The CUDA kernel's order (the states entering every chunk first, then
# every chunk's y from them) against the twin's chunk-after-chunk order:
# the same per-chunk operations on the CPU, so C, n and m equal and y
# within rtol/atol 1e-6 (batched products over the chunks); against the
# Pallas kernel rtol/atol 2e-5, as the twin.
@pytest.mark.parametrize("bh,s,dk,dv,chunk", [(2, 128, 64, 64, 32), (1, 96, 40, 12, 8)])
def test_mlstm_states_order_matches_twin_and_pallas(bh, s, dk, dv, chunk):
    rng = np.random.default_rng(161)
    q = normal(rng, bh, s, dk, scale=dk ** -0.5)
    k, v = normal(rng, bh, s, dk), normal(rng, bh, s, dv)
    logi, logf = gates(rng, bh, s)
    args = (q, k, v, logi, logf)
    got = mlstm_chunked_states_ref(*map(t, args), chunk=chunk)
    twin = mlstm_chunked_ref(*map(t, args), chunk=chunk)
    torch.testing.assert_close(got[0], twin[0], rtol=1e-6, atol=1e-6)
    for g, w in zip(got[1:], twin[1:]):
        assert torch.equal(g, w)
    want = mlstm_chunked(*map(jnp.asarray, args), chunk=chunk, interpret=True)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        close(g, w, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("with_state,chunk", [(False, 16), (True, 16), (True, 64)],
                         ids=["no-state", "state-4-chunks", "state-1-chunk"])
def test_mlstm_cell_matches_jax(with_state, chunk):
    """Chunked (64 steps) from a zero state (port: the kernel's twin) or
    from a carried one (both: the chunkwise loop); y and the new state."""
    rng = np.random.default_rng(161)
    b, s, h, dh = 2, 64, 2, 16
    q, k, v = (normal(rng, b, s, h, dh) for _ in range(3))
    logi, logf = gates(rng, b, s, h)
    state = cell_state(rng, b, h, dh) if with_state else None
    args = (q, k, v, logi, logf)
    y_j, st_j = jx.mlstm_cell(*map(jnp.asarray, args),
                              None if state is None else
                              {key: jnp.asarray(x) for key, x in state.items()},
                              chunk=chunk)
    y_t, st_t = tx.mlstm_cell(*map(t, args),
                              None if state is None else
                              {key: t(x) for key, x in state.items()}, chunk=chunk)
    close(y_t, y_j)
    for key in ("C", "n", "m"):
        close(st_t[key], st_j[key])


def test_mlstm_decode_step_matches_jax():
    rng = np.random.default_rng(162)
    b, h, dh = 3, 2, 16
    q, k, v = (normal(rng, b, 1, h, dh) for _ in range(3))
    logi, logf = gates(rng, b, 1, h)
    state = cell_state(rng, b, h, dh)
    y_j, st_j = jx.mlstm_cell(*map(jnp.asarray, (q, k, v, logi, logf)),
                              {key: jnp.asarray(x) for key, x in state.items()})
    y_t, st_t = tx.mlstm_cell(*map(t, (q, k, v, logi, logf)),
                              {key: t(x) for key, x in state.items()})
    close(y_t, y_j)
    for key in ("C", "n", "m"):
        close(st_t[key], st_j[key])


def block_state(rng, kind, b):
    if kind == "mlstm":
        dh = 2 * T_CFG.d_model // T_CFG.num_heads
        return cell_state(rng, b, T_CFG.num_heads, dh)
    d = T_CFG.d_model
    return {"h": normal(rng, b, d, scale=0.3), "c": normal(rng, b, d),
            "n": np.abs(normal(rng, b, d)) + 1, "m": normal(rng, b, d)}


@pytest.mark.parametrize("with_state", [False, True], ids=["no-state", "state"])
@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_block_matches_jax(kind, policy, with_state):
    """``mlstm_block`` / ``slstm_block`` on a 2 x 48 input (the mLSTM
    cell runs it as one chunk; the sLSTM 48 steps)."""
    rng = np.random.default_rng(163)
    j_policy, t_policy = POLICIES[policy]
    init = jx.init_mlstm if kind == "mlstm" else jx.init_slstm
    j_block = jx.mlstm_block if kind == "mlstm" else jx.slstm_block
    t_block = tx.mlstm_block if kind == "mlstm" else tx.slstm_block
    params = init(jax.random.PRNGKey(16), J_CFG)
    x = normal(rng, 2, 48, J_CFG.d_model)
    state = block_state(rng, kind, 2) if with_state else None
    y_j, st_j = j_block(params, jnp.asarray(x), J_CFG, j_policy(),
                        state=None if state is None else
                        {key: jnp.asarray(v) for key, v in state.items()})
    y_t, st_t = t_block(params_from_numpy(params, device="cpu"), t(x), T_CFG,
                        t_policy(), state=None if state is None else
                        {key: t(v) for key, v in state.items()})
    close(y_t, y_j, rtol=1e-4, atol=1e-4)
    assert (st_t is None) == (st_j is None) == (state is None)
    for key in (st_j or {}):
        close(st_t[key], st_j[key], rtol=1e-4, atol=1e-4)


def test_xlstm_params_convert_unchanged():
    """The xlstm tree carries across as it is: the real ``R [4, h, dh,
    dh]`` and ``gn_scale`` of each block, the ``if_proj`` and
    ``gates_proj`` biases, the untied LM head."""
    params = j_build_model(J_CFG, j_train_policy()).init(jax.random.PRNGKey(1))
    tp = params_from_numpy(params, device="cpu")
    flat_j = jax.tree_util.tree_leaves_with_path(params)
    assert len(flat_j) == len(jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda x: x.numpy(), tp)))
    for path, leaf in flat_j:
        node = tp
        for key in path:
            node = node[key.key if hasattr(key, "key") else key.idx]
        assert tuple(node.shape) == leaf.shape and node.dtype == torch.float32
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    slstm = tp["layers"][0]["slstm"]
    dh = T_CFG.d_model // T_CFG.num_heads
    assert tuple(slstm["R"].shape) == (2, 4, T_CFG.num_heads, dh, dh)
    assert tuple(tp["layers"][1]["mlstm"]["if_proj"]["b"].shape) == (2, 2 * T_CFG.num_heads)
    assert "lm_head" in tp


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_xlstm_loss_matches_jax(policy):
    """``Model.loss`` of a 2 x 512 batch (two mLSTM chunks) on the JAX
    package's params; no MoE, so aux is 0."""
    j_policy, t_policy = POLICIES[policy]
    data = dict(seed=16, global_batch=2, seq_len=512, vocab_size=J_CFG.vocab_size)
    jb = next(j_batches(JDataConfig(**data)))
    jm = j_build_model(J_CFG, j_policy())
    params = jm.init(jax.random.PRNGKey(0))
    want_total, want = jax.jit(jm.loss)(params, {"tokens": jb["tokens"],
                                                 "labels": jb["labels"]})
    model = build_model(T_CFG, t_policy())
    before = ops.LAUNCHES["mlstm_chunked"]
    with torch.no_grad():
        total, parts = model.loss(params_from_numpy(params, device="cpu"),
                                  next(synthetic_lm_batches(DataConfig(**data))))
    assert ops.LAUNCHES["mlstm_chunked"] == before   # the twin on the CPU
    close(total, float(want_total), rtol=1e-4, atol=1e-4)
    close(parts["loss"], float(want["loss"]), rtol=1e-4, atol=1e-4)
    assert float(parts["aux"]) == float(want["aux"]) == 0.0


def test_xlstm_prefill_then_decode_matches_jax():
    """A 2 x 512 prompt into the streaming state (the chunkwise loop with
    state, the sLSTM recurrence), then 2 greedy decode steps teacher-forced
    with the JAX tokens: logits within rtol/atol 1e-4, argmax equal."""
    steps, b, prompt = 2, 2, 512
    jm = j_build_model(J_CFG, j_train_policy())
    params = jm.init(jax.random.PRNGKey(2))
    tokens = np.random.default_rng(164).integers(
        0, J_CFG.vocab_size, (b, prompt)).astype(np.int32)
    state = jm.init_state(b, prompt + steps, dtype=jnp.float32)
    logits, state = jax.jit(jm.prefill)(params, state, {"tokens": jnp.asarray(tokens)})
    decode = jax.jit(jm.decode_step)
    want, fed = [np.asarray(logits)], []
    for _ in range(steps):
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        fed.append(np.asarray(tok))
        logits, state = decode(params, state, {"tokens": tok})
        want.append(np.asarray(logits))

    model = build_model(T_CFG, train_policy())
    tp = params_from_numpy(params, device="cpu")
    st = model.init_state(b, prompt + steps, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        lg, st = model.prefill(tp, st, {"tokens": t(tokens).long()})
        got = [lg]
        for tok in fed:
            lg, st = model.decode_step(tp, st, {"tokens": t(tok).long()})
            got.append(lg)
    for g, w in zip(got, want):
        close(g, w, rtol=1e-4, atol=1e-4)
        assert np.array_equal(g.argmax(-1).numpy(), w.argmax(-1))
    assert st["index"] == prompt + steps
    assert set(st) == {"index", "mlstm", "slstm"}
