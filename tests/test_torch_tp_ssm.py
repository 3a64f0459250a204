"""Tensor parallelism of mamba and the xLSTM over the model axis
(``models.mamba._mamba_tp``, ``models.xlstm._mlstm_tp`` and ``_slstm_tp``
under ``train.step.make_tp_train_step``) for jamba-1.5-large-398b's and
xlstm-1.3b's smoke configs, against the single-device step and the JAX
package's sharded step: the shards against the JAX arrays'
``addressable_shards``, the step on (1, 2), (1, 4) and (2, 2) meshes under
both policies, and the pieces in float32: a fused output re-laid out
after its gather (``tensor_parallel.piece``) against the single device's
``chunk``, the group norm over split channels (``common.rmsnorm_tp``)
against ``rmsnorm``, the replicated dynamics' gradients summed over the
ranks against the single device's, heads the ranks do not divide, and
the refusal of a state. Params come from a seeded generator or the JAX
init, inputs from numpy; the step's tolerances are
``test_torch_lm_dp.py``'s (``assert_same_step``).
"""

import dataclasses
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
from repro_torch.models import mamba, xlstm
from repro_torch.models.common import proj, rmsnorm, rmsnorm_tp
from repro_torch.models.model_factory import build_model
from repro_torch.train.step import (TrainConfig, init_opt_state,
                                    make_tp_train_step, make_train_step)
import torch_parity  # noqa: F401  (one torch thread a pytest-xdist worker)
from test_torch_lm_dp import POLICIES, assert_same_step
from test_torch_tp import batch_of, cpu_mesh, j_mesh
from test_torch_tp import j_params_of as _j_params_of

ARCHS = ["jamba-1.5-large-398b", "xlstm-1.3b"]
MESHES = [(1, 2), (1, 4), (2, 2)]
BLOCKS = {"mamba": ("jamba-1.5-large-398b", mamba.init_mamba, mamba.mamba),
          "mlstm": ("xlstm-1.3b", xlstm.init_mlstm, xlstm.mlstm_block),
          "slstm": ("xlstm-1.3b", xlstm.init_slstm, xlstm.slstm_block)}


# The JAX smoke models' init and jit, once a (arch, policy).
j_params_of = functools.lru_cache(maxsize=None)(_j_params_of)


def _steps(arch, policy, shape, tcfg=TrainConfig()):
    cfg = smoke_config(arch)
    model = build_model(cfg, POLICIES[policy]())
    params = model.init(torch.Generator().manual_seed(1))
    opt = init_opt_state(params)
    batch = batch_of(cfg)
    one = make_train_step(model, tcfg)(params, opt, batch)
    mesh = cpu_mesh(shape)
    p, o, m = make_tp_train_step(model, tcfg, mesh)(
        sharding.shard_params(params, mesh), sharding.shard_params(opt, mesh), batch)
    return one, (sharding.gather_params(p, mesh), sharding.gather_params(o, mesh), m)


def _ranked_block(params: dict, name: str, ranks: int) -> tp.RankedTree:
    """One block's params laid out by the rule table over ``ranks`` CPU
    ranks, each rank's leaves its own tensors requiring grad."""
    shards = sharding.shard_params({"block": {name: params}}, cpu_mesh((1, ranks)))
    live = [tree.tree_map(lambda t: t.detach().requires_grad_(True), t)
            for t in shards.rows()[0]]
    return tp.RankedTree(live, shards.specs)["block"][name]


def _block_case(name: str, seed: int = 0, **changes):
    arch, init, fn = BLOCKS[name]
    cfg = dataclasses.replace(smoke_config(arch), **changes)
    params = init(torch.Generator().manual_seed(seed), cfg)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(0, 1, (2, 32, cfg.d_model)).astype(np.float32))
    w = torch.from_numpy(rng.normal(0, 1, x.shape).astype(np.float32))
    return cfg, fn, params, x, w


# ------------------------------ layout ----------------------------------------


@pytest.mark.parametrize("shape", [(1, 2), (1, 4)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_shards_are_the_jax_arrays_addressable_shards(arch, shape):
    """Leaf by leaf, each rank's shard (mamba's and the xLSTM's fused
    projections split contiguously, the dynamics whole) has the shape of
    the JAX array's shard on that device and holds the same numbers."""
    _, jparams = j_params_of(arch, "float")
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
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_step_equals_the_single_device_step(arch, policy, shape):
    """Loss rtol 1e-5, Adam's first moment rtol 1e-3 / atol 1e-8, params
    within 2 lr lr_scale; the pre-clip norm within rtol 1e-5."""
    one, tp_ = _steps(arch, policy, shape)
    assert_same_step(one, tp_, TrainConfig())


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_step_is_the_jax_sharded_step(arch, policy):
    """The JAX package's ``make_train_step`` jitted with ``in_shardings``
    from ``params_shardings`` under ``activation_mesh`` on a (1, 2) host
    mesh, against one TP step on the same params: loss rtol 1e-5, the
    updated params gathered within 2 lr lr_scale (one Adam step moves a
    param by at most lr lr_scale, so where a near-zero gradient differs
    in sign the two steps land 2 lr lr_scale apart) plus the float32
    rounding of each step's subtraction (rtol 2**-23: xlstm's smoke model
    turns a 1e-7 change of its params into ~7e-6 of its gradients, so such
    sign flips occur)."""
    jm, jparams = j_params_of(arch, policy)
    jopt = j_step.init_opt_state(jparams)
    mesh, jmesh = cpu_mesh((1, 2)), j_mesh((1, 2))
    batch = batch_of(smoke_config(arch), seed=5)
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    with jmesh, j_sharding.activation_mesh(jmesh):
        jstep = jax.jit(j_step.make_train_step(jm, j_step.TrainConfig()),
                        in_shardings=(j_sharding.params_shardings(jmesh, jparams),
                                      j_sharding.params_shardings(jmesh, jopt), None))
        jnew, _, jmetrics = jstep(jparams, jopt, jbatch)
    model = build_model(smoke_config(arch), POLICIES[policy]())
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
@pytest.mark.parametrize("name, pieces", [("in_proj", 2), ("gates_proj", 4)])
def test_fused_output_relayout_is_the_single_device_chunk(name, pieces, ranks):
    """A column-parallel fused projection (mamba's in_proj: xh and z;
    the sLSTM's gates_proj: z, i, f, o) split contiguously over the ranks,
    all-gathered, then each rank's channels of each piece
    (``tensor_parallel.piece``): the ranks' parts concatenated are the
    single device's ``chunk``, bit for bit, and ``split=False`` gives the
    whole piece on every rank; the gradient through the pieces is the
    single device's."""
    rng = np.random.default_rng(7)
    w = torch.from_numpy(rng.normal(0, 1, (pieces * 32, 24)).astype(np.float32))
    x = torch.from_numpy(rng.normal(0, 1, (3, 5, 24)).astype(np.float32))
    g = torch.from_numpy(rng.normal(0, 1, (3, 5, pieces * 32)).astype(np.float32))
    whole = w.clone().requires_grad_(True)
    want = proj({"w": whole}, x, float_policy()).chunk(pieces, dim=-1)
    (g_want,) = torch.autograd.grad(sum((c * gc).sum() for c, gc in zip(
        want, g.chunk(pieces, -1))), whole)
    parts = [t.clone().requires_grad_(True) for t in w.chunk(ranks, 0)]
    params = tp.RankedTree([{"w": p} for p in parts], {"w": sharding.P("model", None)},
                           (name,))
    out = proj(params, tp.Ranked([x] * ranks, (None, None, None)), float_policy())
    assert out.spec == (None, None, "model")
    gathered = out.laid_out((None, None, None), site="t")
    loss = 0
    for i, (c, gc) in enumerate(zip(want, g.chunk(pieces, -1))):
        got = tp.piece(gathered, i, pieces)
        assert got.spec == (None, None, "model")
        assert torch.equal(torch.cat(got.parts, -1), c)
        assert all(torch.equal(p, c) for p in tp.piece(gathered, i, pieces,
                                                       split=False).parts)
        loss = loss + sum((p * gp).sum() for p, gp in zip(got.parts, gc.chunk(ranks, -1)))
    g_got = torch.autograd.grad(loss, parts)
    torch.testing.assert_close(torch.cat(g_got, 0), g_want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("ranks", [2, 4])
def test_group_norm_over_split_channels_is_rmsnorm(ranks):
    """``rmsnorm_tp`` of channels split over the ranks (each rank's float32
    partial sum of squares all-reduced, divided by the whole width) equals
    ``rmsnorm`` over the whole width within rtol 1e-6 / atol 1e-6, and the
    gradients of the input and of the scale summed over the ranks within
    rtol 1e-5 / atol 1e-5 (sums of 21 products, reordered); on a whole
    input it is ``rmsnorm`` on each rank, bit for bit."""
    rng = np.random.default_rng(8)
    y = torch.from_numpy(rng.normal(0, 2, (3, 7, 64)).astype(np.float32))
    scale = torch.from_numpy(rng.normal(1, 0.3, (64,)).astype(np.float32))
    g = torch.from_numpy(rng.normal(0, 1, y.shape).astype(np.float32))
    y1, s1 = y.clone().requires_grad_(True), scale.clone().requires_grad_(True)
    want = rmsnorm({"scale": s1}, y1)
    gy1, gs1 = torch.autograd.grad((want * g).sum(), (y1, s1))
    ys = [t.clone().requires_grad_(True) for t in y.chunk(ranks, -1)]
    ss = [scale.clone().requires_grad_(True) for _ in range(ranks)]
    leaf = tp.RankedTree(ss, sharding.P())
    tp.reset_bytes()
    got = rmsnorm_tp(leaf, tp.Ranked(ys, (None, None, "model")))
    assert tp.BYTES[("all-reduce", "group norm", "fwd")] == 3 * 7 * 4 * 2
    torch.testing.assert_close(torch.cat(got.parts, -1), want, rtol=1e-6, atol=1e-6)
    grads = torch.autograd.grad(sum((p * gp).sum() for p, gp in zip(
        got.parts, g.chunk(ranks, -1))), ys + ss)
    torch.testing.assert_close(torch.cat(grads[:ranks], -1), gy1, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(sum(grads[ranks:]), gs1, rtol=1e-5, atol=1e-5)
    for r, gr in enumerate(grads[ranks:]):   # zero outside the rank's slice
        w = 64 // ranks
        assert float(gr[:r * w].abs().sum() + gr[(r + 1) * w:].abs().sum()) == 0.0
    again = rmsnorm_tp(leaf, tp.Ranked([y] * ranks, (None, None, None)))
    assert all(torch.equal(p, rmsnorm({"scale": scale}, y)) for p in again.parts)


_SLICED = {"mamba": {"A_log": 0, "D": 0}, "mlstm": {"gn_scale": 0},
           "slstm": {"R": 1}}


@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_replicated_dynamics_gradients_sum_to_the_single_device_s(name, ranks):
    """A block over the ranks in float32 (``float_policy()``): the output
    on every rank and the input's gradient equal the single device's
    within rtol 1e-5 / atol 1e-5 (outputs of unit scale, the row-parallel
    sums reordered); each replicated leaf's gradient (conv_w, conv_b,
    A_log, D; gn_scale; R, gn_scale) summed over the ranks equals the
    single device's within rtol 1e-5 / atol 1e-5 of its largest element
    (sums over every token, each rank's share through its own rows); a
    leaf used a slice a rank (A_log, D, the mLSTM's gn_scale, R) gets a
    gradient zero outside its slice."""
    cfg, fn, params, x, w = _block_case(name)
    live = tree.tree_map(lambda t: t.detach().requires_grad_(True), params)
    xs = x.clone().requires_grad_(True)
    want, _ = fn(live, xs, cfg, float_policy())
    rep = [k for k, v in sharding.model_specs(cpu_mesh((1, ranks)), params).items()
           if isinstance(v, tuple) and "model" not in v]
    g_want = torch.autograd.grad((want * w).sum(), [xs] + [live[k] for k in rep])
    ranked = _ranked_block(params, name, ranks)
    xr = x.clone().requires_grad_(True)
    got, _ = fn(ranked, tp.Ranked([xr] * ranks, (None, None, None)), cfg, float_policy())
    assert got.spec == (None, None, None)
    for part in got.parts:
        torch.testing.assert_close(part, want.detach(), rtol=1e-5, atol=1e-5)
    g_got = torch.autograd.grad((got.parts[0] * w).sum(),
                                [xr] + [p for k in rep for p in ranked[k].parts])
    torch.testing.assert_close(g_got[0], g_want[0], rtol=1e-5, atol=1e-5)
    for i, k in enumerate(rep):
        per_rank = g_got[1 + i * ranks:1 + (i + 1) * ranks]
        torch.testing.assert_close(sum(per_rank), g_want[1 + i], rtol=1e-5,
                                   atol=1e-5 * float(g_want[1 + i].abs().max()))
        if k in _SLICED[name]:
            dim = _SLICED[name][k]
            n = per_rank[0].shape[dim] // ranks
            for r, gr in enumerate(per_rank):
                outside = torch.cat([gr.narrow(dim, 0, r * n),
                                     gr.narrow(dim, (r + 1) * n, (ranks - 1 - r) * n)], dim)
                assert float(outside.abs().sum()) == 0.0, (k, r)


@pytest.mark.parametrize("name", ["mlstm", "slstm"])
def test_heads_the_ranks_do_not_divide_run_on_every_rank(name):
    """2 heads over 4 ranks (q, k, v and the gates split mid-head): every
    rank runs every head, its output and the input's gradient equal to the
    single device's within rtol 1e-5 / atol 1e-5, and no group-norm
    all-reduce runs."""
    cfg, fn, params, x, w = _block_case(name, num_heads=2)
    xs = x.clone().requires_grad_(True)
    want, _ = fn(params, xs, cfg, float_policy())
    (gx_want,) = torch.autograd.grad((want * w).sum(), xs)
    xr = x.clone().requires_grad_(True)
    tp.reset_bytes()
    got, _ = fn(_ranked_block(params, name, 4), tp.Ranked([xr] * 4, (None, None, None)),
                cfg, float_policy())
    assert ("all-reduce", "group norm", "fwd") not in tp.BYTES
    for part in got.parts:
        torch.testing.assert_close(part, want.detach(), rtol=1e-5, atol=1e-5)
    (gx,) = torch.autograd.grad((got.parts[0] * w).sum(), xr)
    torch.testing.assert_close(gx, gx_want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_a_state_over_the_ranks_is_refused(name):
    """The model axis trains: a streaming state with ``Ranked`` inputs
    raises, as a PACKED projection over the ranks does."""
    cfg, fn, params, x, _ = _block_case(name)
    with pytest.raises(NotImplementedError, match="trains"):
        fn(_ranked_block(params, name, 2), tp.Ranked([x] * 2, (None, None, None)),
           cfg, float_policy(), state={})
