"""Expert parallelism over the model axis (``models.ffn.moe_ffn`` on
``tensor_parallel.Ranked`` inputs, ``train.step.make_tp_train_step``) for
moonshot-v1-16b-a3b's and arctic-480b's smoke configs (8 experts, top-2;
arctic's dense residual FFN beside them) against the single-device step
and the JAX package's sharded step: the expert stacks' shards against the
JAX arrays' ``addressable_shards``, the step on (1, 2), (1, 4) and (2, 2)
meshes under both policies, 6 experts left whole on 4 ranks, the balance
loss counted once (its gradient alone) and over the whole batch on
several data rows (with microbatches too), every rank's routing in
float32, and the launcher's layout. Batches are drawn with numpy, params
from a seeded generator or the JAX init; the tolerances are
``test_torch_lm_dp.py``'s (``assert_same_step``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import sharding as j_sharding
from repro.train import step as j_step
from repro_torch import tree
from repro_torch.configs.base import float_policy, smoke_config, train_policy
from repro_torch.convert import params_from_numpy
from repro_torch.distributed import sharding
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import DeviceMesh
from repro_torch.models import ffn
from repro_torch.models.model_factory import build_model
from repro_torch.train.step import (TrainConfig, _sum_replicated, init_opt_state,
                                    make_tp_train_step, make_train_step)
import torch_parity  # noqa: F401  (one torch thread a pytest-xdist worker)
from test_torch_lm_dp import POLICIES, assert_same_step
from test_torch_tp import batch_of, cpu_mesh, j_mesh, j_params_of

ARCHS = ["moonshot-v1-16b-a3b", "arctic-480b"]
MESHES = [(1, 2), (1, 4), (2, 2)]


def _model(arch, policy="float", **changes):
    cfg = dataclasses.replace(smoke_config(arch), **changes)
    return build_model(cfg, POLICIES[policy]())


def _steps(model, shape, tcfg=TrainConfig(), batch=None):
    params = model.init(torch.Generator().manual_seed(1))
    opt = init_opt_state(params)
    batch = batch_of(model.cfg) if batch is None else batch
    one = make_train_step(model, tcfg)(params, opt, batch)
    mesh = cpu_mesh(shape)
    p, o, m = make_tp_train_step(model, tcfg, mesh)(
        sharding.shard_params(params, mesh), sharding.shard_params(opt, mesh), batch)
    return one, (sharding.gather_params(p, mesh), sharding.gather_params(o, mesh), m)


def _experts_of(params):
    """The expert stacks' (path, leaf), the router's left out."""
    return [(path, leaf) for path, leaf in tree.leaves_with_path(params)
            if "moe" in path and "router" not in path]


# ------------------------------ layout ----------------------------------------


@pytest.mark.parametrize("shape", [(1, 2), (1, 4)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_expert_shards_are_the_jax_arrays_addressable_shards(arch, shape):
    """Leaf by leaf, each rank's shard has the shape of the JAX array's
    shard on that device (the expert stacks split on their expert axis,
    the router whole), and holds the same numbers."""
    _, jparams = j_params_of(arch, "float")
    jm = j_mesh(shape)
    placed = jax.device_put(jparams, j_sharding.params_shardings(jm, jparams))
    params = params_from_numpy(jparams, device="cpu")
    shards = sharding.shard_params(params, cpu_mesh(shape))
    order = {d: i for i, d in enumerate(jm.devices.flat)}
    paths = [path for path, _ in tree.leaves_with_path(params)]
    experts = {path for path, _ in _experts_of(params)}
    assert experts
    for path, jleaf in zip(paths, jax.tree_util.tree_leaves(placed)):
        for s in jleaf.addressable_shards:
            got = sharding.spec_at(shards[order[s.device]], path)
            assert tuple(got.shape) == s.data.shape
            if path in experts:
                assert got.shape[1] == 8 // shape[1]
                np.testing.assert_array_equal(got.numpy(), np.asarray(s.data))


def test_six_experts_stay_whole_on_four_ranks():
    """6 experts do not split over 4 ranks: the guard leaves every stack
    whole on every rank (no ``moe`` all-reduce), and the step still equals
    the single-device step, the ranks' shares of the expert gradients
    summed."""
    model = _model("moonshot-v1-16b-a3b", num_experts=6)
    params = model.init(torch.Generator().manual_seed(1))
    shards = sharding.shard_params(params, cpu_mesh((1, 4)))
    for path, leaf in _experts_of(params):
        assert sharding.spec_at(shards.specs, path) == (None,) * leaf.ndim
        assert all(torch.equal(sharding.spec_at(t, path), leaf) for t in shards)
    tp.reset_bytes()
    one, ep = _steps(model, (1, 4))
    assert not any(site == "moe" for _, site, _ in tp.BYTES)
    assert_same_step(one, ep, TrainConfig())


# ------------------------------ the step --------------------------------------


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("arch", ARCHS)
def test_ep_step_equals_the_single_device_step(arch, policy, shape):
    """Loss and aux rtol 1e-5, Adam's first moment rtol 1e-3 / atol 1e-8,
    params within 2 lr lr_scale; the pre-clip norm within rtol 1e-5. The
    experts split over the ranks: one ``moe`` all-reduce a layer."""
    tp.reset_bytes()
    one, ep = _steps(_model(arch, policy), shape)
    assert tp.BYTES[("all-reduce", "moe", "fwd")] > 0
    assert_same_step(one, ep, TrainConfig())


@pytest.mark.parametrize("arch", ARCHS)
def test_ep_step_is_the_jax_sharded_step(arch):
    """The JAX package's ``make_train_step`` under ``train_policy()``
    jitted with ``in_shardings`` from ``params_shardings`` (the experts
    over ``model``) under ``activation_mesh`` on a (1, 2) host mesh,
    against one EP step on the same params: loss and aux rtol 1e-5, the
    updated params gathered within 2 lr lr_scale."""
    jm, jparams = j_params_of(arch, "train")
    jopt = j_step.init_opt_state(jparams)
    mesh, jmesh = cpu_mesh((1, 2)), j_mesh((1, 2))
    batch = batch_of(smoke_config(arch), seed=5)
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    with jmesh, j_sharding.activation_mesh(jmesh):
        jstep = jax.jit(j_step.make_train_step(jm, j_step.TrainConfig()),
                        in_shardings=(j_sharding.params_shardings(jmesh, jparams),
                                      j_sharding.params_shardings(jmesh, jopt), None))
        jnew, _, jmetrics = jstep(jparams, jopt, jbatch)
    model = build_model(smoke_config(arch), train_policy())
    params = params_from_numpy(jparams, device="cpu")
    p, _, m = make_tp_train_step(model, TrainConfig(), mesh)(
        sharding.shard_params(params, mesh),
        sharding.shard_params(init_opt_state(params), mesh), batch)
    np.testing.assert_allclose(float(m["loss"]), float(jmetrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["aux"]), float(jmetrics["aux"]), rtol=1e-5)
    move = 2 * TrainConfig().adamw.lr * float(m["lr_scale"])
    for a, b in zip(tree.leaves(sharding.gather_params(p, mesh)),
                    jax.tree_util.tree_leaves(jnew)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=move)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_ep_balance_loss_is_the_whole_batch_s_and_jax_s(microbatches):
    """moonshot on (2, 2): the step's loss and balance loss equal the
    single-device step's on the whole batch (each microbatch's over its
    own rows) and the JAX package's ``loss`` of the same rows, rtol 1e-5;
    the mean of the two data rows' balance losses would not be it."""
    arch = "moonshot-v1-16b-a3b"
    tcfg = TrainConfig(microbatches=microbatches)
    jm, jparams = j_params_of(arch, "float")
    model = build_model(smoke_config(arch), float_policy())
    params = params_from_numpy(jparams, device="cpu")
    batch = batch_of(smoke_config(arch), seed=3)
    opt = init_opt_state(params)
    one = make_train_step(model, tcfg)(params, opt, batch)
    mesh = cpu_mesh((2, 2))
    p, o, m = make_tp_train_step(model, tcfg, mesh)(
        sharding.shard_params(params, mesh), sharding.shard_params(opt, mesh), batch)
    assert_same_step(one, (sharding.gather_params(p, mesh),
                           sharding.gather_params(o, mesh), m), tcfg)
    n = len(batch["tokens"]) // microbatches
    parts = [{k: jnp.asarray(v[i * n:(i + 1) * n].numpy()) for k, v in batch.items()}
             for i in range(microbatches)]
    outs = [jax.jit(jm.loss)(jparams, part) for part in parts]
    np.testing.assert_allclose(float(m["loss"]), np.mean([float(t) for t, _ in outs]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["aux"]),
                               np.mean([float(a["aux"]) for _, a in outs]), rtol=1e-5)
    if microbatches == 1:
        rows = [{k: v[d * 2:(d + 1) * 2] for k, v in batch.items()} for d in range(2)]
        per_row = np.mean([float(model.loss(params, r)[1]["aux"]) for r in rows])
        assert abs(per_row - float(m["aux"])) > 1e-4 * abs(float(m["aux"]))


def _aux_grads(model, params, batch, shape):
    """The gradient of the balance loss alone, single-device and over the
    ranks of a ``shape`` mesh (its ranks' shares of a replicated leaf
    summed, the split leaves gathered)."""
    live = tree.tree_map(lambda t: t.detach().requires_grad_(True), params)
    _, metrics = model.loss(live, batch)
    want = torch.autograd.grad(metrics["aux"], tree.leaves(live), allow_unused=True)
    mesh = cpu_mesh(shape)
    shards = sharding.shard_params(params, mesh)
    row = [tree.tree_map(lambda t: t.detach().requires_grad_(True), t)
           for t in shards.rows()[0]]
    ranked = {k: tp.Ranked.replicated(v, ["cpu"] * shape[1]) for k, v in batch.items()}
    with sharding.activation_mesh(mesh):
        _, metrics = model.loss(tp.RankedTree(row, shards.specs), ranked)
    flat = [leaf for t in row for leaf in tree.leaves(t)]
    got = iter(torch.zeros_like(p) if g is None else g for p, g in zip(
        flat, torch.autograd.grad(metrics["aux"], flat, allow_unused=True)))
    grads = _sum_replicated([tree.tree_map(lambda _: next(got), t) for t in row],
                            shards.specs)
    whole = sharding.gather_params(sharding.Shards(grads, shards.specs, mesh), mesh)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(tree.leaves(params), want)], tree.leaves(whole)


@pytest.mark.parametrize("shape", [(1, 2), (1, 4)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_aux_gradient_alone_is_counted_once(shape):
    """The balance loss enters once: its gradient alone, over the ranks,
    equals the single-device one leaf by leaf within rtol 1e-5 (relative
    L2 of the leaf: the residual stream's partial gradients round in
    another order, ~5e-7 seen); the router's is not zero, and counted on
    every rank it would be ``m`` times this."""
    model = _model("moonshot-v1-16b-a3b")
    params = model.init(torch.Generator().manual_seed(2))
    want, got = _aux_grads(model, params, batch_of(model.cfg, seed=4), shape)
    routers = 0
    for (path, _), w, g in zip(tree.leaves_with_path(params), want, got):
        assert float(torch.linalg.vector_norm(g - w)) <= 1e-5 * float(
            torch.linalg.vector_norm(w)), path
        if "router" in path:
            routers += 1
            assert float(w.abs().max()) > 0
    assert routers


@pytest.mark.parametrize("shape", [(1, 2), (1, 4)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_every_rank_routes_as_the_single_device_in_float32(arch, shape):
    """In float32, every rank's ``expert_idx`` and ``keep`` of every MoE
    layer equal the single device's, bit for bit."""
    model = _model(arch)
    params = model.init(torch.Generator().manual_seed(1))
    batch = batch_of(model.cfg, seed=6)
    mesh = cpu_mesh(shape)
    shards = sharding.shard_params(params, mesh)
    ranked = {k: tp.Ranked.replicated(v, ["cpu"] * shape[1]) for k, v in batch.items()}
    with torch.no_grad():
        with ffn.routing() as one:
            model.loss(params, batch)
        with ffn.routing() as ep, sharding.activation_mesh(mesh):
            model.loss(tp.RankedTree(shards.rows()[0], shards.specs), ranked)
    assert len(one) == model.cfg.num_layers and len(ep) == len(one) * shape[1]
    for layer, (idx, keep) in enumerate(one):
        for r in range(shape[1]):
            assert torch.equal(ep[layer * shape[1] + r][0], idx)
            assert torch.equal(ep[layer * shape[1] + r][1], keep)


# ------------------------------ the launcher ----------------------------------


@pytest.mark.parametrize("n, shape", [(2, (1, 2)), (16, (1, 16)), (32, (2, 16))])
def test_launcher_lays_moonshot_out_as_the_jax_launcher(monkeypatch, n, shape):
    """Several cards give the JAX launcher's ``(n // min(n, 16), min(n,
    16))`` ``DeviceMesh``, the layout the MoE configs train on."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
    got = launch_train.train_mesh()
    assert isinstance(got, DeviceMesh)
    assert tuple(got.shape.values()) == shape
