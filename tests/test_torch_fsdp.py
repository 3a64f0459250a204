"""Fully sharded data parallelism: ``train.step.make_tp_train_step`` on a
``("data", "model")`` mesh whose data axis holds several devices, every
param and AdamW leaf laid out over both axes by the rule table
(``distributed.sharding.shard_params``) and gathered over ``data`` a
period at a time where it is used (``tensor_parallel.gathered``). Against
the JAX package on the forced host devices: each device's block of every
param and AdamW leaf against the JAX arrays' ``addressable_shards`` on
(2, 2), (2, 4) and (4, 2) meshes for six families' smoke configs; the step
against the single-device step on the same meshes under both policies (and
moonshot with microbatches), and against the JAX package's sharded step on
(2, 2); the expert stacks' threshold; the global norm of the blocks; the
launcher's layout at 32 cards, its losses on (2, 2) and a checkpoint
resumed across meshes. Params come from the JAX init or a seeded
generator, batches from numpy; the step's tolerances are
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
from repro_torch.configs.base import get_config, smoke_config, train_policy
from repro_torch.convert import params_from_numpy
from repro_torch.distributed import sharding
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import AbstractMesh, DeviceMesh
from repro_torch.models.model_factory import build_model
from repro_torch.optim.clip import global_norm
from repro_torch.train.step import (TrainConfig, init_opt_state,
                                    make_tp_train_step, make_train_step)
import torch_parity  # noqa: F401  (one torch thread a pytest-xdist worker)
from test_torch_lm_dp import POLICIES, assert_same_step
from test_torch_tp import batch_of as lm_batch_of
from test_torch_tp import cpu_mesh, j_mesh
from test_torch_tp import j_params_of as _j_params_of
from test_torch_tp_encdec import batch_of as encdec_batch_of

ARCHS = ["qwen2.5-3b", "moonshot-v1-16b-a3b", "jamba-1.5-large-398b", "xlstm-1.3b",
         "seamless-m4t-large-v2", "pixtral-12b"]
MESHES = [(2, 2), (2, 4), (4, 2)]

# The JAX smoke models' init, once a (arch, policy).
j_params_of = functools.lru_cache(maxsize=None)(_j_params_of)


def _ids(shape) -> str:
    return f"{shape[0]}x{shape[1]}"


def batch_of(cfg, seed: int = 0) -> dict:
    return encdec_batch_of(cfg, seed) if cfg.family == "encdec" else lm_batch_of(cfg, seed)


def _hold_blocks(shards, whole, mesh) -> None:
    """Every device's block of every leaf has the shape of its spec's
    shard, data axes included (no device holds a whole model slice of a
    leaf the data axes split)."""
    for path, leaf in tree.leaves_with_path(whole):
        want = sharding.shard_shape(mesh, leaf.shape,
                                    sharding.param_spec(mesh, path, leaf))
        for t in shards:
            assert tuple(sharding.spec_at(t, path).shape) == want, path


# ------------------------------ layout ----------------------------------------


@pytest.mark.parametrize("shape", MESHES, ids=_ids)
@pytest.mark.parametrize("arch", ARCHS)
def test_blocks_are_the_jax_arrays_addressable_shards(arch, shape):
    """Each device's block of every param and AdamW leaf (moments drawn
    from the params, count 3) has the shape and the numbers of the JAX
    array's shard on that device, placed by ``params_shardings``; some
    leaves split over ``data``, and ``gather_params`` gives the tree back
    bit for bit."""
    _, jparams = j_params_of(arch, "float")
    jopt = {"adam": {"mu": jax.tree.map(lambda x: 0.5 * x, jparams),
                     "nu": jax.tree.map(jnp.square, jparams),
                     "count": jnp.asarray(3, jnp.int32)}}
    jm, mesh = j_mesh(shape), cpu_mesh(shape)
    order = {d: i for i, d in enumerate(jm.devices.flat)}
    split = 0
    for jtree in (jparams, jopt):
        placed = jax.device_put(jtree, j_sharding.params_shardings(jm, jtree))
        whole = params_from_numpy(jtree, device="cpu")
        shards = sharding.shard_params(whole, mesh)
        jleaves = jax.tree_util.tree_leaves(placed)
        assert len(jleaves) == len(tree.leaves(whole))
        for i, jleaf in enumerate(jleaves):
            for s in jleaf.addressable_shards:
                got = tree.leaves(shards[order[s.device]])[i]
                np.testing.assert_array_equal(got.numpy(), np.asarray(s.data))
        split += sum(sharding.data_dim(sharding.spec_at(shards.specs, path)) is not None
                     for path, _ in tree.leaves_with_path(whole))
        for a, b in zip(tree.leaves(sharding.gather_params(shards, mesh)),
                        tree.leaves(whole)):
            assert torch.equal(a, b)
    assert split > 0


# ------------------------------ the step --------------------------------------


def _steps(arch, policy, shape, tcfg=TrainConfig(), cfg=None):
    cfg = smoke_config(arch) if cfg is None else cfg
    model = build_model(cfg, POLICIES[policy]())
    params = model.init(torch.Generator().manual_seed(1))
    opt = init_opt_state(params)
    batch = batch_of(cfg)
    one = make_train_step(model, tcfg)(params, opt, batch)
    mesh = cpu_mesh(shape)
    p, o, m = make_tp_train_step(model, tcfg, mesh)(
        sharding.shard_params(params, mesh), sharding.shard_params(opt, mesh), batch)
    _hold_blocks(p, params, mesh)
    _hold_blocks(o, opt, mesh)
    return one, (sharding.gather_params(p, mesh), sharding.gather_params(o, mesh), m)


@pytest.mark.parametrize("shape", MESHES, ids=_ids)
@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_step_equals_the_single_device_step(arch, policy, shape):
    """Loss (and aux) rtol 1e-5, Adam's first moment rtol 1e-3 / atol
    1e-8, params within 2 lr lr_scale, the pre-clip norm within rtol 1e-5;
    every returned block the rule table's shape; the data axis's gathers
    and gradient reduction counted."""
    tp.reset_bytes()
    one, fsdp = _steps(arch, policy, shape)
    assert_same_step(one, fsdp, TrainConfig())
    sites = {(kind, site, d) for kind, site, d in tp.BYTES}
    assert ("all-gather", "fsdp gather", "fwd") in sites
    assert ("all-reduce", "data grads", "bwd") in sites


@pytest.mark.parametrize("shape", [(2, 2), (2, 4)], ids=_ids)
def test_fsdp_moe_step_with_microbatches(shape):
    """moonshot with ``microbatches=2``: each microbatch's balance loss
    over its own rows, every period gathered once a microbatch."""
    tcfg = TrainConfig(microbatches=2)
    one, fsdp = _steps("moonshot-v1-16b-a3b", "train", shape, tcfg)
    assert_same_step(one, fsdp, tcfg)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "moonshot-v1-16b-a3b",
                                  "jamba-1.5-large-398b"])
def test_fsdp_step_is_the_jax_sharded_step(arch):
    """The JAX package's ``make_train_step`` jitted with ``in_shardings``
    and ``out_shardings`` from ``params_shardings`` under
    ``activation_mesh`` on a (2, 2) host mesh, as its launcher jits it,
    against one FSDP step on the same params under ``train_policy()``:
    loss and aux rtol 1e-5, each device's updated block within 2 lr
    lr_scale of the JAX shard on that device."""
    jm, jparams = j_params_of(arch, "train")
    jopt = j_step.init_opt_state(jparams)
    mesh, jmesh = cpu_mesh((2, 2)), j_mesh((2, 2))
    batch = batch_of(smoke_config(arch), seed=5)
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    p_sh = j_sharding.params_shardings(jmesh, jparams)
    o_sh = j_sharding.params_shardings(jmesh, jopt)
    with jmesh, j_sharding.activation_mesh(jmesh):
        jstep = jax.jit(j_step.make_train_step(jm, j_step.TrainConfig()),
                        in_shardings=(p_sh, o_sh, None), out_shardings=(p_sh, o_sh, None))
        jnew, _, jmetrics = jstep(jparams, jopt, jbatch)
    model = build_model(smoke_config(arch), train_policy())
    params = params_from_numpy(jparams, device="cpu")
    p, _, m = make_tp_train_step(model, TrainConfig(), mesh)(
        sharding.shard_params(params, mesh),
        sharding.shard_params(init_opt_state(params), mesh), batch)
    for key in ("loss", "aux"):
        if key in jmetrics:
            np.testing.assert_allclose(float(m[key]), float(jmetrics[key]), rtol=1e-5)
    move = 2 * TrainConfig().adamw.lr * float(m["lr_scale"])
    order = {d: i for i, d in enumerate(jmesh.devices.flat)}
    for i, jleaf in enumerate(jax.tree_util.tree_leaves(jnew)):
        for s in jleaf.addressable_shards:
            got = tree.leaves(p[order[s.device]])[i]
            np.testing.assert_allclose(got.numpy(), np.asarray(s.data), rtol=0, atol=move)


def test_expert_stacks_split_over_data_past_the_threshold(monkeypatch):
    """With the port's threshold lowered, moonshot's expert stacks take
    ``in -> data`` beside ``experts -> model``, and the FSDP step still
    equals the single-device step. At full width arctic's and jamba's
    stacks pass the threshold as they are: the port's ``param_spec`` of
    their meta leaves equals the JAX package's of the same
    ``jax.ShapeDtypeStruct`` on the production mesh, ``in`` over data."""
    prod = AbstractMesh((1, 16, 16))
    for arch in ("arctic-480b", "jamba-1.5-large-398b"):
        meta = build_model(get_config(arch), train_policy()).init()
        stacks = [(path, leaf) for path, leaf in tree.leaves_with_path(meta)
                  if "moe" in path and "router" not in path and leaf.ndim == 4]
        assert stacks
        for path, leaf in stacks:
            want = j_sharding.param_spec(
                prod, path, jax.ShapeDtypeStruct(tuple(leaf.shape), jnp.float32))
            got = sharding.param_spec(prod, path, leaf)
            assert tuple(got) == tuple(want)
            assert got[-1] == ("pod", "data") and got[1] == "model"
    monkeypatch.setattr(sharding, "EXPERT_FSDP_ELEMENTS", 0.0)
    model = build_model(smoke_config("moonshot-v1-16b-a3b"), POLICIES["float"]())
    mesh = cpu_mesh((2, 2))
    specs = sharding.shard_params(model.init(torch.Generator().manual_seed(1)),
                                  mesh).specs
    up = sharding.spec_at(specs, ("layers", 0, "moe", "up_proj", "w"))
    assert up == (None, "model", None, "data")
    one, fsdp = _steps("moonshot-v1-16b-a3b", "float", (2, 2))
    assert_same_step(one, fsdp, TrainConfig())


@pytest.mark.parametrize("shape", MESHES, ids=_ids)
def test_global_norm_of_blocks_is_the_whole_tree_s(shape):
    """The global norm of a tree's FSDP ``Shards`` (qwen2.5-3b's smoke
    params as gradients: leaves split over data, over model, over both,
    and whole) equals the gathered tree's, rtol 1e-6; counting every
    device's blocks would not."""
    model = build_model(smoke_config("qwen2.5-3b"), POLICIES["float"]())
    params = model.init(torch.Generator().manual_seed(3))
    mesh = cpu_mesh(shape)
    shards = sharding.shard_params(params, mesh)
    torch.testing.assert_close(global_norm(shards), global_norm(params), rtol=1e-6, atol=0)
    every = torch.sqrt(sum(torch.sum(t ** 2) for s in shards for t in tree.leaves(s)))
    assert float(every) > float(global_norm(params)) * 1.05


# ------------------------------ the launcher ----------------------------------


def test_thirty_two_cards_shard_over_data(monkeypatch):
    """32 cards give the JAX launcher's ``(2, 16)`` mesh, and the layout
    line says the params and optimizer state are sharded over data."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 32)
    mesh = launch_train.train_mesh()
    assert isinstance(mesh, DeviceMesh) and dict(mesh.shape) == {"data": 2, "model": 16}
    model = build_model(smoke_config("smollm-360m"), train_policy())
    *_, layout = launch_train._layout(model, TrainConfig(), mesh)
    assert layout.startswith("tensor parallel over {'data': 2, 'model': 16}")
    assert "sharded over data too" in layout
    *_, layout = launch_train._layout(model, TrainConfig(), cpu_mesh((1, 2)))
    assert "sharded over data" not in layout


def test_fsdp_run_trains_and_resumes_across_meshes(tmp_path, capsys):
    """``launch.train.train`` of smollm on a (2, 2) CPU mesh: 3 steps with
    losses within rtol 1e-5 of one device's, a gathered checkpoint at step
    3 that a run on one device and a run on (1, 2) resume with params
    identical to the (2, 2) run's."""
    kw = dict(smoke=True, batch=4, seq=16, lr=1e-3, log_every=100, quantized=False)
    fsdp = launch_train.train("smollm-360m", steps=3, mesh=cpu_mesh((2, 2)),
                              ckpt_dir=str(tmp_path / "fsdp"), ckpt_every=3, **kw)
    assert "sharded over data too" in capsys.readouterr().out
    one = launch_train.train("smollm-360m", steps=3, device="cpu", **kw)
    np.testing.assert_allclose(fsdp["losses"], one["losses"], rtol=1e-5)
    for where in ({"device": "cpu"}, {"mesh": cpu_mesh((1, 2))}):
        resumed = launch_train.train("smollm-360m", steps=3,
                                     ckpt_dir=str(tmp_path / "fsdp"), **where, **kw)
        assert "resumed from step 3" in capsys.readouterr().out
        for a, b in zip(tree.leaves(resumed["params"]), tree.leaves(fsdp["params"])):
            assert torch.equal(a, b)
