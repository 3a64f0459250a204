"""One process a device (``distributed.process_group``): the training
steps run SPMD over ``torch.distributed`` (gloo on the CPU), each process
holding its own position's part, against the same steps run in lockstep
from one process and against the JAX package's sharded steps.

Worlds are spawned with ``torch.multiprocessing`` and meet through a
``file://`` store under the test's temporary directory (no TCP port, so
xdist workers cannot collide); each process runs one intra-op thread, and
so does the lockstep reference here, so the CPU bits match. The cases live
in ``spmd_cases.py``, which the spawned processes import (no JAX):

* the collectives and their gradients over 2 and 4 processes, float32 and
  bf16, every gather dim: ``torch.equal`` to the lockstep ones;
* the TP step on (1, 2) for qwen2.5-3b, xlstm-1.3b and seamless-m4t-large-
  v2, the FSDP step on (2, 2), the LM DP step over 2 processes and the BNN
  DP step under each compression: every param, optimizer leaf, residual
  and metric ``torch.equal`` to the lockstep step's;
* the SPMD TP step against the JAX package's jitted sharded step (loss
  rtol 1e-5, params within 2 lr lr_scale, as ``test_torch_tp.py``), the
  SPMD sign-SGD step against the JAX ``shard_map`` DP step on 2 host
  devices (``test_torch_resilience.py``'s tolerances);
* the backend rule, the MoE refusal (ROADMAP A5b step 6), the launcher
  under torchrun's environment with a checkpoint only rank 0 writes and a
  one-device resume from it, and a peer that never comes.
"""

import concurrent.futures
import contextlib
import os
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import Mesh

import repro.configs as j_configs
from repro.distributed import sharding as j_sharding
from repro.models.model_factory import build_model as j_build_model
from repro.train import bnn_trainer as jtrainer
from repro.train import step as j_step
from repro_torch import tree
from repro_torch.convert import params_from_numpy
from repro_torch.data.pipeline import DataConfig, cifar_batch_at
from repro_torch.distributed import process_group as pg
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.launch import train as launch_train
from repro_torch.train.step import TrainConfig

import spmd_cases as cases
from test_torch_bnn_train import numpy_params
from test_torch_lm_dp import assert_same_step as assert_same_step_within
from test_torch_resilience import (FIRST_STEP_SIGN_SHARE, METRIC_TOL, PARAM_TOL,
                                   _traced)


@contextlib.contextmanager
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def qwen_jax():
    jm = j_build_model(j_configs.smoke_config("qwen2.5-3b"), j_configs.train_policy())
    return jm, jm.init(jax.random.PRNGKey(0))


def bnn_feed() -> dict:
    b = cifar_batch_at(DataConfig(seed=11, global_batch=cases.BNN_BATCH), 0)
    return {"images": b["images"], "labels": b["labels"]}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(tmp: str) -> str:
    """``launch.train.train`` in 2 processes under torchrun's environment
    (``spmd_cases.launched``); returns the directory of their results."""
    os.makedirs(os.path.join(tmp, "launched"))
    mp.start_processes(cases.launched, args=(2, free_port(), os.path.join(tmp, "ckpt"),
                                             os.path.join(tmp, "launched")),
                       nprocs=2, join=True, start_method="spawn")
    return tmp


def lonely(tmp: str) -> dict:
    """A world of two that one process waits for alone (2 s timeout)."""
    proc = mp.get_context("spawn").Process(
        target=cases.lonely, args=(os.path.join(tmp, "store"), os.path.join(tmp, "out.pt"),
                                   2.0))
    proc.start()
    proc.join(60)
    return {"exitcode": proc.exitcode, **torch.load(os.path.join(tmp, "out.pt"))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every spawned world at once, while the lockstep references run
    here."""
    tmp = str(tmp_path_factory.mktemp("spmd"))
    jm, jparams = qwen_jax()
    qwen = params_from_numpy(jparams, device="cpu")
    bnn = numpy_params()
    feed = bnn_feed()
    with concurrent.futures.ThreadPoolExecutor(4) as ex:
        two = ex.submit(pg.spawn, cases.world_of_two, 2, qwen, bnn, feed,
                        device="cpu", workdir=tmp)
        four = ex.submit(pg.spawn, cases.world_of_four, 4, device="cpu", workdir=tmp)
        launched = ex.submit(launch, str(tmp_path_factory.mktemp("launch")))
        alone = ex.submit(lonely, str(tmp_path_factory.mktemp("lonely")))
        with one_thread():
            refs = {("tp", a): cases.tp_step(a, (1, 2), qwen if a == "qwen2.5-3b" else None)
                    for a in cases.TP_ARCHS}
            refs["fsdp"] = cases.tp_step("qwen2.5-3b", (2, 2))
            refs["fsdp_mb"] = cases.tp_step("qwen2.5-3b", (2, 2), tcfg=cases.MICROBATCHED)
            refs["lm_dp"] = cases.lm_dp_step()
            for c in ("none", "int8", "signsgd"):
                refs[("bnn", c)] = cases.bnn_dp_step(c, bnn, feed)
        return {"two": two.result(), "four": four.result(), "refs": refs,
                "jax": (jm, jparams), "bnn": (bnn, feed), "launched": launched.result(),
                "lonely": alone.result()}


def equal_trees(a, b) -> None:
    la, lb = tree.leaves(a), tree.leaves(b)
    assert len(la) == len(lb)
    for (path, x), y in zip(tree.leaves_with_path(a), lb):
        assert x.dtype == y.dtype and torch.equal(x, y), path


# ------------------------------ collectives -----------------------------------


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("dtype", sorted(cases.DTYPES))
@pytest.mark.parametrize("kind", cases.KINDS)
def test_collectives_are_the_lockstep_ones(runs, world, kind, dtype):
    """Each rank's result and its input's gradient, bit for bit."""
    got = {}
    for rank in runs["two" if world == 2 else "four"]:
        got.update(rank["collectives"][(kind, dtype)])
    with one_thread():
        ref = cases.collective(world, kind, dtype)
    assert sorted(got) == list(range(world))
    for r in range(world):
        assert torch.equal(got[r]["out"], ref[r]["out"])
        if kind != "all_max":
            assert torch.equal(got[r]["grad"], ref[r]["grad"])


# ------------------------------ the steps -------------------------------------


def assert_same_step(ranks, ref, world: int) -> None:
    """Every process's gathered params and Adam state, the loss, the
    pre-clip norm and the schedule, bit for bit; the counted bytes the
    lockstep mean; each process holding one device's share."""
    for got in ranks:
        equal_trees(got["params"], ref["params"])
        equal_trees(got["opt"], ref["opt"])
        for key in ("loss", "grad_norm", "lr_scale"):
            assert torch.equal(torch.as_tensor(got["metrics"][key]),
                               torch.as_tensor(ref["metrics"][key])), key
        assert sorted(got["bytes"]) == sorted(ref["bytes"])
        for k, v in ref["bytes"].items():
            assert got["bytes"][k] == pytest.approx(v, rel=1e-12), k
        assert got["held_bytes"] * world == ref["held_bytes"]


@pytest.mark.parametrize("arch", cases.TP_ARCHS)
def test_tp_step_is_the_lockstep_step(runs, arch):
    assert_same_step([r[("tp", arch)] for r in runs["two"]], runs["refs"][("tp", arch)], 2)


def test_fsdp_step_is_the_lockstep_step(runs):
    """(2, 2): four processes, each its block of every leaf over data and
    model."""
    assert_same_step([r["fsdp"] for r in runs["four"]], runs["refs"]["fsdp"], 4)
    assert runs["refs"]["fsdp"]["bytes"][("all-gather", "fsdp gather", "fwd")] > 0


def test_fsdp_step_with_microbatches_is_the_lockstep_step_to_float_order(runs):
    """With 2 microbatches a block split over data sums the rows within
    each microbatch, before the microbatches (``tensor_parallel.
    _DataGather``): the lockstep step up to the order of float sums, held
    with ``test_torch_lm_dp.py``'s tolerances."""
    ref = runs["refs"]["fsdp_mb"]
    for got in runs["four"]:
        got = got["fsdp_mb"]
        assert_same_step_within((got["params"], got["opt"], got["metrics"]),
                                (ref["params"], ref["opt"], ref["metrics"]),
                                cases.MICROBATCHED)


def test_lm_dp_step_is_the_lockstep_step(runs):
    ref = runs["refs"]["lm_dp"]
    for got in runs["two"]:
        equal_trees(got["lm_dp"]["params"], ref["params"])
        equal_trees(got["lm_dp"]["opt"], ref["opt"])
        equal_trees(got["lm_dp"]["metrics"], ref["metrics"])


@pytest.mark.parametrize("compression", ["none", "int8", "signsgd"])
def test_bnn_dp_step_is_the_lockstep_step(runs, compression):
    """Params, Adam state, every shard's residual and the metrics (BN
    statistics included); each process ran its own shard alone."""
    ref = runs["refs"][("bnn", compression)]
    for rank, got in enumerate(runs["two"]):
        got = got[("bnn", compression)]
        for key in ("params", "opt", "metrics", "err"):
            equal_trees(got[key], ref[key])
        assert len(got["shard_grads"]) == 1
        equal_trees(got["shard_grads"][0], ref["shard_grads"][rank])


# ------------------------------ against JAX -----------------------------------


def test_tp_step_is_the_jax_sharded_step(runs):
    """qwen2.5-3b on (1, 2): the JAX package's ``make_train_step`` jitted
    with ``params_shardings`` on a (1, 2) host mesh, against the SPMD
    step on the same params and batch (``test_torch_tp.py``'s bounds)."""
    jm, jparams = runs["jax"]
    jopt = j_step.init_opt_state(jparams)
    jmesh = Mesh(np.asarray(jax.devices()[:2]).reshape(1, 2), ("data", "model"))
    batch = cases.lm_batch(j_configs.smoke_config("qwen2.5-3b"))
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    with jmesh, j_sharding.activation_mesh(jmesh):
        jstep = jax.jit(j_step.make_train_step(jm, j_step.TrainConfig()),
                        in_shardings=(j_sharding.params_shardings(jmesh, jparams),
                                      j_sharding.params_shardings(jmesh, jopt), None))
        jnew, _, jmetrics = jstep(jparams, jopt, jbatch)
    got = runs["two"][1][("tp", "qwen2.5-3b")]
    np.testing.assert_allclose(float(got["metrics"]["loss"]), float(jmetrics["loss"]),
                               rtol=1e-5)
    move = 2 * TrainConfig().adamw.lr * float(got["metrics"]["lr_scale"])
    for a, b in zip(tree.leaves(got["params"]), jax.tree_util.tree_leaves(jnew)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=move)


def test_bnn_signsgd_step_is_the_jax_shard_map_step(runs):
    """The JAX package's ``make_dp_train_step`` (``shard_map`` over 2 host
    devices, sign-SGD) from the same params, zero residuals and batch:
    metrics within ``METRIC_TOL``; params within ``PARAM_TOL`` but where a
    shard's gradient is roundoff (the first step's sign share, as
    ``test_torch_resilience.py`` bounds it)."""
    bnn, feed = runs["bnn"]
    jcfg = jtrainer.BNNTrainerConfig(**cases.BNN_CFG)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    jstep = jax.jit(jtrainer.make_dp_train_step(
        jtrainer._BNNTask(jcfg.model_config()), jcfg.train_config(), mesh,
        grad_compression="signsgd", clip_predicate=jtrainer.bnn_clip_predicate))
    zeros = jax.tree.map(lambda p: np.zeros((2,) + p.shape, p.dtype), bnn)
    jp, _, _, jm = jstep(bnn, j_step.init_opt_state(bnn), zeros,
                         {k: v.numpy() for k, v in feed.items()})
    runs_ = [r[("bnn", "signsgd")] for r in runs["two"]]
    got = runs_[0]
    for key in ("loss", "acc", "grad_norm", "lr_scale"):
        np.testing.assert_allclose(float(got["metrics"][key]), float(jm[key]),
                                   **METRIC_TOL, err_msg=key)
    for a, b in zip(tree.leaves(got["metrics"]["bn_stats"]), jax.tree.leaves(jm["bn_stats"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **METRIC_TOL)
    corrected = [[g.numpy() for g in tree.leaves(r["shard_grads"][0])] for r in runs_]
    treemax = max(np.abs(c).max() for cs in corrected for c in cs)
    apart = total = 0
    for j, ((path, a), b) in enumerate(zip(tree.leaves_with_path(got["params"]),
                                           jax.tree.leaves(jp))):
        a, b = a.numpy(), np.asarray(b)
        bad = ~np.isclose(a, b, **PARAM_TOL)
        apart += int(bad.sum())
        total += a.size
        if bad.any():
            traced = _traced([c[j] for c in corrected], "signsgd", treemax)
            assert traced[bad].all(), (path, int((bad & ~traced).sum()))
    assert apart / total <= FIRST_STEP_SIGN_SHARE


# ------------------------------ the rules -------------------------------------


@pytest.mark.parametrize("devices, requested, expected", [
    (["cuda:0", "cuda:1"], None, "nccl"),
    (["cuda:0", "cuda:0"], None, "gloo"),
    (["cuda:0", "cuda:0"], "gloo", "gloo"),
    (["cuda:0", "cuda:1", "cuda:1"], "gloo", "gloo"),
    (["cuda:0"], "nccl", "nccl"),
    (["cpu", "cpu"], None, "gloo"),
])
def test_backend_rule(devices, requested, expected):
    assert pg.backend_for(devices, requested) == expected


@pytest.mark.parametrize("devices, requested, match", [
    (["cuda:0", "cuda:0"], "nccl", "2 ranks on cuda:0"),
    (["cuda:0", "cuda:1", "cuda:1"], "nccl", "2 ranks on cuda:1"),
    (["cpu", "cpu"], "nccl", "CPU"),
    (["cpu", "cuda:0"], None, "CUDA devices or on the CPU"),
    (["cuda:0"], "mpi", "expected"),
])
def test_backend_rule_refuses(devices, requested, match):
    """NCCL with two ranks on one card raises before any process group
    starts (the devices here are names: no card is touched)."""
    with pytest.raises(ValueError, match=match):
        pg.backend_for(devices, requested)


def test_moe_steps_refuse_a_process_group(runs):
    for rank in runs["two"]:
        for name in ("tp", "dp"):
            assert "A5b step 6" in rank["moe"][name], name


def test_no_process_group_is_lockstep():
    """Without a world the collectives take every rank's part, and a mesh
    bound to a position refuses to step."""
    assert not pg.active()
    outs = tp.all_reduce([torch.ones(2), torch.ones(2)])
    assert len(outs) == 2 and torch.equal(outs[1], torch.full((2,), 2.0))
    mesh = cases.cpu_mesh((1, 2))
    mesh.position = 0
    model, _ = cases.lm_params("qwen2.5-3b")
    with pytest.raises(ValueError, match="no process group"):
        cases.make_tp_train_step(model, TrainConfig(), mesh)


def test_a_peer_that_never_comes_fails_within_the_timeout(runs):
    got = runs["lonely"]
    assert got["exitcode"] == 0
    assert got["error"] != "joined"
    assert 1.5 <= got["seconds"] < 30, got


# ------------------------------ the launcher ----------------------------------


def test_launcher_under_torchrun_env_and_a_one_device_resume(runs):
    """``launch.train.train`` in 2 processes under torchrun's environment:
    2 steps of qwen2.5-3b on (1, 2), one checkpoint writer (rank 0's), the
    same params on both ranks; a one-device run resumes from that
    checkpoint with those params."""
    ckpt_dir = os.path.join(runs["launched"], "ckpt")
    ranks = [torch.load(os.path.join(runs["launched"], "launched", f"rank{r}.pt"))
             for r in range(2)]
    assert [r["writers"] for r in ranks] == [1, 0]
    assert not any(r["active_after"] for r in ranks)
    equal_trees(ranks[1]["params"], ranks[0]["params"])
    assert ranks[0]["losses"] == ranks[1]["losses"] and len(ranks[0]["losses"]) == 2
    assert sorted(os.listdir(ckpt_dir)) == ["step_00000002"]
    with one_thread():
        resumed = launch_train.train("qwen2.5-3b", steps=2, batch=cases.BATCH,
                                     seq=cases.SEQ, ckpt_dir=ckpt_dir, device="cpu")
    assert resumed["losses"] == []
    equal_trees(resumed["params"], ranks[0]["params"])
