"""The cases of ``tests/test_torch_spmd.py``, each one function that runs
either way: in lockstep from one process (no process group: the
reference), or as one rank of a spawned world (``distributed.
process_group.spawn``), where it binds its mesh to the process's position
first. Spawned processes import this module, which imports torch and the
port alone (no JAX), and return what they computed to the test."""

import os
import time

import numpy as np
import torch

from repro_torch import tree
from repro_torch.configs.base import smoke_config, train_policy
from repro_torch.convert import params_from_numpy
from repro_torch.distributed import process_group as pg
from repro_torch.distributed import sharding
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.launch.mesh import DeviceMesh, ServingMesh
from repro_torch.models.model_factory import build_model
from repro_torch.train import bnn_trainer
from repro_torch.train.step import (TrainConfig, init_opt_state, make_dp_train_step,
                                    make_tp_train_step)

KINDS = ("all_reduce", "all_gather0", "all_gather1", "all_gather2", "all_max")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
PART = (4, 6, 8)
TP_ARCHS = ("qwen2.5-3b", "xlstm-1.3b", "seamless-m4t-large-v2")
BATCH, SEQ = 4, 32
# 8 images a shard on 2 processes: at 4 a shard over 2 the first sign-SGD
# step's pre-clip norm parts from the JAX package's by ~1e-3 relative,
# past test_torch_resilience.METRIC_TOL, in lockstep as SPMD (sign-SGD
# sends roundoff-sized gradients' signs on at full scale: that module's
# docstring).
BNN_BATCH = 16
BNN_CFG = dict(steps=10, batch=BNN_BATCH, warmup_steps=2)


def bound(mesh):
    """``mesh`` bound to this process's position under a process group."""
    return pg.bind(mesh) if pg.active() else mesh


def cpu_mesh(shape) -> DeviceMesh:
    return DeviceMesh(np.full(shape, "cpu", dtype=object), ("data", "model"))


# ------------------------------ collectives -----------------------------------


def collective(world: int, kind: str, dtype: str) -> dict:
    """One collective of ``tensor_parallel`` over a model axis of
    ``world`` ranks on numpy-drawn parts, and the gradients of its inputs
    for the loss ``sum_r <out_r, w_r>``: ``{rank: {"out", "grad"}}`` of
    the ranks this process holds."""
    rng = np.random.default_rng([world, KINDS.index(kind), len(dtype)])
    xs = rng.normal(size=(world, *PART))
    shape = list(PART)
    if kind.startswith("all_gather"):
        shape[int(kind[-1])] *= world
    ws = rng.normal(size=(world, *shape))
    held = [pg.index(pg.MODEL)] if pg.active() else list(range(world))
    ty = DTYPES[dtype]
    grad = kind != "all_max"
    inputs = [torch.tensor(xs[r], dtype=ty, requires_grad=grad) for r in held]
    if kind == "all_reduce":
        outs = tp.all_reduce(inputs, site="test")
    elif kind == "all_max":
        outs = tp.all_max(inputs, site="test")
    else:
        outs = tp.all_gather(inputs, int(kind[-1]), site="test")
    result = {r: {"out": o.detach()} for r, o in zip(held, outs)}
    if grad:
        loss = sum((o * torch.tensor(ws[r], dtype=ty)).sum() for r, o in zip(held, outs))
        for r, g in zip(held, torch.autograd.grad(loss, inputs)):
            result[r]["grad"] = g
    return result


def collectives(world: int) -> dict:
    if pg.active():
        pg.bind(cpu_mesh((1, world)))
    return {(kind, dtype): collective(world, kind, dtype)
            for kind in KINDS for dtype in DTYPES}


# ------------------------------ LM steps --------------------------------------


def lm_batch(cfg, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (BATCH, SEQ + 1)).astype(np.int32)
    batch = {"tokens": tokens[:, :-1].copy(), "labels": tokens[:, 1:].copy()}
    if cfg.input_kind == "embeddings":
        batch["input_embeds"] = rng.normal(0, 1, (BATCH, SEQ, cfg.d_model)).astype(np.float32)
        if cfg.family != "encdec":
            del batch["tokens"]
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def lm_params(arch: str, params=None):
    model = build_model(smoke_config(arch), train_policy())
    if params is None:
        params = model.init(torch.Generator().manual_seed(1))
    return model, params


def tp_step(arch: str, shape, params=None, seed: int = 0,
            tcfg: TrainConfig = TrainConfig()) -> dict:
    """One ``make_tp_train_step`` on a ``shape`` mesh of CPU entries:
    the gathered params and optimizer state, the metrics, the counted
    collective bytes and the param bytes this process holds."""
    model, params = lm_params(arch, params)
    mesh = bound(cpu_mesh(shape))
    shards = sharding.shard_params(params, mesh)
    opt = sharding.shard_params(init_opt_state(params), mesh)
    tp.reset_bytes()
    p, o, m = make_tp_train_step(model, tcfg, mesh)(
        shards, opt, lm_batch(model.cfg, seed))
    held = sum(t.numel() * t.element_size() for s in shards for t in tree.leaves(s))
    return {"params": sharding.gather_params(p, mesh), "opt": sharding.gather_params(o, mesh),
            "metrics": m, "bytes": dict(tp.BYTES), "held_bytes": held}


def lm_dp_step(arch: str = "smollm-360m", n: int = 2) -> dict:
    model, params = lm_params(arch)
    mesh = bound(ServingMesh(("cpu",) * n))
    p, o, m = make_dp_train_step(model, TrainConfig(), mesh)(
        params, init_opt_state(params), lm_batch(model.cfg))
    return {"params": p, "opt": o, "metrics": m}


def moe_refusals() -> dict:
    """The message each step factory raises for an MoE config under a
    process group."""
    model, _ = lm_params("moonshot-v1-16b-a3b")
    out = {}
    for name, make, mesh in (
            ("tp", make_tp_train_step, cpu_mesh((1, pg.world_size()))),
            ("dp", make_dp_train_step, ServingMesh(("cpu",) * pg.world_size()))):
        try:
            make(model, TrainConfig(), pg.bind(mesh))
            out[name] = None
        except NotImplementedError as e:
            out[name] = str(e)
    return out


# ------------------------------ the BNN DP step -------------------------------


def bnn_dp_step(compression: str, params_np, feed: dict, n: int = 2) -> dict:
    """One ``bnn_trainer.make_dp_train_step`` over ``n`` replicas from
    ``params_np`` and zero residuals: params, Adam state, every shard's
    residual rows stacked ``[n, ...]``, metrics, and the gradient of each
    shard this process ran."""
    cfg = bnn_trainer.BNNTrainerConfig(**BNN_CFG)
    mesh = bound(ServingMesh(("cpu",) * n))
    params = params_from_numpy(params_np, device="cpu")
    err = bnn_trainer.init_dp_error_feedback(params, 1 if pg.active() else n)
    step = bnn_trainer.make_dp_train_step(
        bnn_trainer._BNNTask(cfg.model_config()), cfg.train_config(), mesh,
        grad_compression=compression, clip_predicate=bnn_trainer.bnn_clip_predicate)
    shard_grads = []
    inner = bnn_trainer._grads_of

    def recording(task, p, batch):
        out = inner(task, p, batch)
        shard_grads.append(out[2])
        return out

    bnn_trainer._grads_of = recording
    try:
        p, o, e, m = step(params, init_opt_state(params), err, feed)
    finally:
        bnn_trainer._grads_of = inner
    if pg.active():
        e = tree.tree_map(lambda *rows: torch.cat(rows), *pg.gather_tree(e, pg.WORLD))
    return {"params": p, "opt": o, "err": e, "metrics": m, "shard_grads": shard_grads}


# ------------------------------ the worlds ------------------------------------


def world_of_two(qwen_params, bnn_params, bnn_feed) -> dict:
    """Every case of a world of two processes, in one order on each."""
    out = {"collectives": collectives(2)}
    for arch in TP_ARCHS:
        out[("tp", arch)] = tp_step(arch, (1, 2),
                                    qwen_params if arch == "qwen2.5-3b" else None)
    out["lm_dp"] = lm_dp_step()
    for c in bnn_trainer.DP_COMPRESSIONS:
        out[("bnn", c)] = bnn_dp_step(c, bnn_params, bnn_feed)
    out["moe"] = moe_refusals()
    return out


MICROBATCHED = TrainConfig(microbatches=2)


def world_of_four() -> dict:
    return {"collectives": collectives(4), "fsdp": tp_step("qwen2.5-3b", (2, 2)),
            "fsdp_mb": tp_step("qwen2.5-3b", (2, 2), tcfg=MICROBATCHED)}


# ------------------------------ the launcher ----------------------------------


def launched(rank: int, size: int, port: int, ckpt_dir: str, out_dir: str) -> None:
    """One rank of ``launch.train.train`` under torchrun's environment
    (``env://``): its params and the checkpoint writers it opened."""
    from repro_torch.launch import train as launch_train
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(size), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(size), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    writers = []
    real = launch_train.ckpt.AsyncCheckpointer

    class Counted(real):
        def __init__(self, *a, **kw):
            writers.append(a)
            super().__init__(*a, **kw)

    launch_train.ckpt.AsyncCheckpointer = Counted
    out = launch_train.train("qwen2.5-3b", steps=2, batch=BATCH, seq=SEQ,
                             ckpt_dir=ckpt_dir, ckpt_every=2, device="cpu")
    torch.save({"params": out["params"], "losses": out["losses"], "writers": len(writers),
                "active_after": pg.active()}, os.path.join(out_dir, f"rank{rank}.pt"))


def lonely(store: str, out: str, timeout: float) -> None:
    """Rank 0 of a world of two whose other rank never comes: the error
    and the seconds it took."""
    t0 = time.monotonic()
    try:
        pg.init(0, 2, store, device="cpu", timeout=timeout)
        got = "joined"
    except Exception as e:  # the failure is the result
        got = f"{type(e).__name__}: {e}"
    torch.save({"error": got, "seconds": time.monotonic() - t0}, out)
