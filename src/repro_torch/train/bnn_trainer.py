"""The train half of the BNN's train-to-serve loop, as
``repro.train.bnn_trainer``: a CIFAR training loop over
``make_train_step`` with the three BNN pieces the generic step cannot
know about.

* **STE training task**: ``bnn_train_loss`` (FAKE_QUANT forward, batch
  BatchNorm, straight-through gradients) as ``model.loss``; accuracy
  and the BN batch statistics ride along as metrics.
* **Latent-weight clip**: :func:`bnn_clip_predicate` names exactly the
  binarized latent matrices (``conv[i].w``, ``fc[j].w``) for AdamW's
  ``latent_clip``.
* **Running BN statistics**: after each optimizer step the batch
  statistics are EMA'd into the ``mean``/``var`` buffers
  (``update_bn_stats``), which packed inference reads.

Checkpoints (latents + optimizer state) go through
``checkpoint/manager.py`` and resume bit for bit;
``core.bnn.save_binary_checkpoint`` is the sign-form export for serving.

``make_dp_train_step`` is the data-parallel step over a 1-D ``"data"``
mesh (``launch.mesh.ServingMesh``): each shard's gradient, then a reduce
through ``distributed.compression``: float32 (``"none"``), error-feedback
int8 (``"int8"``) or 1-bit EF sign-SGD (``"signsgd"``). The JAX package
runs it under ``shard_map`` with ``psum``; the port runs the shards one
after another in one process and sums in mesh order on the device of the
first replica, neither ``torch.cuda.comm.reduce_add`` nor NCCL: the
resilient trainer's chaos gates need replays bit-identical to their
controls, so the order of every float sum must not vary; the mesh is one
process with no process group; and replicas may share one card. A shard
on another card is moved to the first with ``.to()``. Where the mesh runs
one process a device (``distributed.process_group``) each process takes
its own shard's gradient and gathers the others over ``torch.distributed``
before the same reduce, so its params, residuals and metrics are the
one-process step's bit for bit.
``train/resilience.py`` wraps both steps in the fault-tolerance machinery.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional

import torch

from repro_torch import tree
from repro_torch.checkpoint import manager as ckpt_manager
from repro_torch.core.binarize import QuantMode
from repro_torch.core.bnn import (BNNConfig, bnn_eval_logits,
                                  bnn_train_loss, init_bnn_params,
                                  resolve_device, update_bn_stats,
                                  xent_and_acc)
from repro_torch.data.pipeline import DataConfig, synthetic_cifar_batches
from repro_torch.distributed import compression
from repro_torch.distributed import process_group as pg
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import (TrainConfig, _apply_update, _grads_of,
                                    dp_mesh_mean, dp_shards, init_opt_state,
                                    make_train_step, spmd)


def bnn_clip_predicate(path: tuple) -> bool:
    """True exactly for the binarized latent weight matrices,
    ``("conv", i, "w")`` and ``("fc", j, "w")``: every one is binarized in
    the FAKE_QUANT forward (the first conv's too), and nothing else
    (biases, BatchNorm) is."""
    return len(path) >= 2 and path[0] in ("conv", "fc") and path[-1] == "w"


@dataclasses.dataclass(frozen=True)
class _BNNTask:
    """The ``model.loss`` the train step factory consumes."""

    cfg: BNNConfig

    def loss(self, params, batch):
        return bnn_train_loss(params, batch["images"], batch["labels"],
                              self.cfg)


@dataclasses.dataclass(frozen=True)
class BNNTrainerConfig:
    steps: int = 200
    batch: int = 64
    lr: float = 3e-3
    weight_decay: float = 0.0      # latents live in [-1, 1]; decay hurts
    clip_norm: float = 5.0
    warmup_steps: int = 10
    microbatches: int = 1
    bn_momentum: float = 0.9
    use_scale: bool = False        # XNOR-Net per-channel alpha
    seed: int = 0                  # param init
    data_seed: int = 11            # synthetic-CIFAR stream
    eval_batches: int = 4          # held-out batches AFTER the train range
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 50
    log_every: int = 20

    def train_config(self) -> TrainConfig:
        return TrainConfig(
            adamw=AdamWConfig(lr=self.lr, weight_decay=self.weight_decay,
                              latent_clip=True),
            clip_norm=self.clip_norm, microbatches=self.microbatches,
            warmup_steps=self.warmup_steps, total_steps=self.steps)

    def model_config(self) -> BNNConfig:
        return BNNConfig(mode=QuantMode.FAKE_QUANT, use_scale=self.use_scale)


@dataclasses.dataclass
class TrainResult:
    params: Any
    opt_state: Any
    history: dict          # {"loss": [...], "acc": [...], "lr_scale": [...]}
    eval_loss: float
    eval_acc: float
    start_step: int        # 0, or the resumed checkpoint's step


@torch.no_grad()
def evaluate_bnn(params, data_iter, *, batches: int,
                 use_scale: bool = False) -> tuple[float, float]:
    """Mean (loss, accuracy) of the float-boundary eval forward over the
    next ``batches`` batches of ``data_iter``: the forward the packed
    engines reproduce bit for bit, so this is serving accuracy."""
    dev = tree.leaves(params)[0].device
    losses, accs = [], []
    for _, b in zip(range(batches), data_iter):
        logits = bnn_eval_logits(params, b["images"].to(dev),
                                 use_scale=use_scale)
        loss, acc = xent_and_acc(logits, b["labels"].to(dev))
        losses.append(loss)
        accs.append(acc)
    if not losses:      # the JAX package's mean of no batches: NaN
        return float("nan"), float("nan")
    return (float(torch.mean(torch.stack(losses))),
            float(torch.mean(torch.stack(accs))))


def train_bnn(cfg: BNNTrainerConfig, *, params=None, verbose: bool = False,
              device=None, mesh=None) -> TrainResult:
    """Train the CIFAR BNN with STE, the latent clip and running BN
    statistics, on ``device`` (CUDA unless given; ``params``, if given,
    are moved there, else ``init_bnn_params(cfg.seed)``).

    Deterministic: param seed, stateless ``(seed, step)`` batches. With
    ``checkpoint_dir`` it writes a checkpoint (latents + optimizer state)
    every ``checkpoint_every`` steps and at the end, and resumes from the
    latest valid one there: batch ``i`` comes from the data seed alone
    and the cosine horizon stays ``cfg.steps``, so a resumed run replays
    the rest of the run it resumes. The held-out eval takes the stream's
    batches ``steps .. steps + eval_batches - 1``.

    With ``mesh`` (a ``ServingMesh`` bound to this process's position by
    ``distributed.process_group.bind``) each step is
    :func:`make_dp_train_step` with the plain mean (``"none"``) over the
    world, one process a device on ``device``; rank 0 prints and writes the
    checkpoints, and every rank resumes from the same one.
    """
    dev = resolve_device(device)
    lead = mesh is None or mesh.position == 0
    task = _BNNTask(cfg.model_config())
    tcfg = cfg.train_config()
    if params is None:
        params = init_bnn_params(cfg.seed, device=dev)
    else:
        params = tree.tree_map(lambda t: t.to(dev), params)
    opt_state = init_opt_state(params)

    start_step = 0
    if cfg.checkpoint_dir:
        latest = ckpt_manager.latest_valid_step(cfg.checkpoint_dir)
        if latest is not None:
            state = ckpt_manager.restore(cfg.checkpoint_dir, latest,
                                         {"params": params, "opt": opt_state})
            params, opt_state = state["params"], state["opt"]
            start_step = latest

    step_fn = make_train_step(task, tcfg, clip_predicate=bnn_clip_predicate)
    if mesh is not None:
        dp_step = make_dp_train_step(task, tcfg, mesh, grad_compression="none",
                                     clip_predicate=bnn_clip_predicate)

        def step_fn(p, o, b):
            p, o, _, m = dp_step(p, o, None, b)
            return p, o, m
    data = synthetic_cifar_batches(
        DataConfig(seed=cfg.data_seed, global_batch=cfg.batch))
    steps: dict = {"loss": [], "acc": [], "lr_scale": []}
    for i, batch in zip(range(cfg.steps), data):
        if i < start_step:
            continue  # stateless stream: skip the batches the resume covers
        feed = {"images": batch["images"].to(dev),
                "labels": batch["labels"].to(dev)}
        params, opt_state, metrics = step_fn(params, opt_state, feed)
        params = update_bn_stats(params, metrics.pop("bn_stats"),
                                 momentum=cfg.bn_momentum)
        for key in steps:
            steps[key].append(metrics[key])
        if verbose and lead and (i % cfg.log_every == 0 or i == cfg.steps - 1):
            print(f"step {i:4d} loss {float(metrics['loss']):.4f} "
                  f"acc {float(metrics['acc']):.3f} "
                  f"lr_scale {float(metrics['lr_scale']):.3f}")
        if (lead and cfg.checkpoint_dir and cfg.checkpoint_every
                and (i + 1) % cfg.checkpoint_every == 0):
            ckpt_manager.save(cfg.checkpoint_dir, i + 1,
                              {"params": params, "opt": opt_state})
    if lead and cfg.checkpoint_dir:
        ckpt_manager.save(cfg.checkpoint_dir, cfg.steps,
                          {"params": params, "opt": opt_state})
    # One copy to the host for the run, not one a step.
    history = {k: torch.stack(v).tolist() if v else [] for k, v in steps.items()}

    # Held-out: the stateless stream continues past the train range.
    eval_loss, eval_acc = evaluate_bnn(params, data, batches=cfg.eval_batches,
                                       use_scale=cfg.use_scale)
    if verbose and lead:
        print(f"eval loss {eval_loss:.4f} acc {eval_acc:.3f} "
              f"(chance {1.0 / 10:.2f})")
    return TrainResult(params=params, opt_state=opt_state, history=history,
                       eval_loss=eval_loss, eval_acc=eval_acc,
                       start_step=start_step)


# ---------------------------------------------------------------------------
# The data-parallel train step with a compressed gradient reduce.
# ---------------------------------------------------------------------------

DP_COMPRESSIONS = ("none", "int8", "signsgd")


def init_dp_error_feedback(params, n_devices: int):
    """Zero error-feedback residuals: one a gradient leaf and shard,
    stacked on a leading ``[n_devices, ...]`` axis (the JAX package's
    layout, so a checkpoint resumes in either package). Each shard
    accumulates the quantization error of its own gradient stream."""
    return tree.tree_map(
        lambda p: torch.zeros((n_devices,) + tuple(p.shape), dtype=p.dtype,
                              device=p.device), params)


def make_dp_train_step(task, tcfg: TrainConfig, mesh, *,
                       grad_compression: str = "signsgd",
                       clip_predicate=None):
    """The data-parallel train step over ``mesh``'s devices: ``(params,
    opt_state, err, batch) -> (params, opt_state, err, metrics)``.

    The batch is split into ``len(mesh)`` contiguous shards
    (``distributed.sharding.shard_rows``); shard ``i`` takes the
    gradient of ``task.loss`` on its rows alone on ``mesh.devices[i]``
    (BatchNorm sees the shard's own batch statistics, as each
    ``shard_map`` shard does). The gradients meet in mesh order:

      * ``"none"``: their sum over the mesh divided by n (the JAX
        package's ``pmean``),
      * ``"int8"``: ``compression.psum_compressed``,
      * ``"signsgd"``: ``compression.psum_signsgd``.

    ``err`` is :func:`init_dp_error_feedback`'s tree, row ``i`` shard
    ``i``'s residual. Then one global-norm clip, the cosine schedule on
    ``count + 1`` and one AdamW update with the latent clip. ``loss``,
    ``acc`` and ``bn_stats`` are each the mean of the shards' in mesh
    order (the JAX package's ``pmean`` of the shard statistics, not the
    global batch's). Params, optimizer state and ``err`` live on one
    device; the results come back there. ``tcfg.microbatches`` is not
    read, as in the JAX package's step.

    Where ``mesh`` runs one process a device (its ``position`` set by
    ``distributed.process_group.bind``) a process takes the gradient of its
    own shard alone, ``err`` holds its own residual row (``[1, ...]``, row
    ``position`` of the stack), and the reduce gathers every shard's
    gradient (``"none"``) or every shard's ``g + err``
    (``distributed.compression``) over the world before summing in mesh
    order; the metrics' means gather too. Params, optimizer state,
    residuals and metrics equal the one-process step's bit for bit.
    """
    if grad_compression not in DP_COMPRESSIONS:
        raise ValueError(
            f"unknown grad_compression {grad_compression!r}; expected one "
            f"of {DP_COMPRESSIONS}")
    reduce = {"int8": compression.psum_compressed,
              "signsgd": compression.psum_signsgd}.get(grad_compression)
    devices = tuple(mesh.devices)
    own = mesh.position if spmd(mesh) else None

    def train_step(params, opt_state, err, batch):
        home = tree.leaves(params)[0].device
        losses, shard_metrics, shard_grads = zip(*dp_shards(
            functools.partial(_grads_of, task), params, batch, devices, own))
        if own is not None and reduce is None:
            shard_grads = pg.gather_tree(shard_grads[0], pg.DATA)
        per_leaf = list(zip(*map(tree.leaves, shard_grads)))
        if reduce is None:
            means = [dp_mesh_mean(gs, home) for gs in per_leaf]
            new_err = err
        else:
            means, rows_out = [], []
            for gs, e in zip(per_leaf, tree.leaves(err)):
                mean, rows = reduce(list(gs), e)
                means.append(mean.to(home))
                rows_out.append(rows.to(home))
            new_rows = iter(rows_out)
            new_err = tree.tree_map(lambda _: next(new_rows), err)
        leaves = iter(means)
        grads = tree.tree_map(lambda _: next(leaves), params)

        new_params, new_opt, gnorm, lr_scale = _apply_update(
            tcfg, params, opt_state, grads, clip_predicate)
        metrics = {
            **tree.tree_map(lambda *ms: dp_mesh_mean(ms, home), *shard_metrics),
            "loss": dp_mesh_mean(losses, home), "grad_norm": gnorm,
            "lr_scale": lr_scale}
        return new_params, new_opt, new_err, metrics

    return train_step
