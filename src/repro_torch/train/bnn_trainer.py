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
Not ported yet: the data-parallel step with compressed gradients
(``make_dp_train_step``) and the resilient trainer.
"""

from __future__ import annotations

import dataclasses
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
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import TrainConfig, init_opt_state, make_train_step


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
    return (float(torch.mean(torch.stack(losses))),
            float(torch.mean(torch.stack(accs))))


def train_bnn(cfg: BNNTrainerConfig, *, params=None, verbose: bool = False,
              device=None) -> TrainResult:
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
    """
    dev = resolve_device(device)
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
        if verbose and (i % cfg.log_every == 0 or i == cfg.steps - 1):
            print(f"step {i:4d} loss {float(metrics['loss']):.4f} "
                  f"acc {float(metrics['acc']):.3f} "
                  f"lr_scale {float(metrics['lr_scale']):.3f}")
        if (cfg.checkpoint_dir and cfg.checkpoint_every
                and (i + 1) % cfg.checkpoint_every == 0):
            ckpt_manager.save(cfg.checkpoint_dir, i + 1,
                              {"params": params, "opt": opt_state})
    if cfg.checkpoint_dir:
        ckpt_manager.save(cfg.checkpoint_dir, cfg.steps,
                          {"params": params, "opt": opt_state})
    # One copy to the host for the run, not one a step.
    history = {k: torch.stack(v).tolist() if v else [] for k, v in steps.items()}

    # Held-out: the stateless stream continues past the train range.
    eval_loss, eval_acc = evaluate_bnn(params, data, batches=cfg.eval_batches,
                                       use_scale=cfg.use_scale)
    if verbose:
        print(f"eval loss {eval_loss:.4f} acc {eval_acc:.3f} "
              f"(chance {1.0 / 10:.2f})")
    return TrainResult(params=params, opt_state=opt_state, history=history,
                       eval_loss=eval_loss, eval_acc=eval_acc,
                       start_step=start_step)
