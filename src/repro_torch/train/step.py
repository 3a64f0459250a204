"""Train and serve step factories, as ``repro.train.step``.

``make_train_step(model, tcfg)`` returns ``(params, opt_state, batch) ->
(params, opt_state, metrics)``: the loss gradient by
``torch.autograd.grad``, global-norm clip, AdamW with the latent clip
of the leaves ``clip_predicate`` selects, and optional gradient
accumulation over microbatches, taken in order and summed from zeros
as the JAX package's scan does. The model's own metrics (accuracy, BN
batch statistics, ...) ride along in ``metrics``, averaged over
microbatches, so the BNN trainer keeps running BatchNorm statistics
without a second forward.

The schedule takes the POST-increment optimizer step (``count + 1``):
``cosine_schedule(0)`` is 0.0 during warm-up, so the pre-increment count
would make the first update a no-op (with microbatches, a whole
accumulated batch).

A leaf the loss does not reach (a BatchNorm ``mean``/``var`` buffer in
training mode) gets a zero gradient, as ``jax.grad`` gives it, so
Adam's moments and the global norm see the JAX package's tree.

``make_prefill`` / ``make_decode_step`` wrap ``Model.prefill`` /
``Model.decode_step``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import tree
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.clip import clip_by_global_norm
from repro_torch.optim.schedules import cosine_schedule


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    adamw: AdamWConfig = AdamWConfig(lr=3e-4, weight_decay=0.01, latent_clip=True)
    clip_norm: float = 1.0
    microbatches: int = 1          # >1 => gradient accumulation
    warmup_steps: int = 100
    total_steps: int = 10_000


def _keystr(path: tuple) -> str:
    return "".join(f"[{k!r}]" for k in path)


def _split_microbatches(batch, microbatches: int):
    """Reshape every leaf ``[B, ...] -> [microbatches, B / microbatches,
    ...]``.

    Raises an actionable ValueError where a plain split would fail
    cryptically, or silently mis-split a leaf whose leading dim differs
    from the batch size."""
    leaves = list(tree.leaves_with_path(batch))
    if not leaves:
        raise ValueError("empty batch")
    sizes = {_keystr(path): np.shape(leaf)[0] if np.ndim(leaf) else None
             for path, leaf in leaves}
    dims = set(sizes.values())
    if None in dims or len(dims) != 1:
        raise ValueError(
            f"gradient accumulation needs every batch leaf to share one "
            f"leading batch dim; got leading dims {sizes} (drop scalar "
            f"bookkeeping keys like 'step' before the train step)")
    (bsz,) = dims
    if bsz % microbatches != 0:
        raise ValueError(
            f"batch size {bsz} is not divisible by "
            f"tcfg.microbatches={microbatches}; pick a batch size that "
            f"is a multiple of the microbatch count")
    return tree.tree_map(
        lambda t: t.reshape(microbatches, bsz // microbatches, *t.shape[1:]),
        batch)


def _grads_of(model, params, batch):
    """(loss, metrics, grads): ``model.loss`` and its gradient with
    respect to every leaf of ``params``, zeros where it does not reach.
    Loss and metrics come back detached."""
    live = tree.tree_map(lambda p: p.detach().requires_grad_(True), params)
    flat = tree.leaves(live)
    with torch.enable_grad():
        loss, metrics = model.loss(live, batch)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = iter([torch.zeros_like(p) if g is None else g
                  for p, g in zip(flat, grads)])
    return (loss.detach(), tree.tree_map(torch.Tensor.detach, metrics),
            tree.tree_map(lambda _: next(grads), live))


def make_train_step(model, tcfg: TrainConfig,
                    clip_predicate: Optional[Callable] = None):
    def train_step(params, opt_state, batch):
        # Post-increment: adamw_update runs with count + 1, and
        # cosine_schedule(0) == 0.0.
        step = opt_state["adam"]["count"] + 1
        if tcfg.microbatches > 1:
            gsum = tree.tree_map(torch.zeros_like, params)
            losses, mmetrics = [], []
            mbs = _split_microbatches(batch, tcfg.microbatches)
            for i in range(tcfg.microbatches):
                mb = tree.tree_map(lambda t, i=i: t[i], mbs)
                loss, metrics, grads = _grads_of(model, params, mb)
                gsum = tree.tree_map(torch.add, gsum, grads)
                losses.append(loss)
                mmetrics.append(metrics)
            grads = tree.tree_map(lambda g: g / tcfg.microbatches, gsum)
            loss = torch.mean(torch.stack(losses))
            model_metrics = tree.tree_map(
                lambda *ms: torch.mean(torch.stack(ms), dim=0), *mmetrics)
        else:
            loss, model_metrics, grads = _grads_of(model, params, batch)

        grads, gnorm = clip_by_global_norm(grads, tcfg.clip_norm)
        lr_scale = cosine_schedule(step, warmup_steps=tcfg.warmup_steps,
                                   total_steps=tcfg.total_steps)
        new_params, new_adam = adamw_update(
            grads, opt_state["adam"], params, tcfg.adamw, lr_scale=lr_scale,
            clip_predicate=clip_predicate)
        metrics = {**model_metrics, "loss": loss, "grad_norm": gnorm,
                   "lr_scale": lr_scale}
        return new_params, {"adam": new_adam}, metrics

    return train_step


def init_opt_state(params) -> dict:
    return {"adam": adamw_init(params)}


def make_prefill(model):
    def prefill_step(params, state, batch):
        return model.prefill(params, state, batch)

    return prefill_step


def make_decode_step(model):
    def decode_step(params, state, batch):
        return model.decode_step(params, state, batch)

    return decode_step
