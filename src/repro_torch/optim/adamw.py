"""AdamW with the BNN latent-weight clip, over the params' tree.

Binarized training (BNN, Courbariaux et al.) clips the latent real
weights to [-1, 1] after each update: outside that range the STE
gradient is zero and the weight would be stuck for good.
``latent_clip`` clips every leaf whose path the caller's predicate
selects (the binarized matrices).

The update is ``repro.optim.adamw``'s, op for op: bias corrections as
factors of ``m`` and ``v``, ``lr * (m * mu_hat) / (sqrt(v * nu_hat) +
eps)``, then ``+ lr * wd * p`` on every leaf (``torch.optim.AdamW``
orders both differently and would round otherwise).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch import tree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    latent_clip: bool = False  # clip binarized latent weights to [-1, 1]


def adamw_init(params) -> dict:
    """Zero moments shaped like ``params``, and an int32 step count."""
    leaf = tree.leaves(params)[0]
    return {
        "mu": tree.tree_map(torch.zeros_like, params),
        "nu": tree.tree_map(torch.zeros_like, params),
        "count": torch.zeros((), dtype=torch.int32, device=leaf.device),
    }


def _default_clip(path: tuple) -> bool:
    return bool(path) and path[-1] == "w"


def adamw_update(grads, state: dict, params, cfg: AdamWConfig, *,
                 lr_scale=1.0, clip_predicate: Optional[Callable] = None):
    """Returns (new_params, new_state). ``lr_scale`` multiplies the base
    lr (the schedule's output); ``clip_predicate(path)`` picks the leaves
    the latent clip applies to (default: every leaf named ``w``)."""
    count = state["count"] + 1
    b1, b2 = cfg.b1, cfg.b2
    mu = tree.tree_map(lambda m, g: b1 * m + (1 - b1) * g, state["mu"], grads)
    nu = tree.tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state["nu"], grads)
    c = count.to(torch.float32)
    mu_hat_scale = torch.div(1.0, 1 - b1 ** c)
    nu_hat_scale = torch.div(1.0, 1 - b2 ** c)
    lr = cfg.lr * lr_scale

    def upd(p, m, v):
        step = lr * (m * mu_hat_scale) / (torch.sqrt(v * nu_hat_scale) + cfg.eps)
        if cfg.weight_decay:
            step = step + lr * cfg.weight_decay * p
        return (p - step).to(p.dtype)

    new_params = tree.tree_map(upd, params, mu, nu)
    if cfg.latent_clip:
        pred = clip_predicate or _default_clip
        new_params = tree.map_with_path(
            lambda path, v: torch.clamp(v, -1.0, 1.0) if pred(path) else v,
            new_params)
    return new_params, {"mu": mu, "nu": nu, "count": count}
