"""Unified model API, as ``repro.models.model_factory``: ``build_model(cfg,
policy)`` -> a ``Model`` whose methods have the JAX package's
signatures:

  loss(params, batch)                 -> (total_loss, {"loss", "aux"})
  prefill(params, state, batch)       -> (last_logits, state)
  decode_step(params, state, batch)   -> (logits, state)

Decoder-only token families only; ``loss`` is the forward alone (no
backward through the kernels yet); ``input_specs`` (the dry-run) and the
encoder-decoder family are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.layers import pack_linear_params
from repro_torch.models import transformer as tf_mod
from repro_torch.models.common import QuantPolicy, pack_projection_tree

Params = Any


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: Any
    policy: QuantPolicy

    def init(self, generator: torch.Generator) -> Params:
        """Random float params on the generator's device."""
        return tf_mod.init_lm_params(generator, self.cfg)

    def init_packed(self, generator: torch.Generator) -> Params:
        """The params of ``pack(init(generator))``, drawn and packed one
        projection at a time (MoE stacks expert by expert), so the float
        weights of the whole model never exist: one full-width jamba
        period is 177 GB in float32 and 5.5 GB packed."""
        use_scale = self.policy.use_scale
        return tf_mod.init_lm_params(
            generator, self.cfg,
            finish=lambda p: pack_linear_params(p, use_scale=use_scale))

    def pack(self, params: Params) -> Params:
        """Float params -> 1-bit packed serving params (paper §3.1)."""
        return pack_projection_tree(params, use_scale=self.policy.use_scale)

    def loss(self, params: Params, batch: dict):
        """The training loss of ``batch`` (``{"tokens", "labels"}``)."""
        return tf_mod.lm_loss(params, batch, self.cfg, self.policy)

    def prefill(self, params: Params, state: dict, batch: dict):
        return tf_mod.prefill(params, self.cfg, self.policy, state=state,
                              tokens=batch["tokens"])

    def decode_step(self, params: Params, state: dict, batch: dict):
        return tf_mod.decode_step(params, self.cfg, self.policy, state=state,
                                  tokens=batch["tokens"])

    def init_state(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   device=None) -> dict:
        return tf_mod.init_state(self.cfg, batch, max_len, dtype=dtype,
                                 device=device)


def build_model(cfg, policy: QuantPolicy) -> Model:
    if cfg.family == "encdec":
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder family is not ported yet")
    return Model(cfg=cfg, policy=policy)
