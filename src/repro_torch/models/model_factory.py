"""Unified model API, as ``repro.models.model_factory``: ``build_model(cfg,
policy)`` -> a ``Model`` whose methods have the JAX package's
signatures:

  loss(params, batch)                 -> (total_loss, metrics)
  prefill(params, state, batch)       -> (last_logits, state)
  decode_step(params, state, batch)   -> (logits, state)
  input_specs(shape)                  -> {name: meta tensor}

Every family of the JAX package: the decoder-only ones
(``models/transformer.py``; a config fed by embeddings takes
``batch["input_embeds"]`` in ``loss`` and ``prefill``) and the
encoder-decoder (``models/encdec.py``: ``prefill`` encodes
``batch["input_embeds"]``, decodes ``batch["tokens"]`` and keeps the
encoder's output as ``state["memory"]``). ``loss`` rematerializes each
period (encdec: each layer) in the backward, as the JAX package's does,
and differentiates through the LM kernels' backward kernels.
``input_specs`` returns tensors on the ``meta`` device, torch's
allocation-free counterpart of ``jax.ShapeDtypeStruct``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core.layers import pack_linear_params
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import transformer as tf_mod
from repro_torch.models.common import QuantPolicy, pack_projection_tree

Params = Any


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _lm_input_specs(cfg, shape) -> dict:
    b = shape.global_batch
    if shape.kind == "train":
        s = shape.seq_len
        if cfg.input_kind == "embeddings":
            return {"input_embeds": _spec((b, s, cfg.d_model), cfg.dtype),
                    "labels": _spec((b, s), torch.int32)}
        return {"tokens": _spec((b, s), torch.int32),
                "labels": _spec((b, s), torch.int32)}
    if shape.kind == "prefill":
        s = shape.seq_len
        if cfg.input_kind == "embeddings":
            return {"input_embeds": _spec((b, s, cfg.d_model), cfg.dtype)}
        return {"tokens": _spec((b, s), torch.int32)}
    # decode: one new token against a seq_len-deep cache
    return {"tokens": _spec((b, 1), torch.int32)}


def _encdec_input_specs(cfg, shape) -> dict:
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return {"input_embeds": _spec((b, s, cfg.d_model), cfg.dtype),
                "tokens": _spec((b, s), torch.int32),
                "labels": _spec((b, s), torch.int32)}
    if shape.kind == "prefill":
        return {"input_embeds": _spec((b, s, cfg.d_model), cfg.dtype),
                "tokens": _spec((b, s), torch.int32)}
    return {"tokens": _spec((b, 1), torch.int32),
            "memory": _spec((b, s, cfg.d_model), cfg.dtype)}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: Any
    policy: QuantPolicy

    @property
    def encdec(self) -> bool:
        return self.cfg.family == "encdec"

    def _init(self, generator: Optional[torch.Generator], **kw) -> Params:
        init = (encdec_mod.init_encdec_params if self.encdec
                else tf_mod.init_lm_params)
        return init(generator, self.cfg, **kw)

    def init(self, generator: Optional[torch.Generator] = None) -> Params:
        """Random float params on the generator's device. With no
        generator, the abstract tree: every leaf an empty tensor on the
        ``meta`` device with the shape and dtype of its draw, nothing
        drawn or allocated (the JAX package's ``jax.eval_shape(model.init,
        key)``; ``launch.dryrun`` builds full-width cells from it). A
        ``with torch.device("meta")`` block does not do this: the draws
        follow the generator's device."""
        return self._init(generator)

    def init_packed(self, generator: Optional[torch.Generator] = None) -> Params:
        """The params of ``pack(init(generator))``, drawn and packed one
        projection at a time (MoE stacks expert by expert), so the float
        weights of the whole model never exist: one full-width jamba
        period is 177 GB in float32 and 5.5 GB packed. With no generator,
        the abstract packed tree on the ``meta`` device, as :meth:`init`."""
        use_scale = self.policy.use_scale
        return self._init(
            generator,
            finish=lambda p: pack_linear_params(p, use_scale=use_scale))

    def pack(self, params: Params) -> Params:
        """Float params -> 1-bit packed serving params (paper §3.1)."""
        return pack_projection_tree(params, use_scale=self.policy.use_scale)

    def loss(self, params: Params, batch: dict):
        """The training loss of ``batch``: ``{"tokens", "labels"}``, with
        ``"input_embeds"`` for a config fed by embeddings (encdec: the
        encoder's frames beside the decoder's tokens)."""
        if self.encdec:
            return encdec_mod.encdec_loss(params, batch, self.cfg, self.policy)
        return tf_mod.lm_loss(params, batch, self.cfg, self.policy)

    def prefill(self, params: Params, state: dict, batch: dict):
        cfg, policy = self.cfg, self.policy
        if self.encdec:
            memory = encdec_mod.encode(params, batch["input_embeds"], cfg, policy)
            logits, state = encdec_mod.decode(params, batch["tokens"], memory,
                                              cfg, policy, state=state)
            return logits[:, -1, :cfg.vocab_size], dict(state, memory=memory)
        return tf_mod.prefill(params, cfg, policy, state=state,
                              tokens=batch.get("tokens"),
                              input_embeds=batch.get("input_embeds"))

    def decode_step(self, params: Params, state: dict, batch: dict):
        cfg, policy = self.cfg, self.policy
        if self.encdec:
            memory = state.get("memory", batch.get("memory"))
            st = {"kv": state["kv"], "index": state["index"]}
            logits, st = encdec_mod.decode(params, batch["tokens"], memory, cfg,
                                           policy, state=st)
            if "memory" in state:
                st["memory"] = memory
            return logits[:, -1, :cfg.vocab_size], st
        return tf_mod.decode_step(params, cfg, policy, state=state,
                                  tokens=batch["tokens"])

    def init_state(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   device=None) -> dict:
        init = encdec_mod.init_state if self.encdec else tf_mod.init_state
        return init(self.cfg, batch, max_len, dtype=dtype, device=device)

    def input_specs(self, shape) -> dict:
        """Meta-device stand-ins for every input of a ``ShapeConfig`` cell
        (tokens and labels int32, embeddings in ``cfg.dtype``)."""
        specs = _encdec_input_specs if self.encdec else _lm_input_specs
        return specs(self.cfg, shape)


def build_model(cfg, policy: QuantPolicy) -> Model:
    return Model(cfg=cfg, policy=policy)
