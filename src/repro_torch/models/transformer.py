"""Decoder-only LM assembly, as ``repro.models.transformer``.

Layer stacks are periodic: each arch repeats a short pattern of (mixer,
ffn) layer kinds (dense: a 1-layer period; jamba: 8 layers, 7 mamba + 1
attention, MoE on every other layer). ``params["layers"]`` is a list over
the period's positions whose leaves carry a leading ``[num_periods]``
axis, the JAX package's layout, so its params carry across unchanged
(``repro_torch.convert``). The forward is a Python loop over periods
where the JAX package scans.

Streaming state (KV cache, SSM state) is stacked per mixer kind with a
leading layer axis; layer ``j`` of a kind in period ``p`` is entry ``p *
per_period + j``. A forward returns new state tensors and never writes
the state it was given.

``lm_loss`` is the training forward: ``lm_forward`` with no state,
where long causal attention takes the flash kernel and the mLSTM the
chunkwise kernel. Not ported: ``remat`` (it comes with the backward)
and ``input_embeds`` (the vlm/audio stubs).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core.bnn import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.common import (Finish, Params, QuantPolicy, embed,
                                       init_embedding, init_layernorm,
                                       init_rmsnorm, as_drawn, layernorm, randn,
                                       rmsnorm, softmax_cross_entropy,
                                       stack_trees)

# ------------------------------ period spec ----------------------------------


@dataclasses.dataclass(frozen=True)
class LayerKind:
    mixer: str        # attn | mamba | mlstm | slstm
    ffn: str          # dense | moe | moe+dense | none


def period_spec(cfg) -> list[LayerKind]:
    if cfg.family == "hybrid":
        return [LayerKind("attn" if cfg.is_attention_layer(i) else "mamba",
                          "moe" if cfg.is_moe_layer(i) else "dense")
                for i in range(cfg.attn_every)]
    if cfg.family == "ssm":
        return [LayerKind("slstm" if cfg.is_slstm_layer(i) else "mlstm", "none")
                for i in range(cfg.slstm_every)]
    ffn = "moe" if cfg.num_experts else "dense"
    if cfg.dense_residual_ff:
        ffn = "moe+dense"
    return [LayerKind("attn", ffn)]


def num_periods(cfg) -> int:
    p = len(period_spec(cfg))
    if cfg.num_layers % p:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers is not a whole "
                         f"number of {p}-layer periods")
    return cfg.num_layers // p


def _norm_fns(cfg):
    if cfg.norm == "layernorm":
        return init_layernorm, layernorm
    return init_rmsnorm, rmsnorm


# ------------------------------ layer init -----------------------------------


def _init_layer(generator: torch.Generator, cfg, kind: LayerKind, *,
                finish: Finish = as_drawn) -> Params:
    init_norm, _ = _norm_fns(cfg)
    dev = generator.device
    p: Params = {"norm1": init_norm(cfg.d_model, dev)}
    if kind.mixer == "attn":
        p["attn"] = attn_mod.init_attention(generator, cfg, finish=finish)
    elif kind.mixer == "mamba":
        p["mamba"] = mamba_mod.init_mamba(generator, cfg, finish=finish)
    elif kind.mixer == "mlstm":
        p["mlstm"] = xlstm_mod.init_mlstm(generator, cfg, finish=finish)
    elif kind.mixer == "slstm":
        p["slstm"] = xlstm_mod.init_slstm(generator, cfg, finish=finish)
    else:
        raise ValueError(kind.mixer)
    if kind.ffn != "none":
        p["norm2"] = init_norm(cfg.d_model, dev)
        if "moe" in kind.ffn:
            p["moe"] = ffn_mod.init_moe(generator, cfg, finish=finish)
        if kind.ffn in ("dense", "moe+dense"):
            width = cfg.dense_residual_ff or cfg.d_ff
            p["ffn"] = ffn_mod.init_dense_ffn(generator, cfg.d_model, width,
                                              cfg.act, finish=finish)
    return p


def init_lm_params(generator: torch.Generator, cfg, *,
                   finish: Finish = as_drawn) -> Params:
    """Random params on the generator's device. ``finish`` is applied to
    each projection dict as soon as it is drawn, before the next draw
    (MoE stacks: expert by expert): with a packing ``finish`` the float
    weights of the whole model never exist at once. The draws do not
    depend on ``finish``, so packing after a float init gives the same
    params."""
    if cfg.input_kind != "tokens":
        raise NotImplementedError(
            f"{cfg.name}: input_kind {cfg.input_kind!r} (vlm/audio stubs) is "
            "not ported yet")
    period = period_spec(cfg)
    init_norm, _ = _norm_fns(cfg)
    params: Params = {"embed": init_embedding(generator, cfg.padded_vocab,
                                              cfg.d_model)}
    if not cfg.tie_embeddings:
        # the LM head stays real-valued: a plain param, not a *_proj
        params["lm_head"] = {"w": randn(generator, (cfg.padded_vocab,
                                                    cfg.d_model),
                                        cfg.d_model ** -0.5)}
    periods = [[_init_layer(generator, cfg, kind, finish=finish)
                for kind in period] for _ in range(num_periods(cfg))]
    params["layers"] = [stack_trees(list(per_pos)) for per_pos in zip(*periods)]
    params["final_norm"] = init_norm(cfg.d_model, generator.device)
    return params


# ------------------------------ streaming state -------------------------------


def _kind_per_period(cfg) -> dict[str, int]:
    out: dict[str, int] = {}
    for k in period_spec(cfg):
        out[k.mixer] = out.get(k.mixer, 0) + 1
    return out


def _kind_counts(cfg) -> dict[str, int]:
    np_ = num_periods(cfg)
    return {k: v * np_ for k, v in _kind_per_period(cfg).items()}


def init_state(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None) -> dict:
    """All streaming state for serving: per-mixer-kind stacked tensors
    (KV cache in ``dtype``), on ``device`` (CUDA unless given)."""
    dev = resolve_device(device)
    counts = _kind_counts(cfg)
    st: dict[str, Any] = {"index": 0}
    if "attn" in counts:
        c = attn_mod.init_cache(cfg, batch, max_len, layers=counts["attn"],
                                dtype=dtype, device=dev)
        st["kv"] = {"k": c["k"], "v": c["v"]}
    if "mamba" in counts:
        st["mamba"] = mamba_mod.init_mamba_state(cfg, batch,
                                                 layers=counts["mamba"],
                                                 device=dev)
    if "mlstm" in counts:
        st["mlstm"] = xlstm_mod.init_mlstm_state(cfg, batch,
                                                 layers=counts["mlstm"],
                                                 device=dev)
    if "slstm" in counts:
        st["slstm"] = xlstm_mod.init_slstm_state(cfg, batch,
                                                 layers=counts["slstm"],
                                                 device=dev)
    return st


# ------------------------------ forward --------------------------------------


def _apply_layer(x, lp: Params, cfg, policy: QuantPolicy, kind: LayerKind, *,
                 positions, layer_state, causal=True):
    """One residual block. Returns (x, new_layer_state, aux_loss)."""
    _, norm = _norm_fns(cfg)
    aux = torch.zeros((), device=x.device)
    h = norm(lp["norm1"], x)
    new_state = layer_state
    if kind.mixer == "attn":
        out, new_state = attn_mod.attention(
            lp["attn"], h, cfg, policy, positions=positions, cache=layer_state,
            causal=causal)
    elif kind.mixer == "mamba":
        out, new_state = mamba_mod.mamba(lp["mamba"], h, cfg, policy,
                                         state=layer_state)
    elif kind.mixer == "mlstm":
        out, new_state = xlstm_mod.mlstm_block(lp["mlstm"], h, cfg, policy,
                                               state=layer_state)
    elif kind.mixer == "slstm":
        out, new_state = xlstm_mod.slstm_block(lp["slstm"], h, cfg, policy,
                                               state=layer_state)
    else:
        raise ValueError(kind.mixer)
    x = x + out

    if kind.ffn != "none":
        h = norm(lp["norm2"], x)
        y = torch.zeros_like(x)
        if "moe" in kind.ffn:
            mo, aux = ffn_mod.moe_ffn(lp["moe"], h, cfg, policy, cfg.act)
            y = y + mo
        if kind.ffn in ("dense", "moe+dense"):
            y = y + ffn_mod.dense_ffn(lp["ffn"], h, policy, cfg.act)
        x = x + y
    return x, new_state, aux


def _index_tree(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return tree[i]


def lm_forward(params: Params, cfg, policy: QuantPolicy, *,
               tokens: torch.Tensor, state: Optional[dict] = None,
               causal: bool = True, logits_last_only: bool = False,
               ) -> tuple[torch.Tensor, Optional[dict], torch.Tensor]:
    """tokens ``[B, S]`` -> (logits ``[B, S, V]`` float32, new state,
    aux loss). ``logits_last_only`` (prefill) keeps the last position."""
    _, norm = _norm_fns(cfg)
    x = embed(params["embed"], tokens, dtype=cfg.dtype)
    s = tokens.shape[1]
    index = state["index"] if state is not None else 0
    positions = index + torch.arange(s, device=x.device)

    period = period_spec(cfg)
    per_period = _kind_per_period(cfg)
    new_states: dict[str, list] = {}
    aux_total = torch.zeros((), device=x.device)
    for p in range(num_periods(cfg)):
        cursor: dict[str, int] = {}
        for i, kind in enumerate(period):
            lstate = None
            key = "kv" if kind.mixer == "attn" else kind.mixer
            if state is not None:
                j = p * per_period[kind.mixer] + cursor.get(kind.mixer, 0)
                cursor[kind.mixer] = cursor.get(kind.mixer, 0) + 1
                lstate = _index_tree(state[key], j)
                if kind.mixer == "attn":
                    lstate = dict(lstate, index=index)
            x, lstate_new, aux = _apply_layer(
                x, _index_tree(params["layers"][i], p), cfg, policy, kind,
                positions=positions, layer_state=lstate, causal=causal)
            aux_total = aux_total + aux
            if lstate_new is not None:
                if kind.mixer == "attn":
                    lstate_new = {"k": lstate_new["k"], "v": lstate_new["v"]}
                new_states.setdefault(key, []).append(lstate_new)
    new_state = None
    if state is not None:
        new_state = {"index": index + s,
                     **{k: stack_trees(v) for k, v in new_states.items()}}

    if logits_last_only:
        x = x[:, -1:]
    x = norm(params["final_norm"], x)
    head = params["embed"]["table"] if cfg.tie_embeddings else params["lm_head"]["w"]
    logits = torch.matmul(x.float(), head.float().T)
    return logits, new_state, aux_total


# ------------------------------ entry points ---------------------------------


def lm_loss(params, batch: dict, cfg, policy: QuantPolicy, *,
            aux_weight: float = 0.01):
    """The training forward: next-token cross-entropy of ``batch["tokens"]``
    against ``batch["labels"]`` (``[B, S]``) over the first
    ``cfg.vocab_size`` logits, plus ``aux_weight`` times the MoE balance
    loss. Returns (total, ``{"loss", "aux"}``)."""
    logits, _, aux = lm_forward(params, cfg, policy, tokens=batch["tokens"])
    loss = softmax_cross_entropy(logits[..., :cfg.vocab_size], batch["labels"])
    return loss + aux_weight * aux, {"loss": loss, "aux": aux}


def prefill(params, cfg, policy: QuantPolicy, *, state: dict, tokens):
    """Fill the state with a prompt; returns (last-token logits, state)."""
    logits, state, _ = lm_forward(params, cfg, policy, tokens=tokens,
                                  state=state, logits_last_only=True)
    return logits[:, -1, :cfg.vocab_size], state


def decode_step(params, cfg, policy: QuantPolicy, *, state: dict,
                tokens: torch.Tensor):
    """One serving step: tokens ``[B, 1]`` -> (logits ``[B, V]``, state)."""
    logits, state, _ = lm_forward(params, cfg, policy, tokens=tokens,
                                  state=state)
    return logits[:, -1, :cfg.vocab_size], state
