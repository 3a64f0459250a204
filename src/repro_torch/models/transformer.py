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
chunkwise kernel, each with a backward kernel. With ``remat`` (the
default of ``lm_loss``, as in the JAX package) each period's body runs
under ``torch.utils.checkpoint``: its activations are recomputed in the
backward instead of kept, which changes no number. The JAX package saves
the dot outputs (``dots_with_no_batch_dims_saveable``); here the whole
period is recomputed.

Over a mesh's model axis (``params`` a ``tensor_parallel.RankedTree``,
the inputs ``Ranked``; ``train.step.make_tp_train_step``) the forward
runs every rank's part of each block in lockstep: the residual stream and
the norms replicated on every rank, attention and the dense FFN split by
the rule table (``attention._attention_tp``, ``ffn.dense_ffn``), the
experts over the ranks (``ffn.moe_ffn``), mamba on each rank's channels
(``mamba._mamba_tp``), the mLSTM and the sLSTM on each rank's heads
(``xlstm._mlstm_tp``, ``_slstm_tp``), the embedding and the head
vocab-parallel, a period's ranks rematerialized together. Every family
runs there (the encoder-decoder's is ``models/encdec.py``). On a mesh
with several data rows the params come as a ``tensor_parallel.
ShardedTree``, each leaf in blocks over the data axes: the embedding, the
head and the norms outside the stack are gathered once a forward, and
each period's weights inside its rematerialized body, so the recompute
gathers them again and at most one period's are whole at once.
``constrain_seq`` / ``constrain`` stand where the JAX model has them:
identity with no mesh installed, a layout check under one.

A config fed by embeddings (pixtral-12b's patch-embedding stub) takes
``input_embeds [B, S, D]`` in place of tokens in ``lm_forward``,
``lm_loss`` and ``prefill``, normed by its ``in_norm``; decode still
feeds tokens through ``embed``. The encoder-decoder family is
``models/encdec.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from repro_torch.core.bnn import resolve_device
from repro_torch.distributed import sharding as shard_rules
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models import attention as attn_mod
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.common import (Finish, Params, QuantPolicy, embed,
                                       init_device, init_embedding, init_layernorm,
                                       init_rmsnorm, as_drawn, layernorm, randn,
                                       rmsnorm, softmax_cross_entropy,
                                       stack_trees, vocab_parallel_cross_entropy)

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
    dev = init_device(generator)
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
    period = period_spec(cfg)
    init_norm, _ = _norm_fns(cfg)
    # An embeddings config keeps the table too: decode feeds tokens.
    params: Params = {"embed": init_embedding(generator, cfg.padded_vocab,
                                              cfg.d_model)}
    if cfg.input_kind != "tokens":
        # modality stub: the inputs are precomputed patch/frame embeddings
        params["in_norm"] = init_norm(cfg.d_model, init_device(generator))
    if not cfg.tie_embeddings:
        # the LM head stays real-valued: a plain param, not a *_proj
        params["lm_head"] = {"w": randn(generator, (cfg.padded_vocab,
                                                    cfg.d_model),
                                        cfg.d_model ** -0.5)}
    periods = [[_init_layer(generator, cfg, kind, finish=finish)
                for kind in period] for _ in range(num_periods(cfg))]
    params["layers"] = [stack_trees(list(per_pos)) for per_pos in zip(*periods)]
    params["final_norm"] = init_norm(cfg.d_model, init_device(generator))
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


def _mixer(h, lp: Params, cfg, policy: QuantPolicy, kind: LayerKind, *,
           positions, layer_state, causal):
    """The block's mixer on the normed input ``h``: (output, new layer
    state)."""
    if kind.mixer == "attn":
        return attn_mod.attention(lp["attn"], h, cfg, policy, positions=positions,
                                  cache=layer_state, causal=causal)
    if kind.mixer == "mamba":
        return mamba_mod.mamba(lp["mamba"], h, cfg, policy, state=layer_state)
    if kind.mixer == "mlstm":
        return xlstm_mod.mlstm_block(lp["mlstm"], h, cfg, policy, state=layer_state)
    if kind.mixer == "slstm":
        return xlstm_mod.slstm_block(lp["slstm"], h, cfg, policy, state=layer_state)
    raise ValueError(kind.mixer)


def _apply_layer(x, lp: Params, cfg, policy: QuantPolicy, kind: LayerKind, *,
                 positions, layer_state, causal=True):
    """One residual block. Returns (x, new_layer_state, aux_loss). Over
    the model ranks (a ``tensor_parallel.Ranked`` ``x``) every rank runs
    its part of the mixer (attention, mamba, the mLSTM or the sLSTM) and
    the FFN, the norms on each rank's copy of the residual stream.
    arctic's two branches are all-reduced each (sites ``"moe"`` and
    ``"down_proj"``) and added after, as the single device adds them."""
    _, norm = _norm_fns(cfg)
    if isinstance(x, tp.Ranked):
        h = tp.each(norm, lp["norm1"], x)
        out, _ = _mixer(h, lp, cfg, policy, kind, positions=positions,
                        layer_state=None, causal=causal)
        x = tp.each(torch.add, x, out)
        aux = torch.zeros((), device=x.devices[0])
        if kind.ffn == "none":
            return x, None, aux
        h = tp.each(norm, lp["norm2"], x)
        if "moe" in kind.ffn:
            y, aux = ffn_mod.moe_ffn(lp["moe"], h, cfg, policy, cfg.act)
            if kind.ffn == "moe+dense":
                y = tp.each(torch.add, y,
                            ffn_mod.dense_ffn(lp["ffn"], h, policy, cfg.act))
        else:
            y = ffn_mod.dense_ffn(lp["ffn"], h, policy, cfg.act)
        return tp.each(torch.add, x, y), None, aux
    aux = torch.zeros((), device=x.device)
    h = norm(lp["norm1"], x)
    out, new_state = _mixer(h, lp, cfg, policy, kind, positions=positions,
                            layer_state=layer_state, causal=causal)
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
               tokens: Optional[torch.Tensor] = None,
               input_embeds: Optional[torch.Tensor] = None,
               state: Optional[dict] = None,
               remat: bool = False, causal: bool = True,
               logits_last_only: bool = False,
               ) -> tuple[torch.Tensor, Optional[dict], torch.Tensor]:
    """tokens ``[B, S]`` or ``input_embeds [B, S, D]`` (the vlm stub;
    taken when given) -> (logits ``[B, S, V]`` float32, new state, aux
    loss). ``logits_last_only`` (prefill) keeps the last position.
    ``remat``: with no state and grad mode on, each period runs under
    ``torch.utils.checkpoint`` (recomputed in the backward)."""
    if isinstance(params, (tp.RankedTree, tp.ShardedTree)):
        if state is not None or logits_last_only:
            raise NotImplementedError("the forward over the model ranks trains: "
                                      "no streaming state")
        return _lm_forward_tp(params, cfg, policy, tokens=tokens,
                              input_embeds=input_embeds, remat=remat,
                              causal=causal)
    _, norm = _norm_fns(cfg)
    if input_embeds is not None:
        x = input_embeds.to(cfg.dtype)
        if "in_norm" in params:
            x = norm(params["in_norm"], x)
        s = input_embeds.shape[1]
    else:
        x = embed(params["embed"], tokens, dtype=cfg.dtype)
        s = tokens.shape[1]
    index = state["index"] if state is not None else 0
    positions = index + torch.arange(s, device=x.device)

    period = period_spec(cfg)
    per_period = _kind_per_period(cfg)
    new_states: dict[str, list] = {}
    aux_total = torch.zeros((), device=x.device)
    if remat and state is None and torch.is_grad_enabled():
        def period_body(x, layers):
            x = shard_rules.constrain_seq(x)
            auxes = []
            for kind, lp in zip(period, layers):
                x, _, aux = _apply_layer(x, lp, cfg, policy, kind,
                                         positions=positions, layer_state=None,
                                         causal=causal)
                auxes.append(aux)
            return x, *auxes

        for p in range(num_periods(cfg)):
            layers = [_index_tree(lp, p) for lp in params["layers"]]
            # a period draws no random numbers: no RNG state to stash
            x, *auxes = checkpoint(period_body, x, layers, use_reentrant=False,
                                   preserve_rng_state=False)
            for aux in auxes:
                aux_total = aux_total + aux
        periods = 0
    else:
        periods = num_periods(cfg)
    for p in range(periods):
        x = shard_rules.constrain_seq(x)
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
    logits = shard_rules.constrain(logits, shard_rules.DATA_AXES, None,
                                   shard_rules.MODEL_AXIS)
    return logits, new_state, aux_total


def _lm_forward_tp(params, cfg, policy: QuantPolicy, *,
                   tokens, input_embeds, remat: bool, causal: bool):
    """:func:`lm_forward` with no state over the model ranks of one data
    shard: ``params`` a ``RankedTree`` (or a ``ShardedTree``, gathered
    where used: module docstring), ``tokens`` / ``input_embeds``
    ``Ranked``. Returns vocab-parallel logits (``Ranked``, vocab split
    where the rule table splits the head), no state, and the MoE balance
    loss, once (``ffn._moe_ffn_tp``), on the first rank's device."""
    _, norm = _norm_fns(cfg)
    params = tp.gathered(params, keep="layers")
    if input_embeds is not None:
        x = tp.each(lambda e: e.to(cfg.dtype), input_embeds)
        if "in_norm" in params:
            x = tp.each(norm, params["in_norm"], x)
    else:
        x = embed(params["embed"], tokens, dtype=cfg.dtype)
    positions = tp.Ranked([torch.arange(x.shape[1], device=d) for d in x.devices],
                          (None,))
    period = period_spec(cfg)

    def period_body(x, layers):
        x = shard_rules.constrain_seq(x)
        auxes = []
        for kind, lp in zip(period, layers):
            x, _, aux = _apply_layer(x, tp.gathered(lp), cfg, policy, kind,
                                     positions=positions, layer_state=None,
                                     causal=causal)
            auxes.append(aux)
        return x, *auxes

    aux_total = torch.zeros((), device=x.devices[0])
    for p in range(num_periods(cfg)):
        layers = [lp.index(p) for lp in params["layers"]]
        if remat and torch.is_grad_enabled():
            # every rank's part of the period, recomputed together and
            # whole: with early stop the recompute would end at the last
            # saved tensor and skip a trailing all-reduce or not, by policy
            with set_checkpoint_early_stop(False):
                x, *auxes = checkpoint(period_body, x, layers,
                                       use_reentrant=False,
                                       preserve_rng_state=False)
        else:
            x, *auxes = period_body(x, layers)
        for aux in auxes:
            aux_total = aux_total + aux
    x = tp.each(norm, params["final_norm"], x)
    head = params["embed"]["table"] if cfg.tie_embeddings else params["lm_head"]["w"]
    logits = tp.each(lambda xr, hr: torch.matmul(xr.float(), hr.float().T), x,
                     head, spec=(None, None, tp.MODEL if head.split(0) else None))
    logits = shard_rules.constrain(logits, shard_rules.DATA_AXES, None,
                                   shard_rules.MODEL_AXIS)
    return logits, None, aux_total


# ------------------------------ entry points ---------------------------------


# Weight of the MoE balance loss in the training loss.
AUX_WEIGHT = 0.01


def lm_loss(params, batch: dict, cfg, policy: QuantPolicy, *,
            remat: bool = True, aux_weight: float = AUX_WEIGHT):
    """The training forward: next-token cross-entropy of ``batch["tokens"]``
    (or of ``batch["input_embeds"]`` where given) against
    ``batch["labels"]`` (``[B, S]``) over the first ``cfg.vocab_size``
    logits, plus ``aux_weight`` times the MoE balance loss, each period
    rematerialized in the backward (``remat``). Returns (total, ``{"loss",
    "aux"}``). Over the model ranks (``RankedTree`` params, ``Ranked``
    batch leaves) the loss is vocab-parallel, on the first rank's
    device."""
    logits, _, aux = lm_forward(params, cfg, policy, tokens=batch.get("tokens"),
                                input_embeds=batch.get("input_embeds"),
                                remat=remat)
    if isinstance(logits, tp.Ranked):
        loss = vocab_parallel_cross_entropy(logits, batch["labels"], cfg.vocab_size)
    else:
        loss = softmax_cross_entropy(logits[..., :cfg.vocab_size], batch["labels"])
    return loss + aux_weight * aux, {"loss": loss, "aux": aux}


def prefill(params, cfg, policy: QuantPolicy, *, state: dict, tokens=None,
            input_embeds=None):
    """Fill the state with a prompt (tokens, or ``input_embeds`` where
    given); returns (last-token logits, state)."""
    logits, state, _ = lm_forward(params, cfg, policy, tokens=tokens,
                                  input_embeds=input_embeds, state=state,
                                  logits_last_only=True)
    return logits[:, -1, :cfg.vocab_size], state


def decode_step(params, cfg, policy: QuantPolicy, *, state: dict,
                tokens: torch.Tensor):
    """One serving step: tokens ``[B, 1]`` -> (logits ``[B, V]``, state)."""
    logits, state, _ = lm_forward(params, cfg, policy, tokens=tokens,
                                  state=state)
    return logits[:, -1, :cfg.vocab_size], state
