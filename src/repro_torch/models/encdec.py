"""Encoder-decoder transformer (the seamless-m4t backbone), as
``repro.models.encdec``.

The speech frontend is a stub: the encoder is fed precomputed frame
embeddings ``[B, S_enc, D]``. The decoder is a causal stack with
cross-attention into the encoder's output (``memory``); its
self-attention KV cache has the decoder-only models' layout
(``{"kv": {"k", "v": [L, B, Smax, Hkv, Dh]}, "index"}``). LayerNorm, not
RMS, as in the original architecture. Every projection is a ``*_proj``,
so a PACKED policy runs it on 1-bit weights.

The param tree is the JAX package's: ``encoder`` and ``decoder``, each
with ``layers`` (leaves with a leading ``[L]`` axis) and
``final_norm``, then ``embed`` and ``lm_head``, so
``repro_torch.convert.params_from_numpy`` carries it unchanged. The
stacks are Python loops over layers where the JAX package scans; with
``remat`` each layer runs under ``torch.utils.checkpoint``, as
``jax.checkpoint(body)`` does there. Decode recomputes the
cross-attention keys and values from ``memory`` at every step, as the
JAX package does.

The decoder's causal self-attention at long S takes the flash kernel
(``attention._attend``); the encoder's self-attention and the
cross-attention are not causal and take the chunked path.

Over a mesh's model axis (``train.step.make_tp_train_step``: params a
``tensor_parallel.RankedTree``, the batch's leaves ``Ranked``) the loss
runs every rank's part of each layer in lockstep: the residual streams
and the norms replicated, attention and cross-attention on each rank's
heads, the FFNs split by the rule table, the embedding and the head
vocab-parallel, each layer's ranks rematerialized together. On a mesh
with several data rows (params a ``tensor_parallel.ShardedTree``) the
embedding, the head and the final norms are gathered over the data axes
once a loss, and each layer's weights inside its rematerialized body.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from repro_torch import tree
from repro_torch.core.bnn import resolve_device
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models import attention as attn_mod
from repro_torch.models import ffn as ffn_mod
from repro_torch.models.common import (Finish, Params, QuantPolicy, as_drawn,
                                       embed, init_device, init_embedding,
                                       init_layernorm, layernorm, randn,
                                       softmax_cross_entropy, stack_trees,
                                       vocab_parallel_cross_entropy)


def _init_enc_layer(generator: torch.Generator, cfg, finish: Finish) -> Params:
    dev = init_device(generator)
    return {
        "norm1": init_layernorm(cfg.d_model, dev),
        "attn": attn_mod.init_attention(generator, cfg, finish=finish),
        "norm2": init_layernorm(cfg.d_model, dev),
        "ffn": ffn_mod.init_dense_ffn(generator, cfg.d_model, cfg.d_ff, cfg.act,
                                      finish=finish),
    }


def _init_dec_layer(generator: torch.Generator, cfg, finish: Finish) -> Params:
    dev = init_device(generator)
    return {
        "norm1": init_layernorm(cfg.d_model, dev),
        "self_attn": attn_mod.init_attention(generator, cfg, finish=finish),
        "norm2": init_layernorm(cfg.d_model, dev),
        "cross_attn": attn_mod.init_attention(generator, cfg, finish=finish),
        "norm3": init_layernorm(cfg.d_model, dev),
        "ffn": ffn_mod.init_dense_ffn(generator, cfg.d_model, cfg.d_ff, cfg.act,
                                      finish=finish),
    }


def init_encdec_params(generator: torch.Generator, cfg, *,
                       finish: Finish = as_drawn) -> Params:
    """Random params on the generator's device, drawn in a fixed order
    (encoder layers, decoder layers, embedding, LM head); ``finish`` is
    applied to each projection dict as it is drawn, as in
    ``transformer.init_lm_params``."""
    dev = init_device(generator)
    enc = [_init_enc_layer(generator, cfg, finish)
           for _ in range(cfg.encoder_layers)]
    dec = [_init_dec_layer(generator, cfg, finish) for _ in range(cfg.num_layers)]
    table = init_embedding(generator, cfg.padded_vocab, cfg.d_model)
    # the LM head stays real-valued: a plain param, not a *_proj
    head = randn(generator, (cfg.padded_vocab, cfg.d_model), cfg.d_model ** -0.5)
    return {
        "encoder": {"layers": stack_trees(enc),
                    "final_norm": init_layernorm(cfg.d_model, dev)},
        "decoder": {"layers": stack_trees(dec),
                    "final_norm": init_layernorm(cfg.d_model, dev)},
        "embed": table,
        "lm_head": {"w": head},
    }


def _each(fn, *args):
    """``fn`` on every model rank where an argument is laid out over the
    ranks (``tensor_parallel.each``), else ``fn(*args)``."""
    if any(isinstance(a, (tp.Ranked, tp.RankedTree)) for a in args):
        return tp.each(fn, *args)
    return fn(*args)


def _positions(s: int, like):
    """``arange(s)`` on ``like``'s device, or one a rank of a ``Ranked``."""
    if isinstance(like, tp.Ranked):
        return tp.Ranked([torch.arange(s, device=d) for d in like.devices], (None,))
    return torch.arange(s, device=like.device)


def _run_layers(body, x, layers, n: int, remat: bool):
    """``x = body(x, layer i)`` for each of the ``n`` stacked layers, each
    under ``torch.utils.checkpoint`` when ``remat`` and grad mode is on.
    Over the model ranks (a ``RankedTree`` of layers) a layer's ranks are
    recomputed together and whole: with early stop the recompute would end
    at the last saved tensor and skip a trailing all-reduce or not, by
    policy (as ``transformer._lm_forward_tp``). A ``ShardedTree`` layer is
    gathered inside the body, so the recompute gathers it again."""
    remat = remat and torch.is_grad_enabled()
    ranked = isinstance(layers, (tp.RankedTree, tp.ShardedTree))

    def run(x, lp):
        return body(x, tp.gathered(lp))

    for i in range(n):
        lp = layers.index(i) if ranked else tree.tree_map(lambda t: t[i], layers)
        if not remat:
            x = run(x, lp)
            continue
        with set_checkpoint_early_stop(False) if ranked else contextlib.nullcontext():
            # the bodies draw no random numbers: no RNG state to stash
            x = checkpoint(run, x, lp, use_reentrant=False, preserve_rng_state=False)
    return x


def encode(params: Params, frames: torch.Tensor, cfg, policy: QuantPolicy, *,
           remat: bool = False) -> torch.Tensor:
    """frames ``[B, S_enc, D]`` (the frontend stub's output) -> memory
    ``[B, S_enc, D]`` in ``cfg.dtype``. Over the model ranks (``RankedTree``
    params, ``Ranked`` frames) each layer's self-attention is
    ``attention._attention_tp`` (not causal) and its FFN ``ffn.dense_ffn``
    over the ranks; the memory comes out whole on every rank."""
    positions = _positions(frames.shape[1], frames)

    def body(x, lp):
        h = _each(layernorm, lp["norm1"], x)
        out, _ = attn_mod.attention(lp["attn"], h, cfg, policy,
                                    positions=positions, causal=False)
        x = _each(torch.add, x, out)
        h = _each(layernorm, lp["norm2"], x)
        return _each(torch.add, x, ffn_mod.dense_ffn(lp["ffn"], h, policy, cfg.act))

    x = _run_layers(body, _each(lambda f: f.to(cfg.dtype), frames),
                    params["encoder"]["layers"], cfg.encoder_layers, remat)
    return _each(layernorm, params["encoder"]["final_norm"], x)


def _dec_layer(x, lp: Params, memory, cfg, policy: QuantPolicy, *, positions,
               cache: Optional[dict]):
    """One decoder block. Returns (x, updated self-attention cache)."""
    h = _each(layernorm, lp["norm1"], x)
    out, new_cache = attn_mod.attention(lp["self_attn"], h, cfg, policy,
                                        positions=positions, cache=cache)
    x = _each(torch.add, x, out)
    h = _each(layernorm, lp["norm2"], x)
    x = _each(torch.add, x, attn_mod.cross_attention(lp["cross_attn"], h, memory,
                                                     cfg, policy))
    h = _each(layernorm, lp["norm3"], x)
    return _each(torch.add, x, ffn_mod.dense_ffn(lp["ffn"], h, policy, cfg.act)), new_cache


def decode(params: Params, tokens: torch.Tensor, memory: torch.Tensor, cfg,
           policy: QuantPolicy, *, state: Optional[dict] = None,
           remat: bool = False) -> tuple[torch.Tensor, Optional[dict]]:
    """tokens ``[B, S]``, memory ``[B, S_enc, D]`` -> (logits ``[B, S, V]``
    float32, new state). The state given is not written. Over the model
    ranks (``RankedTree`` params, ``Ranked`` tokens and memory; no state)
    the embedding is vocab-parallel, the self-attention causal over the
    ranks' heads (the flash kernel at long S), the cross-attention
    ``attention._cross_attention_tp``, and the logits come back ``Ranked``,
    vocab split where the rule table splits the head."""
    s = tokens.shape[1]
    ranked = isinstance(tokens, tp.Ranked)
    if ranked and state is not None:
        raise NotImplementedError("the decoder over the model ranks trains: no state")
    x = embed(params["embed"], tokens, dtype=cfg.dtype)
    index = state["index"] if state is not None else 0
    positions = _positions(s, x) if ranked else index + torch.arange(s, device=x.device)
    layers = params["decoder"]["layers"]

    if state is None:
        def body(x, lp):
            return _dec_layer(x, lp, memory, cfg, policy, positions=positions,
                              cache=None)[0]

        x = _run_layers(body, x, layers, cfg.num_layers, remat)
        new_state = None
    else:
        ks, vs = [], []
        for i in range(cfg.num_layers):
            cache = {"k": state["kv"]["k"][i], "v": state["kv"]["v"][i],
                     "index": index}
            lp = tree.tree_map(lambda t: t[i], layers)
            x, c = _dec_layer(x, lp, memory, cfg, policy, positions=positions,
                              cache=cache)
            ks.append(c["k"])
            vs.append(c["v"])
        new_state = {"kv": {"k": torch.stack(ks), "v": torch.stack(vs)},
                     "index": index + s}

    x = _each(layernorm, params["decoder"]["final_norm"], x)
    head = params["lm_head"]["w"]
    if ranked:
        return tp.each(lambda xr, hr: torch.matmul(xr.float(), hr.float().T), x, head,
                       spec=(None, None, tp.MODEL if head.split(0) else None)), None
    logits = torch.matmul(x.float(), head.float().T)
    return logits, new_state


def init_state(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None) -> dict:
    """The decoder's self-attention KV cache, on ``device`` (CUDA unless
    given)."""
    c = attn_mod.init_cache(cfg, batch, max_len, layers=cfg.num_layers,
                            dtype=dtype, device=resolve_device(device))
    return {"kv": {"k": c["k"], "v": c["v"]}, "index": 0}


def encdec_loss(params, batch: dict, cfg, policy: QuantPolicy, *,
                remat: bool = True):
    """Cross-entropy of the decoder's logits on ``batch["tokens"]``, given
    the encoded ``batch["input_embeds"]``, against ``batch["labels"]``.
    Returns (loss, ``{"loss"}``). Over the model ranks (``RankedTree``
    params, ``Ranked`` batch leaves) the loss is vocab-parallel, on the
    first rank's device. A ``ShardedTree`` is gathered where used (module
    docstring)."""
    params = tp.gathered(params, keep="layers")
    memory = encode(params, batch["input_embeds"], cfg, policy, remat=remat)
    logits, _ = decode(params, batch["tokens"], memory, cfg, policy, remat=remat)
    if isinstance(logits, tp.Ranked):
        loss = vocab_parallel_cross_entropy(logits, batch["labels"], cfg.vocab_size)
    else:
        loss = softmax_cross_entropy(logits[..., :cfg.vocab_size], batch["labels"])
    return loss, {"loss": loss}


def decode_step(params, cfg, policy: QuantPolicy, *, state: dict,
                memory: torch.Tensor, tokens: torch.Tensor):
    """One serving step: tokens ``[B, 1]`` -> (logits ``[B, V]``, state)."""
    logits, state = decode(params, tokens, memory, cfg, policy, state=state)
    return logits[:, -1, :cfg.vocab_size], state
