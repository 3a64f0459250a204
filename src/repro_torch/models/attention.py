"""GQA attention with RoPE, a KV cache and a sliding window,
quantization-aware, as ``repro.models.attention``.

The four projections (``q_proj/k_proj/v_proj/o_proj``) go through
:func:`repro_torch.models.common.proj`, so a PACKED policy runs them on
1-bit weights. The KV cache is ``[B, S, Hkv, Dh]`` per layer (stacked
``[L, B, S, Hkv, Dh]`` by the model). Scores and softmax are float32;
the products of ``q``/``k`` and ``probs``/``v`` are summed in float32
and rounded to the activations' dtype, as the JAX package's
``preferred_element_type`` einsums. Long causal self-attention with no
cache and no window (the training forward) runs through
``kernels.ops.flash_attention``: the kernel on the card, its plain twin
on the CPU, where the JAX package takes this branch on the TPU only and
the chunked path elsewhere. Every other long input takes the chunked
path: the encoder-decoder's non-causal encoder self-attention and its
``cross_attention`` too, as in the JAX package. Over a mesh's model axis
self- and cross-attention run each rank's heads (:func:`_heads_tp`).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.distributed import tensor_parallel as tp
from repro_torch.kernels import ops as kops
from repro_torch.models.common import (Finish, Params, QuantPolicy, apply_rope,
                                       init_proj, as_drawn, proj)
from repro_torch.roofline import op_cost

# Above this many score elements per (q, kv) pair, the chunked online-
# softmax path runs, so the [Sq, Skv] score matrix never exists whole.
_DENSE_SCORE_LIMIT = 2048 * 2048

# int8 KV cache: fixed-scale symmetric quantization (RoPE'd keys and
# values are O(1)).
_KV_INT8_SCALE = 24.0


def init_attention(generator: torch.Generator, cfg, *,
                   finish: Finish = as_drawn) -> Params:
    d, bias = cfg.d_model, cfg.qkv_bias
    return {
        "q_proj": init_proj(generator, d, cfg.q_dim, bias=bias, finish=finish),
        "k_proj": init_proj(generator, d, cfg.kv_dim, bias=bias, finish=finish),
        "v_proj": init_proj(generator, d, cfg.kv_dim, bias=bias, finish=finish),
        "o_proj": init_proj(generator, cfg.q_dim, d, finish=finish),
    }


def _repeat_kv(x: torch.Tensor, groups: int) -> torch.Tensor:
    """``[B, S, Hkv, Dh] -> [B, S, Hkv*groups, Dh]`` (GQA head expansion),
    for the flash branch; the other paths use grouped einsums."""
    if groups == 1:
        return x
    b, s, h, dh = x.shape
    return x[:, :, :, None, :].expand(b, s, h, groups, dh).reshape(
        b, s, h * groups, dh)


def _cache_quantize(x: torch.Tensor, cache_dtype: torch.dtype) -> torch.Tensor:
    if cache_dtype == torch.int8:
        return torch.clamp(torch.round(x.float() * _KV_INT8_SCALE),
                           -127, 127).to(torch.int8)
    return x.to(cache_dtype)


def _cache_dequantize(x: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    if x.dtype == torch.int8:
        return (x.to(out_dtype) * (1.0 / _KV_INT8_SCALE)).to(out_dtype)
    return x.to(out_dtype)


def _mask_for(q_pos, kv_pos, *, causal, sliding_window, kv_valid):
    mask = torch.ones((q_pos.shape[0], kv_pos.shape[0]), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask &= kv_pos[None, :] <= q_pos[:, None]
    if sliding_window:
        mask &= kv_pos[None, :] > q_pos[:, None] - sliding_window
    if kv_valid is not None:
        mask &= kv_valid[None, :]
    return mask


def _scores(q5: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """``[B, q, Hkv, G, Dh] x [B, k, Hkv, Dh] -> [B, Hkv, G, q, k]`` float32."""
    return torch.einsum("bqhgd,bkhd->bhgqk", q5.float(), k.float()) * scale


def _attend_chunked(
    q, k, v, *, groups, causal, q_positions, kv_positions, kv_valid,
    sliding_window, q_chunk: int = 512, kv_chunk: int = 1024,
) -> torch.Tensor:
    """Online-softmax GQA attention: a loop over query chunks, an inner
    loop over KV chunks carrying (acc, row max, row sum). The live score
    tensor is ``[B, Hkv, G, q_chunk, kv_chunk]``."""
    b, sq, h, dh = q.shape
    hkv = h // groups
    skv = k.shape[1]
    qc, kc = min(q_chunk, sq), min(kv_chunk, skv)
    if sq % qc or skv % kc:
        raise ValueError(f"chunked attention needs Sq % {qc} == 0 and "
                         f"Skv % {kc} == 0, got Sq={sq}, Skv={skv}")
    scale = dh ** -0.5
    if kv_valid is None:
        kv_valid = torch.ones((skv,), dtype=torch.bool, device=q.device)
    outs, q_chunks = [], op_cost.trips(range(0, sq, qc))
    for q0 in q_chunks:
        q5 = q[:, q0:q0 + qc].reshape(b, qc, hkv, groups, dh)
        qpos = q_positions[q0:q0 + qc]
        acc = torch.zeros((b, hkv, groups, qc, dh), device=q.device)
        mx = torch.full((b, hkv, groups, qc), -torch.inf, device=q.device)
        den = torch.zeros((b, hkv, groups, qc), device=q.device)
        for k0 in op_cost.trips(range(0, skv, kc)):
            kj, vj = k[:, k0:k0 + kc], v[:, k0:k0 + kc]
            s = _scores(q5, kj, scale)
            msk = _mask_for(qpos, kv_positions[k0:k0 + kc], causal=causal,
                            sliding_window=sliding_window,
                            kv_valid=kv_valid[k0:k0 + kc])
            s = torch.where(msk[None, None, None], s, -1e30)
            mx_new = torch.maximum(mx, s.amax(-1))
            corr = torch.exp(mx - mx_new)
            p = torch.exp(s - mx_new[..., None])
            den = den * corr + p.sum(-1)
            pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(q.dtype).float(),
                              vj.float()).to(q.dtype)
            acc = acc * corr[..., None] + pv.float()
            mx = mx_new
        out = acc / torch.clamp(den, min=1e-30)[..., None]
        # [B, Hkv, G, qc, Dh] -> [B, qc, H, Dh]
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(b, qc, h, dh).to(q.dtype))
    return q_chunks.cat(outs, dim=1)


def _attend(
    q: torch.Tensor,              # [B, Sq, H, Dh]
    k: torch.Tensor,              # [B, Skv, Hkv, Dh]  (kv-head width)
    v: torch.Tensor,              # [B, Skv, Hkv, Dh]
    *,
    groups: int = 1,              # H / Hkv
    causal: bool,
    q_positions: torch.Tensor,    # [Sq] absolute positions of the queries
    kv_positions: torch.Tensor,   # [Skv]
    kv_valid: Optional[torch.Tensor] = None,   # [Skv] bool (cache fill)
    sliding_window: int = 0,
) -> torch.Tensor:
    b, sq, h, dh = q.shape
    if sq * k.shape[1] > _DENSE_SCORE_LIMIT:
        if (causal and not sliding_window and kv_valid is None
                and sq == k.shape[1]):
            # flash attention on [B*H, S, Dh], the GQA heads repeated
            def heads(t):
                return t.transpose(1, 2).reshape(b * h, sq, dh).contiguous()

            out = kops.flash_attention(heads(q), heads(_repeat_kv(k, groups)),
                                       heads(_repeat_kv(v, groups)), causal=True)
            return out.reshape(b, h, sq, dh).transpose(1, 2)
        return _attend_chunked(
            q, k, v, groups=groups, causal=causal, q_positions=q_positions,
            kv_positions=kv_positions, kv_valid=kv_valid,
            sliding_window=sliding_window)
    # dense path: grouped einsums, the GQA repeat never materialized
    q5 = q.reshape(b, sq, h // groups, groups, dh)
    scores = _scores(q5, k, dh ** -0.5)
    mask = _mask_for(q_positions, kv_positions, causal=causal,
                     sliding_window=sliding_window, kv_valid=kv_valid)
    scores = torch.where(mask[None, None, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.float(), v.float())
    return out.to(q.dtype).reshape(b, sq, h, dh)


def attention(
    params: Params,
    x: torch.Tensor,                    # [B, S, D]
    cfg,
    policy: QuantPolicy,
    *,
    positions: torch.Tensor,            # [S] absolute positions
    cache: Optional[dict] = None,       # {"k","v": [B, Smax, Hkv, Dh], "index": int}
    causal: bool = True,
) -> tuple[torch.Tensor, Optional[dict]]:
    """Returns (output ``[B, S, D]``, updated cache). The cache is not
    written in place: the updated ``k``/``v`` are new tensors. Over the
    model ranks (a ``tensor_parallel.Ranked`` ``x``, no cache) see
    :func:`_attention_tp`."""
    if isinstance(x, tp.Ranked):
        if cache is not None:
            raise NotImplementedError("tensor-parallel attention trains: no cache")
        return _attention_tp(params, x, cfg, policy, positions=positions,
                             causal=causal), None
    b, s, _ = x.shape
    q = proj(params["q_proj"], x, policy).reshape(b, s, cfg.num_heads, cfg.head_dim)
    k = proj(params["k_proj"], x, policy).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = proj(params["v_proj"], x, policy).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)

    q = apply_rope(q, positions[None, :], cfg.rope_theta)
    k = apply_rope(k, positions[None, :], cfg.rope_theta)

    new_cache = None
    if cache is not None:
        idx = int(cache["index"])
        ck, cv = cache["k"].clone(), cache["v"].clone()
        ck[:, idx:idx + s] = _cache_quantize(k, ck.dtype)
        cv[:, idx:idx + s] = _cache_quantize(v, cv.dtype)
        new_cache = {"k": ck, "v": cv, "index": idx + s}
        kv_positions = torch.arange(ck.shape[1], device=x.device)
        kv_valid = kv_positions < idx + s
        k_full = _cache_dequantize(ck, q.dtype)
        v_full = _cache_dequantize(cv, q.dtype)
    else:
        kv_positions = positions
        kv_valid = None
        k_full, v_full = k, v

    out = _attend(
        q, k_full, v_full,
        groups=cfg.num_heads // cfg.num_kv_heads,
        causal=causal,
        q_positions=positions,
        kv_positions=kv_positions,
        kv_valid=kv_valid,
        sliding_window=cfg.sliding_window,
    )
    return proj(params["o_proj"], out.reshape(b, s, cfg.q_dim), policy), new_cache


def _heads_tp(q: tp.Ranked, k: tp.Ranked, v: tp.Ranked, cfg):
    """The column-parallel q, k, v of attention over the ``m`` model ranks
    laid out by heads: where ``m`` divides both ``num_heads`` and
    ``num_kv_heads`` and the rule table splits each projection's out
    width, rank ``r`` holds q heads ``[rH/m, (r+1)H/m)`` and kv heads
    ``[rHkv/m, (r+1)Hkv/m)``, the GQA map ``h // groups`` with no head
    across ranks. Otherwise (a head cut mid-way) they are all-gathered and
    every rank attends every head. Returns (q, k, v, q heads a rank, kv
    heads a rank, the output's spec)."""
    m = q.ranks
    local = (cfg.num_heads % m == 0 and cfg.num_kv_heads % m == 0
             and all(t.spec[-1] == tp.MODEL for t in (q, k, v)))
    if not local:
        q, k, v = (t.laid_out(t.spec[:-1] + (None,), site="gather heads")
                   for t in (q, k, v))
    h = cfg.num_heads // m if local else cfg.num_heads
    hkv = cfg.num_kv_heads // m if local else cfg.num_kv_heads
    return q, k, v, h, hkv, q.spec


def _attention_tp(params, x: tp.Ranked, cfg, policy: QuantPolicy, *,
                  positions: tp.Ranked, causal: bool) -> tp.Ranked:
    """Self-attention over the model ranks: the heads laid out by
    :func:`_heads_tp`, each rank attending its heads, then ``o_proj``
    row-parallel (each rank takes its slice of a whole output)."""
    b, s = x.parts[0].shape[:2]
    dh = cfg.head_dim
    q, k, v, h, hkv, spec = _heads_tp(
        *(proj(params[name], x, policy) for name in ("q_proj", "k_proj", "v_proj")),
        cfg)

    def attend(qr, kr, vr, pos):
        qr = apply_rope(qr.reshape(b, s, h, dh), pos[None, :], cfg.rope_theta)
        kr = apply_rope(kr.reshape(b, s, hkv, dh), pos[None, :], cfg.rope_theta)
        out = _attend(qr, kr, vr.reshape(b, s, hkv, dh), groups=h // hkv,
                      causal=causal, q_positions=pos, kv_positions=pos,
                      sliding_window=cfg.sliding_window)
        return out.reshape(b, s, h * dh)

    return proj(params["o_proj"], tp.each(attend, q, k, v, positions, spec=spec),
                policy)


def cross_attention(
    params: Params,
    x: torch.Tensor,                    # [B, Sq, D] decoder states
    memory: torch.Tensor,               # [B, Skv, D] encoder output
    cfg,
    policy: QuantPolicy,
) -> torch.Tensor:
    """Encoder-decoder cross-attention (the seamless decoder): queries
    from ``x``, keys and values from ``memory``, no RoPE, no mask. Over
    the model ranks (``tensor_parallel.Ranked`` ``x`` and ``memory``, each
    whole on every rank) see :func:`_cross_attention_tp`."""
    if isinstance(x, tp.Ranked):
        return _cross_attention_tp(params, x, memory, cfg, policy)
    b, sq, _ = x.shape
    skv = memory.shape[1]
    q = proj(params["q_proj"], x, policy).reshape(b, sq, cfg.num_heads, cfg.head_dim)
    k = proj(params["k_proj"], memory, policy).reshape(b, skv, cfg.num_kv_heads,
                                                       cfg.head_dim)
    v = proj(params["v_proj"], memory, policy).reshape(b, skv, cfg.num_kv_heads,
                                                       cfg.head_dim)
    out = _attend(
        q, k, v,
        groups=cfg.num_heads // cfg.num_kv_heads,
        causal=False,
        q_positions=torch.arange(sq, device=x.device),
        kv_positions=torch.arange(skv, device=x.device),
    )
    return proj(params["o_proj"], out.reshape(b, sq, cfg.q_dim), policy)


def _cross_attention_tp(params, x: tp.Ranked, memory: tp.Ranked, cfg,
                        policy: QuantPolicy) -> tp.Ranked:
    """:func:`cross_attention` over the model ranks: ``q`` column-parallel
    from the decoder's stream ``x``, ``k`` and ``v`` column-parallel from
    the encoder's output ``memory`` (both whole on every rank), the heads
    laid out by :func:`_heads_tp` (local, or all-gathered where the rule
    table cuts a head: the smoke config's 2 kv heads at m = 4), each rank
    attending its heads with no RoPE and no mask, ``o_proj`` row-parallel."""
    b, sq = x.parts[0].shape[:2]
    skv, dh = memory.parts[0].shape[1], cfg.head_dim
    q, k, v, h, hkv, spec = _heads_tp(proj(params["q_proj"], x, policy),
                                      proj(params["k_proj"], memory, policy),
                                      proj(params["v_proj"], memory, policy), cfg)

    def attend(qr, kr, vr):
        out = _attend(qr.reshape(b, sq, h, dh), kr.reshape(b, skv, hkv, dh),
                      vr.reshape(b, skv, hkv, dh), groups=h // hkv, causal=False,
                      q_positions=torch.arange(sq, device=qr.device),
                      kv_positions=torch.arange(skv, device=qr.device))
        return out.reshape(b, sq, h * dh)

    return proj(params["o_proj"], tp.each(attend, q, k, v, spec=spec), policy)


def init_cache(cfg, batch: int, max_len: int, *, layers: Optional[int] = None,
               dtype=torch.bfloat16, device=None) -> dict:
    """Stacked per-layer KV cache; ``index`` is the write cursor."""
    layers = cfg.num_layers if layers is None else layers
    shape = (layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "index": 0}
