"""FFN blocks: dense (SwiGLU / GeLU) and mixture-of-experts, as
``repro.models.ffn``.

MoE is GShard-style top-k with a per-row capacity: router -> top-k ->
rank of each (token, slot) pair within its expert by a stable sort ->
dispatch into ``[B, E, C, D]`` -> a batched GEMM over experts against
the stacked expert weights ``[E, ...]`` -> weighted combine. Pairs over
capacity are dropped (the residual carries them). Every expert and
dense matmul is a ``*_proj``, so a PACKED policy runs it on 1-bit
weights.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch.core import bitops
from repro_torch.core.binarize import QuantMode, binarize_weights
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models.common import (Finish, Params, QuantPolicy, init_proj,
                                       as_drawn, proj, randn, stack_trees)
from repro_torch.roofline import op_cost

# --------------------------------- dense ------------------------------------


def init_dense_ffn(generator: torch.Generator, d_model: int, d_ff: int,
                   act: str, *, finish: Finish = as_drawn) -> Params:
    p = {"up_proj": init_proj(generator, d_model, d_ff, finish=finish),
         "down_proj": init_proj(generator, d_ff, d_model, finish=finish)}
    if act == "swiglu":
        p["gate_proj"] = init_proj(generator, d_model, d_ff, finish=finish)
    return p


def dense_ffn(params: Params, x: torch.Tensor, policy: QuantPolicy,
              act: str) -> torch.Tensor:
    """The dense FFN. Over the model ranks (a ``tensor_parallel.Ranked``
    ``x``): ``up_proj`` / ``gate_proj`` column-parallel, the activation on
    each rank's slice of ``d_ff``, ``down_proj`` row-parallel, its partial
    sums all-reduced."""
    if isinstance(x, tp.Ranked):
        up = proj(params["up_proj"], x, policy)
        if act == "swiglu":
            return proj(params["down_proj"], tp.each(
                lambda g, u: F.silu(g) * u, proj(params["gate_proj"], x, policy),
                up), policy)
        return proj(params["down_proj"], tp.each(
            lambda u: F.gelu(u, approximate="tanh"), up), policy)
    up = proj(params["up_proj"], x, policy)
    if act == "swiglu":
        h = F.silu(proj(params["gate_proj"], x, policy)) * up
    else:
        h = F.gelu(up, approximate="tanh")   # jax.nn.gelu's default
    return proj(params["down_proj"], h, policy)


# ---------------------------------- MoE -------------------------------------


def init_moe(generator: torch.Generator, cfg, *, finish: Finish = as_drawn) -> Params:
    """Router ``[E, D]`` (real, never packed) and the stacked expert
    weights ``up/gate [E, F, D]``, ``down [E, D, F]``, drawn and finished
    expert by expert, so a packing ``finish`` never holds a float stack."""
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff

    def experts(d_out: int, d_in: int, std: float) -> Params:
        if generator is None:  # the abstract tree: one stacked meta draw
            return finish({"w": randn(None, (e, d_out, d_in), std)})
        return stack_trees([finish({"w": randn(generator, (d_out, d_in), std)})
                            for _ in range(e)])

    return {
        "router": {"w": randn(generator, (e, d), d ** -0.5)},
        "up_proj": experts(f, d, d ** -0.5),
        "gate_proj": experts(f, d, d ** -0.5),
        "down_proj": experts(d, f, f ** -0.5),
    }


# The collectors of ``balance_terms`` now open, innermost last.
_BALANCE: list = []


@contextlib.contextmanager
def balance_terms():
    """Collect the router terms ``(me, ce)`` of every MoE layer that runs
    in the block, in call order: ``me`` the mean router probability of
    each expert over the layer's tokens (it carries the gradient), ``ce``
    the mean count of slots routed to it. The data-parallel step
    (``train.step.make_dp_train_step``) averages them over its shards to
    form the whole batch's balance loss (:func:`balance_loss`)."""
    terms: list = []
    _BALANCE.append(terms)
    try:
        yield terms
    finally:
        _BALANCE.remove(terms)


def balance_loss(me: torch.Tensor, ce: torch.Tensor) -> torch.Tensor:
    """The Switch/GShard load-balancing loss ``E * sum_e me_e ce_e``."""
    return me.shape[-1] * (me * ce).sum()


def _capacity(cfg, num_tokens: int) -> int:
    c = int(cfg.capacity_factor * num_tokens * cfg.experts_per_token
            / cfg.num_experts)
    return max(8, -(-c // 8) * 8)


def _expert_matmul(w: Params, x: torch.Tensor, policy: QuantPolicy) -> torch.Tensor:
    """Batched-over-experts contraction. x: ``[B, E, C, K]``; ``w["w"]``
    or packed ``w["w_packed"]`` ``[E, M, K(/32)]``. Returns ``[B, E, C,
    M]`` in ``x``'s dtype, summed in float32.

    Packed weights unpack and multiply expert by expert: the same
    per-expert products as the JAX package's one unpack of the whole
    ``[E, M, K]`` stack, with the transient bounded to one expert (0.8 GB
    in float32 for a ``[24576, 8192]`` jamba expert, where the whole
    stack would be 12.9 GB and its unpack's int32 temporaries twice
    that)."""
    k = x.shape[-1]
    if policy.packed and "w_packed" in w:
        ys, experts = [], op_cost.trips(range(w["w_packed"].shape[0]))
        for e in experts:
            wv = bitops.unpack_bits(w["w_packed"][e], axis=-1)[:, :k]
            y = torch.matmul(x[:, e].float(), wv.T)          # [B, C, M]
            if "alpha" in w:
                y = y * w["alpha"][e]
            ys.append(y.to(x.dtype))
        return experts.stack(ys, dim=1)
    wv = w["w"]
    alpha = None
    if policy.enabled and policy.mode == QuantMode.FAKE_QUANT:
        wv, alpha = binarize_weights(wv, scale_axis=-1 if policy.use_scale else None)
    y = torch.einsum("beck,emk->becm", x.float(), wv.to(x.dtype).float())
    if alpha is not None:
        y = y * alpha[..., 0][None, :, None, :]
    return y.to(x.dtype)


def moe_ffn(params: Params, x: torch.Tensor, cfg, policy: QuantPolicy,
            act: str = "swiglu") -> tuple[torch.Tensor, torch.Tensor]:
    """x: ``[B, S, D]`` -> (out ``[B, S, D]``, aux loss scalar).

    Capacity is per row (a sequence is one GShard group). A pair's rank
    within its expert is its position in a stable sort by expert id less
    the expert's first position (``searchsorted``); pairs ranked past
    the capacity go to the trash slot ``E*C`` and come back as zeros.
    """
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    cap = _capacity(cfg, s)
    p = s * k
    dev = x.device

    logits = torch.einsum("bsd,ed->bse", x.float(), params["router"]["w"])
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, k, dim=-1)     # [B, S, k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)

    # load-balancing auxiliary loss (Switch/GShard)
    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(expert_idx, e).float().sum(2).mean(dim=(0, 1))
    aux = balance_loss(me, ce)
    if _BALANCE:
        _BALANCE[-1].append((me, ce))

    flat_e = expert_idx.reshape(b, p)
    sort_idx = torch.argsort(flat_e, dim=1, stable=True)
    sorted_e = torch.gather(flat_e, 1, sort_idx)
    starts = torch.searchsorted(
        sorted_e, torch.arange(e, device=dev).expand(b, e).contiguous(),
        side="left")                                          # [B, E]
    rank_sorted = (torch.arange(p, device=dev)[None, :]
                   - torch.gather(starts, 1, sorted_e))
    pos_in_e = torch.zeros((b, p), dtype=torch.int64, device=dev).scatter_(
        1, sort_idx, rank_sorted)
    keep = pos_in_e < cap
    slot = torch.where(keep, flat_e * cap + pos_in_e, e * cap)  # [B, P]

    # dispatch (row-local): pairs -> [B, E, C, D]
    rows = torch.arange(b, device=dev)[:, None]
    token_of_pair = torch.arange(s, device=dev).repeat_interleave(k)
    buf = torch.zeros((b, e * cap + 1, d), dtype=x.dtype, device=dev)
    buf[rows, slot] = x[:, token_of_pair]
    xe = buf[:, :e * cap].reshape(b, e, cap, d)

    up = _expert_matmul(params["up_proj"], xe, policy)
    if act == "swiglu":
        h = F.silu(_expert_matmul(params["gate_proj"], xe, policy)) * up
    else:
        h = F.gelu(up, approximate="tanh")
    ye = _expert_matmul(params["down_proj"], h, policy)      # [B, E, C, D]

    # combine (row-local): gather each pair's output, weight, sum over k
    ye_flat = torch.cat([ye.reshape(b, e * cap, d),
                         torch.zeros((b, 1, d), dtype=ye.dtype, device=dev)], 1)
    pair_out = torch.gather(ye_flat, 1, slot[..., None].expand(b, p, d))
    gates = (gate_vals.reshape(b, p) * keep).to(pair_out.dtype)
    out = (pair_out * gates[..., None]).reshape(b, s, k, d).sum(2)
    return out, aux
