"""FFN blocks: dense (SwiGLU / GeLU) and mixture-of-experts, as
``repro.models.ffn``.

MoE is GShard-style top-k with a per-row capacity: router -> top-k ->
rank of each (token, slot) pair within its expert by a stable sort ->
dispatch into ``[B, E, C, D]`` -> a batched GEMM over experts against
the stacked expert weights ``[E, ...]`` -> weighted combine. Pairs over
capacity are dropped (the residual carries them). Every expert and
dense matmul is a ``*_proj``, so a PACKED policy runs it on 1-bit
weights.

Over the model ranks (``tensor_parallel.Ranked`` inputs) the dense FFN is
Megatron's column / row split and the MoE expert-parallel: each rank
routes every pair, runs the experts it holds, and one all-reduce sums
the ranks' outputs.
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


# The collectors of ``routing`` now open, innermost last.
_ROUTES: list = []


@contextlib.contextmanager
def routing():
    """Collect ``(expert_idx [B, S, k], keep [B, S*k])`` of every MoE
    layer that runs in the block, detached, in call order: each (token,
    slot) pair's expert and whether it is within capacity. Over the model
    ranks, one entry a rank, in rank order; remat's recompute adds its
    own after the forward's."""
    routes: list = []
    _ROUTES.append(routes)
    try:
        yield routes
    finally:
        _ROUTES.remove(routes)


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


def _route(w_router: torch.Tensor, x: torch.Tensor, cfg) -> dict:
    """Router -> top-k -> each (token, slot) pair's rank within its expert.

    ``x [B, S, D]``. Returns ``gates [B, S*k]`` (the top-k probabilities
    renormalized), ``expert_idx [B, S, k]``, the router terms ``me``,
    ``ce`` of the balance loss, ``flat_e [B, S*k]``, ``pos`` (the pair's
    position in a stable sort by expert id less the expert's first
    position, ``searchsorted``) and ``keep`` (``pos`` within the per-row
    capacity ``cap``). Every op is deterministic, so the same ``x`` routes
    the same way on every rank and in remat's recompute."""
    b, s, _ = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    cap = _capacity(cfg, s)
    p = s * k
    dev = x.device

    logits = torch.einsum("bsd,ed->bse", x.float(), w_router)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, k, dim=-1)     # [B, S, k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)

    # load-balancing auxiliary loss terms (Switch/GShard)
    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(expert_idx, e).float().sum(2).mean(dim=(0, 1))

    flat_e = expert_idx.reshape(b, p)
    sort_idx = torch.argsort(flat_e, dim=1, stable=True)
    sorted_e = torch.gather(flat_e, 1, sort_idx)
    starts = torch.searchsorted(
        sorted_e, torch.arange(e, device=dev).expand(b, e).contiguous(),
        side="left")                                          # [B, E]
    rank_sorted = (torch.arange(p, device=dev)[None, :]
                   - torch.gather(starts, 1, sorted_e))
    pos = torch.zeros((b, p), dtype=torch.int64, device=dev).scatter_(
        1, sort_idx, rank_sorted)
    return {"gates": gate_vals.reshape(b, p), "expert_idx": expert_idx,
            "me": me, "ce": ce, "flat_e": flat_e, "pos": pos,
            "keep": pos < cap, "cap": cap}


def _experts(params: Params, x: torch.Tensor, route: dict, first: int,
             policy: QuantPolicy, act: str) -> torch.Tensor:
    """The experts ``[first, first + E_l)`` of ``params`` (stacks of
    ``E_l`` experts) on the pairs ``route`` keeps and sends to them, each
    output weighted by its gate and summed over the slots; a pair sent to
    another expert, or over capacity, contributes 0. ``x [B, S, D]`` ->
    ``[B, S, D]``.

    Dispatch and combine are row-local: the kept pairs are scattered into
    ``[B, E_l*C + 1, D]``, every other pair into the trash slot ``E_l*C``
    (written more than once, then discarded), the experts run as a batched
    GEMM over ``[B, E_l, C, D]``, and each pair gathers its slot's
    output."""
    b, s, d = x.shape
    w = params["up_proj"]
    el = (w["w_packed"] if "w_packed" in w else w["w"]).shape[0]
    cap, flat_e, keep = route["cap"], route["flat_e"], route["keep"]
    p = flat_e.shape[1]
    dev = x.device
    mine = keep & (flat_e >= first) & (flat_e < first + el)
    slot = torch.where(mine, (flat_e - first) * cap + route["pos"], el * cap)

    # dispatch (row-local): pairs -> [B, E_l, C, D]
    rows = torch.arange(b, device=dev)[:, None]
    token_of_pair = torch.arange(s, device=dev).repeat_interleave(p // s)
    buf = torch.zeros((b, el * cap + 1, d), dtype=x.dtype, device=dev)
    buf[rows, slot] = x[:, token_of_pair]
    xe = buf[:, :el * cap].reshape(b, el, cap, d)

    up = _expert_matmul(params["up_proj"], xe, policy)
    if act == "swiglu":
        h = F.silu(_expert_matmul(params["gate_proj"], xe, policy)) * up
    else:
        h = F.gelu(up, approximate="tanh")
    ye = _expert_matmul(params["down_proj"], h, policy)      # [B, E_l, C, D]

    # combine (row-local): gather each pair's output, weight, sum over k
    ye_flat = torch.cat([ye.reshape(b, el * cap, d),
                         torch.zeros((b, 1, d), dtype=ye.dtype, device=dev)], 1)
    pair_out = torch.gather(ye_flat, 1, slot[..., None].expand(b, p, d))
    gates = (route["gates"] * mine).to(pair_out.dtype)
    return (pair_out * gates[..., None]).reshape(b, s, p // s, d).sum(2)


def _collect(routes: list) -> None:
    """Hand one MoE layer's routes (one a rank) to the open collectors:
    the first's router terms to :func:`balance_terms`, each one's
    ``(expert_idx, keep)`` to :func:`routing`."""
    if _BALANCE:
        _BALANCE[-1].append((routes[0]["me"], routes[0]["ce"]))
    if _ROUTES:
        _ROUTES[-1].extend((r["expert_idx"].detach(), r["keep"].detach())
                           for r in routes)


def moe_ffn(params: Params, x: torch.Tensor, cfg, policy: QuantPolicy,
            act: str = "swiglu") -> tuple[torch.Tensor, torch.Tensor]:
    """x: ``[B, S, D]`` -> (out ``[B, S, D]``, aux loss scalar).

    Capacity is per row (a sequence is one GShard group). A pair's rank
    within its expert is its position in a stable sort by expert id less
    the expert's first position (``searchsorted``); pairs ranked past
    the capacity go to the trash slot ``E*C`` and come back as zeros.

    Over the model ranks (a ``tensor_parallel.Ranked`` ``x``, whole on
    every rank, and a ``RankedTree`` of params) the experts are parallel:
    :func:`_moe_ffn_tp`.
    """
    if isinstance(x, tp.Ranked):
        return _moe_ffn_tp(params, x, cfg, policy, act)
    route = _route(params["router"]["w"], x, cfg)
    _collect([route])
    return (_experts(params, x, route, 0, policy, act),
            balance_loss(route["me"], route["ce"]))


def _moe_ffn_tp(params: tp.RankedTree, x: tp.Ranked, cfg, policy: QuantPolicy,
                act: str) -> tuple[tp.Ranked, torch.Tensor]:
    """:func:`moe_ffn` over the ``m`` model ranks, the residual stream
    ``x`` whole on each. Every rank routes its copy with its copy of the
    replicated router, so all ranks keep and drop the same pairs as the
    single device does.

    * Experts split over ``model`` (the rule table's ``[E, out, in]``
      rule, ``E`` divisible by ``m``): rank ``r`` holds experts ``[r E/m,
      (r+1) E/m)``, dispatches only the pairs sent to them into its
      ``[B, E/m*C + 1, D]`` buffer and runs its local stacks; a FAKE_QUANT
      alpha is a mean over each expert's whole ``in``, so local. Each
      rank's partial output (0 for pairs of other ranks' experts) is
      summed by one all-reduce, site ``"moe"``.
    * Experts left whole (the guard: ``m`` does not divide ``E``): each
      rank runs the whole MoE on its copy, no collective; the step sums
      the ranks' shares of the expert gradients
      (``train.step._sum_replicated``).

    The balance loss is rank 0's, so it enters the loss once and its
    router gradient reaches rank 0's copy alone (the ranks' router
    gradients are summed)."""
    split = params["up_proj"]["w"].split(0)
    routes = [_route(w, xr, cfg) for w, xr in zip(params["router"]["w"].parts,
                                                  x.parts)]
    _collect(routes)
    outs = []
    for r, pr, xr, route in zip(params.indices, params.parts, x.parts, routes):
        first = r * pr["up_proj"]["w"].shape[0] if split else 0
        outs.append(_experts(pr, xr, route, first, policy, act))
    if split:
        outs = tp.all_reduce(outs, site="moe")
    return (tp.Ranked(outs, x.spec),
            balance_loss(routes[0]["me"], routes[0]["ce"]))
