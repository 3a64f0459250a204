"""xLSTM blocks: chunkwise-parallel mLSTM and recurrent sLSTM, as
``repro.models.xlstm``.

mLSTM is linear attention with a matrix memory ``C [dk, dv]`` and
exponential input gating, every exponential stabilized by a carried
``m``. With no state in (the training forward) a sequence runs through
``kernels.ops.mlstm_chunked``: the CUDA kernel for CUDA tensors, its
plain twin on the CPU. With a state (prefill) the chunks run here as a
loop of the chunkwise form carrying ``(C, n, m)``; a decode step
(``S == 1``) is one step of the recurrence.

sLSTM has scalar memory and a true recurrence through ``R h_{t-1}``: a
Python loop over time with the input-side projections hoisted out (the
JAX package's ``lax.scan``).

Projections (q/k/v/up/down and the gates from the input) are ``*_proj``
and binarizable; the recurrent ``R`` and the norms stay real.

Over a mesh's model axis the training forward of each block runs on each
rank's heads (:func:`_mlstm_tp`, :func:`_slstm_tp`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed import tensor_parallel as tp
from repro_torch.kernels import ops as kops
from repro_torch.models.common import (Finish, Params, QuantPolicy, as_drawn,
                                       init_device, init_proj, proj, randn,
                                       rmsnorm, rmsnorm_tp)
from repro_torch.roofline import op_cost

# The stabilizer's start: exp(m - anything finite) is 0.
NEG = -1e30

# --------------------------------- mLSTM -------------------------------------


def init_mlstm(generator: torch.Generator, cfg, *,
               finish: Finish = as_drawn) -> Params:
    d = cfg.d_model
    di = 2 * d
    h = cfg.num_heads
    return {
        "up_proj": init_proj(generator, d, 2 * di, finish=finish),
        "q_proj": init_proj(generator, di, di, finish=finish),
        "k_proj": init_proj(generator, di, di, finish=finish),
        "v_proj": init_proj(generator, di, di, finish=finish),
        # input and forget gate pre-activations
        "if_proj": init_proj(generator, di, 2 * h, bias=True, finish=finish),
        "down_proj": init_proj(generator, di, d, finish=finish),
        "gn_scale": torch.ones((di,), device=init_device(generator)),
    }


def _mlstm_chunk(carry, q, k, v, logi, logf):
    """One chunk of the stabilized mLSTM recurrence.

    carry: C ``[B, H, dk, dv]``, n ``[B, H, dk]``, m ``[B, H]``; q, k, v
    ``[B, L, H, dk|dv]``, logi, logf ``[B, L, H]``, float32. Returns
    (new carry, y ``[B, L, H, dv]``)."""
    C, n, m = carry
    L = q.shape[1]
    b_cum = torch.cumsum(logf, dim=1)               # [B, L, H] inclusive
    g = logi - b_cum
    big_m = torch.cummax(g, dim=1).values           # running max_{j<=t} g_j
    m_loc = torch.maximum(big_m, m[:, None])        # [B, L, H]
    inter_scale = torch.exp(m[:, None] - m_loc)     # <= 1
    # S[t, j] = exp(g_j - m_loc_t), j <= t; index order [B, t, j, H]
    w_intra = torch.exp(g[:, None, :, :] - m_loc[:, :, None, :])
    lmask = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    w_intra = torch.where(lmask[None, :, :, None], w_intra, 0.0)

    qk = torch.einsum("bthd,bjhd->btjh", q, k)
    num_intra = torch.einsum("btjh,btjh,bjhv->bthv", qk, w_intra, v)
    den_intra = torch.einsum("btjh,btjh->bth", qk, w_intra)
    num_inter = torch.einsum("bthd,bhdv->bthv", q, C) * inter_scale[..., None]
    den_inter = torch.einsum("bthd,bhd->bth", q, n) * inter_scale
    y = (num_intra + num_inter) / torch.clamp(
        (den_intra + den_inter).abs(), min=1.0)[..., None]

    # advance the carry to the chunk's end: m' = b_L + max(M_L, m)
    m_loc_l = torch.maximum(big_m[:, -1], m)
    m_new = b_cum[:, -1] + m_loc_l
    wk = torch.exp(g - m_loc_l[:, None])            # per-key weight
    decay = torch.exp(m - m_loc_l)                  # [B, H]
    C_new = decay[..., None, None] * C + torch.einsum(
        "bjhd,bjh,bjhv->bhdv", k, wk, v)
    n_new = decay[..., None] * n + torch.einsum("bjhd,bjh->bhd", k, wk)
    return (C_new, n_new, m_new), y


def mlstm_cell(q, k, v, logi, logf, state: Optional[dict], *, chunk: int = 256):
    """q, k, v ``[B, S, H, dh]``; logi, logf ``[B, S, H]`` float32. Returns
    (y ``[B, S, H, dh]`` float32, new state ``{"C", "n", "m"}``)."""
    b, s, h, dh = q.shape
    q = q * dh ** -0.5
    if state is None:
        C = torch.zeros((b, h, dh, dh), device=q.device)
        n = torch.zeros((b, h, dh), device=q.device)
        m = torch.full((b, h), NEG, device=q.device)
    else:
        C, n, m = state["C"], state["n"], state["m"]

    if s == 1:  # decode: one step of the recurrence
        li, lf = logi[:, 0], logf[:, 0]
        q0, k0, v0 = q[:, 0], k[:, 0], v[:, 0]
        m_new = torch.maximum(lf + m, li)
        i_s = torch.exp(li - m_new)
        f_s = torch.exp(lf + m - m_new)
        # k v^T in the activations' dtype, then float32 (JAX's promotion)
        C = f_s[..., None, None] * C + i_s[..., None, None] * torch.einsum(
            "bhd,bhv->bhdv", k0, v0)
        n = f_s[..., None] * n + i_s[..., None] * k0
        num = torch.einsum("bhd,bhdv->bhv", q0.float(), C)
        den = torch.einsum("bhd,bhd->bh", q0.float(), n)
        y = (num / torch.clamp(den.abs(), min=1.0)[..., None])[:, None]
        return y, {"C": C, "n": n, "m": m_new}

    c = min(chunk, s)
    if s % c:
        raise ValueError(f"mLSTM: sequence {s} is not a multiple of the chunk {c}")

    if state is None:
        # the chunkwise kernel on [B*H, S, dh], from a zero state
        def heads(t):
            return t.transpose(1, 2).reshape(b * h, s, *t.shape[3:]).float().contiguous()

        y, Ck, nk, mk = kops.mlstm_chunked(
            heads(q), heads(k), heads(v), heads(logi), heads(logf), chunk=c)
        y = y.reshape(b, h, s, dh).transpose(1, 2)
        return y, {"C": Ck.reshape(b, h, dh, dh), "n": nk.reshape(b, h, dh),
                   "m": mk.reshape(b, h)}

    qf, kf, vf = q.float(), k.float(), v.float()
    carry, ys, chunks = (C, n, m), [], op_cost.trips(range(0, s, c))
    for c0 in chunks:
        sl = slice(c0, c0 + c)
        carry, y = _mlstm_chunk(carry, qf[:, sl], kf[:, sl], vf[:, sl],
                                logi[:, sl], logf[:, sl])
        ys.append(y)
    C, n, m = carry
    return chunks.cat(ys, dim=1), {"C": C, "n": n, "m": m}


def mlstm_block(params: Params, x: torch.Tensor, cfg, policy: QuantPolicy, *,
                state: Optional[dict] = None,
                ) -> tuple[torch.Tensor, Optional[dict]]:
    """Over the model ranks (a ``tensor_parallel.Ranked`` ``x``, no state)
    see :func:`_mlstm_tp`."""
    if isinstance(x, tp.Ranked):
        if state is not None:
            raise NotImplementedError("the tensor-parallel mLSTM trains: no state")
        return _mlstm_tp(params, x, cfg, policy), None
    b, s, d = x.shape
    h = cfg.num_heads
    di = 2 * d
    dh = di // h
    xm, z = proj(params["up_proj"], x, policy).chunk(2, dim=-1)
    q = proj(params["q_proj"], xm, policy).reshape(b, s, h, dh)
    k = proj(params["k_proj"], xm, policy).reshape(b, s, h, dh)
    v = proj(params["v_proj"], xm, policy).reshape(b, s, h, dh)
    gates = proj(params["if_proj"], xm, policy).float().reshape(b, s, 2, h)
    logi = gates[:, :, 0]
    logf = F.logsigmoid(gates[:, :, 1])

    y, new_state = mlstm_cell(q, k, v, logi, logf, state)
    y = y.reshape(b, s, di).to(x.dtype)
    # the group norm runs over the whole width di, one scale a channel
    y = rmsnorm({"scale": params["gn_scale"]}, y)
    y = y * F.silu(z)
    # the training forward (no state in) emits no state
    if state is None:
        new_state = None
    return proj(params["down_proj"], y, policy), new_state


def _mlstm_tp(params: tp.RankedTree, x: tp.Ranked, cfg, policy: QuantPolicy) -> tp.Ranked:
    """:func:`mlstm_block` with no state over the ``m`` model ranks, the
    residual stream ``x`` whole on each:

    * ``up_proj`` is column-parallel; its output, split contiguously over
      the ranks (at m = 2 rank 0 holds all of ``xm``, rank 1 all of ``z``),
      is all-gathered (site ``"gather up_proj"``): each rank keeps the whole
      ``xm`` and its channels of ``z``;
    * ``q``, ``k``, ``v`` are column-parallel: where ``m`` divides the heads,
      rank ``r`` holds heads ``[r H/m, (r+1) H/m)``; otherwise they are
      all-gathered and every rank runs every head, as
      ``attention._attention_tp`` does;
    * ``if_proj`` (out ``2H``: every head's i, then every head's f) is
      all-gathered where split (site ``"gather if_proj"``) and each rank
      takes its heads' i and f;
    * the cell runs on the rank's heads (``kernels.ops.mlstm_chunked`` and
      its backward kernel);
    * the group norm runs over the whole width (``common.rmsnorm_tp``: one
      float32 all-reduce of the partial sums of squares), the gate on the
      rank's channels of ``z``, and ``down_proj`` is row-parallel."""
    b, s = x.parts[0].shape[:2]
    h, m = cfg.num_heads, x.ranks
    dh = 2 * cfg.d_model // h
    whole = x.spec[:-1] + (None,)
    g = proj(params["up_proj"], x, policy).laid_out(whole, site="gather up_proj")
    xm = tp.piece(g, 0, 2, split=False)
    q, k, v = (proj(params[name], xm, policy) for name in ("q_proj", "k_proj", "v_proj"))
    local = h % m == 0 and all(t.spec[-1] == tp.MODEL for t in (q, k, v))
    if not local:
        q, k, v = (t.laid_out(whole, site="gather heads") for t in (q, k, v))
    hl = h // m if local else h
    gates = proj(params["if_proj"], xm, policy).laid_out(whole, site="gather if_proj")
    ys = []
    for r, qr, kr, vr, gr in zip(q.indices, q.parts, k.parts, v.parts, gates.parts):
        first = r * hl if local else 0
        gr = gr.float().reshape(b, s, 2, h)[..., first:first + hl]
        y, _ = mlstm_cell(qr.reshape(b, s, hl, dh), kr.reshape(b, s, hl, dh),
                          vr.reshape(b, s, hl, dh), gr[:, :, 0],
                          F.logsigmoid(gr[:, :, 1]), None)
        ys.append(y.reshape(b, s, hl * dh).to(qr.dtype))
    y = rmsnorm_tp(params["gn_scale"], tp.Ranked(ys, q.spec))
    y = tp.each(lambda yr, zr: yr * F.silu(zr), y, tp.piece(g, 1, 2, split=local))
    return proj(params["down_proj"], y, policy)


def init_mlstm_state(cfg, batch: int, *, layers: int, device=None) -> dict:
    h = cfg.num_heads
    dh = 2 * cfg.d_model // h
    return {
        "C": torch.zeros((layers, batch, h, dh, dh), device=device),
        "n": torch.zeros((layers, batch, h, dh), device=device),
        "m": torch.full((layers, batch, h), NEG, device=device),
    }


# --------------------------------- sLSTM -------------------------------------


def init_slstm(generator: torch.Generator, cfg, *,
               finish: Finish = as_drawn) -> Params:
    d = cfg.d_model
    h = cfg.num_heads
    dh = d // h
    dff = int(d * 4 / 3 / 64) * 64 * 2  # gated FFN, projection factor 4/3
    return {
        # input-side projections of the 4 gates (the binarizable bulk)
        "gates_proj": init_proj(generator, d, 4 * d, bias=True, finish=finish),
        # recurrent block-diagonal weights per gate and head (stay real)
        "R": randn(generator, (4, h, dh, dh), dh ** -0.5),
        "up_proj": init_proj(generator, d, dff, finish=finish),
        "down_proj": init_proj(generator, dff // 2, d, finish=finish),
        "gn_scale": torch.ones((d,), device=init_device(generator)),
    }


def _slstm_step(carry, wx, r_heads, h_heads: int, dh: int):
    """One time step: carry (h, c, n, m) ``[B, d]`` each, ``wx [B, 4d]``
    the step's input projections, ``r_heads [H, dh, 4 dh]`` the recurrent
    weights per head (``R [4, H, dh, dh]`` laid out once per sequence, so
    the step's product saves no copy of them for the backward). Returns
    the new carry."""
    hprev, c, n, m = carry
    b = hprev.shape[0]
    hh = hprev.reshape(b, h_heads, dh).transpose(0, 1)            # [H, B, dh]
    rec = torch.bmm(hh, r_heads).reshape(h_heads, b, 4, dh)
    rec = rec.permute(1, 2, 0, 3).reshape(b, 4, h_heads * dh)
    pre = wx.reshape(b, 4, -1) + rec
    zi, ii, fi, oi = pre.unbind(1)
    logi = ii
    logf = F.logsigmoid(fi)
    m_new = torch.maximum(logf + m, logi)
    i_s = torch.exp(logi - m_new)
    f_s = torch.exp(logf + m - m_new)
    c_new = f_s * c + i_s * torch.tanh(zi)
    n_new = f_s * n + i_s
    h_new = torch.sigmoid(oi) * c_new / torch.clamp(n_new.abs(), min=1.0)
    return h_new, c_new, n_new, m_new


def _slstm_loop(wx: torch.Tensor, R: torch.Tensor, carry):
    """The recurrence over time: ``wx [B, S, 4 w]`` the input projections
    (gate-major), ``R [4, H, dh, dh]`` the recurrent weights of the ``H``
    heads of ``w`` channels, carry ``(h, c, n, m)`` ``[B, w]`` each.
    Returns (``h`` of every step ``[B, S, w]`` float32, the last carry)."""
    _, h, dh, _ = R.shape
    r_heads = R.permute(1, 2, 0, 3).reshape(h, dh, 4 * dh)
    ys, steps = [], op_cost.trips(range(wx.shape[1]))
    for t in steps:
        carry = _slstm_step(carry, wx[:, t], r_heads, h, dh)
        ys.append(carry[0])
    return steps.stack(ys, dim=1), carry


def _zero_carry(b: int, w: int, device) -> tuple:
    zeros = torch.zeros((b, w), device=device)
    return zeros, zeros, zeros, torch.full((b, w), NEG, device=device)


def slstm_block(params: Params, x: torch.Tensor, cfg, policy: QuantPolicy, *,
                state: Optional[dict] = None,
                ) -> tuple[torch.Tensor, Optional[dict]]:
    """Over the model ranks (a ``tensor_parallel.Ranked`` ``x``, no state)
    see :func:`_slstm_tp`."""
    if isinstance(x, tp.Ranked):
        if state is not None:
            raise NotImplementedError("the tensor-parallel sLSTM trains: no state")
        return _slstm_tp(params, x, cfg, policy), None
    b, s, d = x.shape
    wx = proj(params["gates_proj"], x, policy).float()   # [B, S, 4d]
    if state is None:
        carry = _zero_carry(b, d, x.device)
    else:
        carry = (state["h"], state["c"], state["n"], state["m"])
    y, carry = _slstm_loop(wx, params["R"], carry)
    y = rmsnorm({"scale": params["gn_scale"]}, y.to(x.dtype))   # [B, S, d]

    a, g = proj(params["up_proj"], y, policy).chunk(2, dim=-1)
    y = proj(params["down_proj"], a * F.silu(g), policy)
    new_state = None
    if state is not None:
        hT, cT, nT, mT = carry
        new_state = {"h": hT, "c": cT, "n": nT, "m": mT}
    return y, new_state


def _slstm_tp(params: tp.RankedTree, x: tp.Ranked, cfg, policy: QuantPolicy) -> tp.Ranked:
    """:func:`slstm_block` with no state over the ``m`` model ranks, the
    residual stream ``x`` whole on each. Where ``m`` divides the heads,
    rank ``r`` runs the recurrence of heads ``[r H/m, (r+1) H/m)``, its
    ``d / m`` channels (otherwise every rank runs every head):

    * ``gates_proj`` (out ``4d``: gates z, i, f, o, each over every
      channel) is column-parallel, its contiguous split cutting the gates
      apart; it is all-gathered (site ``"gather gates_proj"``) and each rank
      takes its channels of each gate;
    * the loop over time carries ``[B, d/m]``, with the rank's heads of the
      replicated ``R``;
    * its output is all-gathered (site ``"gather slstm"``): ``up_proj``,
      column-parallel, takes its input whole, so the group norm runs on
      every rank's whole copy, as the single device's does (the gather
      costs the same bytes before the norm as after it, and no all-reduce
      of partial sums is needed);
    * ``up_proj``'s output (halves a and g) is all-gathered (site
      ``"gather up_proj"``): each rank takes its channels of a and g;
    * ``down_proj`` is row-parallel over ``dff / 2``.

    The loop is the host-bound loop of ROADMAP A7a: ranks sharing a card
    run it in turn."""
    b, s = x.parts[0].shape[:2]
    d, h, m = cfg.d_model, cfg.num_heads, x.ranks
    local = h % m == 0
    w = d // m if local else d
    whole = x.spec[:-1] + (None,)
    wx = proj(params["gates_proj"], x, policy).laid_out(whole, site="gather gates_proj")
    rec = params["R"].rank_slices(1) if local else params["R"].parts
    ys = []
    for r, wr, rr, xr in zip(x.indices, wx.parts, rec, x.parts):
        wr = wr.float()
        if local:
            wr = wr.reshape(b, s, 4, d)[..., r * w:(r + 1) * w].reshape(b, s, 4 * w)
        y, _ = _slstm_loop(wr, rr, _zero_carry(b, w, wr.device))
        ys.append(y.to(xr.dtype))
    y = tp.Ranked(ys, x.spec[:-1] + (tp.MODEL if local else None,))
    y = rmsnorm_tp(params["gn_scale"], y.laid_out(whole, site="gather slstm"))
    u = proj(params["up_proj"], y, policy).laid_out(whole, site="gather up_proj")
    split = params["down_proj"]["w"].split(-1)
    return proj(params["down_proj"], tp.each(
        lambda a, g: a * F.silu(g), tp.piece(u, 0, 2, split=split),
        tp.piece(u, 1, 2, split=split)), policy)


def init_slstm_state(cfg, batch: int, *, layers: int, device=None) -> dict:
    d = cfg.d_model
    shape = (layers, batch, d)
    return {"h": torch.zeros(shape, device=device),
            "c": torch.zeros(shape, device=device),
            "n": torch.zeros(shape, device=device),
            "m": torch.full(shape, NEG, device=device)}
