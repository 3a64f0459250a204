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
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models.common import (Finish, Params, QuantPolicy, as_drawn,
                                       init_device, init_proj, proj, randn,
                                       rmsnorm)
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
    y = rmsnorm({"scale": params["gn_scale"]}, y)   # per-cell group norm
    y = y * F.silu(z)
    # the training forward (no state in) emits no state
    if state is None:
        new_state = None
    return proj(params["down_proj"], y, policy), new_state


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


def slstm_block(params: Params, x: torch.Tensor, cfg, policy: QuantPolicy, *,
                state: Optional[dict] = None,
                ) -> tuple[torch.Tensor, Optional[dict]]:
    b, s, d = x.shape
    h = cfg.num_heads
    dh = d // h
    wx = proj(params["gates_proj"], x, policy).float()   # [B, S, 4d]
    if state is None:
        zeros = torch.zeros((b, d), device=x.device)
        carry = (zeros, zeros, zeros, torch.full((b, d), NEG, device=x.device))
    else:
        carry = (state["h"], state["c"], state["n"], state["m"])
    r_heads = params["R"].permute(1, 2, 0, 3).reshape(h, dh, 4 * dh)
    ys, steps = [], op_cost.trips(range(s))
    for t in steps:
        carry = _slstm_step(carry, wx[:, t], r_heads, h, dh)
        ys.append(carry[0])
    y = steps.stack(ys, dim=1).to(x.dtype)                # [B, S, d]
    y = rmsnorm({"scale": params["gn_scale"]}, y)

    a, g = proj(params["up_proj"], y, policy).chunk(2, dim=-1)
    y = proj(params["down_proj"], a * F.silu(g), policy)
    new_state = None
    if state is not None:
        hT, cT, nT, mT = carry
        new_state = {"h": hT, "c": cT, "n": nT, "m": mT}
    return y, new_state


def init_slstm_state(cfg, batch: int, *, layers: int, device=None) -> dict:
    d = cfg.d_model
    shape = (layers, batch, d)
    return {"h": torch.zeros(shape, device=device),
            "c": torch.zeros(shape, device=device),
            "n": torch.zeros(shape, device=device),
            "m": torch.full(shape, NEG, device=device)}
