"""Mamba (S6 selective SSM) block, the non-attention layer of jamba, as
``repro.models.mamba``.

The prefill runs the selective scan chunk by chunk (``chunk`` steps,
default 256), carrying the state ``h [B, d_inner, d_state]`` from one
chunk to the next; each chunk is one ``kernels.ops.ssm_scan_chunk``
call: the CUDA kernel for CUDA tensors, its plain twin on the CPU. A
decode step (``S == 1``) is one step of the recurrence in plain torch.
Over a mesh's model axis the training forward runs on each rank's
channels (:func:`_mamba_tp`).

Projections (``in_proj/x_proj/dt_proj/out_proj``) are binarizable; the
SSM dynamics (A_log, D, the conv) stay real.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed import tensor_parallel as tp
from repro_torch.kernels import ops as kops
from repro_torch.models.common import (Finish, Params, QuantPolicy, as_drawn,
                                       init_device, init_proj, proj, randn)
from repro_torch.roofline import op_cost


def _dt_rank(cfg) -> int:
    return -(-cfg.d_model // 16)


def init_mamba(generator: torch.Generator, cfg, *, finish: Finish = as_drawn) -> Params:
    d, di, ds = cfg.d_model, cfg.d_inner, cfg.d_state
    r = _dt_rank(cfg)
    dev = init_device(generator)
    a = torch.arange(1, ds + 1, dtype=torch.float32, device=dev).expand(di, ds)
    return {
        "in_proj": init_proj(generator, d, 2 * di, finish=finish),
        "conv_w": randn(generator, (cfg.conv_width, di), 0.1),
        "conv_b": torch.zeros((di,), device=dev),
        "x_proj": init_proj(generator, di, r + 2 * ds, finish=finish),
        "dt_proj": init_proj(generator, r, di, bias=True, finish=finish),
        "out_proj": init_proj(generator, di, d, finish=finish),
        "A_log": torch.log(a),
        "D": torch.ones((di,), device=dev),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv. x: ``[B, S, di]``; w: ``[K, di]``.

    Returns (y, new_state), the state being the last K-1 inputs ``[B,
    K-1, di]`` in ``x``'s dtype. The taps sum in the JAX package's order.
    """
    k = w.shape[0]
    if state is None:
        hist = F.pad(x, (0, 0, k - 1, 0))
    else:
        hist = torch.cat([state.to(x.dtype), x], dim=1)
    s = x.shape[1]
    y = sum(hist[:, i:i + s, :] * w[i] for i in range(k)) + b
    return y.to(x.dtype), hist[:, -(k - 1):, :]


def _selective_scan_chunk(carry: torch.Tensor, xs):
    """One chunk of the scan, the JAX package's scan-body signature:
    carry ``h [B, di, ds]``, xs ``(dt, xh, B, C, A)`` -> (h_last, y)."""
    dt, xh, bmat, cmat, a = xs
    y, h_last = kops.ssm_scan_chunk(dt, xh, bmat, cmat, a, carry)
    return h_last, y


def _chunked_scan(dt, xh32, bmat, cmat, a, h0, chunk: int):
    """The prefill's scan, ``chunk`` steps a ``kernels.ops.ssm_scan_chunk``
    call, ``h0`` carried from one chunk to the next: (y ``[B, S, di]``,
    h_last)."""
    s = dt.shape[1]
    c = min(chunk, s)
    if s % c:
        raise ValueError(f"mamba prefill needs S <= {chunk} or a multiple "
                         f"of it, got S={s}")
    # Each chunk is a view of the whole sequence (batch stride S*di),
    # read in place by the kernel; h_last carries into the next call.
    h_last, ys, chunks = h0.contiguous(), [], op_cost.trips(range(0, s, c))
    for t0 in chunks:
        sl = slice(t0, t0 + c)
        h_last, y = _selective_scan_chunk(
            h_last, (dt[:, sl], xh32[:, sl], bmat[:, sl], cmat[:, sl], a))
        ys.append(y)
    return chunks.cat(ys, dim=1), h_last


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: log(exp(x) + 1) without a threshold."""
    return torch.logaddexp(x, torch.zeros_like(x))


def mamba(params: Params, x: torch.Tensor, cfg, policy: QuantPolicy, *,
          state: Optional[dict] = None, chunk: int = 256
          ) -> tuple[torch.Tensor, Optional[dict]]:
    """x: ``[B, S, D]`` -> (y ``[B, S, D]``, new streaming state).

    ``state = {"h": [B, di, ds], "conv": [B, K-1, di]}`` for serving.
    ``S`` must be at most ``chunk`` or a multiple of it. Over the model
    ranks (a ``tensor_parallel.Ranked`` ``x``, no state) see
    :func:`_mamba_tp`.
    """
    if isinstance(x, tp.Ranked):
        if state is not None:
            raise NotImplementedError("tensor-parallel mamba trains: no state")
        return _mamba_tp(params, x, cfg, policy, chunk=chunk), None
    b, s, _ = x.shape
    di, ds = cfg.d_inner, cfg.d_state
    xh, z = proj(params["in_proj"], x, policy).chunk(2, dim=-1)

    conv_state = state["conv"] if state is not None else None
    xh, new_conv = _causal_conv(xh, params["conv_w"], params["conv_b"],
                                conv_state)
    xh = F.silu(xh)

    bcdt = proj(params["x_proj"], xh, policy).float()
    r = _dt_rank(cfg)
    dt_in, bmat, cmat = torch.split(bcdt, [r, ds, ds], dim=-1)
    dt_lin = proj(params["dt_proj"], dt_in.to(x.dtype), policy).float()
    dt = _softplus(dt_lin)                                      # [B, S, di]
    a = -torch.exp(params["A_log"])                             # [di, ds]
    xh32 = xh.float()

    h0 = (state["h"].float() if state is not None
          else torch.zeros((b, di, ds), device=x.device))

    if s == 1:  # decode: one step of the recurrence
        da = torch.exp(dt[:, 0, :, None] * a)
        dbx = (dt[:, 0] * xh32[:, 0])[..., None] * bmat[:, 0, None, :]
        h_last = h0 * da + dbx
        y = (h_last * cmat[:, 0, None, :]).sum(-1)[:, None]
    else:
        y, h_last = _chunked_scan(dt, xh32, bmat, cmat, a, h0, chunk)

    y = y + xh.float() * params["D"]
    y = y.to(x.dtype) * F.silu(z)
    out = proj(params["out_proj"], y, policy)

    new_state = {"h": h_last, "conv": new_conv} if state is not None else None
    return out, new_state


def _mamba_tp(params: tp.RankedTree, x: tp.Ranked, cfg, policy: QuantPolicy, *,
              chunk: int) -> tp.Ranked:
    """:func:`mamba` with no state over the ``m`` model ranks, the residual
    stream ``x`` whole on each, every rank on its ``d_inner / m`` channels
    ``[r di/m, (r+1) di/m)``:

    * ``in_proj`` is column-parallel; its output, split contiguously over
      the ranks (at m = 2 rank 0 holds all of ``xh``, rank 1 all of
      ``z``), is all-gathered (site ``"gather in_proj"``), then each rank
      keeps the whole ``xh`` and its channels of ``z``;
    * the causal conv and the silu run on every channel on every rank, so
      ``x_proj``, column-parallel, takes its whole input with no second
      gather; its output (``dt_in``, ``B``, ``C``) is all-gathered where the
      rule table splits it (site ``"gather x_proj"``) and is whole on
      every rank;
    * ``dt_proj`` is column-parallel (its bias split): each rank's ``dt``;
    * the scan (``kernels.ops.ssm_scan_chunk``, chunk by chunk, and its
      backward kernel) runs on the rank's channels, with its slices of the
      replicated ``A_log`` and ``D``; the silu(z) gate on its channels;
    * ``out_proj`` is row-parallel: one all-reduce.

    The replicated ``conv_w`` and ``conv_b`` get each rank's share of their
    gradient (through its rows of ``x_proj`` and its channels' scan),
    ``A_log`` and ``D`` gradients zero outside the rank's slice: the step
    sums them over the ranks."""
    b = x.parts[0].shape[0]
    ds, r = cfg.d_state, _dt_rank(cfg)
    whole = x.spec[:-1] + (None,)
    split = x.spec[:-1] + (tp.MODEL,)
    g = proj(params["in_proj"], x, policy).laid_out(whole, site="gather in_proj")
    z = tp.piece(g, 1, 2)
    xc = tp.each(lambda t, w, bias: F.silu(_causal_conv(t, w, bias)[0]),
                 tp.piece(g, 0, 2, split=False), params["conv_w"], params["conv_b"])
    bcdt = proj(params["x_proj"], xc, policy).laid_out(whole, site="gather x_proj")
    bcdt = tp.each(torch.Tensor.float, bcdt)
    dt_lin = proj(params["dt_proj"], tp.each(lambda t: t[..., :r].to(x.parts[0].dtype),
                                             bcdt), policy).laid_out(split)
    ys = []
    for dtl, xr, bc, a_log, d, zr in zip(
            dt_lin.parts, tp.piece(xc, 0, 1).parts, bcdt.parts,
            params["A_log"].rank_slices(0), params["D"].rank_slices(0), z.parts):
        _, bmat, cmat = torch.split(bc, [r, ds, ds], dim=-1)
        xh32 = xr.float()
        h0 = torch.zeros((b, xr.shape[-1], ds), device=xr.device)
        y, _ = _chunked_scan(_softplus(dtl.float()), xh32, bmat, cmat,
                             -torch.exp(a_log), h0, chunk)
        y = y + xh32 * d
        ys.append(y.to(xr.dtype) * F.silu(zr))
    return proj(params["out_proj"], tp.Ranked(ys, split), policy)


def init_mamba_state(cfg, batch: int, *, layers: int, device=None) -> dict:
    return {
        "h": torch.zeros((layers, batch, cfg.d_inner, cfg.d_state),
                         device=device),
        "conv": torch.zeros((layers, batch, cfg.conv_width - 1, cfg.d_inner),
                            device=device),
    }
