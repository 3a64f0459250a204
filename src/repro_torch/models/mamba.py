"""Mamba (S6 selective SSM) block, the non-attention layer of jamba, as
``repro.models.mamba``.

The prefill runs the selective scan chunk by chunk (``chunk`` steps,
default 256), carrying the state ``h [B, d_inner, d_state]`` from one
chunk to the next; each chunk is one ``kernels.ops.ssm_scan_chunk``
call: the CUDA kernel for CUDA tensors, its plain twin on the CPU. A
decode step (``S == 1``) is one step of the recurrence in plain torch.

Projections (``in_proj/x_proj/dt_proj/out_proj``) are binarizable; the
SSM dynamics (A_log, D, the conv) stay real.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models.common import (Finish, Params, QuantPolicy, init_proj,
                                       as_drawn, proj, randn)


def _dt_rank(cfg) -> int:
    return -(-cfg.d_model // 16)


def init_mamba(generator: torch.Generator, cfg, *, finish: Finish = as_drawn) -> Params:
    d, di, ds = cfg.d_model, cfg.d_inner, cfg.d_state
    r = _dt_rank(cfg)
    dev = generator.device
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


def mamba(params: Params, x: torch.Tensor, cfg, policy: QuantPolicy, *,
          state: Optional[dict] = None, chunk: int = 256
          ) -> tuple[torch.Tensor, Optional[dict]]:
    """x: ``[B, S, D]`` -> (y ``[B, S, D]``, new streaming state).

    ``state = {"h": [B, di, ds], "conv": [B, K-1, di]}`` for serving.
    ``S`` must be at most ``chunk`` or a multiple of it.
    """
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
    # softplus as jax.nn.softplus: log(exp(x) + 1) without a threshold
    dt_lin = proj(params["dt_proj"], dt_in.to(x.dtype), policy).float()
    dt = torch.logaddexp(dt_lin, torch.zeros_like(dt_lin))     # [B, S, di]
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
        c = min(chunk, s)
        if s % c:
            raise ValueError(f"mamba prefill needs S <= {chunk} or a multiple "
                             f"of it, got S={s}")
        # Each chunk is a view of the whole sequence (batch stride S*di),
        # read in place by the kernel; h_last carries into the next call.
        h_last, ys = h0.contiguous(), []
        for t0 in range(0, s, c):
            sl = slice(t0, t0 + c)
            h_last, y = _selective_scan_chunk(
                h_last, (dt[:, sl], xh32[:, sl], bmat[:, sl], cmat[:, sl], a))
            ys.append(y)
        y = torch.cat(ys, dim=1)

    y = y + xh.float() * params["D"]
    y = y.to(x.dtype) * F.silu(z)
    out = proj(params["out_proj"], y, policy)

    new_state = {"h": h_last, "conv": new_conv} if state is not None else None
    return out, new_state


def init_mamba_state(cfg, batch: int, *, layers: int, device=None) -> dict:
    return {
        "h": torch.zeros((layers, batch, cfg.d_inner, cfg.d_state),
                         device=device),
        "conv": torch.zeros((layers, batch, cfg.conv_width - 1, cfg.d_inner),
                            device=device),
    }
