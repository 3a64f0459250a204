"""Plain-torch twins of the kernels that are not bit operations (those
live in ``repro_torch.core.bitops``). Device-agnostic tensor code: the
CPU path of their ``ops`` wrappers and the oracle each CUDA kernel is
held to on the card."""

from __future__ import annotations

import torch


def ssm_scan_chunk_ref(dt: torch.Tensor, xh: torch.Tensor, bmat: torch.Tensor,
                       cmat: torch.Tensor, a: torch.Tensor,
                       h0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba S6 scan over one chunk as the sequential recurrence (the JAX
    package's test oracle ``ref_scan``), one torch op per rounding:
    ``h_t = h_{t-1} * exp(dt_t * A) + (dt_t * x_t) * B_t``,
    ``y_t = sum_n h_t[:, n] * C_t[n]``.

    dt, xh ``[B, C, di]``; bmat, cmat ``[B, C, ds]``; a ``[di, ds]``; h0
    ``[B, di, ds]``. Returns (y ``[B, C, di]``, h_last ``[B, di, ds]``).
    """
    b, c, di = dt.shape
    h = h0
    ys = []
    for t in range(c):
        da = torch.exp(dt[:, t, :, None] * a)
        dbx = (dt[:, t] * xh[:, t])[..., None] * bmat[:, t, None, :]
        h = h * da + dbx
        ys.append((h * cmat[:, t, None, :]).sum(-1))
    if not ys:
        return dt.new_empty((b, 0, di)), h0.clone()
    return torch.stack(ys, dim=1), h
