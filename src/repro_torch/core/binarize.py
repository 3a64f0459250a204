"""Binarization math: deterministic sign and XNOR-Net scale factors.

``sign(0) := +1``, as in ``repro.core.binarize``. The straight-through
estimator (``ste_sign``) belongs to training and is not ported yet: the
functions here are forward-only.
"""

from __future__ import annotations

import enum
from typing import Optional

import torch


class QuantMode(str, enum.Enum):
    """How a Bit* layer executes.

    FLOAT        — plain matmul on the latent real weights.
    FAKE_QUANT   — ±1 values held in float.
    PACKED       — 1-bit packed int32 weights (inference).
    """

    FLOAT = "float"
    FAKE_QUANT = "fake_quant"
    PACKED = "packed"


def sign(x: torch.Tensor) -> torch.Tensor:
    """±1 with sign(0) := +1, in ``x``'s dtype."""
    return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)


def weight_scale(w: torch.Tensor, axis: int = -1,
                 keepdims: bool = True) -> torch.Tensor:
    """XNOR-Net per-output-channel scale: ``mean(|W|)`` along ``axis``."""
    return w.abs().mean(dim=axis, keepdim=keepdims)


def binarize_weights(
    w: torch.Tensor, *, scale_axis: Optional[int] = None
) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Latent weights -> (±1 weights, optional alpha scale)."""
    wb = sign(w)
    if scale_axis is None:
        return wb, None
    return wb, weight_scale(w, axis=scale_axis)


def binarize_activations(x: torch.Tensor, clip: float = 1.0) -> torch.Tensor:
    """Htanh then sign, the BNN activation binarization."""
    return sign(torch.clamp(x, -clip, clip))
