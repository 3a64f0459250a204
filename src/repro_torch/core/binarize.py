"""Binarization math: deterministic sign, the straight-through estimator
and XNOR-Net scale factors.

``sign(0) := +1``, as in ``repro.core.binarize``. FAKE_QUANT layers
binarize through :func:`ste_sign`: ``Sign(x)`` forward and the hard-tanh
straight-through gradient ``g * (|x| <= 1)`` backward (BNN,
Courbariaux et al. 2016, eq. 4); the XNOR-Net scale carries no gradient
(``stop_gradient`` in the JAX package, ``detach`` here).
"""

from __future__ import annotations

import enum
from typing import Optional

import torch


class QuantMode(str, enum.Enum):
    """How a Bit* layer executes.

    FLOAT        — plain matmul on the latent real weights.
    FAKE_QUANT   — ±1 values held in float, STE gradients.
    PACKED       — 1-bit packed int32 weights (inference).
    """

    FLOAT = "float"
    FAKE_QUANT = "fake_quant"
    PACKED = "packed"


def sign(x: torch.Tensor) -> torch.Tensor:
    """±1 with sign(0) := +1, in ``x``'s dtype. No gradient: training
    paths take :func:`ste_sign`."""
    return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)


class _SteSign(torch.autograd.Function):
    """:func:`sign` forward, the hard-tanh STE backward."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x)
        return sign(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        (x,) = ctx.saved_tensors
        return g * (x.abs() <= 1.0).to(g.dtype)


def ste_sign(x: torch.Tensor) -> torch.Tensor:
    """Sign with sign(0) := +1 and the hard-tanh STE gradient: the
    JAX package's ``ste_sign`` custom VJP."""
    return _SteSign.apply(x)


def weight_scale(w: torch.Tensor, axis: int = -1,
                 keepdims: bool = True) -> torch.Tensor:
    """XNOR-Net per-output-channel scale: ``mean(|W|)`` along ``axis``."""
    return w.abs().mean(dim=axis, keepdim=keepdims)


def binarize_weights(
    w: torch.Tensor, *, scale_axis: Optional[int] = None
) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Latent weights -> (±1 STE weights, optional alpha scale). Alpha is
    detached: no gradient flows through it."""
    wb = ste_sign(w)
    if scale_axis is None:
        return wb, None
    return wb, weight_scale(w, axis=scale_axis).detach()


class _Htanh(torch.autograd.Function):
    """``clamp(x, -clip, clip)`` with ``jnp.clip``'s gradient: 1 inside,
    0 outside, and 1/2 at ``x == ±clip`` (``jnp.clip`` is a max then a
    min, and each splits a tie between its inputs), where
    ``torch.clamp`` passes 1."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, clip: float) -> torch.Tensor:
        ctx.save_for_backward(x)
        ctx.clip = clip
        return torch.clamp(x, -clip, clip)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (x,) = ctx.saved_tensors
        a = x.abs()
        scale = (a < ctx.clip).to(g.dtype) + 0.5 * (a == ctx.clip).to(g.dtype)
        return g * scale, None


def binarize_activations(x: torch.Tensor, clip: float = 1.0) -> torch.Tensor:
    """Htanh then sign, the BNN activation binarization (STE backward).
    The Htanh's gradient at ``x == ±clip`` is the JAX package's 1/2
    (:class:`_Htanh`): a FAKE_QUANT layer re-binarizes its ±1 input, so
    every binary layer's input gradient passes through that tie."""
    return ste_sign(_Htanh.apply(x, clip))
