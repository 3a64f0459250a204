"""Shared model components: the quantization policy, quantization-aware
projections, norms, RoPE, embeddings and the LM loss, as
``repro.models.common``.

Projection params are dicts ``{"w": [out, in], ("b": [out])}``; after
:func:`pack_projection_tree` they are ``{"w_packed": int32 [out,
in/32], ("alpha", "b")}``, the paper's §3.1 encoding applied to every
matmul of the network. A projection is packed iff its key ends in
``_proj``: embeddings, norms, routers and the LM head stay real.

Initializers draw from a ``torch.Generator`` on the device the params
live on. They take ``finish``, applied to each projection dict as soon
as it is drawn (identity, or packing: see ``transformer.init_lm_params``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core.binarize import QuantMode
from repro_torch.core.layers import BitLinearConfig, bit_linear, pack_linear_params

Params = dict[str, Any]
Finish = Callable[[Params], Params]

PROJ_SUFFIX = "_proj"


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """How the paper's encoding applies to a whole model."""

    enabled: bool = True
    mode: QuantMode = QuantMode.FAKE_QUANT   # train: FAKE_QUANT; serve: PACKED
    binarize_acts: bool = False              # weight-only for LMs
    use_scale: bool = True                   # XNOR-Net alpha
    engine: str = "xla"                      # plain-torch unpack + matmul

    def layer_cfg(self) -> BitLinearConfig:
        return BitLinearConfig(
            mode=self.mode if self.enabled else QuantMode.FLOAT,
            binarize_acts=self.binarize_acts,
            use_scale=self.use_scale,
            engine=self.engine,
        )

    @property
    def packed(self) -> bool:
        return self.enabled and self.mode == QuantMode.PACKED


def as_drawn(params: Params) -> Params:
    """The ``finish`` of a float init: the drawn params as they are."""
    return params


def randn(generator: torch.Generator, shape, std: float) -> torch.Tensor:
    """``N(0, std²)`` float32 draws on the generator's device."""
    return torch.randn(shape, generator=generator,
                       device=generator.device) * std


def init_proj(generator: torch.Generator, d_in: int, d_out: int, *,
              bias: bool = False, finish: Finish = as_drawn) -> Params:
    p = {"w": randn(generator, (d_out, d_in), d_in ** -0.5)}
    if bias:
        p["b"] = torch.zeros((d_out,), device=generator.device)
    return finish(p)


def proj(params: Params, x: torch.Tensor, policy: QuantPolicy) -> torch.Tensor:
    """Quantization-aware ``y = x @ W^T (+ b)``, in ``x``'s dtype and
    row-major (a PACKED ``bit_linear`` returns the transpose of its
    ``[out, N]`` product, whose rows would be ``N`` elements apart)."""
    return bit_linear(params, x, policy.layer_cfg()).to(x.dtype).contiguous()


def pack_projection_tree(params, *, use_scale: bool = True):
    """Replace every ``*_proj`` dict of a float tree with its packed
    params: a float checkpoint becomes a 1-bit serving checkpoint."""
    if isinstance(params, dict):
        return {k: (pack_linear_params(v, use_scale=use_scale)
                    if k.endswith(PROJ_SUFFIX) and isinstance(v, dict)
                    and "w" in v
                    else pack_projection_tree(v, use_scale=use_scale))
                for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(pack_projection_tree(v, use_scale=use_scale)
                            for v in params)
    return params


# ------------------------------- norms --------------------------------------

def init_rmsnorm(d: int, device=None) -> Params:
    return {"scale": torch.ones((d,), device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    inv = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (x32 * inv * p["scale"]).to(x.dtype)


def init_layernorm(d: int, device=None) -> Params:
    return {"scale": torch.ones((d,), device=device),
            "bias": torch.zeros((d,), device=device)}


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


# ------------------------------- RoPE ---------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / theta ** (exps / head_dim)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: ``[..., S, H, Dh]``; positions broadcastable to ``[..., S]``.
    Rotates the two halves of ``Dh`` (not interleaved pairs)."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)
    angles = positions[..., None].float() * freqs          # [..., S, Dh/2]
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


# ----------------------------- embeddings -----------------------------------

def init_embedding(generator: torch.Generator, vocab: int, d: int) -> Params:
    return {"table": randn(generator, (vocab, d), d ** -0.5)}


def embed(p: Params, ids: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    return p["table"][ids].to(dtype)


def stack_trees(trees: list):
    """Stack matching trees (dicts/lists of tensors) leaf by leaf along a
    new leading axis: per-expert or per-period params -> stacked leaves."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_trees([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(stack_trees(list(ts)) for ts in zip(*trees))
    return torch.stack(trees)


# ------------------------------- loss ---------------------------------------

def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """logits ``[..., V]``, integer labels ``[...]`` -> the mean negative
    log-likelihood, float32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, labels.long()[..., None])[..., 0]
    return -ll.mean()
