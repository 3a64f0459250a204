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
Given ``None`` for the generator they draw nothing: every leaf is an
empty tensor on the ``meta`` device, with the shape and dtype the draw
would have (``init_device``), so a full-width tree costs no memory.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core.binarize import QuantMode
from repro_torch.core.layers import BitLinearConfig, bit_linear, pack_linear_params
from repro_torch.distributed import tensor_parallel as tp

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


def init_device(generator) -> torch.device:
    """Where an initializer puts its params: the generator's device, or
    ``meta`` for no generator (shapes and dtypes, nothing drawn)."""
    return torch.device("meta") if generator is None else generator.device


def randn(generator, shape, std: float) -> torch.Tensor:
    """``N(0, std²)`` float32 draws on the generator's device; an empty
    meta tensor of that shape for no generator."""
    if generator is None:
        return torch.empty(shape, device="meta")
    return torch.randn(shape, generator=generator,
                       device=generator.device) * std


def init_proj(generator: torch.Generator, d_in: int, d_out: int, *,
              bias: bool = False, finish: Finish = as_drawn) -> Params:
    p = {"w": randn(generator, (d_out, d_in), d_in ** -0.5)}
    if bias:
        p["b"] = torch.zeros((d_out,), device=init_device(generator))
    return finish(p)


def proj(params: Params, x: torch.Tensor, policy: QuantPolicy) -> torch.Tensor:
    """Quantization-aware ``y = x @ W^T (+ b)``, in ``x``'s dtype and
    row-major (a PACKED ``bit_linear`` returns the transpose of its
    ``[out, N]`` product, whose rows would be ``N`` elements apart).

    Given a ``tensor_parallel.Ranked`` ``x`` and a ``RankedTree`` of the
    projection, each rank runs its part (:func:`_proj_tp`)."""
    if isinstance(x, tp.Ranked):
        return _proj_tp(params, x, policy)
    return bit_linear(params, x, policy.layer_cfg()).to(x.dtype).contiguous()


def _proj_tp(params: tp.RankedTree, x: tp.Ranked, policy: QuantPolicy) -> tp.Ranked:
    """One projection over the model ranks, by its weight's spec:

    * column-parallel (``out`` split): each rank holds whole rows, so its
      alpha is the whole row's; ``x`` is taken whole on every rank
      (gathered if split) and the output is split like ``out``, the bias
      its rank's slice;
    * row-parallel (``in`` split): ``x`` is taken split (sliced on each
      rank if whole); each rank's partial product, with no alpha, is
      all-reduced; XNOR-Net's alpha is ``mean(|w|)`` over the whole row,
      the all-reduced sum of the ranks' partial ``|w|`` sums over the
      whole ``in``, detached; the replicated bias is added once, after;
    * replicated: every rank computes the whole output from a whole ``x``.
    """
    cfg = policy.layer_cfg()
    if cfg.mode == QuantMode.PACKED:
        raise NotImplementedError("tensor-parallel projections train; a PACKED "
                                  "policy serves on one device")
    w = params["w"]
    lead = x.spec[:-1]
    if not w.split(-1):
        x = x.laid_out(lead + (None,), site=f"gather {_site(params)}")
        return tp.each(lambda p, xr: bit_linear(p, xr, cfg).to(xr.dtype).contiguous(),
                       params, x, spec=lead + (tp.MODEL if w.split(-2) else None,))
    x = x.laid_out(lead + (tp.MODEL,))
    bare = dataclasses.replace(cfg, use_scale=False)
    partial = [bit_linear({"w": wr}, xr, bare) for wr, xr in zip(w.parts, x.parts)]
    y = tp.all_reduce(partial, site=_site(params))
    if cfg.mode == QuantMode.FAKE_QUANT and cfg.use_scale:
        n_in = w.parts[0].shape[-1] * w.size   # equal parts, every rank's
        sums = tp.all_reduce([wr.detach().abs().sum(-1) for wr in w.parts],
                             site="alpha")
        y = [yr * (s / n_in).reshape(1, -1).to(yr.dtype) for yr, s in zip(y, sums)]
    if "b" in params:
        y = [yr + b.to(yr.dtype) for yr, b in zip(y, params["b"].parts)]
    return tp.Ranked([yr.to(xr.dtype).contiguous() for yr, xr in zip(y, x.parts)],
                     lead + (None,))


def _site(params: tp.RankedTree) -> str:
    """A projection's name for the collectives' byte counts: its key."""
    return next((k for k in reversed(params.path)
                 if isinstance(k, str) and k.endswith(PROJ_SUFFIX)), "proj")


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


def rmsnorm_tp(scale: tp.RankedTree, x: tp.Ranked, eps: float = 1e-5,
               site: str = "group norm") -> tp.Ranked:
    """:func:`rmsnorm` with ``scale`` over the model ranks, a leaf every
    rank holds whole. With the last dim of ``x`` whole on each rank, each
    rank norms its copy. With it split (a layer's channels or heads over
    the ranks) the norm still runs over the whole width, as the single
    device's does: each rank's float32 partial sum of squares (``[...,
    1]``, not the activations) is all-reduced, divided by the whole width,
    and each rank scales its part by its slice of ``scale`` (Megatron's
    way)."""
    if x.spec[-1] != tp.MODEL:
        return tp.each(lambda sc, xr: rmsnorm({"scale": sc}, xr, eps), scale, x)
    width = x.shape[-1]
    x32 = [xr.float() for xr in x.parts]
    sums = tp.all_reduce([(t * t).sum(-1, keepdim=True) for t in x32], site=site)
    return tp.Ranked([(t * torch.rsqrt(ss / width + eps) * sc).to(xr.dtype)
                      for t, ss, sc, xr in zip(x32, sums, scale.rank_slices(0), x.parts)],
                     x.spec)


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
    """Rows ``ids`` of the table, in ``dtype``. Over the model ranks (a
    ``RankedTree`` table, ``Ranked`` ids) a vocab-split table is
    vocab-parallel: each rank looks up the ids in its slice, zero
    elsewhere, and the parts are all-reduced; a whole table is looked up
    on every rank."""
    if not isinstance(ids, tp.Ranked):
        return p["table"][ids].to(dtype)
    table = p["table"]
    if not table.split(0):
        return tp.each(lambda t, i: t[i].to(dtype), table, ids,
                       spec=ids.spec + (None,))
    parts = []
    for r, t, i in zip(table.indices, table.parts, ids.parts):
        v = t.shape[0]
        local = i.long() - r * v
        hit = (local >= 0) & (local < v)
        rows = t[torch.clamp(local, 0, v - 1)]
        parts.append(torch.where(hit[..., None], rows, 0.0).to(dtype))
    return tp.Ranked(tp.all_reduce(parts, site="embed"), ids.spec + (None,))


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


def vocab_parallel_cross_entropy(logits: tp.Ranked, labels: tp.Ranked,
                                 vocab: int) -> torch.Tensor:
    """:func:`softmax_cross_entropy` of the first ``vocab`` columns of
    logits laid out over the model ranks, on the first rank's device.

    Vocab split over the ranks (rank ``r`` holds columns ``[r V/m, (r+1)
    V/m)`` of the padded vocab): each rank masks its columns past
    ``vocab`` (the padding, in the last ranks' slices), then the row max
    is a max all-reduce (no gradient: the shift), the sum of exps an
    all-reduce, and the label's logit an all-reduce of the one rank that
    holds it. A whole vocab: every rank's loss is the plain one, and the
    first rank's is returned (``tensor_parallel.first_rank``: one process
    a device, each computes the first rank's loss on its own copy)."""
    if logits.spec[-1] != tp.MODEL:
        return softmax_cross_entropy(tp.first_rank(logits.parts)[..., :vocab],
                                     labels.parts[0])
    cols, parts = logits.parts[0].shape[-1], []
    for r, z in zip(logits.indices, logits.parts):
        z = z.float()
        col = torch.arange(r * cols, (r + 1) * cols, device=z.device)
        parts.append(torch.where(col < vocab, z, -torch.inf))
    shift = tp.all_max([z.amax(-1) for z in parts], site="loss max")
    sums = tp.all_reduce([torch.exp(z - s[..., None]).sum(-1)
                          for z, s in zip(parts, shift)], site="loss sum")
    picked = []
    for r, z, lab in zip(logits.indices, parts, labels.parts):
        local = lab.long() - r * cols
        hit = (local >= 0) & (local < cols)
        got = z.gather(-1, torch.clamp(local, 0, cols - 1)[..., None])[..., 0]
        picked.append(torch.where(hit, got, 0.0))
    label_logit = tp.all_reduce(picked, site="loss label")
    nll = (shift[0] + torch.log(tp.first_rank(sums))
           - tp.first_rank(label_logit))
    return nll.mean()
