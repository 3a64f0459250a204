"""Bit layers in PyTorch: the unfused layers of the paper's forward
graph and the fused packed pipeline.

Plain functions on tensors; params are dicts of tensors, with the keys
and layouts of ``repro.core.layers`` so the JAX package's params carry
across (``repro_torch.convert``). Engines:

  * ``engine="xnor"``   — the xnor-popcount CUDA kernels of
    ``repro_torch.kernels`` (their plain twins on CPU tensors),
  * ``engine="unpack"`` — unfused PACKED layers only: the ``unpack_gemm``
    kernel, packed weights against the binarized float activations,
  * ``engine="xla"``    — the plain-torch twins of ``core.bitops``, the
    last rung of the serving fallback ladder (named after the JAX
    engine it mirrors).

:func:`bit_linear` and :func:`bit_conv2d` run one layer in any
``QuantMode`` (FLOAT control group, FAKE_QUANT, PACKED with float
layer boundaries: the paper's Table 2 path). The fused executors keep
packed words between layers, and the megakernel executors
(:func:`stack_chain_layers`, :func:`megakernel_fc_chain`,
:func:`megakernel_conv_stage`) run whole stages of them in one launch
each.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import bitops
from repro_torch.core.binarize import (QuantMode, binarize_activations,
                                       binarize_weights)
from repro_torch.core.im2col import col2im, filters_to_matrix, im2col
from repro_torch.kernels import ops as kops

BN_EPS = 1e-4  # the one BatchNorm eps; core.bnn._batchnorm imports it


@dataclasses.dataclass(frozen=True)
class BitLinearConfig:
    """How :func:`bit_linear` and :func:`bit_conv2d` run. ``engine`` and
    ``conv_impl`` matter in PACKED mode only; ``use_scale`` (the XNOR-Net
    alpha) in FAKE_QUANT mode only (PACKED params carry their ``alpha``).
    The JAX package's ``blocks`` (kernel tiling) is not ported."""

    mode: QuantMode = QuantMode.FAKE_QUANT
    binarize_acts: bool = True          # False => weight-only
    use_scale: bool = False             # XNOR-Net alpha
    engine: str = "xla"                 # "xnor" | "unpack" | "xla"
    conv_impl: str = "im2col"           # "im2col" | "direct" (PACKED convs)
    compute_dtype: torch.dtype = torch.float32


def init_linear(generator: torch.Generator, in_features: int,
                out_features: int, *, bias: bool = True,
                device=None) -> dict:
    std = (2.0 / in_features) ** 0.5
    w = torch.randn((out_features, in_features), generator=generator) * std
    p = {"w": w.to(device)}
    if bias:
        p["b"] = torch.zeros((out_features,), device=device)
    return p


def init_conv(generator: torch.Generator, kh: int, kw: int, c_in: int,
              c_out: int, *, bias: bool = True, device=None) -> dict:
    std = (2.0 / (kh * kw * c_in)) ** 0.5
    w = torch.randn((c_out, kh, kw, c_in), generator=generator) * std
    p = {"w": w.to(device)}
    if bias:
        p["b"] = torch.zeros((c_out,), device=device)
    return p


def _pack_rows_padded(wm: torch.Tensor) -> torch.Tensor:
    """[out, K] real -> [out, ceil(K/32)] words, K padded with -1."""
    pad = -wm.shape[-1] % bitops.PACK_BITS
    if pad:
        wm = torch.nn.functional.pad(wm, (0, pad), value=-1.0)
    return bitops.pack_bits(wm, axis=-1)


def pack_linear_params(params: dict, *, use_scale: bool = False) -> dict:
    """Latent float params -> packed inference params (paper §3.1).

    ``w`` is ``[out, in]``, or stacked ``[..., out, in]`` (MoE experts);
    ``use_scale`` adds the XNOR-Net ``alpha = mean(|w|)`` over the
    unpadded ``in`` axis, one per output row."""
    w = params["w"]
    packed = {"w_packed": _pack_rows_padded(w)}
    if use_scale:
        packed["alpha"] = w.abs().mean(dim=-1)
    if "b" in params:
        packed["b"] = params["b"]
    return packed


def _packed_matmul(wp: torch.Tensor, x2d: torch.Tensor, k_orig: int,
                   cfg: BitLinearConfig) -> torch.Tensor:
    """x2d: ``[B, K_orig]`` real, wp: ``[out, K_pad/32]``. Returns ``[B,
    out]`` in ``cfg.compute_dtype``.

    When K_orig is not a multiple of 32 the packed weights carry
    ``n_pad = K_pad - K_orig`` trailing -1 bits. The xnor engine pads the
    activations with +1 there (each padded position then adds exactly
    -1 to the ±1 dot) and adds ``n_pad`` back; the unpack engines pad
    the binarized activations with 0, which adds nothing.
    """
    k_pad = wp.shape[1] * bitops.PACK_BITS
    n_pad = k_pad - k_orig
    if cfg.engine == "xnor":
        # Paper path: binarize + pack activations, xnor-popcount GEMM.
        xin = torch.clamp(x2d, -1, 1).contiguous()   # pack_rows reads K-contiguous
        if n_pad:
            xin = torch.nn.functional.pad(xin, (0, n_pad), value=1.0)
        xp = kops.pack_rows(xin.T)                        # [K_pad/32, B]
        out = kops.xnor_gemm(wp, xp, k_pad) + n_pad       # [out, B] int32
        return out.T.to(cfg.compute_dtype)
    if cfg.engine not in ("unpack", "xla"):
        raise ValueError(f"packed matmul has no engine {cfg.engine!r}")
    # Binarize FIRST, then zero-pad: padded positions stay exactly 0 so
    # the -1 pad weights add nothing.
    xin = x2d.to(cfg.compute_dtype)
    if cfg.binarize_acts:
        xin = torch.sign(xin) + (xin == 0).to(cfg.compute_dtype)
    if n_pad:
        xin = torch.nn.functional.pad(xin, (0, n_pad))
    if cfg.engine == "unpack":
        y = kops.unpack_gemm(wp, xin.T)
    else:
        y = bitops.packed_matmul_unpack(wp, xin.T,
                                        compute_dtype=cfg.compute_dtype)
    return y.T.to(cfg.compute_dtype)


def _float_matmul(w: torch.Tensor, x: torch.Tensor,
                  cfg: BitLinearConfig) -> torch.Tensor:
    """``x @ w^T`` on latent weights ``[out, K]``: FAKE_QUANT (±1 weights,
    binarized activations unless weight-only) or the FLOAT control
    group. ``cfg.use_scale`` scales FAKE_QUANT by the per-row alpha."""
    if cfg.mode == QuantMode.FAKE_QUANT:
        wq, alpha = binarize_weights(w, scale_axis=-1 if cfg.use_scale else None)
        xq = binarize_activations(x) if cfg.binarize_acts else x
        y = xq @ wq.to(x.dtype).T
        if alpha is not None:
            y = y * alpha.reshape(1, -1).to(y.dtype)
        return y
    return x @ w.to(x.dtype).T


def bit_linear(params: dict, x: torch.Tensor,
               cfg: BitLinearConfig) -> torch.Tensor:
    """``y = x @ W^T (+ b)`` under the configured quantization mode.
    x: ``[..., in_features]``; PACKED takes ``pack_linear_params`` and
    scales by its ``alpha`` (if any) before the bias."""
    if cfg.mode == QuantMode.PACKED:
        k = x.shape[-1]
        y = _packed_matmul(params["w_packed"], x.reshape(-1, k), k, cfg)
        if "alpha" in params:
            y = y * params["alpha"][None, :].to(y.dtype)
        y = y.reshape(*x.shape[:-1], -1)
    else:
        y = _float_matmul(params["w"], x, cfg)
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y


def pack_conv_params(params: dict) -> dict:
    """Filters [D, kH, kW, C] -> packed matrix [D, ceil(kH*kW*C/32)]."""
    packed = {"w_packed": _pack_rows_padded(filters_to_matrix(params["w"]))}
    if "b" in params:
        packed["b"] = params["b"]
    return packed


def pack_conv_aligned(params: dict) -> dict:
    """Tap-aligned packing for C % 32 != 0: each tap's channel block pads
    to whole words with -1 weights before packing, so filter word
    ``(h*kW + w)*ceil(C/32) + cw`` lines up with ``pack_channels``
    activation words. Identical to :func:`pack_conv_params` when
    C % 32 == 0."""
    w = params["w"]  # [D, kH, kW, C]
    d = w.shape[0]
    pad = -w.shape[-1] % bitops.PACK_BITS
    wm = torch.nn.functional.pad(w, (0, pad), value=-1.0) if pad else w
    packed = {"w_packed": bitops.pack_bits(wm.reshape(d, -1), axis=-1)}
    if "b" in params:
        packed["b"] = params["b"]
    return packed


def fold_bn_params(
    bn: dict,
    *,
    bias: Optional[torch.Tensor] = None,
    eps: float = BN_EPS,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Inference BatchNorm (+ bias) -> the per-channel affine ``(a, b)``
    the fused epilogue applies to the ±1 dot: ``a = s``,
    ``b = s*(bias - mean) + beta``, ``s = gamma * rsqrt(var + eps)``.

    ``torch.rsqrt`` and XLA's ``rsqrt`` round differently in some
    channels (by up to 2 ulp), so ``(a, b)`` folded here can differ from
    the JAX package's in the last bits.
    """
    s = bn["gamma"] * torch.rsqrt(bn["var"] + eps)
    y0 = bias if bias is not None else torch.zeros_like(s)
    b = s * (y0 - bn["mean"]) + bn["beta"]
    return s.float(), b.float()


def _fold_into(packed: dict, bn: dict, eps: float) -> dict:
    a, b = fold_bn_params(bn, bias=packed.pop("b", None), eps=eps)
    packed["a"], packed["b"] = a, b
    return packed


def pack_linear_fused(params: dict, bn: dict, *, eps: float = BN_EPS) -> dict:
    """Pack weights and fold the layer's BN/bias into ``(a, b)``."""
    return _fold_into(pack_linear_params(params), bn, eps)


def pack_conv_fused(params: dict, bn: dict, *, eps: float = BN_EPS) -> dict:
    """Conv variant of :func:`pack_linear_fused`."""
    return _fold_into(pack_conv_params(params), bn, eps)


def _fused_dispatch(wp, xpT, k_orig: int, a, b, engine: str):
    """Packed ``[KW, N]`` acts -> packed ``[ceil(M/32), N]`` outputs."""
    if engine == "xnor":
        return kops.fused_xnor_gemm(wp, xpT, k_orig, a, b)
    if engine == "xla":
        return bitops.fused_xnor_layer(wp, xpT, k_orig, a, b)
    raise ValueError(f"fused path has no engine {engine!r}")


def fused_bit_linear(packed: dict, xp: torch.Tensor, k_orig: int, *,
                     engine: str = "xnor") -> torch.Tensor:
    """Fused binary FC: ``[batch, KW]`` packed acts (K-pad bits +1) ->
    ``[batch, ceil(out/32)]`` packed words of ``sign(a*(x·w) + b)``."""
    out = _fused_dispatch(packed["w_packed"], xp.T.contiguous(), k_orig,
                          packed["a"], packed["b"], engine)
    return out.T


def fused_bit_conv2d(
    packed: dict,
    xp: torch.Tensor,
    k_orig: int,
    *,
    kh: int,
    kw: int,
    stride: int = 1,
    pad: int = 0,
    engine: str = "xnor",
    conv_impl: str = "im2col",
) -> torch.Tensor:
    """Fused binary conv: channel-packed ``[N, H, W, CW]`` maps in and
    out (``[N, OH, OW, ceil(D/32)]``). Borders pad with all-ones words.

    ``conv_impl="im2col"`` lowers to the patch-matrix GEMM;
    ``"direct"`` convolves the packed map in place. Both are
    bit-identical on both engines.
    """
    if conv_impl == "direct":
        args = (packed["w_packed"], xp.contiguous(), k_orig, packed["a"],
                packed["b"])
        if engine == "xnor":
            return kops.fused_direct_conv(*args, kh=kh, kw=kw, stride=stride,
                                          pad=pad)
        if engine == "xla":
            return bitops.direct_conv_oracle(*args, kh=kh, kw=kw,
                                             stride=stride, pad=pad)
        raise ValueError(f"direct conv has no engine {engine!r}")
    if conv_impl != "im2col":
        raise ValueError(f"unknown conv_impl {conv_impl!r}")
    patches, (oh, ow) = im2col(xp, kh, kw, stride=stride, pad=pad,
                               pad_value=-1)
    n, _, kwords = patches.shape
    x2d = patches.reshape(n * oh * ow, kwords)
    out = _fused_dispatch(packed["w_packed"], x2d.T.contiguous(), k_orig,
                          packed["a"], packed["b"], engine)
    return col2im(out.T.reshape(n, oh * ow, -1), oh, ow)


def packed_act_linear(packed: dict, xp: torch.Tensor, k_orig: int, *,
                      engine: str = "xnor") -> torch.Tensor:
    """Float-boundary epilogue-free layer (the chain's last): packed
    ``[batch, KW]`` -> float ``[batch, out]`` = ``x·w (+bias)``."""
    wp, xpT = packed["w_packed"], xp.T.contiguous()
    if engine == "xnor":
        dot = kops.xnor_gemm(wp, xpT, k_orig)
    elif engine == "xla":
        dot = bitops.xnor_popcount_matmul(wp, xpT, k_orig)
    else:
        raise ValueError(f"fused path has no engine {engine!r}")
    y = dot.T.float()
    if "b" in packed:
        y = y + packed["b"].float()
    return y


# ---------------------------------------------------------------------------
# Megakernel executors: a whole stage of layers in one launch.
# ---------------------------------------------------------------------------

def stack_chain_layers(layers: list[dict]) -> dict:
    """Stack fused-layer params (``{"w_packed" [m, kw], "a", "b" [m]}``)
    into the chain's operands ``{"w": [L, M_max, KW_max], "a", "b": [L,
    M_max]}``, ``M_max = round_up(max m, 32)``, ``KW_max = max kw``. Pad
    weight rows and words are 0; pad affine rows are ``a=0, b=+1``, so
    the padded output bits are +1, the activation-pad convention the
    next layer's zero weight words consume xnor-neutrally."""
    m_max = max(-(-p["w_packed"].shape[0] // bitops.PACK_BITS)
                * bitops.PACK_BITS for p in layers)
    kw_max = max(p["w_packed"].shape[1] for p in layers)
    ws, as_, bs = [], [], []
    for p in layers:
        m, kw = p["w_packed"].shape
        ws.append(torch.nn.functional.pad(p["w_packed"],
                                          (0, kw_max - kw, 0, m_max - m)))
        as_.append(torch.nn.functional.pad(p["a"].float(), (0, m_max - m)))
        bs.append(torch.nn.functional.pad(p["b"].float(), (0, m_max - m),
                                          value=1.0))
    return {"w": torch.stack(ws), "a": torch.stack(as_), "b": torch.stack(bs)}


def megakernel_fc_chain(stack: dict, xp: torch.Tensor, k_bits, m_out: int, *,
                        final: Optional[dict] = None, final_k: int = 0,
                        engine: str = "xnor",
                        ragged: bool = False) -> torch.Tensor:
    """A whole FC trunk, the stacked fused layers and optionally the
    float-boundary head's GEMM, in one launch.

    ``stack`` comes from :func:`stack_chain_layers`; ``xp`` is ``[batch,
    KW_in]`` packed activations. Without ``final``: ``[batch,
    ceil(m_out/32)]`` packed words. With ``final`` (a
    ``pack_linear_params`` dict): the head's float ``[batch, out]``, its
    int32 dot computed in the launch and the bias added here with the
    ops of :func:`packed_act_linear`, so logits match the per-layer chain
    bit for bit. ``ragged`` takes the kernel's masked-tail path (batch
    padded to ``RAGGED_TILE_N``); the twin is exact-N either way.
    """
    fin_wp = final["w_packed"] if final is not None else None
    xpT = xp.T.contiguous()
    if engine == "xnor":
        out = kops.megakernel_chain(
            stack["w"], stack["a"], stack["b"], tuple(k_bits), xpT, m_out,
            final_wp=fin_wp, final_k_bits=final_k,
            ragged_tile=kops.RAGGED_TILE_N if ragged else None)
    elif engine == "xla":
        out = bitops.megakernel_chain_xla(
            stack["w"], stack["a"], stack["b"], tuple(k_bits), xpT, m_out,
            final_wp=fin_wp, final_k_bits=final_k)
    else:
        raise ValueError(f"megakernel has no engine {engine!r}")
    if final is None:
        return out.T
    y = out.T.float()
    if "b" in final:
        y = y + final["b"].float()
    return y


def megakernel_conv_stage(layers: list[dict], xp: torch.Tensor, k_bits, *,
                          kh: int = 3, kw: int = 3, pad: int = 1,
                          pool: bool = True,
                          engine: str = "xnor") -> torch.Tensor:
    """One conv stage, the stage's fused binary convs and the packed-OR
    maxpool, in one launch (``engine="xnor"``) or through the chained
    plain-torch direct-conv twin (``engine="xla"``).

    ``layers``: ``pack_conv_fused`` dicts (tap-aligned ``w_packed``,
    folded ``a``/``b``); ``xp``: ``[N, H, W, CW]`` channel-packed map.
    Bit-identical to :func:`fused_bit_conv2d` per layer and
    ``maxpool2_packed``; on the kernel the intermediate maps never reach
    device memory.
    """
    weights = tuple(p["w_packed"] for p in layers)
    a = tuple(p["a"] for p in layers)
    b = tuple(p["b"] for p in layers)
    if engine == "xnor":
        return kops.megakernel_conv_stage(xp.contiguous(), weights, a, b,
                                          tuple(k_bits), kh=kh, kw=kw,
                                          pad=pad, pool=pool)
    if engine == "xla":
        return bitops.conv_stage_xla(xp, weights, a, b, tuple(k_bits), kh=kh,
                                     kw=kw, pad=pad, pool=pool)
    raise ValueError(f"megakernel has no engine {engine!r}")


def _direct_bit_conv2d(params: dict, x: torch.Tensor, cfg: BitLinearConfig,
                       *, kh: int, kw: int, stride: int,
                       pad: int) -> torch.Tensor:
    """PACKED conv without the im2col lowering (``conv_impl="direct"``):
    binarize and channel-pack the input once (``[N, H, W, C/32]``) and
    convolve the packed map; the ``[N*OH*OW, kH*kW*C]`` patch matrix never
    exists. Needs C % 32 == 0, where the ``pack_conv_params`` filter
    layout is the tap-aligned one."""
    c = x.shape[-1]
    if c % bitops.PACK_BITS != 0:
        raise ValueError(
            f"conv_impl='direct' via bit_conv2d needs C % 32 == 0, got "
            f"C={c}; use conv_impl='im2col' (or pack_conv_aligned + "
            "fused_bit_conv2d)")
    if cfg.engine not in ("xnor", "xla"):
        raise ValueError(f"conv_impl='direct' has no engine {cfg.engine!r} "
                         "(packed-activation path: 'xnor' | 'xla')")
    xp = bitops.pack_bits(torch.clamp(x, -1, 1), axis=-1)
    args = (params["w_packed"], xp, kh * kw * c)
    kwargs = dict(kh=kh, kw=kw, stride=stride, pad=pad)
    if cfg.engine == "xnor":
        dot = kops.direct_conv(*args, **kwargs)
    else:
        dot = bitops.direct_conv_dot(*args, **kwargs)
    y = dot.to(cfg.compute_dtype)
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y


def bit_conv2d(params: dict, x: torch.Tensor, cfg: BitLinearConfig, *,
               stride: int = 1, pad: int = 0, kh: Optional[int] = None,
               kw: Optional[int] = None) -> torch.Tensor:
    """Conv via the paper's forward graph, im2col -> GEMM -> (+bias) ->
    col2im (``cfg.conv_impl="im2col"``), or the direct packed-window
    kernel (``"direct"``, PACKED mode only).

    x: [N, H, W, C]. Returns [N, OH, OW, D]. PACKED takes
    ``pack_conv_params`` and needs ``kh``/``kw``. The FLOAT and
    FAKE_QUANT GEMMs are a plain fp32 ``torch.matmul``, as the JAX
    package leaves them to XLA; callers on a GPU keep TF32 off.
    """
    packed = cfg.mode == QuantMode.PACKED
    if packed:
        if kh is None or kw is None:
            raise ValueError("a PACKED conv needs kh and kw")
        if cfg.conv_impl == "direct":
            return _direct_bit_conv2d(params, x, cfg, kh=kh, kw=kw,
                                      stride=stride, pad=pad)
        if cfg.conv_impl != "im2col":
            raise ValueError(f"unknown conv_impl {cfg.conv_impl!r}")
    else:
        _, kh, kw, _ = params["w"].shape
    patches, (oh, ow) = im2col(x, kh, kw, stride=stride, pad=pad)
    n, _, pk = patches.shape
    x2d = patches.reshape(n * oh * ow, pk)
    if packed:
        y2d = _packed_matmul(params["w_packed"], x2d, pk, cfg)
    else:
        y2d = _float_matmul(filters_to_matrix(params["w"]), x2d, cfg)
    if "b" in params:
        y2d = y2d + params["b"].to(y2d.dtype)
    return col2im(y2d.reshape(n, oh * ow, -1), oh, ow)
