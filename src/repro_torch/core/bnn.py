"""The paper's evaluation model, the CIFAR-10 BNN, for inference in
PyTorch.

Architecture (as ``repro.core.bnn``):

    2x(128C3) - MaxPool2 - 2x(256C3) - MaxPool2 - 2x(512C3) - MaxPool2
    - 1024FC - 1024FC - 10FC

The first conv consumes real images (FAKE_QUANT: ±1 weights, float
inputs); every other layer is binary. :func:`bnn_apply` is the paper's
Table 2 forward in any ``QuantMode``, with float tensors between layers
(PACKED: each layer encodes its input on the fly). The serving paths
keep only packed int32 words between binary layers: one launch per
layer in :func:`bnn_apply_fused`, one per network stage in
:func:`bnn_apply_megakernel`. Training is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import bitops
from repro_torch.core.binarize import QuantMode, binarize_activations
from repro_torch.core.layers import (
    BN_EPS,
    BitLinearConfig,
    bit_conv2d,
    bit_linear,
    fused_bit_conv2d,
    fused_bit_linear,
    init_conv,
    init_linear,
    megakernel_conv_stage,
    megakernel_fc_chain,
    pack_conv_fused,
    pack_conv_params,
    pack_linear_fused,
    pack_linear_params,
    packed_act_linear,
    stack_chain_layers,
)

CONV_CHANNELS = [(3, 128), (128, 128), (128, 256), (256, 256), (256, 512), (512, 512)]
POOL_AFTER = {1, 3, 5}  # maxpool after conv index
FC_SIZES = [(512 * 4 * 4, 1024), (1024, 1024), (1024, 10)]


def _conv_stages() -> tuple[tuple[int, ...], ...]:
    """Interior binary convs grouped into pool-terminated stages,
    ((1,), (2, 3), (4, 5)) for the CIFAR net: one megakernel launch
    each. Derived from POOL_AFTER."""
    stages, cur = [], []
    for i in range(1, len(CONV_CHANNELS)):
        cur.append(i)
        if i in POOL_AFTER:
            stages.append(tuple(cur))
            cur = []
    if cur:
        stages.append(tuple(cur))
    return tuple(stages)


CONV_STAGES = _conv_stages()


@dataclasses.dataclass(frozen=True)
class BNNConfig:
    """How :func:`bnn_apply` runs: the quantization mode and, in PACKED
    mode, the engine (``"xnor"``, ``"unpack"``, ``"xla"``) and conv
    lowering (``"im2col"``, ``"direct"``). The JAX package's
    ``use_scale`` and ``blocks`` are not ported."""

    mode: QuantMode = QuantMode.FAKE_QUANT
    engine: str = "xnor"
    conv_impl: str = "im2col"  # "im2col" | "direct" (PACKED convs only)
    num_classes: int = 10

    def layer_cfg(self, *, binarize_acts: bool) -> BitLinearConfig:
        return BitLinearConfig(mode=self.mode, engine=self.engine,
                               conv_impl=self.conv_impl,
                               binarize_acts=binarize_acts)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Raises rather than fall back to the CPU when CUDA is asked
    for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default, but "
            "torch.cuda.is_available() is False; pass device='cpu' "
            "(--device cpu) to run the plain-torch path on the CPU")
    return dev


def _init_bn(width: int, device) -> dict:
    return {
        "gamma": torch.ones((width,), device=device),
        "beta": torch.zeros((width,), device=device),
        "mean": torch.zeros((width,), device=device),
        "var": torch.ones((width,), device=device),
    }


def init_bnn_params(seed: int = 0, *, device=None) -> dict[str, Any]:
    """Random latent params from ``torch.Generator().manual_seed(seed)``
    (not the JAX package's numbers: carry those with ``convert``)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    params: dict[str, Any] = {"conv": [], "bn_conv": [], "fc": [], "bn_fc": []}
    for cin, cout in CONV_CHANNELS:
        params["conv"].append(init_conv(gen, 3, 3, cin, cout, device=dev))
        params["bn_conv"].append(_init_bn(cout, dev))
    for fin, fout in FC_SIZES:
        params["fc"].append(init_linear(gen, fin, fout, device=dev))
        params["bn_fc"].append(_init_bn(fout, dev))
    return params


def pack_bnn_params(params: dict) -> dict:
    """Latent float params -> packed 1-bit inference params for
    :func:`bnn_apply` in PACKED mode (paper §3.1). The first conv stays
    float (real-valued images in); BN stays unfolded."""
    return {
        "conv": [params["conv"][0]]
        + [pack_conv_params(p) for p in params["conv"][1:]],
        "fc": [pack_linear_params(p) for p in params["fc"]],
        "bn_conv": params["bn_conv"],
        "bn_fc": params["bn_fc"],
    }


def pack_bnn_params_fused(params: dict) -> dict:
    """Latent float params -> fused-pipeline inference params: every
    interior binary layer packs its weights and folds its BN (+ bias)
    into ``(a, b)``; the first conv stays float and the last FC
    keeps its BN unfolded."""
    n_fc = len(FC_SIZES)
    return {
        "conv": [params["conv"][0]]
        + [
            pack_conv_fused(p, bn)
            for p, bn in zip(params["conv"][1:], params["bn_conv"][1:])
        ],
        "bn_conv0": params["bn_conv"][0],
        "fc": [
            pack_linear_fused(params["fc"][j], params["bn_fc"][j])
            for j in range(n_fc - 1)
        ]
        + [pack_linear_params(params["fc"][-1])],
        "bn_fc_last": params["bn_fc"][-1],
    }


def _batchnorm(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Eval BatchNorm, in the JAX package's op order:
    ``(x - mean) * rsqrt(var + eps) * gamma + beta``."""
    inv = torch.rsqrt(p["var"] + BN_EPS)
    return (x - p["mean"]) * inv * p["gamma"] + p["beta"]


def _maxpool2(x: torch.Tensor) -> torch.Tensor:
    """2x2/stride-2 max pool of a float NHWC map (``lax.reduce_window``
    with a -inf fill and VALID windows: odd trailing rows drop)."""
    _, h, w, _ = x.shape
    x = x[:, :h // 2 * 2, :w // 2 * 2]
    return torch.maximum(torch.maximum(x[:, 0::2, 0::2], x[:, 0::2, 1::2]),
                         torch.maximum(x[:, 1::2, 0::2], x[:, 1::2, 1::2]))


def bnn_apply(params: dict, images: torch.Tensor,
              cfg: BNNConfig) -> torch.Tensor:
    """images ``[N, 32, 32, 3]`` -> logits ``[N, 10]``, eval mode (running
    BN statistics), with float tensors at every layer boundary: the
    paper's Table 2 forward.

    PACKED takes :func:`pack_bnn_params` params: its first conv runs
    FAKE_QUANT on the real images, and every later layer re-encodes the
    clipped float activations itself (``engine`` and ``conv_impl`` pick
    the kernels). FLOAT and FAKE_QUANT take latent params and binarize
    the activations between layers.
    """
    x = images
    packed = cfg.mode == QuantMode.PACKED
    for i in range(len(CONV_CHANNELS)):
        first = i == 0
        if first and packed:
            lcfg = BitLinearConfig(mode=QuantMode.FAKE_QUANT,
                                   binarize_acts=False)
        else:
            lcfg = cfg.layer_cfg(binarize_acts=not first)
        x = bit_conv2d(params["conv"][i], x, lcfg, stride=1, pad=1,
                       kh=3 if packed else None, kw=3 if packed else None)
        x = _batchnorm(params["bn_conv"][i], x)
        if i in POOL_AFTER:
            x = _maxpool2(x)
        # In PACKED mode the next layer's engine binarizes and encodes.
        x = torch.clamp(x, -1, 1) if packed else binarize_activations(x)
    x = x.reshape(x.shape[0], -1)
    for j in range(len(FC_SIZES)):
        x = bit_linear(params["fc"][j], x, cfg.layer_cfg(binarize_acts=True))
        x = _batchnorm(params["bn_fc"][j], x)
        if j < len(FC_SIZES) - 1:
            x = torch.clamp(x, -1, 1) if packed else binarize_activations(x)
    return x


def bnn_eval_logits(params: dict, images: torch.Tensor) -> torch.Tensor:
    """The trained model's float-boundary forward: FAKE_QUANT in eval
    mode on latent params. Every ±1 dot is an integer (exact in float32
    below 2^24) and ``sign(0) := +1`` on every path, so PACKED and fused
    logits of the same params equal it on the CPU."""
    return bnn_apply(params, images, BNNConfig(mode=QuantMode.FAKE_QUANT))


def first_conv_packed(packed: dict, images: torch.Tensor) -> torch.Tensor:
    """The float boundary at the input: first conv (FAKE_QUANT), eval BN,
    then channel packing -> ``[N, 32, 32, 4]`` words."""
    lcfg = BitLinearConfig(mode=QuantMode.FAKE_QUANT, binarize_acts=False)
    x = bit_conv2d(packed["conv"][0], images, lcfg, stride=1, pad=1)
    x = _batchnorm(packed["bn_conv0"], x)
    return bitops.pack_bits(x, axis=-1)


def bnn_apply_fused(
    packed: dict,
    images: torch.Tensor,
    *,
    engine: str = "xnor",
    conv_impl: str = "im2col",
) -> torch.Tensor:
    """Fused packed inference: images ``[N, 32, 32, 3]`` -> logits
    ``[N, 10]``, with packed int32 words at every interior boundary.

    ``packed`` comes from :func:`pack_bnn_params_fused`. ``engine`` is
    ``"xnor"`` (CUDA kernels) or ``"xla"`` (plain-torch twins);
    ``conv_impl`` is ``"im2col"`` or ``"direct"``.
    """
    xp = first_conv_packed(packed, images)
    for i in range(1, len(CONV_CHANNELS)):
        xp = fused_bit_conv2d(
            packed["conv"][i], xp, 3 * 3 * CONV_CHANNELS[i][0],
            kh=3, kw=3, stride=1, pad=1, engine=engine,
            conv_impl=conv_impl,
        )
        if i in POOL_AFTER:
            xp = bitops.maxpool2_packed(xp)
    xp = xp.reshape(xp.shape[0], -1)  # word order matches pack_linear's K order
    for j in range(len(FC_SIZES) - 1):
        xp = fused_bit_linear(packed["fc"][j], xp, FC_SIZES[j][0],
                              engine=engine)
    y = packed_act_linear(packed["fc"][-1], xp, FC_SIZES[-1][0], engine=engine)
    return _batchnorm(packed["bn_fc_last"], y)


def pack_bnn_params_megakernel(params: dict) -> dict:
    """Latent float params -> megakernel inference params: the packing
    and folding of :func:`pack_bnn_params_fused`, with the FC trunk's
    interior layers stacked into the chain's ``[L, M_max, KW_max]``
    operands (``fc_stack``) here, once, not per forward. Conv stages
    keep their per-layer tap-aligned params."""
    fused = pack_bnn_params_fused(params)
    return {
        "conv": fused["conv"],
        "bn_conv0": fused["bn_conv0"],
        "fc_stack": stack_chain_layers(fused["fc"][:-1]),
        "fc_final": fused["fc"][-1],
        "bn_fc_last": fused["bn_fc_last"],
    }


def bnn_apply_megakernel(
    packed: dict,
    images: torch.Tensor,
    *,
    engine: str = "xnor",
    ragged: bool = False,
) -> torch.Tensor:
    """Megakernel inference: one launch per network stage.

    Logits bit-identical to :func:`bnn_apply_fused`, from
    :func:`pack_bnn_params_megakernel` params, with this launch
    structure:

      float first conv -> pack                (torch ops)
      conv stage 1: conv1 + OR-pool           1 launch
      conv stage 2: conv2 + conv3 + OR-pool   1 launch
      conv stage 3: conv4 + conv5 + OR-pool   1 launch
      FC trunk: fc0 + fc1 (fused) + fc2 dot   1 launch
      bias + unfolded BN on [N, 10] floats    (torch ops)

    ``engine="xnor"`` runs the CUDA megakernels (their twins on CPU
    tensors), ``"xla"`` the plain-torch twins. ``ragged`` sends the FC
    trunk through the chain's masked-tail path (batch padded to
    ``RAGGED_TILE_N``); logits are the same either way.
    """
    xp = first_conv_packed(packed, images)
    for stage in CONV_STAGES:
        xp = megakernel_conv_stage(
            [packed["conv"][i] for i in stage], xp,
            tuple(3 * 3 * CONV_CHANNELS[i][0] for i in stage),
            pool=stage[-1] in POOL_AFTER, engine=engine,
        )
    xp = xp.reshape(xp.shape[0], -1)  # word order matches pack_linear's K order
    y = megakernel_fc_chain(
        packed["fc_stack"], xp, tuple(fin for fin, _ in FC_SIZES[:-1]),
        FC_SIZES[-2][1], final=packed["fc_final"], final_k=FC_SIZES[-1][0],
        engine=engine, ragged=ragged,
    )
    return _batchnorm(packed["bn_fc_last"], y)


# Engines bnn_serve_fn (and the serving executor caches) accepts:
# "xla"/"xnor" run the per-layer fused chain on pack_bnn_params_fused
# params, "megakernel"/"megakernel_xla" one launch per stage on
# pack_bnn_params_megakernel params; the "xla" forms run the
# plain-torch twins.
SERVE_ENGINES = ("xla", "xnor", "megakernel", "megakernel_xla")

# Failover ladder: on repeated kernel failure an engine demotes to the
# next rung. Every rung is bit-identical to the one above it. The
# megakernel rungs take pack_bnn_params_megakernel params, the fused
# ones pack_bnn_params_fused: FallbackPolicy skips rungs it holds no
# params for.
SERVE_FALLBACKS = {
    "megakernel": ("xnor", "xla"),
    "megakernel_xla": ("xla",),
    "xnor": ("xla",),
    "xla": (),
}


def bnn_serve_fn(*, engine: str = "xla", conv_impl: str = "im2col",
                 ragged: bool = False):
    """The serving entry point: a ``(packed, images) -> logits`` callable
    over :func:`bnn_apply_fused`, or :func:`bnn_apply_megakernel` for the
    megakernel engines (which ignore ``conv_impl``: their convs are
    direct), with the kernel path bound at closure time, run under
    ``torch.inference_mode``. ``ragged`` (the continuous scheduler's
    executors) sends the megakernel FC trunk through the masked-tail
    path; the other engines are exact-shape and ignore it."""
    if engine not in SERVE_ENGINES:
        raise ValueError(f"unknown serving engine {engine!r}; "
                         f"expected one of {SERVE_ENGINES}")

    if engine.startswith("megakernel"):
        inner = "xnor" if engine == "megakernel" else "xla"

        def apply_fn(packed: dict, images: torch.Tensor) -> torch.Tensor:
            with torch.inference_mode():
                return bnn_apply_megakernel(packed, images, engine=inner,
                                            ragged=ragged)
    else:

        def apply_fn(packed: dict, images: torch.Tensor) -> torch.Tensor:
            with torch.inference_mode():
                return bnn_apply_fused(packed, images, engine=engine,
                                       conv_impl=conv_impl)

    return apply_fn


# --- sign-form checkpoint (format "bnn-sign-v1" of repro.core.bnn) ---------
# 1 bit per weight (np.packbits of w >= 0) plus float32 biases and BN
# buffers. Loading gives ±1.0 latent weights, whose forward is
# bit-identical to the trained model's.

BINARY_CKPT_FORMAT = "bnn-sign-v1"


def load_binary_checkpoint(path, *, device=None) -> dict:
    """Load a sign-form checkpoint into latent params with ±1.0 weights."""
    dev = resolve_device(device)
    with np.load(path) as z:
        if str(z["format"]) != BINARY_CKPT_FORMAT:
            raise ValueError(
                f"{path}: unknown binary checkpoint format {z['format']!r}"
                f" (expected {BINARY_CKPT_FORMAT!r})")
        data = {k: z[k] for k in z.files}

    def tensor(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32, copy=True)).to(dev)

    params: dict[str, Any] = {"conv": [], "bn_conv": [], "fc": [], "bn_fc": []}
    for group in ("conv", "fc"):
        i = 0
        while f"{group}{i}/w_bits" in data:
            shape = tuple(int(s) for s in data[f"{group}{i}/w_shape"])
            bits = np.unpackbits(data[f"{group}{i}/w_bits"])[:int(np.prod(shape))]
            p = {"w": tensor((bits.astype(np.float32) * 2.0 - 1.0).reshape(shape))}
            if f"{group}{i}/b" in data:
                p["b"] = tensor(data[f"{group}{i}/b"])
            params[group].append(p)
            i += 1
    for group in ("bn_conv", "bn_fc"):
        i = 0
        while f"{group}{i}/gamma" in data:
            params[group].append({k: tensor(data[f"{group}{i}/{k}"])
                                  for k in ("gamma", "beta", "mean", "var")})
            i += 1
    return params
