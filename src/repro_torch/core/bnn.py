"""The paper's evaluation model, the CIFAR-10 BNN, in PyTorch: its
training forward and loss, its inference paths, and the export from one
to the other.

Architecture (as ``repro.core.bnn``):

    2x(128C3) - MaxPool2 - 2x(256C3) - MaxPool2 - 2x(512C3) - MaxPool2
    - 1024FC - 1024FC - 10FC

The first conv consumes real images (FAKE_QUANT: ±1 weights, float
inputs); every other layer is binary. :func:`bnn_apply` is the paper's
Table 2 forward in any ``QuantMode``, with float tensors between layers
(PACKED: each layer encodes its input on the fly). The serving paths
keep only packed int32 words between binary layers: one launch per
layer in :func:`bnn_apply_fused`, one per network stage in
:func:`bnn_apply_megakernel`. Every kernel path takes a ``blocks``
tiling (``kernels.autotune``; logits do not depend on it) and every
packer the XNOR-Net ``use_scale``.

Training (``train.bnn_trainer``) runs :func:`bnn_apply` in FAKE_QUANT
with ``training=True``: batch BatchNorm statistics, STE gradients by
plain autograd (:func:`bnn_train_loss`), the batch statistics folded
into the running buffers outside autograd (:func:`update_bn_stats`).
:func:`pack_trained_params` exports trained latents to every packed
format and verifies every engine bit-identical to the float-boundary
forward (:func:`bnn_eval_logits`); :func:`save_binary_checkpoint`
writes the 1-bit sign form the serving CLI loads.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import bitops
from repro_torch.core.binarize import (QuantMode, binarize_activations,
                                       binarize_weights)
from repro_torch.core.im2col import col2im, filters_to_matrix, im2col
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
from repro_torch.kernels.autotune import AUTO

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
    mode, the engine (``"xnor"``, ``"unpack"``, ``"xla"``), conv lowering
    (``"im2col"``, ``"direct"``) and kernel tiling (``blocks``: ``"auto"``
    or a ``kernels.autotune.BlockConfig``); ``use_scale`` the XNOR-Net
    alpha of FAKE_QUANT layers and of the first conv (PACKED params carry
    theirs from ``pack_bnn_params(..., use_scale=True)``)."""

    mode: QuantMode = QuantMode.FAKE_QUANT
    engine: str = "xnor"
    conv_impl: str = "im2col"  # "im2col" | "direct" (PACKED convs only)
    use_scale: bool = False
    num_classes: int = 10
    blocks: object = AUTO

    def layer_cfg(self, *, binarize_acts: bool) -> BitLinearConfig:
        return BitLinearConfig(mode=self.mode, engine=self.engine,
                               conv_impl=self.conv_impl,
                               use_scale=self.use_scale,
                               binarize_acts=binarize_acts,
                               blocks=self.blocks)


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


def pack_bnn_params(params: dict, *, use_scale: bool = False) -> dict:
    """Latent float params -> packed 1-bit inference params for
    :func:`bnn_apply` in PACKED mode (paper §3.1). The first conv stays
    float (real-valued images in); BN stays unfolded. ``use_scale`` adds
    each binary layer's XNOR-Net ``alpha``."""
    return {
        "conv": [params["conv"][0]]
        + [pack_conv_params(p, use_scale=use_scale) for p in params["conv"][1:]],
        "fc": [pack_linear_params(p, use_scale=use_scale) for p in params["fc"]],
        "bn_conv": params["bn_conv"],
        "bn_fc": params["bn_fc"],
    }


def pack_bnn_params_fused(params: dict, *, use_scale: bool = False) -> dict:
    """Latent float params -> fused-pipeline inference params: every
    interior binary layer packs its weights and folds its BN (+ bias +
    ``use_scale``'s alpha) into ``(a, b)``; the first conv stays float
    and the last FC keeps its BN unfolded (and its alpha)."""
    n_fc = len(FC_SIZES)
    return {
        "conv": [params["conv"][0]]
        + [
            pack_conv_fused(p, bn, use_scale=use_scale)
            for p, bn in zip(params["conv"][1:], params["bn_conv"][1:])
        ],
        "bn_conv0": params["bn_conv"][0],
        "fc": [
            pack_linear_fused(params["fc"][j], params["bn_fc"][j],
                              use_scale=use_scale)
            for j in range(n_fc - 1)
        ]
        + [pack_linear_params(params["fc"][-1], use_scale=use_scale)],
        "bn_fc_last": params["bn_fc"][-1],
    }


def _batchnorm(p: dict, x: torch.Tensor, training: bool = False,
               stats: list | None = None) -> torch.Tensor:
    """BatchNorm over every axis but the last, in the JAX package's op
    order: ``(x - mean) * rsqrt(var + eps) * gamma + beta``. Eval mode
    reads the running ``mean``/``var`` buffers; training mode takes the
    batch mean and the biased variance (``jnp.var``'s, ``correction=0``)
    and appends them to ``stats`` when given."""
    if training:
        axes = tuple(range(x.ndim - 1))
        mean = torch.mean(x, dim=axes)
        var = torch.var(x, dim=axes, correction=0)
        if stats is not None:
            stats.append({"mean": mean, "var": var})
    else:
        mean, var = p["mean"], p["var"]
    inv = torch.rsqrt(var + BN_EPS)
    return (x - mean) * inv * p["gamma"] + p["beta"]


def _maxpool2(x: torch.Tensor) -> torch.Tensor:
    """2x2/stride-2 max pool of a float NHWC map (``lax.reduce_window``
    with a -inf fill and VALID windows: odd trailing rows drop). Its
    gradient goes to the first maximal element of a window in row-major
    order, as ``reduce_window``'s does; ties are common here (equal
    integer dots of a channel normalize to equal floats), and splitting
    them, as ``torch.maximum`` does, would give other gradients."""
    y = torch.nn.functional.max_pool2d(x.permute(0, 3, 1, 2), 2, 2)
    return y.permute(0, 2, 3, 1)


def bnn_apply(params: dict, images: torch.Tensor, cfg: BNNConfig, *,
              training: bool = False, return_stats: bool = False):
    """images ``[N, 32, 32, 3]`` -> logits ``[N, 10]`` with float tensors at
    every layer boundary: the paper's Table 2 forward, and the training
    forward.

    PACKED takes :func:`pack_bnn_params` params: its first conv runs
    FAKE_QUANT on the real images, and every later layer re-encodes the
    clipped float activations itself (``engine`` and ``conv_impl`` pick
    the kernels). FLOAT and FAKE_QUANT take latent params and binarize
    the activations between layers (STE gradients).

    ``training=True`` uses batch BatchNorm statistics; ``return_stats``
    also returns them per layer, ``{"bn_conv": [{"mean", "var"}, ...],
    "bn_fc": [...]}``, for :func:`update_bn_stats`. PACKED's first conv,
    and FAKE_QUANT's in eval mode, is :func:`_first_conv`, the serving
    engines' own (on CUDA its GEMM runs in fixed chunks of images), so
    the float-boundary forward and every engine compute it alike.
    """
    stats_conv = [] if return_stats else None
    stats_fc = [] if return_stats else None
    x = images
    packed = cfg.mode == QuantMode.PACKED
    for i in range(len(CONV_CHANNELS)):
        first = i == 0
        if first and (packed or (cfg.mode == QuantMode.FAKE_QUANT
                                 and not training)):
            x = _first_conv(params["conv"][0], x, cfg.use_scale)
        else:
            x = bit_conv2d(params["conv"][i], x,
                           cfg.layer_cfg(binarize_acts=not first), stride=1,
                           pad=1, kh=3 if packed else None,
                           kw=3 if packed else None)
        x = _batchnorm(params["bn_conv"][i], x, training, stats_conv)
        if i in POOL_AFTER:
            x = _maxpool2(x)
        # In PACKED mode the next layer's engine binarizes and encodes.
        x = torch.clamp(x, -1, 1) if packed else binarize_activations(x)
    x = x.reshape(x.shape[0], -1)
    for j in range(len(FC_SIZES)):
        x = bit_linear(params["fc"][j], x, cfg.layer_cfg(binarize_acts=True))
        x = _batchnorm(params["bn_fc"][j], x, training, stats_fc)
        if j < len(FC_SIZES) - 1:
            x = torch.clamp(x, -1, 1) if packed else binarize_activations(x)
    if return_stats:
        return x, {"bn_conv": stats_conv, "bn_fc": stats_fc}
    return x


def bnn_eval_logits(params: dict, images: torch.Tensor, *,
                    use_scale: bool = False) -> torch.Tensor:
    """The trained model's float-boundary forward: FAKE_QUANT in eval
    mode on latent params (``use_scale``: the XNOR-Net alpha). Every ±1
    dot is an integer (exact in float32 below 2^24), ``sign(0) := +1`` on
    every path and the first conv is the engines' own, so the packed
    engines reproduce it bit for bit (:func:`pack_trained_params`)."""
    return bnn_apply(params, images,
                     BNNConfig(mode=QuantMode.FAKE_QUANT, use_scale=use_scale))


def xent_and_acc(logits: torch.Tensor, labels: torch.Tensor):
    """Mean cross-entropy and accuracy against int labels."""
    logp = torch.log_softmax(logits, dim=-1)
    loss = -torch.mean(torch.gather(logp, 1, labels.long()[:, None]))
    acc = torch.mean((torch.argmax(logits, -1) == labels).to(torch.float32))
    return loss, acc


def bnn_loss(params, images, labels, cfg: BNNConfig):
    """(loss, accuracy) of the training forward (batch statistics)."""
    return xent_and_acc(bnn_apply(params, images, cfg, training=True), labels)


def bnn_train_loss(params, images, labels, cfg: BNNConfig):
    """:func:`bnn_loss` with the BatchNorm batch statistics as aux:
    ``(loss, {"acc", "bn_stats"})``. The trainer folds the statistics
    into the running buffers (:func:`update_bn_stats`), which packed
    inference reads; without them the export would normalize with the
    init statistics."""
    logits, stats = bnn_apply(params, images, cfg, training=True,
                              return_stats=True)
    loss, acc = xent_and_acc(logits, labels)
    return loss, {"acc": acc, "bn_stats": stats}


@torch.no_grad()
def update_bn_stats(params: dict, bn_stats: dict, *,
                    momentum: float = 0.9) -> dict:
    """EMA the batch statistics into the BN buffers, ``new = momentum *
    old + (1 - momentum) * batch``, outside autograd (the buffers are no
    trainable params)."""
    out = dict(params)
    for key in ("bn_conv", "bn_fc"):
        out[key] = [
            {**bn,
             "mean": momentum * bn["mean"] + (1 - momentum) * s["mean"],
             "var": momentum * bn["var"] + (1 - momentum) * s["var"]}
            for bn, s in zip(params[key], bn_stats[key])
        ]
    return out


# Images one float32 GEMM of the first conv takes on CUDA (_first_conv).
FIRST_CONV_CHUNK = 8


def _first_conv(params: dict, images: torch.Tensor,
                use_scale: bool) -> torch.Tensor:
    """The first conv, FAKE_QUANT on float images, as :func:`bit_conv2d`
    computes it; on CUDA its GEMM runs on fixed chunks of
    ``FIRST_CONV_CHUNK`` images, the batch zero-padded to whole chunks.
    cuBLAS picks a float32 GEMM kernel by shape and its kernels sum K in
    different orders, so an image's products round differently alone than
    in a batch (a packed word flips now and then: ``chip_smoke.py`` phase
    4a counts them). One GEMM shape at every batch size keeps a request's
    logits independent of the batch the engines serve it in."""
    lcfg = BitLinearConfig(mode=QuantMode.FAKE_QUANT, binarize_acts=False,
                           use_scale=use_scale)
    if images.device.type != "cuda":
        return bit_conv2d(params, images, lcfg, stride=1, pad=1)
    n = images.shape[0]
    pad = -n % FIRST_CONV_CHUNK
    x = torch.nn.functional.pad(images, (0, 0, 0, 0, 0, 0, 0, pad)) if pad else images
    patches, (oh, ow) = im2col(x, 3, 3, stride=1, pad=1)
    x2d = patches.reshape(-1, patches.shape[-1])
    wq, alpha = binarize_weights(filters_to_matrix(params["w"]),
                                 scale_axis=-1 if use_scale else None)
    wt = wq.to(x2d.dtype).T
    y = torch.empty((x2d.shape[0], wt.shape[1]), dtype=x2d.dtype,
                    device=x2d.device)
    rows = FIRST_CONV_CHUNK * oh * ow
    for r in range(0, x2d.shape[0], rows):
        torch.matmul(x2d[r:r + rows], wt, out=y[r:r + rows])
    if alpha is not None:
        y = y * alpha.reshape(1, -1).to(y.dtype)
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return col2im(y.reshape(x.shape[0], oh * ow, -1), oh, ow)[:n]


def first_conv_packed(packed: dict, images: torch.Tensor, *,
                      use_scale: bool = False) -> torch.Tensor:
    """The float boundary at the input: first conv (FAKE_QUANT, with
    alpha under ``use_scale``), eval BN, then channel packing ->
    ``[N, 32, 32, 4]`` words. Each image's words do not depend on the
    batch it comes in (:func:`_first_conv`)."""
    x = _first_conv(packed["conv"][0], images, use_scale)
    x = _batchnorm(packed["bn_conv0"], x)
    return bitops.pack_bits(x, axis=-1)


def bnn_apply_fused(
    packed: dict,
    images: torch.Tensor,
    *,
    engine: str = "xnor",
    conv_impl: str = "im2col",
    use_scale: bool = False,
    blocks: object = AUTO,
) -> torch.Tensor:
    """Fused packed inference: images ``[N, 32, 32, 3]`` -> logits
    ``[N, 10]``, with packed int32 words at every interior boundary.

    ``packed`` comes from :func:`pack_bnn_params_fused`. ``engine`` is
    ``"xnor"`` (CUDA kernels) or ``"xla"`` (plain-torch twins);
    ``conv_impl`` is ``"im2col"`` or ``"direct"``; ``use_scale`` gives
    the first conv its alpha; ``blocks`` is ``"auto"`` or a
    ``kernels.autotune.BlockConfig`` for every kernel launched. Logits
    are bit-identical across engines, conv lowerings and tilings.
    """
    xp = first_conv_packed(packed, images, use_scale=use_scale)
    for i in range(1, len(CONV_CHANNELS)):
        xp = fused_bit_conv2d(
            packed["conv"][i], xp, 3 * 3 * CONV_CHANNELS[i][0],
            kh=3, kw=3, stride=1, pad=1, engine=engine,
            conv_impl=conv_impl, blocks=blocks,
        )
        if i in POOL_AFTER:
            xp = bitops.maxpool2_packed(xp)
    xp = xp.reshape(xp.shape[0], -1)  # word order matches pack_linear's K order
    for j in range(len(FC_SIZES) - 1):
        xp = fused_bit_linear(packed["fc"][j], xp, FC_SIZES[j][0],
                              engine=engine, blocks=blocks)
    y = packed_act_linear(packed["fc"][-1], xp, FC_SIZES[-1][0], engine=engine,
                          blocks=blocks)
    return _batchnorm(packed["bn_fc_last"], y)


def pack_bnn_params_megakernel(params: dict, *, use_scale: bool = False) -> dict:
    """Latent float params -> megakernel inference params: the packing
    and folding of :func:`pack_bnn_params_fused`, with the FC trunk's
    interior layers stacked into the chain's ``[L, M_max, KW_max]``
    operands (``fc_stack``) here, once, not per forward. Conv stages
    keep their per-layer tap-aligned params."""
    fused = pack_bnn_params_fused(params, use_scale=use_scale)
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
    use_scale: bool = False,
    blocks: object = AUTO,
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
    ``RAGGED_TILE_N``); logits are the same either way, and for every
    ``blocks`` (the megakernels' clusters). ``use_scale`` as in
    :func:`bnn_apply_fused`.
    """
    xp = first_conv_packed(packed, images, use_scale=use_scale)
    for stage in CONV_STAGES:
        xp = megakernel_conv_stage(
            [packed["conv"][i] for i in stage], xp,
            tuple(3 * 3 * CONV_CHANNELS[i][0] for i in stage),
            pool=stage[-1] in POOL_AFTER, engine=engine, blocks=blocks,
        )
    xp = xp.reshape(xp.shape[0], -1)  # word order matches pack_linear's K order
    y = megakernel_fc_chain(
        packed["fc_stack"], xp, tuple(fin for fin, _ in FC_SIZES[:-1]),
        FC_SIZES[-2][1], final=packed["fc_final"], final_k=FC_SIZES[-1][0],
        engine=engine, blocks=blocks, ragged=ragged,
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
                 blocks: object = AUTO, ragged: bool = False,
                 mesh: object = None):
    """The serving entry point: a ``(packed, images) -> logits`` callable
    over :func:`bnn_apply_fused`, or :func:`bnn_apply_megakernel` for the
    megakernel engines (which ignore ``conv_impl``: their convs are
    direct), with the kernel path and tiling (``blocks``) bound at
    closure time, run under ``torch.inference_mode``. ``ragged`` (the
    continuous scheduler's executors) sends the megakernel FC trunk
    through the masked-tail path; the other engines are exact-shape and
    ignore it. The serving executors capture one CUDA graph of it per
    batch shape (``serve.executor``).

    ``mesh`` (a ``launch.mesh.ServingMesh``, DESIGN.md §10) makes it a
    ``(replicas, images) -> logits`` callable, ``replicas`` from
    ``distributed.sharding.replicate(packed, mesh)``: the batch splits
    into one contiguous shard a device (``ValueError`` when the rows do
    not divide the mesh, as ``shard_map`` raises), every shard is
    launched on its replica before any is collected, and the logits are
    gathered on the host in mesh order. Each shard runs the
    single-device forward, so the logits equal the unsharded forward's
    bit for bit."""
    if engine not in SERVE_ENGINES:
        raise ValueError(f"unknown serving engine {engine!r}; "
                         f"expected one of {SERVE_ENGINES}")

    if engine.startswith("megakernel"):
        inner = "xnor" if engine == "megakernel" else "xla"

        def apply_fn(packed: dict, images: torch.Tensor) -> torch.Tensor:
            with torch.inference_mode():
                return bnn_apply_megakernel(packed, images, engine=inner,
                                            blocks=blocks, ragged=ragged)
    else:

        def apply_fn(packed: dict, images: torch.Tensor) -> torch.Tensor:
            with torch.inference_mode():
                return bnn_apply_fused(packed, images, engine=engine,
                                       conv_impl=conv_impl, blocks=blocks)

    if mesh is None:
        return apply_fn

    from repro_torch.distributed.sharding import shard_rows

    def sharded_fn(replicas: list, images: torch.Tensor) -> torch.Tensor:
        shards = images.split(shard_rows(images.shape[0], len(mesh)))
        outs = [apply_fn(p, x.to(d, non_blocking=True))
                for p, x, d in zip(replicas, shards, mesh.devices)]
        return torch.cat([y.cpu() for y in outs])

    return sharded_fn


@torch.no_grad()
def pack_trained_params(params: dict, *, use_scale: bool = False,
                        probe_images: torch.Tensor | None = None,
                        probe_conv_impls: tuple[str, ...] = ("im2col", "direct"),
                        ) -> dict:
    """Export trained latents into the packed formats the engines take:
    ``"packed"`` (:func:`pack_bnn_params`, the unfused PACKED path),
    ``"fused"`` (:func:`pack_bnn_params_fused`, serving engines
    ``"xla"``/``"xnor"``) and ``"megakernel"``
    (:func:`pack_bnn_params_megakernel`).

    With ``probe_images`` the export is verified before it ships: the
    logits of ``packed/xla``, of the fused chain on both engines x
    ``probe_conv_impls`` and of both megakernel engines must equal the
    float-boundary forward's (:func:`bnn_eval_logits`) bit for bit, or a
    ValueError names each diverging engine. On CUDA probe images the
    ``xnor`` and ``megakernel`` engines launch the kernels. Runs under
    ``torch.no_grad()``, so params that require grad never reach the
    kernels' grad guard."""
    out = {
        "packed": pack_bnn_params(params, use_scale=use_scale),
        "fused": pack_bnn_params_fused(params, use_scale=use_scale),
        "megakernel": pack_bnn_params_megakernel(params, use_scale=use_scale),
    }
    if probe_images is None:
        return out

    want = bnn_eval_logits(params, probe_images, use_scale=use_scale)
    got = {"packed/xla": bnn_apply(
        out["packed"], probe_images,
        BNNConfig(mode=QuantMode.PACKED, engine="xla", use_scale=use_scale))}
    for engine in ("xla", "xnor"):
        for conv_impl in probe_conv_impls:
            got[f"fused/{engine}/{conv_impl}"] = bnn_apply_fused(
                out["fused"], probe_images, engine=engine,
                conv_impl=conv_impl, use_scale=use_scale)
    for engine, inner in (("megakernel", "xnor"), ("megakernel_xla", "xla")):
        got[engine] = bnn_apply_megakernel(
            out["megakernel"], probe_images, engine=inner,
            use_scale=use_scale)
    bad = {k: int((v != want).sum()) for k, v in got.items()
           if not torch.equal(v, want)}
    if bad:
        raise ValueError(
            "pack_trained_params bit-identity check failed — packed "
            "logits diverge from the trained float-boundary forward on "
            f"the probe batch: {bad} (engine -> #differing logits). "
            "The exported model would not serve what was trained.")
    return out


# --- sign-form checkpoint (format "bnn-sign-v1" of repro.core.bnn) ---------
# A trained BNN's forward depends on its latent weights only through
# their sign, so the checkpoint for serving stores 1 bit per weight
# (np.packbits of w >= 0) plus float32 biases and BN buffers, ~32x
# smaller than the latents. Loading gives ±1.0 latent weights, whose
# forward is bit-identical to the trained model's (sign(sign(w)) ==
# sign(w) with sign(0) := +1). Not for resuming training: the latent
# magnitudes are gone (checkpoint/manager.py keeps them).

BINARY_CKPT_FORMAT = "bnn-sign-v1"


def save_binary_checkpoint(path, params: dict) -> None:
    """Write the sign-form checkpoint (``.npz``) of latent params."""
    arrays: dict[str, Any] = {"format": np.asarray(BINARY_CKPT_FORMAT)}

    def host(t) -> np.ndarray:
        return t.detach().cpu().numpy()

    for group in ("conv", "fc"):
        for i, p in enumerate(params[group]):
            w = host(p["w"])
            arrays[f"{group}{i}/w_bits"] = np.packbits((w >= 0).reshape(-1))
            arrays[f"{group}{i}/w_shape"] = np.asarray(w.shape)
            if "b" in p:
                arrays[f"{group}{i}/b"] = host(p["b"]).astype(np.float32)
    for group in ("bn_conv", "bn_fc"):
        for i, bn in enumerate(params[group]):
            for k, v in bn.items():
                arrays[f"{group}{i}/{k}"] = host(v).astype(np.float32)
    np.savez_compressed(path, **arrays)


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
