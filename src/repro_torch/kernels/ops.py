"""Wrappers around the CUDA kernels of ``csrc/``, with a launch counter
each.

A wrapper checks dtype, shape, contiguity and device, and raises on
what its kernel does not take: a transposed view must be made
contiguous by the caller. On CPU tensors it returns the kernel's plain
twin from ``repro_torch.core.bitops``; on CUDA tensors it launches the
kernel or raises — it never falls back. Outputs are allocated here with
``torch.empty``; the kernel runs on PyTorch's current stream.

``LAUNCHES[name]`` counts the launches of each kernel, and nothing
else; :func:`reset_launches` sets every count to 0.
"""

from __future__ import annotations

import torch

from repro_torch.core import bitops
from repro_torch.core.bitops import PACK_BITS, PACKED_DTYPE
from repro_torch.core.im2col import conv_out_size
from repro_torch.kernels import build

LAUNCHES = {"xnor_gemm": 0, "fused_xnor_gemm": 0, "fused_direct_conv": 0}

# Dynamic shared memory one block may use on Hopper (232,448 bytes).
MAX_SMEM_BYTES = 227 * 1024
_INT_MAX = 2**31 - 1


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous (got strides "
                         f"{t.stride()}); call .contiguous() first")
    if t.numel() > _INT_MAX:
        raise ValueError(f"{name} has {t.numel()} elements; the kernels "
                         "index with 32-bit sizes")


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True if every operand is on one CUDA device, False if all are on
    the CPU; raises for any other mix."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"operands on different devices: {sorted(map(str, devices))}")
    (dev,) = devices
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return True


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _raise_on(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {rc}")


def xnor_gemm(wp: torch.Tensor, xp: torch.Tensor, k_bits: int) -> torch.Tensor:
    """Packed ``[M, KW] x [KW, N]`` -> int32 ``[M, N]`` ±1 dot
    (``2*popcount(xnor) - k_bits``; ``k_bits`` is the true K)."""
    _check("wp", wp, PACKED_DTYPE, 2)
    _check("xp", xp, PACKED_DTYPE, 2)
    (m, kw), (kw2, n) = wp.shape, xp.shape
    if kw != kw2:
        raise ValueError(f"contraction mismatch: {tuple(wp.shape)} x {tuple(xp.shape)}")
    if not _on_cuda(wp, xp):
        return bitops.xnor_popcount_matmul(wp, xp, k_bits)
    out = torch.empty((m, n), dtype=torch.int32, device=wp.device)
    if m and n:
        with torch.cuda.device(wp.device):
            rc = build.load("repro_xnor_gemm")(
                wp.data_ptr(), xp.data_ptr(), out.data_ptr(), m, kw, n,
                int(k_bits), _stream(wp.device))
        _raise_on(rc, "xnor_gemm")
        LAUNCHES["xnor_gemm"] += 1
    return out


def _check_affine(a: torch.Tensor, b: torch.Tensor, rows: int) -> None:
    for name, t in (("a", a), ("b", b)):
        _check(name, t, torch.float32, 1)
        if t.shape[0] != rows:
            raise ValueError(f"{name} has {t.shape[0]} rows, expected {rows}")


def fused_xnor_gemm(wp: torch.Tensor, xp: torch.Tensor, k_bits: int,
                    a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Fused binary layer: packed ``[M, KW] x [KW, N]``, per-row affine
    ``a, b [M]`` -> packed int32 ``[ceil(M/32), N]`` of
    ``sign(a*dot + b)`` repacked along M; rows past M are +1 bits."""
    _check("wp", wp, PACKED_DTYPE, 2)
    _check("xp", xp, PACKED_DTYPE, 2)
    (m, kw), (kw2, n) = wp.shape, xp.shape
    if kw != kw2:
        raise ValueError(f"contraction mismatch: {tuple(wp.shape)} x {tuple(xp.shape)}")
    _check_affine(a, b, m)
    if not _on_cuda(wp, xp, a, b):
        return bitops.fused_xnor_layer(wp, xp, k_bits, a, b)
    mw = -(-m // PACK_BITS)
    out = torch.empty((mw, n), dtype=torch.int32, device=wp.device)
    if m and n:
        with torch.cuda.device(wp.device):
            rc = build.load("repro_fused_xnor_gemm")(
                wp.data_ptr(), xp.data_ptr(), a.data_ptr(), b.data_ptr(),
                out.data_ptr(), m, kw, n, int(k_bits), _stream(wp.device))
        _raise_on(rc, "fused_xnor_gemm")
        LAUNCHES["fused_xnor_gemm"] += 1
    return out


def fused_direct_conv(wp: torch.Tensor, xp: torch.Tensor, k_bits: int,
                      a: torch.Tensor, b: torch.Tensor, *, kh: int, kw: int,
                      stride: int = 1, pad: int = 0) -> torch.Tensor:
    """Fused direct conv: channel-packed ``[N, H, W, CW]`` x tap-aligned
    filters ``[D, kH*kW*CW]``, per-channel affine ``a, b [D]`` -> packed
    ``[N, OH, OW, ceil(D/32)]``. The spatial border pads with all-ones
    words here; channels past D are +1 bits."""
    _check("wp", wp, PACKED_DTYPE, 2)
    _check("xp", xp, PACKED_DTYPE, 4)
    n, h, w, cw = xp.shape
    d, kwords = wp.shape
    if kwords != kh * kw * cw:
        raise ValueError(
            f"filter words {kwords} != kh*kw*CW = {kh}*{kw}*{cw} — direct "
            "conv needs tap-aligned packed filters (pack_conv_aligned)")
    _check_affine(a, b, d)
    if not _on_cuda(wp, xp, a, b):
        return bitops.direct_conv_oracle(wp, xp, k_bits, a, b, kh=kh, kw=kw,
                                         stride=stride, pad=pad)
    oh = conv_out_size(h, kh, stride, pad)
    ow = conv_out_size(w, kw, stride, pad)
    hp, wp_sp = h + 2 * pad, w + 2 * pad
    smem = build.load("repro_fused_direct_conv_smem_bytes")(cw, wp_sp, kh, kw)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"fused_direct_conv needs {smem} B of shared memory "
                         f"per block (> {MAX_SMEM_BYTES}); use conv_impl='im2col'")
    if n * oh > _INT_MAX:
        raise ValueError(f"N*OH = {n * oh} exceeds the grid")
    xpad = xp
    if pad:
        xpad = torch.nn.functional.pad(xp, (0, 0, pad, pad, pad, pad), value=-1)
    out = torch.empty((n, oh, ow, -(-d // PACK_BITS)), dtype=torch.int32,
                      device=xp.device)
    if out.numel():
        with torch.cuda.device(xp.device):
            rc = build.load("repro_fused_direct_conv")(
                xpad.data_ptr(), wp.data_ptr(), a.data_ptr(), b.data_ptr(),
                out.data_ptr(), n, hp, wp_sp, cw, d, kh, kw, stride,
                int(k_bits), _stream(xp.device))
        _raise_on(rc, "fused_direct_conv")
        LAUNCHES["fused_direct_conv"] += 1
    return out


__all__ = ["LAUNCHES", "reset_launches", "xnor_gemm", "fused_xnor_gemm",
           "fused_direct_conv"]
