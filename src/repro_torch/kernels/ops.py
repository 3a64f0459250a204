"""Wrappers around the CUDA kernels of ``csrc/``, with a launch counter
each.

A wrapper checks dtype, shape, contiguity and device, and raises on
what its kernel does not take: a transposed view must be made
contiguous by the caller, except for the real-valued inputs of
``pack_rows`` (any stride along N, unit stride along K),
``unpack_gemm`` (any strides) and ``ssm_scan_chunk`` (batch and time
strides), which their kernels read in place. On CPU tensors it returns
the kernel's plain twin from ``repro_torch.core.bitops`` (from
``kernels.ref`` for the scan, flash attention and the mLSTM); on CUDA
tensors it launches the kernel or raises — it never falls back. No
kernel has a backward: a wrapper raises on CUDA operands that require
grad while grad mode is on. Outputs and scratch are allocated here with
``torch.empty``; the kernel runs on PyTorch's current stream.

``LAUNCHES[name]`` counts the launches of each kernel, and nothing
else; :func:`reset_launches` sets every count to 0.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core import bitops
from repro_torch.core.bitops import PACK_BITS, PACKED_DTYPE
from repro_torch.core.im2col import conv_out_size
from repro_torch.kernels import build, ref

LAUNCHES = {"xnor_gemm": 0, "fused_xnor_gemm": 0, "fused_direct_conv": 0,
            "megakernel_conv_stage": 0, "megakernel_chain": 0,
            "pack_rows": 0, "direct_conv": 0, "unpack_gemm": 0,
            "ssm_scan_chunk": 0, "flash_attention": 0, "mlstm_chunked": 0}

# Batch tile of the chain's masked-tail path: the batch pads to a multiple
# of it. It is the compiled tile of csrc/megakernel_chain.cu (kChainTileN),
# where one thread-block cluster serves one tile of 8 columns.
RAGGED_TILE_N = 8
# Largest portable thread-block cluster on Hopper.
MAX_CLUSTER = 8

# Dynamic shared memory one block may use on Hopper (232,448 bytes).
MAX_SMEM_BYTES = 227 * 1024
_INT_MAX = 2**31 - 1
# Largest y dimension of a CUDA grid.
_GRID_Y_MAX = 65535


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


def _check_strided(name: str, t: torch.Tensor, dtypes, ndim: int) -> None:
    """``_check`` for an operand its kernel reads through its strides: any
    strides (a transposed view included), sizes that fit 32-bit ints."""
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be one of {dtypes}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if max(t.shape, default=0) > _INT_MAX:
        raise ValueError(f"{name} has a dimension past 2^31; the kernels "
                         "index with 32-bit sizes")


def _check_no_grad(kernel: str, *tensors: torch.Tensor) -> None:
    """Raise if autograd would record a call of ``kernel`` on ``tensors``:
    grad mode is on and an operand requires grad. No kernel of the port
    has a backward, so its output would carry no gradient at all."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: an operand requires grad, but the CUDA kernel has no "
            "backward and its output would silently get no gradient; call it "
            "under torch.no_grad() (or on detached tensors)")


def _on_cuda(kernel: str, *tensors: torch.Tensor) -> bool:
    """True if every operand is on one CUDA device, False if all are on
    the CPU; raises for any other mix, and for CUDA operands that autograd
    would track (``_check_no_grad``). On the CPU the twin, plain torch,
    differentiates as usual."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"operands on different devices: {sorted(map(str, devices))}")
    (dev,) = devices
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    _check_no_grad(kernel, *tensors)
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
    if not _on_cuda("xnor_gemm", wp, xp):
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
    if not _on_cuda("fused_xnor_gemm", wp, xp, a, b):
        return bitops.fused_xnor_layer(wp, xp, k_bits, a, b)
    mw = -(-m // PACK_BITS)
    out = torch.empty((mw, n), dtype=torch.int32, device=wp.device)
    if m and n:
        with torch.cuda.device(wp.device):
            splits = build.load("repro_fused_xnor_gemm_splits")(m, kw, n)
            # split K: each split's integer counts, added in order after
            partial = (torch.empty((splits, n, m), dtype=torch.int32,
                                   device=wp.device) if splits > 1 else None)
            rc = build.load("repro_fused_xnor_gemm")(
                wp.data_ptr(), xp.data_ptr(), a.data_ptr(), b.data_ptr(),
                out.data_ptr(), None if partial is None else partial.data_ptr(),
                m, kw, n, int(k_bits), splits, _stream(wp.device))
        _raise_on(rc, "fused_xnor_gemm")
        LAUNCHES["fused_xnor_gemm"] += 1
    return out


def _check_direct_conv(wp: torch.Tensor, xp: torch.Tensor, kh: int,
                       kw: int) -> None:
    _check("wp", wp, PACKED_DTYPE, 2)
    _check("xp", xp, PACKED_DTYPE, 4)
    cw, kwords = xp.shape[3], wp.shape[1]
    if kwords != kh * kw * cw:
        raise ValueError(
            f"filter words {kwords} != kh*kw*CW = {kh}*{kw}*{cw} — direct "
            "conv needs tap-aligned packed filters (pack_conv_aligned)")


def _direct_conv_out(name: str, xp: torch.Tensor, out_c: int, *, kh: int,
                     kw: int, stride: int, pad: int) -> tuple[int, int]:
    """``(oh, ow)`` of a direct conv; raises where the output ``[n, oh,
    ow, out_c]`` exceeds 32-bit sizes."""
    n, h, w, _ = xp.shape
    oh = conv_out_size(h, kh, stride, pad)
    ow = conv_out_size(w, kw, stride, pad)
    if n * oh * ow * out_c > _INT_MAX:
        raise ValueError(f"{name} output [{n}, {oh}, {ow}, {out_c}] exceeds "
                         "32-bit sizes")
    return oh, ow


def fused_direct_conv(wp: torch.Tensor, xp: torch.Tensor, k_bits: int,
                      a: torch.Tensor, b: torch.Tensor, *, kh: int, kw: int,
                      stride: int = 1, pad: int = 0) -> torch.Tensor:
    """Fused direct conv: channel-packed ``[N, H, W, CW]`` x tap-aligned
    filters ``[D, kH*kW*CW]``, per-channel affine ``a, b [D]`` -> packed
    ``[N, OH, OW, ceil(D/32)]``. The spatial border is all-ones words (the
    kernel lays it down; the map is read unpadded); channels past D are
    +1 bits."""
    _check_direct_conv(wp, xp, kh, kw)
    d = wp.shape[0]
    _check_affine(a, b, d)
    if not _on_cuda("fused_direct_conv", wp, xp, a, b):
        return bitops.direct_conv_oracle(wp, xp, k_bits, a, b, kh=kh, kw=kw,
                                         stride=stride, pad=pad)
    dw = -(-d // PACK_BITS)
    n, h, w, cw = xp.shape
    oh, ow = _direct_conv_out("fused_direct_conv", xp, dw, kh=kh, kw=kw,
                              stride=stride, pad=pad)
    out = torch.empty((n, oh, ow, dw), dtype=torch.int32, device=xp.device)
    if out.numel():
        with torch.cuda.device(xp.device):
            rc = build.load("repro_fused_direct_conv")(
                xp.data_ptr(), wp.data_ptr(), a.data_ptr(), b.data_ptr(),
                out.data_ptr(), n, h, w, cw, d, kh, kw, stride, pad,
                int(k_bits), _stream(xp.device))
        _raise_on(rc, "fused_direct_conv")
        LAUNCHES["fused_direct_conv"] += 1
    return out


def direct_conv(wp: torch.Tensor, xp: torch.Tensor, k_bits: int, *,
                kh: int, kw: int, stride: int = 1,
                pad: int = 0) -> torch.Tensor:
    """Direct conv without an epilogue (the ``direct_conv_dot`` kernel):
    channel-packed ``[N, H, W, CW]`` x tap-aligned filters ``[D,
    kH*kW*CW]`` -> the int32 ±1 dot ``[N, OH, OW, D]``, for float-boundary
    layers that apply bias and BN themselves. The spatial border is
    all-ones words (the kernel lays it down; the map is read unpadded), as
    in :func:`fused_direct_conv`."""
    _check_direct_conv(wp, xp, kh, kw)
    if not _on_cuda("direct_conv", wp, xp):
        return bitops.direct_conv_dot(wp, xp, k_bits, kh=kh, kw=kw,
                                      stride=stride, pad=pad)
    d = wp.shape[0]
    n, h, w, cw = xp.shape
    oh, ow = _direct_conv_out("direct_conv", xp, d, kh=kh, kw=kw,
                              stride=stride, pad=pad)
    out = torch.empty((n, oh, ow, d), dtype=torch.int32, device=xp.device)
    if out.numel():
        with torch.cuda.device(xp.device):
            rc = build.load("repro_direct_conv_dot")(
                xp.data_ptr(), wp.data_ptr(), out.data_ptr(), n, h, w, cw, d,
                kh, kw, stride, pad, int(k_bits), _stream(xp.device))
        _raise_on(rc, "direct_conv")
        LAUNCHES["direct_conv"] += 1
    return out


def pack_rows(x: torch.Tensor) -> torch.Tensor:
    """Sign-encode float32 ``[K, N]`` along K -> contiguous int32 ``[K/32,
    N]``: bit ``b`` of word ``w`` is ``x[32w + b, n] >= 0`` (LSB-first;
    -0.0 sets it, NaN clears it). ``x`` must be K-contiguous (unit stride
    along K, any stride along N), as the transposed patch matrix
    ``x2d.T`` the layers hand over, which the kernel reads in place."""
    _check_strided("x", x, (torch.float32,), 2)
    k, n = x.shape
    if k % PACK_BITS:
        raise ValueError(f"K={k} must be a multiple of {PACK_BITS}")
    if x.stride(0) != 1:
        raise ValueError(f"x must have unit stride along K (got strides "
                         f"{x.stride()}); pass the transpose of a contiguous "
                         "[N, K] matrix")
    kw = k // PACK_BITS
    if not _on_cuda("pack_rows", x):
        return bitops.pack_bits(x, axis=0).contiguous()
    if kw * n > _INT_MAX or kw > _GRID_Y_MAX:
        raise ValueError(f"pack_rows of [{k}, {n}] exceeds the grid")
    out = torch.empty((kw, n), dtype=PACKED_DTYPE, device=x.device)
    if out.numel():
        with torch.cuda.device(x.device):
            rc = build.load("repro_pack_rows")(
                x.data_ptr(), out.data_ptr(), kw, n, x.stride(1),
                _stream(x.device))
        _raise_on(rc, "pack_rows")
        LAUNCHES["pack_rows"] += 1
    return out


def unpack_gemm(wp: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Packed weights ``[M, KW]`` x real input ``[KW*32, N]`` (float32 or
    bfloat16, any strides) -> float32 ``[M, N]``: the weights unpack to
    ±1 inside the kernel and the dot accumulates in float32. Zero-word K
    pads unpack to -1: pair them with zero rows of ``x``."""
    _check("wp", wp, PACKED_DTYPE, 2)
    _check_strided("x", x, (torch.float32, torch.bfloat16), 2)
    (m, kw), (k, n) = wp.shape, x.shape
    if k != kw * PACK_BITS:
        raise ValueError(f"x has {k} rows, expected KW*32 = {kw * PACK_BITS}")
    if not _on_cuda("unpack_gemm", wp, x):
        return bitops.packed_matmul_unpack(wp, x, compute_dtype=x.dtype)
    if m * n > _INT_MAX:
        raise ValueError(f"unpack_gemm output [{m}, {n}] exceeds the grid")
    out = torch.empty((m, n), dtype=torch.float32, device=wp.device)
    if out.numel():
        with torch.cuda.device(wp.device):
            # Split-K where the output tiles cannot fill the card: the
            # kernel writes each split's total to the scratch, a second
            # kernel adds them in a fixed order.
            splits = build.load("repro_unpack_gemm_splits")(m, kw, n)
            scratch = (torch.empty((splits, m, n), dtype=torch.float32,
                                   device=wp.device) if splits > 1 else None)
            rc = build.load("repro_unpack_gemm")(
                wp.data_ptr(), x.data_ptr(), out.data_ptr(),
                None if scratch is None else scratch.data_ptr(), m, kw, n,
                x.stride(0), x.stride(1), int(x.dtype == torch.bfloat16),
                splits, _stream(wp.device))
        _raise_on(rc, "unpack_gemm")
        LAUNCHES["unpack_gemm"] += 1
    return out


# Widest state (d_state) the scan kernel keeps in registers.
MAX_SCAN_STATE = 32


def ssm_scan_chunk(dt: torch.Tensor, xh: torch.Tensor, bmat: torch.Tensor,
                   cmat: torch.Tensor, a: torch.Tensor,
                   h0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba S6 selective scan over one chunk, carrying ``h``: float32
    ``dt, xh [B, C, di]``, ``bmat, cmat [B, C, ds]``, ``a [di, ds]``,
    ``h0 [B, di, ds]`` -> (``y [B, C, di]``, ``h_last [B, di, ds]``), both
    new and contiguous. ``dt``, ``xh``, ``bmat`` and ``cmat`` are read
    through their batch and time strides (unit stride along the last
    axis), so chunk views of a longer sequence need no copy; ``a`` and
    ``h0`` must be contiguous. ``ds`` up to ``MAX_SCAN_STATE``."""
    for name, x in (("dt", dt), ("xh", xh), ("bmat", bmat), ("cmat", cmat)):
        _check_strided(name, x, (torch.float32,), 3)
        if x.numel() and x.shape[-1] > 1 and x.stride(-1) != 1:
            raise ValueError(f"{name} must have unit stride along its last "
                             f"axis (got strides {x.stride()})")
    _check("a", a, torch.float32, 2)
    _check("h0", h0, torch.float32, 3)
    b, c, di = dt.shape
    ds = a.shape[1]
    for name, x, want in (("xh", xh, (b, c, di)), ("bmat", bmat, (b, c, ds)),
                          ("cmat", cmat, (b, c, ds)), ("a", a, (di, ds)),
                          ("h0", h0, (b, di, ds))):
        if tuple(x.shape) != want:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {want}")
    if not _on_cuda("ssm_scan_chunk", dt, xh, bmat, cmat, a, h0):
        return ref.ssm_scan_chunk_ref(dt, xh, bmat, cmat, a, h0)
    if ds > MAX_SCAN_STATE:
        raise ValueError(f"ssm_scan_chunk keeps at most {MAX_SCAN_STATE} "
                         f"states per channel in registers, got ds={ds}")
    if b > _GRID_Y_MAX or b * c * di > _INT_MAX:
        raise ValueError(f"ssm_scan_chunk of [{b}, {c}, {di}] exceeds the grid")
    y = torch.empty((b, c, di), dtype=torch.float32, device=dt.device)
    h_last = torch.empty((b, di, ds), dtype=torch.float32, device=dt.device)
    if b and di and ds:
        with torch.cuda.device(dt.device):
            rc = build.load("repro_ssm_scan_chunk")(
                dt.data_ptr(), xh.data_ptr(), bmat.data_ptr(), cmat.data_ptr(),
                a.data_ptr(), h0.data_ptr(), y.data_ptr(), h_last.data_ptr(),
                b, c, di, ds, dt.stride(0), dt.stride(1), xh.stride(0),
                xh.stride(1), bmat.stride(0), bmat.stride(1), cmat.stride(0),
                cmat.stride(1), _stream(dt.device))
        _raise_on(rc, "ssm_scan_chunk")
        LAUNCHES["ssm_scan_chunk"] += 1
    return y, h_last


# Keys per KV tile of csrc/flash_attention.cu (kFlashKeys, both types): the
# twin with block_kv = FLASH_TILE rounds where the kernel rounds.
FLASH_TILE = 64
# Query rows per block of csrc/flash_attention.cu (kFlashRowsBf16,
# kFlashRowsF32).
_FLASH_ROWS = {torch.bfloat16: 128, torch.float32: 64}
# Head widths the flash kernel is compiled for.
FLASH_HEAD_DIMS = (16, 32, 64, 128)


def _aligned(name: str, t: torch.Tensor) -> None:
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary (the "
                         "kernel loads 16 bytes at a time)")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Online-softmax attention, the JAX package's ``flash_attention``:
    ``q [BH, Sq, Dh]``, ``k, v [BH, Skv, Dh]``, contiguous, all bfloat16
    or all float32 -> ``[BH, Sq, Dh]`` in q's dtype; causal masks keys past
    the query's position (both counted from 0). Scores, softmax and the
    accumulator are float32, ``p`` is rounded to v's dtype before the PV
    product. On the CPU: ``ref.flash_attention_ref`` with the JAX
    function's default blocks; on the card the kernel tiles keys by
    ``FLASH_TILE`` (its twin: ``block_kv=FLASH_TILE``). Any Sq, Skv; Dh in
    ``FLASH_HEAD_DIMS`` on the card."""
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"q must be bfloat16 or float32, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, q.dtype, 3)
    bh, sq, dh = q.shape
    skv = k.shape[1]
    for name, t in (("k", k), ("v", v)):
        if tuple(t.shape) != (bh, skv, dh):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{(bh, skv, dh)}")
    if not _on_cuda("flash_attention", q, k, v):
        return ref.flash_attention_ref(q, k, v, causal=causal)
    if dh not in FLASH_HEAD_DIMS:
        raise ValueError(f"flash_attention is compiled for Dh in "
                         f"{FLASH_HEAD_DIMS}, got {dh}")
    if bh > _INT_MAX or -(-sq // _FLASH_ROWS[q.dtype]) > _GRID_Y_MAX:
        raise ValueError(f"flash_attention of [{bh}, {sq}, {dh}] exceeds the grid")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _aligned(name, t)
    out = torch.empty_like(q)
    if bh and sq and skv:
        with torch.cuda.device(q.device):
            rc = build.load("repro_flash_attention")(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh,
                sq, skv, dh, int(causal), int(q.dtype == torch.bfloat16),
                dh ** -0.5, _stream(q.device))
        _raise_on(rc, "flash_attention")
        LAUNCHES["flash_attention"] += 1
    elif bh and sq:
        out.zero_()  # no keys: acc and l stay 0, acc / max(l, 1e-30) = 0
    return out


# Longest chunk and most chunks csrc/mlstm_chunk.cu takes, and the rows of
# dk (and columns of dv) one block of its states kernel holds.
MLSTM_MAX_CHUNK, MLSTM_MAX_CHUNKS, MLSTM_TILE = 256, 1024, 128


def mlstm_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  logi: torch.Tensor, logf: torch.Tensor, *,
                  chunk: int = 128) -> tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor, torch.Tensor]:
    """Chunkwise stabilized mLSTM from a zero state, the JAX package's
    ``mlstm_chunked``: float32 contiguous ``q`` (pre-scaled by
    ``dk**-0.5``), ``k [BH, S, dk]``, ``v [BH, S, dv]``, ``logi, logf [BH,
    S]`` -> (y ``[BH, S, dv]``, C ``[BH, dk, dv]``, n ``[BH, 1, dk]``, m
    ``[BH, 1, 1]``), chunks of ``L = min(chunk, S)`` steps; S must be a
    multiple of L. On the CPU: ``ref.mlstm_chunked_ref``. On the card L
    must be a multiple of 8 up to ``MLSTM_MAX_CHUNK``, dk and dv multiples
    of 4; the grid bounds BH x S / L and dk / ``MLSTM_TILE`` by 65535."""
    for name, t, nd in (("q", q, 3), ("k", k, 3), ("v", v, 3),
                        ("logi", logi, 2), ("logf", logf, 2)):
        _check(name, t, torch.float32, nd)
    bh, s, dk = q.shape
    dv = v.shape[-1]
    for name, t, want in (("k", k, (bh, s, dk)), ("v", v, (bh, s, dv)),
                          ("logi", logi, (bh, s)), ("logf", logf, (bh, s))):
        if tuple(t.shape) != want:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {want}")
    if not _on_cuda("mlstm_chunked", q, k, v, logi, logf):
        return ref.mlstm_chunked_ref(q, k, v, logi, logf, chunk=chunk)
    ln = min(chunk, s)
    if ln < 8 or ln % 8 or ln > MLSTM_MAX_CHUNK or s % ln:
        raise ValueError(f"mlstm_chunked on the card needs a chunk that is a "
                         f"multiple of 8 up to {MLSTM_MAX_CHUNK} and divides S; "
                         f"got S={s}, chunk={ln}")
    nc = s // ln
    if dk % 4 or dv % 4 or dk < 4 or nc > MLSTM_MAX_CHUNKS:
        raise ValueError(f"mlstm_chunked on the card needs dk, dv multiples of "
                         f"4 and at most {MLSTM_MAX_CHUNKS} chunks; got dk={dk}, "
                         f"dv={dv}, {nc} chunks")
    if bh * nc > _GRID_Y_MAX or -(-dk // MLSTM_TILE) > _GRID_Y_MAX:
        raise ValueError(f"mlstm_chunked of [{bh}, {s}, {dk}, {dv}] exceeds "
                         "the grid (BH x chunks or dk / 128 past 65535)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _aligned(name, t)
    dev = q.device
    y = torch.empty((bh, s, dv), dtype=torch.float32, device=dev)
    c_out = torch.empty((bh, dk, dv), dtype=torch.float32, device=dev)
    n_out = torch.empty((bh, 1, dk), dtype=torch.float32, device=dev)
    m_out = torch.empty((bh, 1, 1), dtype=torch.float32, device=dev)
    if bh:
        sw = torch.empty((bh, nc, ln, ln), dtype=torch.float32, device=dev)
        gates = torch.empty((4, bh, s), dtype=torch.float32, device=dev)
        decay = torch.empty((bh, nc), dtype=torch.float32, device=dev)
        chunk_ends = torch.empty((bh, nc, 2), dtype=torch.float32, device=dev)
        # the states entering chunks 1.. (503 MB at xlstm-1.3b's training
        # shape, [8, 15, 1024, 1024] float32)
        states = torch.empty((bh, nc - 1, dk, dv), dtype=torch.float32, device=dev)
        nstates = torch.empty((bh, nc - 1, dk), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            rc = build.load("repro_mlstm_chunked")(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), logi.data_ptr(),
                logf.data_ptr(), y.data_ptr(), c_out.data_ptr(),
                n_out.data_ptr(), m_out.data_ptr(), sw.data_ptr(),
                *(gates[i].data_ptr() for i in range(4)), decay.data_ptr(),
                chunk_ends.data_ptr(), states.data_ptr(), nstates.data_ptr(),
                bh, s, ln, dk, dv, _stream(dev))
        _raise_on(rc, "mlstm_chunked")
        LAUNCHES["mlstm_chunked"] += 1
    return y, c_out, n_out, m_out


def _ints(values) -> ctypes.Array:
    return (ctypes.c_int * len(values))(*values)


def _ptrs(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


# (kernel, geometry) -> (smem bytes, clusters the device holds at once)
_LIMITS: dict[tuple, tuple[int, int]] = {}


def _check_limits(kernel: str, symbol: str, dev: torch.device, *args) -> None:
    """Ask the library for one CTA's shared memory and the number of
    clusters the device can run at once (``args``: the geometry, int
    arrays as tuples); raise if the launch cannot run."""
    key = (kernel, dev.index, args)
    if key not in _LIMITS:
        smem, clusters = (ctypes.c_int * 1)(), (ctypes.c_int * 1)()
        c_args = [_ints(a) if isinstance(a, tuple) else a for a in args]
        with torch.cuda.device(dev):
            rc = build.load(symbol)(*c_args, smem, clusters)
        _raise_on(rc, f"{kernel} occupancy query")
        _LIMITS[key] = (smem[0], clusters[0])
    smem, clusters = _LIMITS[key]
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"{kernel} needs {smem} B of shared memory per block "
                         f"(> {MAX_SMEM_BYTES})")
    if clusters < 1:
        raise RuntimeError(f"{kernel}: the device cannot hold one cluster of "
                           f"this launch ({smem} B of shared memory per block)")


def megakernel_conv_stage(xp: torch.Tensor, weights, a, b, k_bits, *,
                          kh: int = 3, kw: int = 3, pad: int = 1,
                          pool: bool = True) -> torch.Tensor:
    """One conv stage in one launch: ``len(weights)`` fused direct convs
    (stride 1) and, when ``pool``, the 2x2 packed-OR maxpool.

    ``xp [N, H, W, CW]`` channel-packed; ``weights[l] [D_l, kH*kW*CW_l]``
    tap-aligned filters with ``CW_{l+1} = ceil(D_l/32)``; ``a[l]``,
    ``b[l] [D_l]`` folded affines; ``k_bits[l]`` the true ``kH*kW*C_l``.
    The all-ones spatial border (``pad``, before every conv) is laid down
    by the kernel, which reads the map unpadded; the ``a=0, b=+1``
    padding of D to whole words is applied here. Returns
    packed ``[N, OH', OW', ceil(D_last/32)]``.
    """
    weights, a, b, k_bits = tuple(weights), tuple(a), tuple(b), tuple(k_bits)
    n_layers = len(weights)
    if not 1 <= n_layers <= 4 or not len(a) == len(b) == len(k_bits) == n_layers:
        raise ValueError("a conv stage takes 1-4 convs, each with weights, "
                         "a, b and k_bits")
    _check("xp", xp, PACKED_DTYPE, 4)
    n, h, w, cw = xp.shape
    cws, cw_in = [], cw
    for l, (wl, al, bl) in enumerate(zip(weights, a, b)):
        _check(f"weights[{l}]", wl, PACKED_DTYPE, 2)
        d, kwords = wl.shape
        if kwords != kh * kw * cw_in:
            raise ValueError(f"conv {l}: filter words {kwords} != kh*kw*CW = "
                             f"{kh}*{kw}*{cw_in} (tap-aligned filters)")
        _check_affine(al, bl, d)
        cws.append(cw_in)
        cw_in = -(-d // PACK_BITS)
    if not _on_cuda("megakernel_conv_stage", xp, *weights, *a, *b):
        return bitops.conv_stage_xla(xp, weights, a, b, k_bits, kh=kh, kw=kw,
                                     pad=pad, pool=pool)
    hp, wp_sp = h + 2 * pad, w + 2 * pad
    oh, ow = hp - kh + 1, wp_sp - kw + 1
    for _ in range(n_layers - 1):
        oh, ow = oh + 2 * pad - kh + 1, ow + 2 * pad - kw + 1
    if oh < 1 or ow < 1:
        raise ValueError(f"the stage's maps vanish: {oh}x{ow} output")
    if pool and (oh % 2 or ow % 2):
        raise ValueError(f"2x2 pool needs an even output map, got {oh}x{ow}")
    ws, aps, bps, d_words = [], [], [], []
    for wl, al, bl in zip(weights, a, b):
        pd = -wl.shape[0] % PACK_BITS
        if pd:
            wl = torch.nn.functional.pad(wl, (0, 0, 0, pd))
            al = torch.nn.functional.pad(al, (0, pd))
            bl = torch.nn.functional.pad(bl, (0, pd), value=1.0)
        ws.append(wl)
        aps.append(al)
        bps.append(bl)
        d_words.append(wl.shape[0] // PACK_BITS)
    # A cluster of 8 CTAs an image, in channel groups of gcd(8, D_l/32).
    cluster = MAX_CLUSTER
    _check_limits("megakernel_conv_stage", "repro_megakernel_conv_stage_limits",
                  xp.device, tuple(d_words), tuple(cws), n_layers, hp, wp_sp,
                  kh, kw, pad, cluster)
    out_h, out_w = (oh // 2, ow // 2) if pool else (oh, ow)
    out = torch.empty((n, out_h, out_w, d_words[-1]), dtype=torch.int32,
                      device=xp.device)
    if n:
        if n * cluster > _INT_MAX:
            raise ValueError(f"{n} images exceed the grid")
        with torch.cuda.device(xp.device):
            rc = build.load("repro_megakernel_conv_stage")(
                xp.data_ptr(), out.data_ptr(), _ptrs(ws), _ptrs(aps),
                _ptrs(bps), _ints(d_words), _ints(cws), _ints(k_bits),
                n_layers, n, hp, wp_sp, kh, kw, pad, int(pool), cluster,
                _stream(xp.device))
        _raise_on(rc, "megakernel_conv_stage")
        LAUNCHES["megakernel_conv_stage"] += 1
    return out


def megakernel_chain(w_stack: torch.Tensor, a_stack: torch.Tensor,
                     b_stack: torch.Tensor, k_bits, xp: torch.Tensor,
                     m_out: int, *, final_wp: torch.Tensor | None = None,
                     final_k_bits: int = 0, ragged_tile: int | None = None,
                     n_real: int | None = None) -> torch.Tensor:
    """``L`` stacked fused binary layers, then optionally the
    epilogue-free head GEMM, in one launch.

    ``w_stack [L, M_max, KW_max]``, ``a_stack``/``b_stack [L, M_max]``
    from ``core.layers.stack_chain_layers``; ``k_bits`` the true K of
    each layer; ``xp [KW_in, N]`` packed activations (K-pad bits +1),
    grown here to ``KW_act = max(KW_max, M_max/32)`` all-ones rows and
    N padded to the batch tile. Returns packed ``[ceil(m_out/32), N]``,
    or with ``final_wp [Mf, KWf]`` the int32 ±1 dot ``[Mf, N]``.

    ``ragged_tile`` selects the masked-tail path: the batch pads only to
    that tile, and every output column at or after ``n_real`` (default
    N) is 0 — pass a tile-padded ``xp`` and the true ``n_real`` to see
    the pad columns zeroed. Real columns are the same on both paths.
    """
    _check("w_stack", w_stack, PACKED_DTYPE, 3)
    _check("xp", xp, PACKED_DTYPE, 2)
    n_layers, m_max, kw_max = w_stack.shape
    kw_in, n = xp.shape
    k_bits = tuple(int(k) for k in k_bits)
    if m_max % PACK_BITS or len(k_bits) != n_layers or not 1 <= n_layers <= 8:
        raise ValueError(f"w_stack {tuple(w_stack.shape)} needs M_max % 32 == 0 "
                         f"and 1-8 layers, one k_bits each (got {len(k_bits)})")
    for name, t in (("a_stack", a_stack), ("b_stack", b_stack)):
        _check(name, t, torch.float32, 2)
        if tuple(t.shape) != (n_layers, m_max):
            raise ValueError(f"{name} {tuple(t.shape)} != {(n_layers, m_max)}")
    kw_act = max(kw_max, m_max // PACK_BITS)
    if kw_in > kw_act:
        raise ValueError(f"xp has {kw_in} words, more than KW_act = {kw_act}")
    mf = kwf = 0
    if final_wp is not None:
        _check("final_wp", final_wp, PACKED_DTYPE, 2)
        mf, kwf = final_wp.shape
        if kwf > kw_act:
            raise ValueError(f"final_wp has {kwf} words, more than KW_act = {kw_act}")
    if n_real is not None and ragged_tile is None:
        raise ValueError("n_real needs ragged_tile (the masked-tail path)")
    n_real = n if n_real is None else int(n_real)
    rows = mf if final_wp is not None else -(-m_out // PACK_BITS)
    operands = [w_stack, a_stack, b_stack, xp]
    if final_wp is not None:
        operands.append(final_wp)
    if not _on_cuda("megakernel_chain", *operands):
        if ragged_tile is None:
            return bitops.megakernel_chain_xla(
                w_stack, a_stack, b_stack, k_bits, xp, m_out,
                final_wp=final_wp, final_k_bits=final_k_bits)
        pn = -n % max(1, int(ragged_tile))
        xpad = torch.nn.functional.pad(xp, (0, pn), value=-1) if pn else xp
        return bitops.megakernel_chain_ragged_xla(
            w_stack, a_stack, b_stack, k_bits, xpad, m_out, n_real,
            final_wp=final_wp, final_k_bits=final_k_bits)[:rows, :n]
    n_pad = -(-n // RAGGED_TILE_N) * RAGGED_TILE_N
    if kw_act - kw_in or n_pad - n:
        xp = torch.nn.functional.pad(xp, (0, n_pad - n, 0, kw_act - kw_in),
                                     value=-1)
    kw_layer = [min(kw_max, -(-k // PACK_BITS)) for k in k_bits]
    cluster = math.gcd(MAX_CLUSTER, m_max // PACK_BITS)
    _check_limits("megakernel_chain", "repro_megakernel_chain_limits",
                  xp.device, tuple(kw_layer), n_layers, m_max, kw_act, mf, kwf,
                  cluster)
    out_rows = mf if final_wp is not None else m_max // PACK_BITS
    out = torch.empty((out_rows, n_pad), dtype=torch.int32, device=xp.device)
    if n:
        with torch.cuda.device(xp.device):
            rc = build.load("repro_megakernel_chain")(
                w_stack.data_ptr(), a_stack.data_ptr(), b_stack.data_ptr(),
                xp.data_ptr(),
                final_wp.data_ptr() if final_wp is not None else None,
                out.data_ptr(), _ints(kw_layer), _ints(k_bits), n_layers,
                m_max, kw_max, kw_act, mf, kwf, int(final_k_bits), n_pad,
                n_real, cluster, _stream(xp.device))
        _raise_on(rc, "megakernel_chain")
        LAUNCHES["megakernel_chain"] += 1
    out = out[:rows]
    return out if n_pad == n else out[:, :n]


__all__ = ["LAUNCHES", "reset_launches", "xnor_gemm", "fused_xnor_gemm",
           "fused_direct_conv", "megakernel_conv_stage", "megakernel_chain",
           "pack_rows", "direct_conv", "unpack_gemm", "ssm_scan_chunk",
           "flash_attention", "mlstm_chunked", "RAGGED_TILE_N",
           "MAX_SCAN_STATE", "FLASH_TILE", "FLASH_HEAD_DIMS"]
