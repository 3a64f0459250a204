"""Bit-packing and xnor-popcount primitives: the plain-PyTorch twins.

Same encoding as the JAX package's ``repro.core.bitops``:

* binary values are {-1, +1}; encodings are {0, 1} with ``1 <-> +1``,
* 32 encodings pack into one ``int32`` word, LSB-first along the packed
  axis (bit 31 set makes a negative word),
* ``a_ij = 2 * sum_k popcount(~(w_ik ^ x_kj)) - K`` is the exact ±1 dot.

Everything here is device-agnostic tensor code. It is the port's
``xla`` serving engine and the oracle every CUDA kernel in
``repro_torch.kernels`` is held to, bit for bit.

Two torch facts shape the code: torch has no popcount op (SWAR in int64
below), and ``sum`` over int32 promotes to int64, so every repack wraps
back to int32 explicitly.
"""

from __future__ import annotations

import torch

from repro_torch.core.im2col import conv_out_size

PACK_BITS = 32
PACKED_DTYPE = torch.int32

__all__ = [
    "PACK_BITS",
    "PACKED_DTYPE",
    "pack_bits",
    "pack_channels",
    "unpack_bits",
    "popcount",
    "xnor_popcount_matmul",
    "packed_matmul_unpack",
    "fused_xnor_layer",
    "direct_conv_dot",
    "direct_conv_oracle",
    "maxpool2_packed",
    "megakernel_chain_xla",
    "megakernel_chain_ragged_xla",
    "conv_stage_xla",
]

# Elements of the int64 [M, g, N] popcount intermediate one block of
# xnor_popcount_matmul may hold (2 MiB: blocks that stay in cache run
# several times faster on the CPU than larger ones).
_BLOCK_ELEMS = 1 << 18


def _wrap_int32(words: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> the int32 with the same bit pattern."""
    return (words - ((words >> 31) << 32)).to(PACKED_DTYPE)


def pack_bits(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Pack the sign bits of ``x`` along ``axis`` into int32 words.

    ``bit = 1 if x >= 0 else 0`` (sign(0) := +1). ``x.shape[axis]`` must
    be a multiple of 32. Bit ``b`` of word ``w`` encodes element
    ``w * 32 + b``.
    """
    axis = axis % x.ndim
    k = x.shape[axis]
    if k % PACK_BITS != 0:
        raise ValueError(f"pack axis length {k} not a multiple of {PACK_BITS}")
    x = torch.movedim(x, axis, -1)
    bits = (x >= 0).to(torch.int64)
    bits = bits.reshape(*x.shape[:-1], k // PACK_BITS, PACK_BITS)
    shifts = torch.arange(PACK_BITS, dtype=torch.int64, device=x.device)
    words = _wrap_int32((bits << shifts).sum(dim=-1))
    return torch.movedim(words, -1, axis)


def pack_channels(x: torch.Tensor, *, pad_value: float = 1.0) -> torch.Tensor:
    """Channel-pack ``[..., C]`` reals into ``[..., ceil(C/32)]`` words;
    the tail of the last word takes the sign bit of ``pad_value``."""
    pad = -x.shape[-1] % PACK_BITS
    if pad:
        x = torch.nn.functional.pad(x, (0, pad), value=pad_value)
    return pack_bits(x, axis=-1)


def unpack_bits(words: torch.Tensor, axis: int = -1,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: int32 words -> ±1 values."""
    axis = axis % words.ndim
    w = torch.movedim(words, axis, -1)
    shifts = torch.arange(PACK_BITS, dtype=torch.int32, device=w.device)
    bits = (w[..., None] >> shifts) & 1
    vals = (2 * bits - 1).to(dtype)
    vals = vals.reshape(*w.shape[:-1], w.shape[-1] * PACK_BITS)
    return torch.movedim(vals, -1, axis)


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Population count of each int32 word's bit pattern -> int64.

    SWAR in int64 on the word's low 32 bits, so the sign extension of a
    negative word never reaches the count.
    """
    v = x.to(torch.int64).bitwise_and_(0xFFFFFFFF)
    v -= (v >> 1).bitwise_and_(0x55555555)
    v = (v & 0x33333333).add_((v >> 2).bitwise_and_(0x33333333))
    v = (v + (v >> 4)).bitwise_and_(0x0F0F0F0F)
    v *= 0x01010101
    return v.bitwise_and_(0xFFFFFFFF) >> 24


def xnor_popcount_matmul(wp: torch.Tensor, xp: torch.Tensor,
                         k_bits: int) -> torch.Tensor:
    """Packed ``[M, KW] x [KW, N]`` -> int32 ``[M, N]``:
    ``2 * sum_k popcount(~(w_ik ^ x_kj)) - k_bits``.

    Blocked over KW so the int64 ``[M, g, N]`` intermediate stays
    bounded. ``k_bits`` is the true contraction length; K pads must be
    xnor-neutral (weight word 0 against activation word -1).
    """
    m, kw = wp.shape
    kw2, n = xp.shape
    if kw != kw2:
        raise ValueError(f"contraction mismatch: {tuple(wp.shape)} x "
                         f"{tuple(xp.shape)}")
    g = max(1, min(kw, _BLOCK_ELEMS // max(1, m * n)))
    acc = torch.zeros((m, n), dtype=torch.int64, device=wp.device)
    for k0 in range(0, kw, g):
        wb = wp[:, k0:k0 + g, None]
        xb = xp[None, k0:k0 + g, :]
        acc += popcount(~(wb ^ xb)).sum(dim=1)
    return (2 * acc - k_bits).to(torch.int32)


def packed_matmul_unpack(wp: torch.Tensor, x: torch.Tensor, *,
                         compute_dtype: torch.dtype = torch.bfloat16,
                         accum_dtype: torch.dtype = torch.float32
                         ) -> torch.Tensor:
    """Packed weights ``[M, KW]`` x real or ±1 input ``[KW*32, N]`` ->
    ``[M, N]`` in ``accum_dtype``: the weights unpack to ±1 in
    ``compute_dtype``, ``x`` rounds to it, and the dot accumulates in
    ``accum_dtype`` (the JAX package's ``preferred_element_type``). This
    is the PACKED ``xla`` engine and the plain twin of the
    ``unpack_gemm`` kernel (with ``compute_dtype = x.dtype``). Zero-word
    K pads unpack to -1 and need zero rows of ``x`` against them.
    """
    w = unpack_bits(wp, axis=-1, dtype=compute_dtype)
    # ±1 and compute_dtype values are exact in accum_dtype, so the product
    # is the accum_dtype-accumulated dot of the compute_dtype operands.
    return torch.matmul(w.to(accum_dtype), x.to(compute_dtype).to(accum_dtype))


def fused_xnor_layer(wp: torch.Tensor, xp: torch.Tensor, k_bits: int,
                     a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Whole fused binary layer: packed ``[M, KW] x [KW, N]`` -> packed
    ``[ceil(M/32), N]`` of ``sign(a*dot + b)``, repacked along M.

    The affine rounds twice (multiply, then add), as the JAX reference
    does. Rows past M inside the last word are +1 bits.
    """
    dot = xnor_popcount_matmul(wp, xp, k_bits)
    y = a.float()[:, None] * dot.float() + b.float()[:, None]
    pad = -y.shape[0] % PACK_BITS
    if pad:
        y = torch.nn.functional.pad(y, (0, 0, 0, pad), value=1.0)
    return pack_bits(y, axis=0)


def _spatial_pad(xp: torch.Tensor, pad: int) -> torch.Tensor:
    """All-ones border words around a ``[N, H, W, CW]`` packed map."""
    if not pad:
        return xp
    return torch.nn.functional.pad(xp, (0, 0, pad, pad, pad, pad), value=-1)


def direct_conv_dot(wp: torch.Tensor, xp: torch.Tensor, k_bits: int, *,
                    kh: int, kw: int, stride: int = 1,
                    pad: int = 0) -> torch.Tensor:
    """Direct binary convolution: the ±1 conv dot without a patch matrix.

    ``xp``: channel-packed map ``[N, H, W, CW]`` (tail bits +1).
    ``wp``: tap-aligned filters ``[D, kH*kW*CW]``, word
    ``(i*kW + j)*CW + cw`` holding tap ``(i, j)``'s channel word ``cw``.
    Borders pad with all-ones words. Returns int32 ``[N, OH, OW, D]``.
    """
    n, h, w, cw = xp.shape
    d, kwords = wp.shape
    if kwords != kh * kw * cw:
        raise ValueError(
            f"filter words {kwords} != kh*kw*CW = {kh}*{kw}*{cw} — direct "
            "conv needs tap-aligned packed filters (pack_conv_aligned)"
        )
    oh = conv_out_size(h, kh, stride, pad)
    ow = conv_out_size(w, kw, stride, pad)
    xp = _spatial_pad(xp, pad)
    wr = wp.reshape(d, kh * kw, cw)
    acc = torch.zeros((n, oh, ow, d), dtype=torch.int64, device=xp.device)
    for i in range(kh):
        for j in range(kw):
            win = xp[:, i:i + stride * (oh - 1) + 1:stride,
                     j:j + stride * (ow - 1) + 1:stride, :]  # [N, OH, OW, CW]
            tap = wr[:, i * kw + j, :]  # [D, CW]
            for c in range(cw):
                acc += popcount(~(win[..., c, None] ^ tap[:, c]))
    return (2 * acc - k_bits).to(torch.int32)


def direct_conv_oracle(wp: torch.Tensor, xp: torch.Tensor, k_bits: int,
                       a: torch.Tensor, b: torch.Tensor, *, kh: int, kw: int,
                       stride: int = 1, pad: int = 0) -> torch.Tensor:
    """Whole fused direct-conv layer: :func:`direct_conv_dot`, then
    ``sign(a*dot + b)`` per output channel, repacked along D (channels
    past D get +1 bits). Returns packed ``[N, OH, OW, ceil(D/32)]``."""
    dot = direct_conv_dot(wp, xp, k_bits, kh=kh, kw=kw, stride=stride,
                          pad=pad)
    y = a.float() * dot.float() + b.float()
    return pack_channels(y)


def maxpool2_packed(xp: torch.Tensor) -> torch.Tensor:
    """2x2/stride-2 maxpool on a channel-packed ±1 map ``[N, H, W, CW]``:
    the bitwise OR of the four window words."""
    return (xp[:, 0::2, 0::2] | xp[:, 0::2, 1::2]
            | xp[:, 1::2, 0::2] | xp[:, 1::2, 1::2])


def _pad_rows_ones(xp: torch.Tensor, rows: int) -> torch.Tensor:
    """Grow packed ``[KW, N]`` activations to ``rows`` words with
    all-ones (xnor-neutral) rows."""
    pad = rows - xp.shape[0]
    return torch.nn.functional.pad(xp, (0, 0, 0, pad), value=-1) if pad else xp


def megakernel_chain_xla(w_stack: torch.Tensor, a_stack: torch.Tensor,
                         b_stack: torch.Tensor, k_bits, xp: torch.Tensor,
                         m_out: int, *, final_wp: torch.Tensor | None = None,
                         final_k_bits: int = 0) -> torch.Tensor:
    """The megakernel chain as a sequence of :func:`fused_xnor_layer`
    calls on the stacked operands.

    ``w_stack [L, M_max, KW_max]`` (pad rows and words 0), ``a_stack``/
    ``b_stack [L, M_max]`` (pad rows ``a=0, b=+1``), packed ``xp [KW_in,
    N]``. Between layers the activations grow back to
    ``KW_act = max(KW_max, M_max/32)`` words with all-ones rows, as the
    kernel's ping-pong buffers do, and each layer reads only its true
    ``ceil(k_bits/32)`` words. Returns packed ``[ceil(m_out/32), N]``,
    or with ``final_wp [Mf, KWf]`` the int32 ±1 dot ``[Mf, N]``.
    """
    n_layers, m_max, kw_max = w_stack.shape
    kw_act = max(kw_max, m_max // PACK_BITS)
    act = _pad_rows_ones(xp, kw_act)
    for i in range(n_layers):
        kw_i = min(kw_max, -(-int(k_bits[i]) // PACK_BITS))
        out = fused_xnor_layer(w_stack[i, :, :kw_i], act[:kw_i],
                               int(k_bits[i]), a_stack[i], b_stack[i])
        act = _pad_rows_ones(out, kw_act)
    if final_wp is not None:
        return xnor_popcount_matmul(final_wp, act[:final_wp.shape[1]],
                                    final_k_bits)
    return act[:-(-m_out // PACK_BITS)]


def megakernel_chain_ragged_xla(w_stack: torch.Tensor, a_stack: torch.Tensor,
                                b_stack: torch.Tensor, k_bits,
                                xp: torch.Tensor, m_out: int, n_real: int, *,
                                final_wp: torch.Tensor | None = None,
                                final_k_bits: int = 0) -> torch.Tensor:
    """The chain's masked tail: :func:`megakernel_chain_xla` on a
    tile-padded batch ``xp [KW_in, N_pad]``, then every output column
    at or after ``n_real`` set to 0 (pad columns included)."""
    out = megakernel_chain_xla(w_stack, a_stack, b_stack, k_bits, xp, m_out,
                               final_wp=final_wp, final_k_bits=final_k_bits)
    keep = torch.arange(out.shape[1], device=out.device) < int(n_real)
    return torch.where(keep[None, :], out, torch.zeros_like(out))


def conv_stage_xla(xp: torch.Tensor, weights, a, b, k_bits, *, kh: int = 3,
                   kw: int = 3, pad: int = 1, pool: bool = True) -> torch.Tensor:
    """One conv stage: :func:`direct_conv_oracle` chained over the
    stage's convs (true shapes: tap-aligned ``weights[l] [D_l,
    kH*kW*CW_l]``, ``a[l]``/``b[l] [D_l]``), then the packed-OR maxpool
    when ``pool``. Returns packed ``[N, OH', OW', ceil(D_last/32)]``."""
    act = xp
    for wl, al, bl, k in zip(weights, a, b, k_bits):
        act = direct_conv_oracle(wl, act, int(k), al, bl, kh=kh, kw=kw,
                                 stride=1, pad=pad)
    return maxpool2_packed(act) if pool else act
