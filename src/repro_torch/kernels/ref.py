"""Plain-torch twins of the kernels that are not bit operations (those
live in ``repro_torch.core.bitops``). Device-agnostic tensor code: the
CPU path of their ``ops`` wrappers and the oracle each CUDA kernel is
held to on the card."""

from __future__ import annotations

import math

import torch

from repro_torch.core.bitops import PACK_BITS, pack_bits, popcount

# Masked scores and the initial stabilizers of flash attention and the
# mLSTM, as the JAX package's kernels write them.
NEG = -1e30


def ssm_scan_chunk_ref(dt: torch.Tensor, xh: torch.Tensor, bmat: torch.Tensor,
                       cmat: torch.Tensor, a: torch.Tensor,
                       h0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba S6 scan over one chunk as the sequential recurrence (the JAX
    package's test oracle ``ref_scan``), one torch op per rounding:
    ``h_t = h_{t-1} * exp(dt_t * A) + (dt_t * x_t) * B_t``,
    ``y_t = sum_n h_t[:, n] * C_t[n]``.

    dt, xh ``[B, C, di]``; bmat, cmat ``[B, C, ds]``; a ``[di, ds]``; h0
    ``[B, di, ds]``. Returns (y ``[B, C, di]``, h_last ``[B, di, ds]``).
    """
    b, c, di = dt.shape
    h = h0
    ys = []
    for t in range(c):
        da = torch.exp(dt[:, t, :, None] * a)
        dbx = (dt[:, t] * xh[:, t])[..., None] * bmat[:, t, None, :]
        h = h * da + dbx
        ys.append((h * cmat[:, t, None, :]).sum(-1))
    if not ys:
        return dt.new_empty((b, 0, di)), h0.clone()
    return torch.stack(ys, dim=1), h


def ssm_scan_chunk_chain(dt: torch.Tensor, xh: torch.Tensor,
                         bmat: torch.Tensor, cmat: torch.Tensor,
                         a: torch.Tensor, h0: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`ssm_scan_chunk_ref` in the order of work of the
    ``ssm_scan_chunk`` kernel (tests only): ``da = exp(dt * A)`` and the
    update ``h * da + (dt * x) * B`` rounded at every op, as the twin's;
    ``y`` one fma chain over the states in order, ``fma(h_n, C_n, acc)``
    from ``acc = 0`` (the kernel carries it from lane to lane), each fma
    a float64 product and sum rounded to float32."""
    b, c, di = dt.shape
    h = h0
    ys = []
    for t in range(c):
        da = torch.exp(dt[:, t, :, None] * a)
        dbx = (dt[:, t] * xh[:, t])[..., None] * bmat[:, t, None, :]
        h = h * da + dbx
        prod = h.double() * cmat[:, t, None, :].double()
        acc = torch.zeros((b, di), dtype=torch.float32)
        for n in range(prod.shape[-1]):
            acc = (acc.double() + prod[..., n]).float()
        ys.append(acc)
    if not ys:
        return dt.new_empty((b, 0, di)), h0.clone()
    return torch.stack(ys, dim=1), h


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, block_q: int = 512,
                        block_kv: int = 512) -> torch.Tensor:
    """Online-softmax attention over KV blocks of ``block_kv``, rounding
    where the JAX package's Pallas ``flash_attention`` rounds:
    ``s = (q . k in float32) * Dh**-0.5``, masked with -1e30 (causal:
    key position <= query position); per block ``m' = max(m, max s)``,
    ``p = exp(s - m')``, ``l = l * exp(m - m') + sum p``, ``acc = acc *
    exp(m - m') + (p rounded to v's dtype) . v`` in float32; out ``acc /
    max(l, 1e-30)`` in q's dtype.

    q ``[BH, Sq, Dh]``, k and v ``[BH, Skv, Dh]``. Rows are independent,
    so ``block_q`` does not change the result (it is the JAX signature's);
    the result depends on ``block_kv`` in its last bits. A last KV block
    shorter than ``block_kv`` is taken as it is. A causal block lying
    wholly above a row's diagonal leaves that row exactly as it was
    (``p = 0``, ``exp(m - m') = 1``), so only the rows it reaches are
    updated."""
    del block_q
    bh, sq, dh = q.shape
    skv = k.shape[1]
    bkv = max(1, min(block_kv, skv))
    scale = dh ** -0.5
    qf = q.float()
    acc = torch.zeros((bh, sq, v.shape[-1]), device=q.device)
    m = torch.full((bh, sq), NEG, device=q.device)
    den = torch.zeros((bh, sq), device=q.device)
    q_pos = torch.arange(sq, device=q.device)
    for j0 in range(0, skv, bkv):
        r0 = min(j0, sq) if causal else 0
        if r0 == sq:
            break
        kj, vj = k[:, j0:j0 + bkv].float(), v[:, j0:j0 + bkv]
        s = torch.matmul(qf[:, r0:], kj.transpose(1, 2)) * scale
        if causal:
            k_pos = j0 + torch.arange(kj.shape[1], device=q.device)
            s = torch.where(k_pos[None, :] <= q_pos[r0:, None], s, NEG)
        m_prev = m[:, r0:]
        m_new = torch.maximum(m_prev, s.amax(-1))
        corr = torch.exp(m_prev - m_new)
        p = torch.exp(s - m_new[..., None])
        pv = torch.matmul(p.to(v.dtype).float(), vj.float())
        # rows before r0 keep their values (no in-place update: autograd)
        den = torch.cat([den[:, :r0], den[:, r0:] * corr + p.sum(-1)], 1)
        acc = torch.cat([acc[:, :r0], acc[:, r0:] * corr[..., None] + pv], 1)
        m = torch.cat([m[:, :r0], m_new], 1)
    return (acc / torch.clamp(den, min=1e-30)[..., None]).to(q.dtype)


def split_bf16_pieces(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor,
                                                torch.Tensor]:
    """Float32 ``x`` as three bfloat16-exact float32 pieces, each cut by
    truncation (the low 16 bits cleared): ``hi`` of ``x``, ``mid`` of
    ``x - hi``, ``lo = x - hi - mid``. The split the ``unpack_gemm``
    kernel makes of a float32 input before its three bf16 products:
    ``hi + mid + lo == x`` exactly for ±0 and every finite ``x`` with
    ``|x| >= 2^-110`` (24 significant bits in three slices of 8; below,
    ``lo`` falls under bf16's normal range and loses less than 2^-126).
    Rounding ``hi`` to nearest instead would carry ``|x|`` above bf16's
    largest value (~3.39e38) to inf."""
    def trunc(v: torch.Tensor) -> torch.Tensor:
        return (v.view(torch.int32) & -65536).view(torch.float32)

    x = x.float()
    hi = trunc(x)
    rest = x - hi
    mid = trunc(rest)
    return hi, mid, rest - mid


def xnor_dot_and_popc(wp: torch.Tensor, xp: torch.Tensor, k_bits: int,
                      real_words: int | None = None) -> torch.Tensor:
    """``bitops.xnor_popcount_matmul`` the way the xnor kernels compute it
    on the tensor cores, whose 1-bit product counts ``popc(w & x)``
    (``mma.sync ... .and.popc``): bit by bit ``xnor(w, x) = 1 - w - x + 2
    w x``, so over the KW words of a row and a column ``sum popc(~(w ^ x))
    = 32 KW - P(w) - P(x) + 2 sum popc(w & x)``, with ``P`` the row's and
    the column's popcounts. It holds for any words, the xnor-neutral pads
    included. ``real_words``: KW counts only the first ``real_words``
    words, and the words past them, zeros in both operands (the tile's
    loads past K), add nothing to any term. Packed ``wp [M, KW]``, ``xp
    [KW, N]`` (int32) -> int32 ``[M, N]`` dot ``2 * count - k_bits``."""
    m, kw = wp.shape
    n = xp.shape[1]
    both = torch.zeros((m, n), dtype=torch.int64, device=wp.device)
    for k in range(kw):
        both += popcount(wp[:, k, None] & xp[None, k, :])
    kw_real = kw if real_words is None else real_words
    count = (PACK_BITS * kw_real - popcount(wp).sum(1)[:, None]
             - popcount(xp).sum(0)[None, :] + 2 * both)
    return (2 * count - k_bits).to(torch.int32)


def window_words(xp: torch.Tensor, *, kh: int, kw: int, stride: int,
                 pad: int) -> torch.Tensor:
    """The implicit patch matrix of a direct conv in the kernels' K order:
    channel-packed ``[N, H, W, CW]`` -> ``[N, OH, OW, kh*kw*CW]``, word
    ``(i*kw + j)*CW + c`` of output pixel (y, x) being word c of map pixel
    ``(y*stride - pad + i, x*stride - pad + j)``, all-ones where that lies
    on the spatial border."""
    n, h, w, _ = xp.shape
    oh = (h + 2 * pad - kh) // stride + 1
    ow = (w + 2 * pad - kw) // stride + 1
    xpad = torch.nn.functional.pad(xp, (0, 0, pad, pad, pad, pad), value=-1)
    return torch.cat([xpad[:, i:i + stride * (oh - 1) + 1:stride,
                           j:j + stride * (ow - 1) + 1:stride]
                      for i in range(kh) for j in range(kw)], dim=-1)


def _conv_dots(wp: torch.Tensor, patches: torch.Tensor, k_bits: int,
               slab: int) -> torch.Tensor:
    """Int32 dots ``[M, P]`` of filter rows ``wp [M, K]`` against window
    words ``patches [P, K]``: K zero-filled to a multiple of ``slab`` in
    both operands (the tiles' loads past K), counts by
    :func:`xnor_dot_and_popc` over the real K."""
    kwords = wp.shape[1]
    fill = -kwords % slab
    wk = torch.nn.functional.pad(wp, (0, fill))
    xk = torch.nn.functional.pad(patches, (0, fill)).T
    return xnor_dot_and_popc(wk, xk, k_bits, real_words=kwords)


def _conv_sign_words(wp: torch.Tensor, patches: torch.Tensor, k_bits: int,
                     a: torch.Tensor, b: torch.Tensor,
                     slab: int) -> torch.Tensor:
    """Packed sign words ``[ceil(M/32), P]`` of :func:`_conv_dots`: ``y =
    (a*dot) + b``, rows past M +1 bits."""
    dot = _conv_dots(wp, patches, k_bits, slab)
    y = a.float()[:, None] * dot.float() + b.float()[:, None]
    y = torch.nn.functional.pad(y, (0, 0, 0, -y.shape[0] % PACK_BITS), value=1.0)
    return pack_bits(y, axis=0)


def direct_conv_tc(wp: torch.Tensor, xp: torch.Tensor, k_bits: int,
                   a: torch.Tensor, b: torch.Tensor, *, kh: int, kw: int,
                   stride: int = 1, pad: int = 0) -> torch.Tensor:
    """``bitops.direct_conv_oracle`` as the ``fused_direct_conv`` kernel
    computes it: an implicit GEMM of the filters ``wp [D, K]`` against
    the window words of every output pixel (:func:`window_words`, K in
    tap-major order, border words all-ones), 32-word K slabs with zeros
    past K, counts from the and-popc identity, the epilogue ``(a*dot) +
    b`` packed along D with +1 bits past D, stored pixel-major: packed
    ``[N, OH, OW, ceil(D/32)]``."""
    patches = window_words(xp, kh=kh, kw=kw, stride=stride, pad=pad)
    n, oh, ow, kwords = patches.shape
    words = _conv_sign_words(wp, patches.reshape(-1, kwords), k_bits, a, b,
                             slab=32)
    return words.T.reshape(n, oh, ow, -1).contiguous()


def direct_conv_dot_tc(wp: torch.Tensor, xp: torch.Tensor, k_bits: int, *,
                       kh: int, kw: int, stride: int = 1,
                       pad: int = 0) -> torch.Tensor:
    """``bitops.direct_conv_dot`` as the ``direct_conv_dot`` kernel computes
    it: the implicit GEMM of :func:`direct_conv_tc` (window words in
    tap-major K order, all-ones border words, zeros past K in 32-word
    slabs, counts from the and-popc identity), then the int32 epilogue
    ``2 * count - k_bits`` stored pixel-major: int32 ``[N, OH, OW, D]``."""
    patches = window_words(xp, kh=kh, kw=kw, stride=stride, pad=pad)
    n, oh, ow, kwords = patches.shape
    dot = _conv_dots(wp, patches.reshape(-1, kwords), k_bits, slab=32)
    return dot.T.reshape(n, oh, ow, -1).contiguous()


def conv_stage_tc(xp: torch.Tensor, weights, a, b, k_bits, *, kh: int = 3,
                  kw: int = 3, pad: int = 1, pool: bool = True,
                  unit: int = 16) -> torch.Tensor:
    """``bitops.conv_stage_xla`` as the ``megakernel_conv_stage`` kernel's
    cluster computes it: every conv's D padded to whole words (rows 0,
    ``a = 0, b = +1``), a cluster of ``S = gcd(8, D_l/32 for every l)``
    CTAs, CTA r computing channel words ``[r*DW_l/S, (r+1)*DW_l/S)`` of
    every conv over the image's output pixels in chunks of ``unit`` (a
    warp's unit; K in 8-word mma steps, zeros past K), the words of all
    CTAs making the next conv's map; after the last conv the 2x2 OR-pool.
    Returns packed ``[N, OH', OW', ceil(D_last/32)]``."""
    d_words = [-(-wl.shape[0] // PACK_BITS) for wl in weights]
    cluster = math.gcd(8, *d_words)
    act = xp
    for wl, al, bl, k, dw in zip(weights, a, b, k_bits, d_words):
        fill = dw * PACK_BITS - wl.shape[0]
        wl = torch.nn.functional.pad(wl, (0, 0, 0, fill))
        al = torch.nn.functional.pad(al, (0, fill))
        bl = torch.nn.functional.pad(bl, (0, fill), value=1.0)
        patches = window_words(act, kh=kh, kw=kw, stride=1, pad=pad)
        n, oh, ow, kwords = patches.shape
        patches = patches.reshape(n, oh * ow, kwords)
        own = dw // cluster * PACK_BITS
        nxt = torch.empty((n, oh * ow, dw), dtype=act.dtype, device=act.device)
        for r in range(cluster):
            rows = slice(r * own, (r + 1) * own)
            for p0 in range(0, oh * ow, unit):
                chunk = patches[:, p0:p0 + unit].reshape(-1, kwords)
                words = _conv_sign_words(wl[rows], chunk, int(k), al[rows],
                                         bl[rows], slab=8)
                nxt[:, p0:p0 + unit, rows.start // PACK_BITS:rows.stop // PACK_BITS] = (
                    words.T.reshape(n, -1, own // PACK_BITS))
        act = nxt.reshape(n, oh, ow, dw)
    if not pool:
        return act
    return (act[:, 0::2, 0::2] | act[:, 0::2, 1::2]
            | act[:, 1::2, 0::2] | act[:, 1::2, 1::2])


def sequential_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum along the last axis, one float add after another
    (``torch.cumsum`` on the card sums in a tree: other roundings)."""
    out = torch.empty_like(x)
    run = torch.zeros_like(x[..., 0])
    for t in range(x.shape[-1]):
        run = run + x[..., t]
        out[..., t] = run
    return out


def _mlstm_gates(logi: torch.Tensor, logf: torch.Tensor, chunk: int):
    """The mLSTM's gates within each chunk: (L, number of chunks, ``b`` the
    sequential cumsum of ``logf``, ``g = logi - b``, ``M`` its running
    max), each ``[BH, nc, L]``."""
    bh, s = logi.shape
    ln = min(chunk, s)
    if ln < 1 or s % ln:
        raise ValueError(f"mlstm_chunked needs S % chunk == 0, got S={s}, "
                         f"chunk={ln}")
    nc = s // ln
    b_cum = sequential_cumsum(logf.float().reshape(bh, nc, ln))
    g = logi.float().reshape(bh, nc, ln) - b_cum
    return ln, nc, b_cum, g, torch.cummax(g, dim=-1).values


def mlstm_chunked_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      logi: torch.Tensor, logf: torch.Tensor, *,
                      chunk: int = 128) -> tuple[torch.Tensor, torch.Tensor,
                                                 torch.Tensor, torch.Tensor]:
    """Chunkwise stabilized mLSTM from a zero state, as the JAX package's
    Pallas ``mlstm_chunked`` computes it, chunk after chunk carrying the
    matrix memory ``C``, the normalizer ``n`` and the stabilizer ``m``
    (-1e30 at the start). Within a chunk of ``L`` steps: ``b`` the
    sequential cumsum of ``logf``, ``g = logi - b``, ``M`` its running max,
    ``m_loc = max(M, m)``; ``y_t = (sum_{j<=t} (q_t . k_j) exp(g_j -
    m_loc_t) v_j + (q_t C) exp(m - m_loc_t)) / max(|den_t|, 1)`` with
    ``den`` the same sums over a ones column (``n`` for ``C``); then
    ``C' = exp(m - m_L) C + sum_j exp(g_j - m_L) k_j v_j^T`` with ``m_L =
    max(M_L, m)``, ``n'`` likewise, ``m' = b_L + m_L``.

    q (pre-scaled by ``dk**-0.5``), k ``[BH, S, dk]``, v ``[BH, S, dv]``,
    logi, logf ``[BH, S]``, float32. Returns (y ``[BH, S, dv]`` in q's
    dtype, C ``[BH, dk, dv]``, n ``[BH, 1, dk]``, m ``[BH, 1, 1]``)."""
    bh, s, dk = q.shape
    dv = v.shape[-1]
    ln, nc, b_cum, g, big_m = _mlstm_gates(logi, logf, chunk)
    dev = q.device
    tril = torch.ones((ln, ln), dtype=torch.bool, device=dev).tril()
    C = torch.zeros((bh, dk, dv), device=dev)
    n = torch.zeros((bh, 1, dk), device=dev)
    m = torch.full((bh,), NEG, device=dev)
    ys = []
    for c in range(nc):
        sl = slice(c * ln, (c + 1) * ln)
        qc, kc, vc = q[:, sl].float(), k[:, sl].float(), v[:, sl].float()
        gc, mc = g[:, c], big_m[:, c]
        m_loc = torch.maximum(mc, m[:, None])
        inter_scale = torch.exp(m[:, None] - m_loc)
        w_intra = torch.exp(gc[:, None, :] - m_loc[:, :, None])
        w_intra = torch.where(tril, w_intra, 0.0)
        sw = torch.matmul(qc, kc.transpose(1, 2)) * w_intra
        num = torch.matmul(sw, vc) + torch.matmul(qc, C) * inter_scale[..., None]
        den = sw.sum(-1) + (qc * n).sum(-1) * inter_scale
        ys.append(num / torch.clamp(den.abs(), min=1.0)[..., None])
        m_loc_l = torch.maximum(mc[:, -1], m)
        wk = torch.exp(gc - m_loc_l[:, None])
        decay = torch.exp(m - m_loc_l)
        kw = kc * wk[..., None]
        C = decay[:, None, None] * C + torch.matmul(kw.transpose(1, 2), vc)
        n = decay[:, None, None] * n + kw.sum(1, keepdim=True)
        m = b_cum[:, c, -1] + m_loc_l
    return torch.cat(ys, dim=1).to(q.dtype), C, n, m.reshape(bh, 1, 1)


def mlstm_chunked_states_ref(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, logi: torch.Tensor,
                             logf: torch.Tensor, *, chunk: int = 128
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor, torch.Tensor]:
    """``mlstm_chunked_ref`` in the order the CUDA kernel computes it: the
    stabilizer chain over the chunks first, then the states ``(C, n)``
    entering every chunk (``C_{c+1} = exp(m_c - m_L) C_c + (k_c w_c)^T
    v_c``, the twin's operations in the twin's order), then every chunk's
    ``y`` from its entering state at once, as batched products over the
    chunks. Same arguments and returns as ``mlstm_chunked_ref``; its C, n
    and m are the twin's exactly, its y the same products summed by
    batched matmuls."""
    bh, s, dk = q.shape
    dv = v.shape[-1]
    ln, nc, b_cum, g, big_m = _mlstm_gates(logi, logf, chunk)
    dev = q.device
    m_prev = [torch.full((bh,), NEG, device=dev)]
    for c in range(nc):
        m_loc_l = torch.maximum(big_m[:, c, -1], m_prev[c])
        m_prev.append(b_cum[:, c, -1] + m_loc_l)
    m_in = torch.stack(m_prev[:nc], 1)                    # [BH, nc]
    m_last = torch.maximum(big_m[..., -1], m_in)          # m_L of each chunk
    qc, kc, vc = (x.float().reshape(bh, nc, ln, x.shape[-1]) for x in (q, k, v))
    wk = torch.exp(g - m_last[..., None])
    decay = torch.exp(m_in - m_last)
    C = torch.zeros((bh, dk, dv), device=dev)
    n = torch.zeros((bh, 1, dk), device=dev)
    cs, ns = [], []
    for c in range(nc):
        cs.append(C)
        ns.append(n)
        kw = kc[:, c] * wk[:, c, :, None]
        C = decay[:, c, None, None] * C + torch.matmul(kw.transpose(1, 2), vc[:, c])
        n = decay[:, c, None, None] * n + kw.sum(1, keepdim=True)
    c_in, n_in = torch.stack(cs, 1), torch.stack(ns, 1)  # [BH, nc, dk, dv], [BH, nc, 1, dk]
    m_loc = torch.maximum(big_m, m_in[..., None])
    inter = torch.exp(m_in[..., None] - m_loc)
    tril = torch.ones((ln, ln), dtype=torch.bool, device=dev).tril()
    w_intra = torch.where(tril, torch.exp(g[..., None, :] - m_loc[..., :, None]), 0.0)
    sw = torch.matmul(qc, kc.transpose(-1, -2)) * w_intra
    num = torch.matmul(sw, vc) + torch.matmul(qc, c_in) * inter[..., None]
    den = sw.sum(-1) + (qc * n_in).sum(-1) * inter
    y = num / torch.clamp(den.abs(), min=1.0)[..., None]
    return (y.reshape(bh, s, dv).to(q.dtype), C, n,
            m_prev[nc].reshape(bh, 1, 1))
