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


def ssm_scan_chunk_bwd_ref(dt: torch.Tensor, xh: torch.Tensor,
                           bmat: torch.Tensor, cmat: torch.Tensor,
                           a: torch.Tensor, h0: torch.Tensor, dy: torch.Tensor,
                           dh_last: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The gradients of :func:`ssm_scan_chunk_ref` with respect to all six
    inputs, from the output gradients ``dy [B, C, di]`` and ``dh_last [B,
    di, ds]``, with no autograd. The states entering each step are
    recomputed forward from ``h0`` (never by dividing the recurrence
    backwards: ``exp(dt A)`` underflows), then the recurrence runs in
    reverse: ``g_t = dh + dy_t C_t`` (the gradient of ``h_t``), ``dC_t =
    sum_di dy_t h_t``, ``dB_t = sum_di g_t dt_t x_t``, ``d(dt)_t = sum_s
    g_t h_{t-1} exp(dt_t A) A + x_t sum_s g_t B_t``, ``dx_t = dt_t sum_s
    g_t B_t``, ``dA = sum_{b,t} g_t h_{t-1} exp(dt_t A) dt_t``, ``dh = g_t
    exp(dt_t A)``, down to ``dh0``. Returns ``(d dt, d xh, d bmat, d
    cmat, d a, d h0)``."""
    b, c, di = dt.shape
    hs, h = [], h0
    for t in range(c):
        hs.append(h)
        da = torch.exp(dt[:, t, :, None] * a)
        h = h * da + (dt[:, t] * xh[:, t])[..., None] * bmat[:, t, None, :]
    dh = dh_last.clone()
    like = dict(dtype=dt.dtype, device=dt.device)
    ddt, dxh = (torch.empty((b, c, di), **like) for _ in range(2))
    dbm, dcm = (torch.empty((b, c, a.shape[1]), **like) for _ in range(2))
    d_a = torch.zeros((b, di, a.shape[1]), **like)
    for t in reversed(range(c)):
        h_prev, dt_t, x_t = hs[t], dt[:, t], xh[:, t]
        da = torch.exp(dt_t[..., None] * a)
        dtx = dt_t * x_t
        h_t = h_prev * da + dtx[..., None] * bmat[:, t, None, :]
        g = dh + dy[:, t, :, None] * cmat[:, t, None, :]
        dcm[:, t] = (dy[:, t, :, None] * h_t).sum(1)
        dbm[:, t] = (g * dtx[..., None]).sum(1)
        gb = (g * bmat[:, t, None, :]).sum(-1)
        gda = g * h_prev * da
        ddt[:, t] = (gda * a).sum(-1) + x_t * gb
        dxh[:, t] = dt_t * gb
        d_a += gda * dt_t[..., None]
        dh = g * da
    return ddt, dxh, dbm, dcm, d_a.sum(0), dh


# Compiled state width of csrc/ssm_scan_bwd.cu -> (lanes a channel,
# channels a block), as its kBwd16 / kBwd32 set them; the second kernel's
# threads a block (kBwdSumThreads).
SCAN_BWD_TILING = {16: (4, 64), 32: (8, 32)}
SCAN_BWD_SUM_THREADS = 256


def _fma(x: torch.Tensor, y: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """``fmaf``: the float64 product (exact) plus ``acc``, rounded to float32."""
    return (x.double() * y.double() + acc.double()).float()


def _in_order(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum along ``dim`` one term at a time, from 0, in float32."""
    acc = torch.zeros_like(x.select(dim, 0))
    for i in range(x.shape[dim]):
        acc = acc + x.select(dim, i)
    return acc


def ssm_scan_chunk_bwd_segmented(dt: torch.Tensor, xh: torch.Tensor,
                                 bmat: torch.Tensor, cmat: torch.Tensor,
                                 a: torch.Tensor, h0: torch.Tensor,
                                 dy: torch.Tensor, dh_last: torch.Tensor,
                                 k: int, *, return_states: bool = False):
    """:func:`ssm_scan_chunk_bwd_ref` in the order of work of the
    ``ssm_scan_chunk_bwd`` kernel (tests only). A forward pass keeps only
    the state entering every ``k``-th step; the reverse pass recomputes
    each segment's states and decays from its checkpoint, last segment
    first, and reuses them. States are padded to the kernel's compiled
    width and channels to whole blocks (``SCAN_BWD_TILING``), with zeros.
    Sums over a channel's states: each lane's states as one fma chain, then
    the lanes pairwise (the kernel's xor butterfly); sums over channels:
    a warp's channels pairwise, the block's warps in order, then every
    GROUPS-th block's partial in order and the groups in order (the second
    kernel); d a over the batch rows in order. ``return_states``: also the
    recomputed states ``[B, C, di, ds]`` (each ``h_t``). Its reverse step
    takes ``g = fma(dy, C, dh)``, ``dh = g * da`` and ``g h_{t-1} da`` as
    ``dh * h_{t-1}``, as the kernel does."""
    b, c, di = dt.shape
    ds = a.shape[1]
    width = 16 if ds <= 16 else 32
    lanes, block = SCAN_BWD_TILING[width]
    ns, cpw = width // lanes, 32 // lanes
    warps = block * lanes // 32
    nblk = -(-di // block)
    cpad, spad = nblk * block - di, width - ds
    pad = torch.nn.functional.pad
    dt_, xh_, dy_ = (pad(x, (0, cpad)) for x in (dt, xh, dy))
    bm, cm = pad(bmat, (0, spad)), pad(cmat, (0, spad))
    a_ = pad(a, (0, spad, 0, cpad))
    h0_, dh = (pad(x, (0, spad, 0, cpad)) for x in (h0, dh_last))

    def step(h, t):
        da = torch.exp(dt_[:, t, :, None] * a_)
        return h * da + (dt_[:, t] * xh_[:, t])[..., None] * bm[:, t, None, :], da

    def over_lanes(x, y):  # [b, D, width] -> each lane's fma chain, lanes pairwise
        x, y = x.reshape(*x.shape[:-1], lanes, ns), y.reshape(*y.shape[:-1], lanes, ns)
        acc = torch.zeros(x.shape[:-1])
        for q in range(ns):
            acc = _fma(x[..., q], y[..., q], acc)
        while acc.shape[-1] > 1:
            acc = acc[..., 0::2] + acc[..., 1::2]
        return acc[..., 0]

    def over_channels(v):  # [b, D, width] -> [b, nblk, width]
        v = v.reshape(b, nblk, warps, cpw, width)
        while v.shape[3] > 1:  # a warp's channels pairwise
            v = v[:, :, :, 0::2] + v[:, :, :, 1::2]
        return _in_order(v[:, :, :, 0], 2)

    nseg = -(-c // k)
    ckpt, h = [], h0_
    for t in range(c):
        if t % k == 0:
            ckpt.append(h)
        h, _ = step(h, t)
    ddt, dxh = (torch.empty((b, c, di)) for _ in range(2))
    part = torch.empty((b, c, nblk, 2, width))
    gacc = torch.zeros_like(a_.expand_as(dh))
    states = torch.empty((b, c, di, ds))
    for seg in reversed(range(nseg)):
        t0 = seg * k
        hs, das = [ckpt[seg]], []
        for t in range(t0, min(t0 + k, c)):
            h, da = step(hs[-1], t)
            hs.append(h)
            das.append(da)
            states[:, t] = h[:, :di, :ds]
        for j in reversed(range(len(das))):
            t = t0 + j
            dtv, xv, dyv = dt_[:, t], xh_[:, t], dy_[:, t]
            dtx = dtv * xv
            g = _fma(dyv[..., None].expand_as(dh), cm[:, t, None, :].expand_as(dh), dh)
            dh = g * das[j]
            gda = dh * hs[j]
            gb, ga = over_lanes(g, bm[:, t, None, :].expand_as(g)), over_lanes(gda, a_.expand_as(g))
            gacc = _fma(gda, dtv[..., None], gacc)
            ddt[:, t] = _fma(xv, gb, ga)[:, :di]
            dxh[:, t] = (dtv * gb)[:, :di]
            part[:, t, :, 0] = over_channels(dyv[..., None] * hs[j + 1])
            part[:, t, :, 1] = over_channels(g * dtx[..., None])
    groups = SCAN_BWD_SUM_THREADS // (2 * width)
    sums = torch.zeros((b, c, groups, 2, width))
    for i in range(nblk):
        sums[:, :, i % groups] = sums[:, :, i % groups] + part[:, :, i]
    sums = _in_order(sums, 2)
    d_a = gacc[0] if b == 1 else _in_order(gacc, 0)
    grads = (ddt, dxh, sums[:, :, 1, :ds], sums[:, :, 0, :ds], d_a[:di, :ds],
             dh[:, :di, :ds])
    return (grads, states) if return_states else grads


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, block_q: int = 512,
                        block_kv: int = 512, return_lse: bool = False):
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
    updated. ``return_lse``: also the float32 row log-sum-exp ``m +
    log(l)`` ``[BH, Sq]`` that :func:`flash_attention_bwd_ref` takes."""
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
    out = (acc / torch.clamp(den, min=1e-30)[..., None]).to(q.dtype)
    if return_lse:
        return out, m + torch.log(den)
    return out


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            o: torch.Tensor, lse: torch.Tensor,
                            do: torch.Tensor, *, causal: bool = True,
                            block_q: int = 512
                            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients ``(dq, dk, dv)`` of :func:`flash_attention_ref` from
    what its forward keeps (``o`` and the row log-sum-exp ``lse``), with
    no autograd: per query row ``p = exp(s - lse)`` (``s`` the masked
    scaled scores in float32), ``D = rowsum(dO o)`` in float32, ``dV =
    round(p)^T dO`` (``p`` rounded to v's dtype, as the forward's PV
    product takes it, whose rounding ``jax.grad`` treats as the identity),
    ``dP = dO V^T``, ``dS = p (dP - D)`` rounded to q's dtype, ``dQ = dS K
    scale``, ``dK = dS^T Q scale``; every sum in float32, the outputs in
    the inputs' dtypes. Query rows go ``block_q`` at a time (the [rows,
    Skv] matrices of one block are what it holds)."""
    bh, sq, dh = q.shape
    skv = k.shape[1]
    scale = dh ** -0.5
    kf, vf = k.float(), v.float()
    delta = (do.float() * o.float()).sum(-1)
    dq = torch.empty((bh, sq, dh), device=q.device)
    dk = torch.zeros((bh, skv, dh), device=q.device)
    dv = torch.zeros((bh, skv, v.shape[-1]), device=q.device)
    k_pos = torch.arange(skv, device=q.device)
    for i0 in range(0, sq, block_q):
        rows = slice(i0, i0 + block_q)
        qf, dof = q[:, rows].float(), do[:, rows].float()
        s = torch.matmul(qf, kf.transpose(1, 2)) * scale
        if causal:
            q_pos = torch.arange(i0, i0 + qf.shape[1], device=q.device)
            s = torch.where(k_pos[None, :] <= q_pos[:, None], s, NEG)
        p = torch.exp(s - lse[:, rows, None])
        dv += torch.matmul(p.to(v.dtype).float().transpose(1, 2), dof)
        dp = torch.matmul(dof, vf.transpose(1, 2))
        ds = (p * (dp - delta[:, rows, None])).to(q.dtype).float()
        dq[:, rows] = torch.matmul(ds, kf) * scale
        dk += torch.matmul(ds.transpose(1, 2), qf)
    return dq.to(q.dtype), (dk * scale).to(k.dtype), dv.to(v.dtype)


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
    return (2 * xnor_counts_and_popc(wp, xp, real_words) - k_bits).to(torch.int32)


def xnor_counts_and_popc(wp: torch.Tensor, xp: torch.Tensor,
                         real_words: int | None = None) -> torch.Tensor:
    """The xnor counts ``sum popc(~(w ^ x))`` of :func:`xnor_dot_and_popc`
    (int64 ``[M, N]``), from the and-popc identity over the first
    ``real_words`` words (default all of them)."""
    m, kw = wp.shape
    n = xp.shape[1]
    both = torch.zeros((m, n), dtype=torch.int64, device=wp.device)
    for k in range(kw):
        both += popcount(wp[:, k, None] & xp[None, k, :])
    kw_real = kw if real_words is None else real_words
    return (PACK_BITS * kw_real - popcount(wp).sum(1)[:, None]
            - popcount(xp).sum(0)[None, :] + 2 * both)


def _slab_counts(wp: torch.Tensor, xp: torch.Tensor, slab: int) -> torch.Tensor:
    """:func:`xnor_counts_and_popc` of ``wp [M, K] x xp [K, N]`` with K
    zero-filled to a multiple of ``slab`` in both operands (a tile's loads
    past K), counted over the real K."""
    kwords = wp.shape[1]
    fill = -kwords % slab
    wk = torch.nn.functional.pad(wp, (0, fill))
    xk = torch.nn.functional.pad(xp, (0, 0, 0, fill))
    return xnor_counts_and_popc(wk, xk, real_words=kwords)


def xnor_gemm_tc(wp: torch.Tensor, xp: torch.Tensor, k_bits: int, *,
                 splits: int = 1) -> torch.Tensor:
    """``bitops.xnor_popcount_matmul`` as the ``xnor_gemm`` kernel computes
    it: K cut into ``splits`` ranges of ``ceil(KW/splits)`` words rounded
    up to the 8-word mma step (fewer splits where the rounding leaves the
    last ones empty), each range's xnor counts from the and-popc identity
    over 32-word slabs (zeros past the range in both operands), the
    splits' integer counts added in split order, then ``2 * count -
    k_bits``. Packed ``wp [M, KW]``, ``xp [KW, N]`` -> int32 ``[M, N]``."""
    m, kw = wp.shape
    width = (-(-kw // splits) + 7) & ~7 if splits > 1 else kw
    count = torch.zeros((m, xp.shape[1]), dtype=torch.int64, device=wp.device)
    for lo in range(0, max(kw, 1), max(width, 1)):
        count += _slab_counts(wp[:, lo:lo + width], xp[lo:lo + width], slab=32)
    return (2 * count - k_bits).to(torch.int32)


# The megakernel chain's work split (csrc/megakernel_chain.cu): 16 warps a
# CTA, K in k-groups of 16 words.
CHAIN_WARPS = 16
CHAIN_GROUP = 16


def chain_work(mtiles: int, kw: int) -> tuple[int, int]:
    """``(parts, per)``: a layer's K parts on a CTA of ``mtiles`` m16 tiles
    (as many as the warps left over by the tiles allow, at most one a
    k-group) and the k-groups of each, as ``chain_work`` of the kernel."""
    groups = max(1, -(-kw // CHAIN_GROUP))
    parts = max(1, min(CHAIN_WARPS // mtiles, groups))
    per = -(-groups // parts)
    return -(-groups // per), per


def megakernel_chain_tc(w_stack: torch.Tensor, a_stack: torch.Tensor,
                        b_stack: torch.Tensor, k_bits, xp: torch.Tensor,
                        m_out: int, *, final_wp: torch.Tensor | None = None,
                        final_k_bits: int = 0, n_real: int | None = None,
                        cluster: int | None = None) -> torch.Tensor:
    """``bitops.megakernel_chain_ragged_xla`` as one cluster of the
    ``megakernel_chain`` kernel computes it: ``S = cluster`` CTAs (default
    gcd(16, M_max/32)), CTA r owning rows ``[r*M_max/S, (r+1)*M_max/S)`` of
    every layer; each layer's K (its ``ceil(k_bits/32)`` words) cut into
    the parts of :func:`chain_work`, each part's xnor counts from the
    and-popc identity, the parts' integer counts added in part order, the
    affine ``(a*dot) + b`` (two roundings), the sign words of all CTAs
    making the next layer's input (words past M_max/32 all-ones). The head
    ``final_wp [Mf, KWf]``: CTA r counts over the words it computed, CTA 0
    also over the all-ones words past M_max/32, the CTAs' counts added,
    then ``2 * count - final_k_bits``. Output columns at or past ``n_real``
    (default N) are 0. Returns packed ``[ceil(m_out/32), N]``, or the
    head's int32 ``[Mf, N]``."""
    n_layers, m_max, kw_max = w_stack.shape
    m_words = m_max // PACK_BITS
    kw_act = max(kw_max, m_words)
    s = cluster or math.gcd(16, m_words)
    rows = m_max // s
    n = xp.shape[1]
    act = torch.nn.functional.pad(xp, (0, 0, 0, kw_act - xp.shape[0]), value=-1)
    for l in range(n_layers):
        kw = min(kw_max, -(-int(k_bits[l]) // PACK_BITS))
        parts, per = chain_work(rows // 16, kw)
        words = []
        for r in range(s):
            own = slice(r * rows, (r + 1) * rows)
            count = torch.zeros((rows, n), dtype=torch.int64, device=xp.device)
            for q in range(parts):
                lo, hi = q * per * CHAIN_GROUP, min(kw, (q + 1) * per * CHAIN_GROUP)
                count += xnor_counts_and_popc(w_stack[l, own, lo:hi], act[lo:hi])
            dot = (2 * count - int(k_bits[l])).float()
            y = a_stack[l, own, None] * dot + b_stack[l, own, None]
            words.append(pack_bits(y, axis=0))
        act = torch.nn.functional.pad(torch.cat(words), (0, 0, 0, kw_act - m_words),
                                      value=-1)
    if final_wp is None:
        out = act[:-(-m_out // PACK_BITS)]
    else:
        mf, kwf = final_wp.shape
        wpc = rows // PACK_BITS
        count = torch.zeros((mf, n), dtype=torch.int64, device=xp.device)
        ranges = [(r * wpc, min(kwf, (r + 1) * wpc)) for r in range(s)]
        ranges.append((m_words, kwf))       # CTA 0's all-ones words
        for lo, hi in ranges:
            if lo < hi:
                count += xnor_counts_and_popc(final_wp[:, lo:hi], act[lo:hi])
        out = (2 * count - final_k_bits).to(torch.int32)
    keep = torch.arange(n, device=out.device) < (n if n_real is None else n_real)
    return torch.where(keep[None, :], out, torch.zeros_like(out))


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
    words ``patches [P, K]`` (:func:`_slab_counts`)."""
    return (2 * _slab_counts(wp, patches.T, slab) - k_bits).to(torch.int32)


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
                      chunk: int = 128, return_states: bool = False):
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
    dtype, C ``[BH, dk, dv]``, n ``[BH, 1, dk]``, m ``[BH, 1, 1]``);
    ``return_states`` adds the states entering chunks 1.. that
    :func:`mlstm_chunked_bwd_ref` takes, C's ``[BH, S/L - 1, dk, dv]``
    and n's ``[BH, S/L - 1, dk]`` (the CUDA kernel's scratch layout)."""
    bh, s, dk = q.shape
    dv = v.shape[-1]
    ln, nc, b_cum, g, big_m = _mlstm_gates(logi, logf, chunk)
    dev = q.device
    tril = torch.ones((ln, ln), dtype=torch.bool, device=dev).tril()
    C = torch.zeros((bh, dk, dv), device=dev)
    n = torch.zeros((bh, 1, dk), device=dev)
    m = torch.full((bh,), NEG, device=dev)
    ys, cs, ns = [], [], []
    for c in range(nc):
        if c:
            cs.append(C)
            ns.append(n[:, 0])
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
    out = torch.cat(ys, dim=1).to(q.dtype), C, n, m.reshape(bh, 1, 1)
    if not return_states:
        return out
    return (*out, torch.stack(cs, 1) if cs else q.new_zeros((bh, 0, dk, dv)),
            torch.stack(ns, 1) if ns else q.new_zeros((bh, 0, dk)))


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
    m_in, m_last = _mlstm_chain(b_cum, big_m)             # [BH, nc] each
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
            (b_cum[:, -1, -1] + m_last[:, -1]).reshape(bh, 1, 1))


def _mlstm_chain(b_cum: torch.Tensor, big_m: torch.Tensor):
    """The stabilizer entering each chunk (``m_in``, -1e30 for the first)
    and ``m_L = max(M_L, m_in)`` of each, ``[BH, nc]``, in the forward's
    order of operations."""
    m_prev = [torch.full(b_cum.shape[:1], NEG, device=b_cum.device)]
    for c in range(b_cum.shape[1] - 1):
        m_prev.append(b_cum[:, c, -1] + torch.maximum(big_m[:, c, -1], m_prev[c]))
    m_in = torch.stack(m_prev, 1)
    return m_in, torch.maximum(big_m[..., -1], m_in)


def _half_at_ties(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The share of ``max(x, y)``'s gradient that goes to ``x``, as
    ``jax.grad`` splits it: 1 where x > y, 1/2 at a tie, else 0."""
    return torch.where(x > y, 1.0, torch.where(x == y, 0.5, 0.0))


def mlstm_chunked_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          logi: torch.Tensor, logf: torch.Tensor,
                          y: torch.Tensor, states: torch.Tensor,
                          nstates: torch.Tensor, dy: torch.Tensor,
                          dC: torch.Tensor | None = None,
                          dn: torch.Tensor | None = None, *,
                          chunk: int = 128) -> tuple[torch.Tensor, ...]:
    """The gradients ``(dq, dk, dv, dlogi, dlogf)`` of
    :func:`mlstm_chunked_ref` from its output ``y`` and the states entering
    chunks 1.. (``states [BH, S/L - 1, dk, dv]``, ``nstates [BH, S/L - 1,
    dk]``), given ``dy`` and the final state's ``dC [BH, dk, dv]`` and
    ``dn [BH, 1, dk]`` (None: zero), with no autograd. The final ``m`` has
    no gradient: it is a stabilizer no caller differentiates through.

    Within a chunk, with ``D = max(|den|, 1)``: ``dnum = dy / D``,
    ``dden = -(dy . y) / D`` times ``sign(den)`` where ``|den| > 1`` (half
    of it at ``|den| = 1``, as ``jax.grad`` splits a tie of ``max``), 0
    under the clamp; ``dSW = dnum V^T + dden`` on the causal triangle; the
    intra-chunk products and ``q C_in``, ``q . n_in`` give ``dq, dk, dv``
    and the gradients of the log-weights; the state gradients run as a
    reverse scan over chunks, ``dC_in = exp(m_in - m_L) dC_out + Q^T
    (inter dnum)``, seeded by ``dC``. The stabilizer does not cancel
    where ``D`` clamps, so the gradient flows through ``m_loc = max(M,
    m_in)`` (ties split in halves), the running max ``M`` (to the latest
    maximum of ``g``, torch.cummax's index) and the chain ``m' = b_L +
    m_L`` back to earlier chunks; ``g = logi - b``, ``b`` the cumsum of
    ``logf``, give ``dlogi = dg`` and ``dlogf`` the reverse cumsum of
    ``-dg`` (plus ``dm'`` at the chunk's last step)."""
    bh, s, dk = q.shape
    dv = v.shape[-1]
    ln, nc, b_cum, g, big_m = _mlstm_gates(logi, logf, chunk)
    dev = q.device
    m_in, m_last = _mlstm_chain(b_cum, big_m)
    c_in = torch.cat([torch.zeros((bh, 1, dk, dv), device=dev), states.float()], 1)
    n_in = torch.cat([torch.zeros((bh, 1, dk), device=dev), nstates.float()], 1)
    qc, kc, vc, yc, dyc = (x.float().reshape(bh, nc, ln, x.shape[-1])
                           for x in (q, k, v, y, dy))
    m_loc = torch.maximum(big_m, m_in[..., None])
    inter = torch.exp(m_in[..., None] - m_loc)
    tril = torch.ones((ln, ln), dtype=torch.bool, device=dev).tril()
    w = torch.where(tril, torch.exp(g[..., None, :] - m_loc[..., :, None]), 0.0)
    sw = torch.matmul(qc, kc.transpose(-1, -2)) * w
    qn = (qc * n_in[:, :, None, :]).sum(-1)
    den = sw.sum(-1) + qn * inter
    dmax = torch.clamp(den.abs(), min=1.0)
    dnum = dyc / dmax[..., None]
    dden = (-(dyc * yc).sum(-1) / dmax * torch.sign(den)
            * _half_at_ties(den.abs(), torch.ones_like(den)))
    dsw = torch.where(tril, torch.matmul(dnum, vc.transpose(-1, -2)) + dden[..., None], 0.0)
    dlogw = dsw * sw
    dsc = dsw * w
    dq = torch.matmul(dsc, kc)
    dk_ = torch.matmul(dsc.transpose(-1, -2), qc)
    dv_ = torch.matmul(sw.transpose(-1, -2), dnum)
    p7 = torch.matmul(dnum, c_in.transpose(-1, -2))
    dq = dq + inter[..., None] * p7 + (inter * dden)[..., None] * n_in[:, :, None, :]
    dinter = (qc * p7).sum(-1) + dden * qn
    dc_loc = torch.matmul(qc.transpose(-1, -2), inter[..., None] * dnum)
    dn_loc = (qc * (inter * dden)[..., None]).sum(2)
    decay = torch.exp(m_in - m_last)
    dc_out = [None] * nc
    dn_out = [None] * nc
    dc_out[-1] = torch.zeros((bh, dk, dv), device=dev) if dC is None else dC.float()
    dn_out[-1] = (torch.zeros((bh, dk), device=dev) if dn is None
                  else dn.float().reshape(bh, dk))
    for c in range(nc - 1, 0, -1):
        dc_out[c - 1] = decay[:, c, None, None] * dc_out[c] + dc_loc[:, c]
        dn_out[c - 1] = decay[:, c, None] * dn_out[c] + dn_loc[:, c]
    dc_out, dn_out = torch.stack(dc_out, 1), torch.stack(dn_out, 1)
    wk = torch.exp(g - m_last[..., None])
    p8 = torch.matmul(vc, dc_out.transpose(-1, -2)) + dn_out[:, :, None, :]
    dk_ = dk_ + wk[..., None] * p8
    dv_ = dv_ + wk[..., None] * torch.matmul(kc, dc_out)
    dwk = (kc * p8).sum(-1)
    ddecay = (dc_out * c_in).sum((-1, -2)) + (dn_out * n_in).sum(-1)

    # The gates, chunk by chunk from the last, carrying dm_out: the
    # gradient of the stabilizer leaving the chunk (0 for the final m).
    row_lw, col_lw = dlogw.sum(-1), dlogw.sum(-2)
    arg = torch.cummax(g, dim=-1).indices
    dlogi = torch.empty((bh, nc, ln), device=dev)
    dlogf = torch.empty((bh, nc, ln), device=dev)
    dm_out = torch.zeros((bh,), device=dev)
    for c in range(nc - 1, -1, -1):
        f = _half_at_ties(big_m[:, c], m_in[:, c, None])
        it, wt = dinter[:, c] * inter[:, c], dwk[:, c] * wk[:, c]
        dd = ddecay[:, c] * decay[:, c]
        dm_loc = -row_lw[:, c] - it
        dm_l = dm_out - wt.sum(-1) - dd
        dm_in = it.sum(-1) + dd + (dm_loc * (1 - f)).sum(-1) + dm_l * (1 - f[:, -1])
        dbig_m = dm_loc * f
        dbig_m[:, -1] += dm_l * f[:, -1]
        dg = (col_lw[:, c] + wt).scatter_add(-1, arg[:, c], dbig_m)
        db = -dg
        db[:, -1] += dm_out
        dlogi[:, c] = dg
        dlogf[:, c] = db.flip(-1).cumsum(-1).flip(-1)
        dm_out = dm_in
    return (dq.reshape(bh, s, dk), dk_.reshape(bh, s, dk),
            dv_.reshape(bh, s, dv), dlogi.reshape(bh, s), dlogf.reshape(bh, s))
