// Chunkwise stabilized mLSTM from a zero state, carrying the matrix memory
// C [dk, dv], the normalizer n [dk] and the stabilizer m across chunks of
// L steps. Within chunk c (m = the stabilizer carried in, -1e30 at first):
//   b = sequential cumsum of logf, g = logi - b, M = running max of g,
//   m_loc_t = max(M_t, m),
//   y_t = (sum_{j<=t} (q_t . k_j) exp(g_j - m_loc_t) v_j
//          + (q_t C) exp(m - m_loc_t)) / max(|den_t|, 1),
//   den_t = the same two sums with a ones column for v and n for C;
//   with m_L = max(M_{L-1}, m): C' = exp(m - m_L) C + sum_j exp(g_j - m_L)
//   k_j v_j^T, n' likewise, m' = b_{L-1} + m_L,
// for q (pre-scaled), k [BH, S, dk], v [BH, S, dv], logi, logf [BH, S],
// float32 contiguous -> y [BH, S, dv], C [BH, dk, dv], n [BH, dk], m [BH].
//
// Replaces the Pallas kernel `mlstm_chunked` (src/repro/kernels/mlstm_chunk.py,
// pallas_call at :112). Plain twin: repro_torch.kernels.ref.mlstm_chunked_ref;
// the decomposition below, as plain torch: ref.mlstm_chunked_states_ref.
//
// Bound on the H100 at the xlstm-1.3b training shape (BH 8, S 4096, dk = dv
// 1024, L 256, 16 chunks): operations. Per (bh, chunk) L(L+1)(dk + dv)
// (the causal q k^T and S v) + 4 L dk dv (q C and the update of C), 155
// GFLOP in all = 2.31 ms at 67 TFLOP/s (float32 on the CUDA cores, the
// rate of the reference's arithmetic); the operands are 0.4 GB = 0.12 ms
// at 3.35 TB/s.
//
// Design. The recurrence over chunks is only the elementwise
// C_{c+1} = dec_c C_c + U_c with U_c = (k_c w_c)^T v_c: none of the
// products depends on it. So the products run over every (bh, chunk) at
// once, as in the xLSTM authors' chunkwise kernels (TFLA), in five
// launches:
//  1. gates_chunk, one block per (chunk, bh): the chunk's sequential cumsum
//     b (one thread, the twin's order), g = logi - b and its running max M
//     (a block scan: max is exact in any order).
//  2. gates_chain, one block per (chunk, bh): the stabilizer chain over the
//     chunks before it (one thread, the twin's order), then m_loc,
//     exp(m - m_loc), exp(g - m_L) per step, exp(m - m_L) per chunk, and
//     the final m.
//  3. intra, one block per (128 x 128 tile of the chunk's [L, L] weights,
//     chunk, bh): S[t, j] = (q_t . k_j) exp(g_j - m_loc_t) for j <= t, else
//     0, into a scratch buffer; tiles wholly above the diagonal are not
//     computed (and never read).
//  4. states, one block per (128 columns of v, 128 rows of dk, bh): walks
//     the chunks in order with its tile of C in registers, computes U_c
//     (k scaled by exp(g - m_L) in its fragments), folds it in and
//     writes the state entering each later chunk to scratch
//     [BH, nc - 1, dk, dv] (n's to [BH, nc - 1, dk]), then the final C, n.
//     C and U take 128 registers a thread: one block an SM.
//  5. outputs, one block per (128 columns of v, 128 rows of the chunk,
//     chunk x bh), all independent: q C_c with q . n_c (none for chunk 0,
//     whose state is zero), (q C_c) exp(m - m_loc) parked in y, then S v
//     with S's row sums, then y.
// Every product (3-5) runs on the tensor cores as 3xTF32: each float32
// operand split into two tf32 halves (hi, lo), a_hi b_hi + a_hi b_lo +
// a_lo b_hi by mma.sync m16n8k8, float32 accumulation; each product is
// within ~2^-21 of the float32 one, and the sums run in another order than
// torch.matmul's, as any float32 GEMM's would. The tensor cores' float32
// accumulation truncates, so a sum over dk (S, q C) would drift by up to
// an ulp of its running value at each mma: kernels 3 and 5 add each
// 32-deep slab's partial to a total rounded to nearest (flush_acc), which
// takes them to 128 registers a thread and one block an SM (PERF.md has
// the error and time on an H100 with and without it); the states' sums
// run over one chunk, U from zero each time. Each product is
// one loop over 32-deep slabs of its contraction: a 3-stage cp.async ring
// (the next slab in flight during this one's math, one barrier a slab),
// 128 x 128 block tiles, 64 x 32 warp tiles; operands land as they are
// stored in memory: a K-contiguous operand (q, k in S, S) as rows of 36
// floats (ldmatrix's 16-byte rows of 8 neighbours hit distinct banks),
// the others as rows of 136 (8 mod 32: a fragment's 32 elements, k = t
// and n = g, one conflict-free load).
// Rounding elsewhere follows the reference's operations: separate
// roundings (__fmul_rn / __fadd_rn) where it multiplies and adds
// separately.
#include "mma.cuh"

namespace repro_torch {

constexpr float kMlNeg = -1e30f;
// -inf: the start of a running max.
#define REPRO_NEG_INF __int_as_float(0xff800000)
constexpr int kMlThreads = 256;
constexpr int kMlMaxL = 256;        // longest chunk (two row tiles)
constexpr int kMlMaxChunks = 1024;  // chunks the chain stages in shared memory
constexpr int kMlTile = 128;        // rows and columns of a block's output tile
constexpr int kMlSlab = 32;         // contraction depth of one stage
constexpr int kMlStages = 3;
constexpr int kMlLdk = kMlSlab + 4;   // stride of a K-contiguous slab: 4 mod 32
constexpr int kMlLdn = kMlTile + 8;   // stride of a [k][128] slab: 8 mod 32
constexpr int kMlOperand = kMlTile * kMlLdk;    // floats of one operand's stage
constexpr int kMlStage = 2 * kMlOperand + kMlSlab;  // A, B and a vector (n)
constexpr size_t kMlRingBytes = sizeof(float) * kMlStages * kMlStage;

// Slab [rows 0..127][k0, k0 + 32) of an operand whose k is contiguous
// (row stride ld, from `src`, rows past `rows` and k past `k_end` zero)
// into dst[row][kk] (stride kMlLdk). 16 bytes a copy, 4 a thread.
__device__ __forceinline__ void load_kc(float* dst, const float* src,
                                        long long ld, int rows, int k0,
                                        int k_end) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int idx = threadIdx.x + q * kMlThreads;
    const int r = idx >> 3, kk = (idx & 7) * 4;
    const bool ok = r < rows && k0 + kk < k_end;
    cp_async16(dst + r * kMlLdk + kk, ok ? src + r * ld + k0 + kk : src,
               ok ? 16 : 0);
  }
}

// Slab [k0, k0 + 32) x [columns 0..127] of an operand whose columns are
// contiguous (row stride ld; columns past `cols` and k past `k_end` zero)
// into dst[kk][col] (stride kMlLdn).
__device__ __forceinline__ void load_mn(float* dst, const float* src,
                                        long long ld, int cols, int k0,
                                        int k_end) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int idx = threadIdx.x + q * kMlThreads;
    const int kk = idx >> 5, cc = (idx & 31) * 4;
    const bool ok = cc < cols && k0 + kk < k_end;
    cp_async16(dst + kk * kMlLdn + cc,
               ok ? src + static_cast<long long>(k0 + kk) * ld + cc : src,
               ok ? 16 : 0);
  }
}

// x = hi + lo + r, hi and lo tf32 (10 stored mantissa bits each, rounded
// to nearest), |r| <= 2^-22 |x|: x - hi is exact in float32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(__fsub_rn(x, __uint_as_float(hi))));
}

// c += A . B on the tensor cores, tf32 inputs, float32 accumulation.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A warp's 64 x 32 share of the block's 128 x 128 tile: warp w takes rows
// 64 (w / 4).. and columns 32 (w % 4)..; acc[mt][nt] is the m16n8 tile
// (mt, nt) in mma.sync's C layout (lane 4g + t: rows g, g + 8, columns
// 2t, 2t + 1).
using Acc = float[4][4][4];

// Row and column (in the block's tile) of acc[mt][nt][e].
__device__ __forceinline__ int frag_row(int mt, int e) {
  return (threadIdx.x >> 7) * 64 + mt * 16 + ((threadIdx.x & 31) >> 2) + (e >> 1) * 8;
}
__device__ __forceinline__ int frag_col(int nt, int e) {
  return ((threadIdx.x >> 5) & 3) * 32 + nt * 8 + 2 * (threadIdx.x & 3) + (e & 1);
}

__device__ __forceinline__ void zero_acc(Acc& acc) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// total += part, rounded to nearest; part = 0. The tensor cores' float32
// accumulation truncates, so a long contraction accumulated there drifts
// by up to an ulp of its running sum at each step: sums over more than
// one slab are carried here instead.
__device__ __forceinline__ void flush_acc(Acc& total, Acc& part) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        total[i][j][e] = __fadd_rn(total[i][j][e], part[i][j][e]);
        part[i][j][e] = 0.f;
      }
}

// acc += A . B over the slab's 32 k, as 3xTF32 on the tensor cores:
// a_lo b_hi + a_hi b_lo + a_hi b_hi, each product of float32 operands to
// within ~2^-21 of itself (a_lo b_lo and the remainders dropped); each
// pass runs over 8 tiles before the next touches an accumulator again, so
// the mma latency is hidden. A is K-contiguous ([128][kMlLdk]: ldmatrix)
// or not ([32][kMlLdn]: one conflict-free load an element, the stride 8
// mod 32); B likewise ([128 n][kMlLdk] or [32][kMlLdn]). `wa` (or null):
// A's element at k is first multiplied by wa[k], one rounding, as the
// twin's k * wk.
template <bool kAKc, bool kBKc>
__device__ __forceinline__ void slab_mma(const float* __restrict__ As,
                                         const float* __restrict__ Bs,
                                         const float* __restrict__ wa, Acc& acc) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = (threadIdx.x >> 7) * 64, col0 = ((threadIdx.x >> 5) & 3) * 32;
#pragma unroll
  for (int kk = 0; kk < kMlSlab; kk += 8) {
    uint32_t bh[4][2], bl[4][2];
    if constexpr (kBKc) {
      // ldmatrix.x4 of rows n: r = (b0, b1) of n-tile 2p, then of 2p + 1
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        uint32_t r[4];
        ldmatrix_x4(r, Bs + (col0 + p * 16 + (lane & 7) + ((lane >> 4) & 1) * 8) * kMlLdk +
                           kk + ((lane >> 3) & 1) * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          split_tf32(__uint_as_float(r[i]), bh[2 * p + (i >> 1)][i & 1],
                     bl[2 * p + (i >> 1)][i & 1]);
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float* p = Bs + (kk + t) * kMlLdn + col0 + nt * 8 + g;
        split_tf32(p[0], bh[nt][0], bl[nt][0]);
        split_tf32(p[4 * kMlLdn], bh[nt][1], bl[nt][1]);
      }
    }
    const float w0 = wa != nullptr ? wa[kk + t] : 1.f;
    const float w1 = wa != nullptr ? wa[kk + t + 4] : 1.f;
#pragma unroll
    for (int mp = 0; mp < 4; mp += 2) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int m2 = 0; m2 < 2; ++m2) {
        const int mt = mp + m2;
        float av[4];
        if constexpr (kAKc) {
          uint32_t r[4];
          ldmatrix_x4(r, As + (row0 + mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kMlLdk +
                             kk + (lane >> 4) * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) av[i] = __uint_as_float(r[i]);
        } else {
          const float* p = As + (kk + t) * kMlLdn + row0 + mt * 16 + g;
          av[0] = p[0];
          av[1] = p[8];
          av[2] = p[4 * kMlLdn];
          av[3] = p[4 * kMlLdn + 8];
        }
        if (wa != nullptr) {  // a0, a1 at k = kk + t; a2, a3 at kk + t + 4
          av[0] = __fmul_rn(av[0], w0);
          av[1] = __fmul_rn(av[1], w0);
          av[2] = __fmul_rn(av[2], w1);
          av[3] = __fmul_rn(av[3], w1);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(av[i], ah[m2][i], al[m2][i]);
      }
#pragma unroll
      for (int m2 = 0; m2 < 2; ++m2)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_tf32(acc[mp + m2][nt], al[m2], bh[nt][0], bh[nt][1]);
#pragma unroll
      for (int m2 = 0; m2 < 2; ++m2)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_tf32(acc[mp + m2][nt], ah[m2], bl[nt][0], bl[nt][1]);
#pragma unroll
      for (int m2 = 0; m2 < 2; ++m2)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_tf32(acc[mp + m2][nt], ah[m2], bh[nt][0], bh[nt][1]);
    }
  }
}

// --- 1. gates within a chunk -----------------------------------------------
// g [BH, S]; big_m [BH, S] (the running max of g; m_loc's buffer, which
// gates_chain turns into m_loc in place); bm [BH, nc, 2] = (b, M) at the
// chunk's last step.
__global__ void __launch_bounds__(kMlThreads)
mlstm_gates_chunk_kernel(const float* __restrict__ logi,
                         const float* __restrict__ logf, float* __restrict__ g,
                         float* __restrict__ big_m, float* __restrict__ bm,
                         int S, int L) {
  __shared__ float run[kMlMaxL];
  __shared__ float warp_max[kMlThreads / 32];
  const int c = blockIdx.x, bh = blockIdx.y, nc = S / L;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long base = static_cast<long long>(bh) * S + static_cast<long long>(c) * L;
  if (t < L) run[t] = logf[base + t];
  __syncthreads();
  if (t == 0) {
    float b = 0.f;
    for (int i = 0; i < L; ++i) {
      b = __fadd_rn(b, run[i]);
      run[i] = b;
    }
  }
  __syncthreads();
  float gv = REPRO_NEG_INF;
  if (t < L) {
    gv = __fsub_rn(logi[base + t], run[t]);
    g[base + t] = gv;
  }
  float mx = gv;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, mx, o);
    if (lane >= o) mx = fmaxf(mx, u);
  }
  if (lane == 31) warp_max[warp] = mx;
  __syncthreads();
  for (int w = 0; w < warp; ++w) mx = fmaxf(mx, warp_max[w]);
  if (t < L) big_m[base + t] = mx;
  if (t == L - 1) {
    const long long i = 2 * (static_cast<long long>(bh) * nc + c);
    bm[i] = run[L - 1];
    bm[i + 1] = mx;
  }
}

// --- 2. the stabilizer chain over chunks -------------------------------------
__global__ void __launch_bounds__(kMlThreads)
mlstm_gates_chain_kernel(const float* __restrict__ g, float* __restrict__ m_loc,
                         const float* __restrict__ bm, float* __restrict__ inter,
                         float* __restrict__ wk, float* __restrict__ decay,
                         float* __restrict__ m_out, int S, int L) {
  __shared__ float chain[2 * kMlMaxChunks];
  __shared__ float m_prev;
  const int c = blockIdx.x, bh = blockIdx.y, nc = S / L, t = threadIdx.x;
  const float* bmb = bm + 2 * static_cast<long long>(bh) * nc;
  for (int i = t; i < 2 * (c + 1); i += kMlThreads) chain[i] = bmb[i];
  __syncthreads();
  if (t == 0) {
    float m = kMlNeg;
    for (int cc = 0; cc < c; ++cc) m = __fadd_rn(chain[2 * cc], fmaxf(chain[2 * cc + 1], m));
    m_prev = m;
    if (c == nc - 1) m_out[bh] = __fadd_rn(chain[2 * c], fmaxf(chain[2 * c + 1], m));
  }
  __syncthreads();
  const float mp = m_prev;
  const float m_l = fmaxf(chain[2 * c + 1], mp);
  if (t == 0) decay[static_cast<long long>(bh) * nc + c] = expf(__fsub_rn(mp, m_l));
  if (t < L) {
    const long long i = static_cast<long long>(bh) * S + static_cast<long long>(c) * L + t;
    const float ml = fmaxf(m_loc[i], mp);
    m_loc[i] = ml;
    inter[i] = expf(__fsub_rn(mp, ml));
    wk[i] = expf(__fsub_rn(g[i], m_l));
  }
}

// --- 3. intra-chunk weights S ---------------------------------------------
// Block (tile, chunk, bh); tile 0 = rows and columns [0, 128), and for
// L > 128 tile 1 = (rows [128, L), columns [0, 128)), tile 2 = both [128, L).
__global__ void __launch_bounds__(kMlThreads, 1)
mlstm_intra_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ g, const float* __restrict__ m_loc,
                   float* __restrict__ sw, int S, int L, int dk) {
  extern __shared__ __align__(16) float ring[];
  const int c = blockIdx.y, bh = blockIdx.z, nc = S / L;
  const int t0 = blockIdx.x == 0 ? 0 : kMlTile, j0 = blockIdx.x == 2 ? kMlTile : 0;
  const long long row0 = static_cast<long long>(bh) * S + static_cast<long long>(c) * L;
  const int rows = min(kMlTile, L - t0), cols = min(kMlTile, L - j0);
  const float* qa = q + (row0 + t0) * dk;
  const float* kb = k + (row0 + j0) * dk;
  Acc acc, slab;
  zero_acc(acc);
  zero_acc(slab);
  const int slabs = (dk + kMlSlab - 1) / kMlSlab;
  auto load = [&](int s) {
    float* st = ring + (s % kMlStages) * kMlStage;
    load_kc(st, qa, dk, rows, s * kMlSlab, dk);
    load_kc(st + kMlOperand, kb, dk, cols, s * kMlSlab, dk);
  };
#pragma unroll
  for (int s = 0; s < kMlStages - 1; ++s) {
    if (s < slabs) load(s);
    cp_async_commit();
  }
  for (int s = 0; s < slabs; ++s) {
    cp_async_wait<kMlStages - 2>();
    __syncthreads();  // slab s has landed; slab s - 1's stage is free
    if (s + kMlStages - 1 < slabs) load(s + kMlStages - 1);
    cp_async_commit();
    const float* st = ring + (s % kMlStages) * kMlStage;
    slab_mma<true, true>(st, st + kMlOperand, nullptr, slab);
    flush_acc(acc, slab);
  }
  float* out = sw + (static_cast<long long>(bh) * nc + c) * L * L;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = t0 + frag_row(mt, 2 * h);
      if (t >= L) continue;
      const float ml = m_loc[row0 + t];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int jj = j0 + frag_col(nt, 0);  // and jj + 1 (L is even)
        if (jj >= L) continue;
        float2 val = make_float2(0.f, 0.f);
        if (jj <= t) val.x = __fmul_rn(acc[mt][nt][2 * h], expf(__fsub_rn(g[row0 + jj], ml)));
        if (jj + 1 <= t) {
          val.y = __fmul_rn(acc[mt][nt][2 * h + 1], expf(__fsub_rn(g[row0 + jj + 1], ml)));
        }
        *reinterpret_cast<float2*>(out + static_cast<long long>(t) * L + jj) = val;
      }
    }
}

// --- 4. chunk states --------------------------------------------------------
// Block (128 columns of v, 128 rows of dk, bh). Its tile of C stays in
// registers through the chunks; U_c accumulates beside it.
__global__ void __launch_bounds__(kMlThreads, 1)
mlstm_states_kernel(const float* __restrict__ k, const float* __restrict__ v,
                    const float* __restrict__ wk, const float* __restrict__ decay,
                    float* __restrict__ states, float* __restrict__ nstates,
                    float* __restrict__ c_out, float* __restrict__ n_out, int S,
                    int L, int dk, int dv) {
  extern __shared__ __align__(16) float ring[];
  const int j0 = blockIdx.x * kMlTile, d0 = blockIdx.y * kMlTile, bh = blockIdx.z;
  const int nc = S / L, tid = threadIdx.x;
  const int rows = min(kMlTile, dk - d0), cols = min(kMlTile, dv - j0);
  const bool with_n = blockIdx.x == 0;  // one block of each dk tile sums n
  const int per_chunk = (L + kMlSlab - 1) / kMlSlab, slabs = nc * per_chunk;
  auto chunk_row = [&](int s) {
    return static_cast<long long>(bh) * S + static_cast<long long>(s / per_chunk) * L;
  };
  auto load = [&](int s) {
    float* st = ring + (s % kMlStages) * kMlStage;
    const long long r0 = chunk_row(s);
    const int k0 = (s % per_chunk) * kMlSlab;
    load_mn(st, k + r0 * dk + d0, dk, rows, k0, L);
    load_mn(st + kMlOperand, v + r0 * dv + j0, dv, cols, k0, L);
    if (tid < kMlSlab / 4) {  // w = exp(g - m_L) of the slab's steps
      const bool ok = k0 + tid * 4 < L;
      cp_async16(st + 2 * kMlOperand + tid * 4, ok ? wk + r0 + k0 + tid * 4 : wk,
                 ok ? 16 : 0);
    }
  };
  Acc cst, u;
  zero_acc(cst);
  zero_acc(u);
  float n_st = 0.f, n_sum = 0.f;  // n of row d0 + tid (tid < 128)
#pragma unroll
  for (int s = 0; s < kMlStages - 1; ++s) {
    if (s < slabs) load(s);
    cp_async_commit();
  }
  for (int s = 0; s < slabs; ++s) {
    const int c = s / per_chunk;
    cp_async_wait<kMlStages - 2>();
    __syncthreads();
    if (s + kMlStages - 1 < slabs) load(s + kMlStages - 1);
    cp_async_commit();
    const float* st = ring + (s % kMlStages) * kMlStage;
    const float* w = st + 2 * kMlOperand;
    slab_mma<false, false>(st, st + kMlOperand, w, u);
    if (with_n && tid < kMlTile) {  // sum_j k_j w_j, the products rounded as the twin's
#pragma unroll 8
      for (int kk = 0; kk < kMlSlab; ++kk) {
        n_sum = __fadd_rn(n_sum, __fmul_rn(st[kk * kMlLdn + tid], w[kk]));
      }
    }
    if (s % per_chunk != per_chunk - 1) continue;
    // End of chunk c: C = dec C + U, n = dec n + sum_j k_j w_j; store the
    // state entering chunk c + 1, or the final one.
    const float dec = decay[static_cast<long long>(bh) * nc + c];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          cst[mt][nt][e] = __fadd_rn(__fmul_rn(dec, cst[mt][nt][e]), u[mt][nt][e]);
        }
    zero_acc(u);
    n_st = __fadd_rn(__fmul_rn(dec, n_st), n_sum);
    n_sum = 0.f;
    const bool last = c == nc - 1;
    float* cdst = last ? c_out + static_cast<long long>(bh) * dk * dv
                       : states + (static_cast<long long>(bh) * (nc - 1) + c) * dk * dv;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int d = d0 + frag_row(mt, 2 * h);
        if (d >= dk) continue;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int col = frag_col(nt, 0);
          if (col < cols) {
            *reinterpret_cast<float2*>(cdst + static_cast<long long>(d) * dv + j0 + col) =
                make_float2(cst[mt][nt][2 * h], cst[mt][nt][2 * h + 1]);
          }
        }
      }
    if (with_n && tid < rows) {
      float* ndst = last ? n_out + static_cast<long long>(bh) * dk
                         : nstates + (static_cast<long long>(bh) * (nc - 1) + c) * dk;
      ndst[d0 + tid] = n_st;
    }
  }
}

// --- 5. outputs ---------------------------------------------------------------
// Block (128 columns of v, 128 rows of the chunk, bh * nc + c). Dynamic
// shared memory: the ring, then q . n and the row sums of S, 128 each.
__global__ void __launch_bounds__(kMlThreads, 1)
mlstm_outputs_kernel(const float* __restrict__ q, const float* __restrict__ v,
                     const float* __restrict__ sw, const float* __restrict__ inter,
                     const float* __restrict__ states,
                     const float* __restrict__ nstates, float* __restrict__ y,
                     int S, int L, int dk, int dv) {
  extern __shared__ __align__(16) float ring[];
  float* dn_s = ring + kMlStages * kMlStage;
  float* di_s = dn_s + kMlTile;
  const int nc = S / L, tid = threadIdx.x;
  const int j0 = blockIdx.x * kMlTile, t0 = blockIdx.y * kMlTile;
  const int bh = blockIdx.z / nc, c = blockIdx.z % nc;
  const int rows = min(kMlTile, L - t0), cols = min(kMlTile, dv - j0);
  const int j_end = min(L, t0 + kMlTile);  // S[t, j] = 0 past the tile's last row
  const long long row0 = static_cast<long long>(bh) * S + static_cast<long long>(c) * L;
  const long long state = static_cast<long long>(bh) * (nc - 1) + c - 1;
  const int slabs_qc = c > 0 ? (dk + kMlSlab - 1) / kMlSlab : 0;  // C_0 = 0
  const int slabs = slabs_qc + (j_end + kMlSlab - 1) / kMlSlab;
  const float* qa = q + (row0 + t0) * dk;
  const float* sa = sw + ((static_cast<long long>(bh) * nc + c) * L + t0) * L;
  const float* vb = v + row0 * dv + j0;
  auto load = [&](int s) {
    float* st = ring + (s % kMlStages) * kMlStage;
    if (s < slabs_qc) {
      const int k0 = s * kMlSlab;
      load_kc(st, qa, dk, rows, k0, dk);
      load_mn(st + kMlOperand, states + state * dk * dv + j0, dv, cols, k0, dk);
      if (tid < kMlSlab / 4) {
        const bool ok = k0 + tid * 4 < dk;
        const float* src = nstates + state * dk + k0 + tid * 4;
        cp_async16(st + 2 * kMlOperand + tid * 4, ok ? src : nstates, ok ? 16 : 0);
      }
    } else {
      const int k0 = (s - slabs_qc) * kMlSlab;
      load_kc(st, sa, L, rows, k0, j_end);
      load_mn(st + kMlOperand, vb, dv, cols, k0, j_end);
    }
  };
  Acc acc, slab;
  zero_acc(acc);
  zero_acc(slab);
  // q . n (then S's row sums) of row tid / 2 over half the slab each
  const int rr = tid >> 1, half = (tid & 1) * (kMlSlab / 2);
  float part = 0.f;
#pragma unroll
  for (int s = 0; s < kMlStages - 1; ++s) {
    if (s < slabs) load(s);
    cp_async_commit();
  }
  for (int s = 0; s < slabs; ++s) {
    cp_async_wait<kMlStages - 2>();
    __syncthreads();
    if (s + kMlStages - 1 < slabs) load(s + kMlStages - 1);
    cp_async_commit();
    const float* st = ring + (s % kMlStages) * kMlStage;
    slab_mma<true, false>(st, st + kMlOperand, nullptr, slab);
    flush_acc(acc, slab);
    const float* ar = st + rr * kMlLdk + half;
    if (s < slabs_qc) {
      const float* nv = st + 2 * kMlOperand + half;
#pragma unroll
      for (int e = 0; e < kMlSlab / 2; ++e) part = fmaf(ar[e], nv[e], part);
    } else {
#pragma unroll
      for (int e = 0; e < kMlSlab / 2; ++e) part = __fadd_rn(part, ar[e]);
    }
    if (s != slabs_qc - 1) continue;
    // q C done: park (q C) exp(m - m_loc) in y, keep q . n
    part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, 1));
    if (half == 0) dn_s[rr] = part;
    part = 0.f;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = t0 + frag_row(mt, 2 * h);
        if (t >= L) continue;
        const float e = inter[row0 + t];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int col = frag_col(nt, 0);
          if (col < cols) {
            *reinterpret_cast<float2*>(y + (row0 + t) * dv + j0 + col) =
                make_float2(__fmul_rn(acc[mt][nt][2 * h], e),
                            __fmul_rn(acc[mt][nt][2 * h + 1], e));
          }
        }
      }
    zero_acc(acc);
  }
  part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, 1));
  if (half == 0) di_s[rr] = part;
  __syncthreads();
  // y = (S v + (q C) e) / max(|S 1 + (q . n) e|, 1), e = exp(m - m_loc)
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = frag_row(mt, 2 * h), t = t0 + r;
      if (t >= L) continue;
      const float e = inter[row0 + t];
      const float dn = c > 0 ? dn_s[r] : 0.f;
      const float den = fmaxf(fabsf(__fadd_rn(di_s[r], __fmul_rn(dn, e))), 1.f);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = frag_col(nt, 0);
        if (col >= cols) continue;
        float2* dst = reinterpret_cast<float2*>(y + (row0 + t) * dv + j0 + col);
        float2 out = make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
        if (c > 0) {
          const float2 qc = *dst;
          out.x = __fadd_rn(out.x, qc.x);
          out.y = __fadd_rn(out.y, qc.y);
        }
        out.x = out.x / den;
        out.y = out.y / den;
        *dst = out;
      }
    }
}

}  // namespace repro_torch

// q, k [BH, S, dk], v [BH, S, dv], logi, logf [BH, S] -> y [BH, S, dv],
// C [BH, dk, dv], n [BH, dk], m [BH]; float32, contiguous, 16-byte aligned.
// Scratch: sw [BH, S/L, L, L], g, m_loc, inter, wk [BH, S], decay [BH, S/L],
// bm [BH, S/L, 2], states [BH, S/L - 1, dk, dv], nstates [BH, S/L - 1, dk].
// S % L == 0, L % 8 == 0, L <= 256, S/L <= 1024, BH * S/L <= 65535,
// dk / 128 <= 65535 (rounded up), dk % 4 == dv % 4 == 0.
extern "C" int repro_mlstm_chunked(const void* q, const void* k, const void* v,
                                   const void* logi, const void* logf, void* y,
                                   void* c_out, void* n_out, void* m_out,
                                   void* sw, void* g, void* m_loc, void* inter,
                                   void* wk, void* decay, void* bm, void* states,
                                   void* nstates, int BH, int S, int L, int dk,
                                   int dv, void* stream) {
  using namespace repro_torch;
  if (L < 8 || L > kMlMaxL || L % 8 || S % L || S / L > kMlMaxChunks ||
      static_cast<long long>(BH) * (S / L) > 65535 ||
      (dk + kMlTile - 1) / kMlTile > 65535 || dk % 4 || dv % 4 ||
      dk < 4 || dv < 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* fq = static_cast<const float*>(q);
  const auto* fk = static_cast<const float*>(k);
  const auto* fv = static_cast<const float*>(v);
  auto* fg = static_cast<float*>(g);
  auto* fm = static_cast<float*>(m_loc);
  auto* fi = static_cast<float*>(inter);
  auto* fw = static_cast<float*>(wk);
  auto* fd = static_cast<float*>(decay);
  auto* fsw = static_cast<float*>(sw);
  auto* fst = static_cast<float*>(states);
  auto* fns = static_cast<float*>(nstates);
  const int nc = S / L;
  const int out_smem = static_cast<int>(kMlRingBytes + 2 * kMlTile * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_intra_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, out_smem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(mlstm_states_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, out_smem);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(mlstm_outputs_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, out_smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  mlstm_gates_chunk_kernel<<<dim3(nc, BH), kMlThreads, 0, s>>>(
      static_cast<const float*>(logi), static_cast<const float*>(logf), fg, fm,
      static_cast<float*>(bm), S, L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mlstm_gates_chain_kernel<<<dim3(nc, BH), kMlThreads, 0, s>>>(
      fg, fm, static_cast<const float*>(bm), fi, fw, fd,
      static_cast<float*>(m_out), S, L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mlstm_intra_kernel<<<dim3(L > kMlTile ? 3 : 1, nc, BH), kMlThreads, kMlRingBytes, s>>>(
      fq, fk, fg, fm, fsw, S, L, dk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mlstm_states_kernel<<<dim3((dv + kMlTile - 1) / kMlTile, (dk + kMlTile - 1) / kMlTile, BH),
                        kMlThreads, kMlRingBytes, s>>>(
      fk, fv, fw, fd, fst, fns, static_cast<float*>(c_out),
      static_cast<float*>(n_out), S, L, dk, dv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mlstm_outputs_kernel<<<dim3((dv + kMlTile - 1) / kMlTile, (L + kMlTile - 1) / kMlTile,
                              BH * nc),
                         kMlThreads, out_smem, s>>>(
      fq, fv, fsw, fi, fst, fns, static_cast<float*>(y), S, L, dk, dv);
  return static_cast<int>(cudaGetLastError());
}
