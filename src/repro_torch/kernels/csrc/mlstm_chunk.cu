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
// twin's k * wk. `wb` (or null; B stored [32][kMlLdn] only): B's element
// at k multiplied by wb[k] likewise.
template <bool kAKc, bool kBKc>
__device__ __forceinline__ void slab_mma(const float* __restrict__ As,
                                         const float* __restrict__ Bs,
                                         const float* __restrict__ wa, Acc& acc,
                                         const float* __restrict__ wb = nullptr) {
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
      const float v0 = wb != nullptr ? wb[kk + t] : 1.f;
      const float v1 = wb != nullptr ? wb[kk + t + 4] : 1.f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float* p = Bs + (kk + t) * kMlLdn + col0 + nt * 8 + g;
        float b0 = p[0], b1 = p[4 * kMlLdn];
        if (wb != nullptr) {
          b0 = __fmul_rn(b0, v0);
          b1 = __fmul_rn(b1, v1);
        }
        split_tf32(b0, bh[nt][0], bl[nt][0]);
        split_tf32(b1, bh[nt][1], bl[nt][1]);
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

// ============================================================================
// The backward: dq, dk, dv, dlogi, dlogf of the chunkwise mLSTM above from
// its inputs, its output y, the states entering chunks 1.. (the forward's
// `states`, `nstates` scratch), dy and the final state's dC, dn (zero when
// absent); the final m gets no gradient. Per chunk, with D = max(|den|, 1)
// and W[t, j] = exp(g_j - m_loc_t) (j <= t):
//   dnum = dy / D, dden = -(dy . y) / D sign(den) (1/2 of it at |den| = 1,
//   0 below: jax.grad splits a tie of max in halves),
//   dSW = dnum V^T + dden (causal triangle), dS = dSW o W, dlogW = dSW o SW,
//   dq = dS K + inter (dnum C_in^T) + inter dden n_in, dk = dS^T Q,
//   dv = SW^T dnum; then the state gradients as a reverse scan over chunks,
//   dC_out[c-1] = exp(m_in - m_L)_c dC_out[c] + Q_c^T (inter dnum)_c (and
//   n's), and from them dk += wk (V dC_out^T + dn_out), dv += wk K dC_out;
//   last the gates, chunk by chunk from the last: the stabilizer does not
//   cancel where D clamps, so the gradients of m_loc = max(M, m_in), of
//   m_L and of the chain m' = b_L + m_L go to the running max M (to the
//   latest maximum of g, torch.cummax's index) and to the previous chunk;
//   dlogi = dg, dlogf = the reverse cumsum of -dg (+ dm' at the last step).
//
// Replaces no Pallas kernel: the JAX package has no backward for its
// `mlstm_chunked`; this computes jax.grad of the reference path
// `_mlstm_chunk` (src/repro/models/xlstm.py:49-93) scanned over chunks
// (:146). Plain twin: repro_torch.kernels.ref.mlstm_chunked_bwd_ref, the
// same decomposition in plain torch.
//
// Bound on the H100 at the xlstm-1.3b training shape (BH 8, S 4096, dk = dv
// 1024, L 256): operations. Nine products per chunk, five over [L, L]
// (S again, dnum V^T, SW^T dnum, dS K, dS^T Q: 2 L^2 d each) and four over
// [L, d] x [d, d] (dnum C^T, Q^T dnum, V dC^T, K dC: 2 L d^2 each), 361
// GFLOP as computed; the causal half of the [L, L] ones, 318 GFLOP, =
// 4.75 ms at 67 TFLOP/s (float32 on the CUDA cores).
//
// Design. The nine products run on the forward's tensor-core machinery
// (split_tf32, mma_tf32, slab_mma, flush_acc: 3xTF32 mma.sync, each
// product within ~2^-21 of float32, sums over more than one 32-deep slab
// carried in a float32 total rounded to nearest) through one batched
// kernel, mlstm_bwd_mma_kernel: 128 x 128 block tiles, 64 x 32 warp
// tiles, a 3-stage cp.async ring of 32-deep slabs, either operand read
// as stored (k contiguous or not), batched over (bh, chunk) by pointer
// strides, its scales folded in (a scale along k into the B operand as
// it is split, one along the rows and an accumulate into the store). On
// the [L, L] products it skips what lies wholly above the diagonal: the
// output tiles of S and dSW (the row kernels read only t >= j), and the
// slabs of dS (dq: j <= t) or its transpose (dk, dv: t >= j) that are
// zero. Bound by the tensor cores' tf32 rate: 3 x 318 GFLOP in 1.93 ms.
// The elementwise and row work (the weights, den and D, dS and the
// log-weight sums, the row dots) runs one warp a row; the reverse scan
// over chunks one thread an element of (C, n); the gates one block a
// (bh) with the sequential parts (running max, the argmax routing, the
// reverse cumsum) on one thread. Every sum has a fixed order: no atomics,
// deterministic.
// ============================================================================

namespace repro_torch {

// Slots of the [BH, S] (vec) and [BH, S/L] (cvec) vectors of the scratch:
// ops.MLSTM_BWD_VECS = 10 and ops.MLSTM_BWD_CVECS = 5 of them (bm takes two).
enum { kVG, kVMloc, kVInter, kVWk, kVDden, kVQn, kVDinter, kVDwk, kVRow, kVCol };
enum { kCBm = 0, kCDecay = 2, kCDdecay = 3, kCMout = 4 };

// What a product skips on an [L, L] operand: nothing; output tiles wholly
// above the diagonal (n > m); slabs past the diagonal of a lower-
// triangular A (k > m); slabs before the diagonal of an upper-triangular
// A (k < m).
enum { kTriNone, kTriOut, kTriALower, kTriAUpper };

struct GemmOp {
  const float* a;     // op(A) [M, K]: A[m * lda + k], or A[k * lda + m] (ta)
  const float* b;     // op(B) [K, N]: B[k * ldb + n], or B[n * ldb + k] (tb)
  float* c;           // C [M, N], C[m * ldc + n]
  const float* kscale;   // op(B)[k, :] scaled by kscale[k], or NULL (tb = 0)
  const float* rscale;   // the product's row m scaled by rscale[m], or NULL
  long long lda, ldb, ldc;
  // batch z = bh * nb + cb: every pointer advances by its (bh, cb) strides
  long long sa_bh, sa_c, sb_bh, sb_c, sc_bh, sc_c, sk_bh, sk_c, sr_bh, sr_c;
  int M, N, K, nb, ta, tb, accumulate, tri;
};

// C = (accumulate ? C : 0) + rscale * (op(A) diag(kscale) op(B)), 3xTF32
// on the tensor cores; block (128 columns, 128 rows, batch).
template <bool kAKc, bool kBKc>
__global__ void __launch_bounds__(kMlThreads, 1)
mlstm_bwd_mma_kernel(const GemmOp p) {
  extern __shared__ __align__(16) float ring[];
  const int z = blockIdx.z, bh = z / p.nb, cb = z % p.nb;
  const int m0 = blockIdx.y * kMlTile, n0 = blockIdx.x * kMlTile, tid = threadIdx.x;
  if (p.tri == kTriOut && n0 > m0 + kMlTile - 1) return;
  const float* A = p.a + bh * p.sa_bh + cb * p.sa_c;
  const float* B = p.b + bh * p.sb_bh + cb * p.sb_c;
  float* C = p.c + bh * p.sc_bh + cb * p.sc_c;
  const float* ks = p.kscale ? p.kscale + bh * p.sk_bh + cb * p.sk_c : nullptr;
  const float* rs = p.rscale ? p.rscale + bh * p.sr_bh + cb * p.sr_c : nullptr;
  const int k_begin = p.tri == kTriAUpper ? m0 : 0;
  const int k_end = p.tri == kTriALower ? min(p.K, m0 + kMlTile) : p.K;
  const int rows = min(kMlTile, p.M - m0), cols = min(kMlTile, p.N - n0);
  const int slabs = k_end > k_begin ? (k_end - k_begin + kMlSlab - 1) / kMlSlab : 0;
  const float* a0 = kAKc ? A + static_cast<long long>(m0) * p.lda : A + m0;
  const float* b0 = kBKc ? B + static_cast<long long>(n0) * p.ldb : B + n0;
  auto load = [&](int s) {
    float* st = ring + (s % kMlStages) * kMlStage;
    const int k0 = k_begin + s * kMlSlab;
    if constexpr (kAKc) load_kc(st, a0, p.lda, rows, k0, k_end);
    else load_mn(st, a0, p.lda, rows, k0, k_end);
    if constexpr (kBKc) load_kc(st + kMlOperand, b0, p.ldb, cols, k0, k_end);
    else load_mn(st + kMlOperand, b0, p.ldb, cols, k0, k_end);
    if (ks != nullptr && tid < kMlSlab / 4) {
      const bool ok = k0 + tid * 4 < k_end;
      cp_async16(st + 2 * kMlOperand + tid * 4, ok ? ks + k0 + tid * 4 : ks, ok ? 16 : 0);
    }
  };
  Acc acc, slab;
  zero_acc(acc);
  zero_acc(slab);
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
    slab_mma<kAKc, kBKc>(st, st + kMlOperand, nullptr, slab,
                         ks != nullptr ? st + 2 * kMlOperand : nullptr);
    flush_acc(acc, slab);
  }
  cp_async_wait<0>();
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + frag_row(mt, 2 * h);
      if (m >= p.M) continue;
      const float r = rs != nullptr ? rs[m] : 1.f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = n0 + frag_col(nt, 0);  // and n + 1 (N is a multiple of 4)
        if (n >= p.N) continue;
        float2 val = make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
        if (rs != nullptr) {
          val.x = __fmul_rn(r, val.x);
          val.y = __fmul_rn(r, val.y);
        }
        float2* dst = reinterpret_cast<float2*>(C + static_cast<long long>(m) * p.ldc + n);
        if (p.accumulate) {
          const float2 old = *dst;
          val.x = __fadd_rn(old.x, val.x);
          val.y = __fadd_rn(old.y, val.y);
        }
        *dst = val;
      }
    }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

struct MlBwd {
  const float *q, *k, *v, *y, *states, *nstates, *dy, *dC, *dn;
  float *dq, *dk, *dv, *dlogi, *dlogf;
  float *sw, *dsw, *dnum, *prod, *dc_out, *dn_out, *vec, *cvec;
  int BH, S, L, dk_, dv_, nc;
  __device__ float* vecp(int slot) const {
    return vec + static_cast<long long>(slot) * BH * S;
  }
  __device__ float* cvecp(int slot) const {
    return cvec + static_cast<long long>(slot) * BH * nc;
  }
};

// One warp a row t of chunk c: SW[t, :] (zero past t) and its sum, q . n_in,
// den, D, dy . y, dden, and dnum = dy / D.
__global__ void mlstm_bwd_rows_kernel(const MlBwd p) {
  const long long row = static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= static_cast<long long>(p.BH) * p.S) return;
  const int bh = static_cast<int>(row / p.S), pos = static_cast<int>(row % p.S);
  const int c = pos / p.L, t = pos % p.L;
  const long long base = static_cast<long long>(bh) * p.S + static_cast<long long>(c) * p.L;
  const float* g = p.vecp(kVG) + base;
  const float ml = p.vecp(kVMloc)[row];
  float* swr = p.sw + (static_cast<long long>(bh) * p.nc + c) * p.L * p.L +
               static_cast<long long>(t) * p.L;
  float den_i = 0.f;
  for (int j = lane; j < p.L; j += 32) {
    // S above the diagonal is not computed (its tiles are skipped): zero it
    const float x = j <= t ? __fmul_rn(swr[j], expf(__fsub_rn(g[j], ml))) : 0.f;
    swr[j] = x;
    den_i += x;
  }
  den_i = warp_sum(den_i);
  float qn = 0.f;
  if (c > 0) {
    const float* nin = p.nstates + (static_cast<long long>(bh) * (p.nc - 1) + c - 1) * p.dk_;
    const float* qr = p.q + row * p.dk_;
    for (int d = lane; d < p.dk_; d += 32) qn = fmaf(qr[d], nin[d], qn);
    qn = warp_sum(qn);
  }
  const float den = __fadd_rn(den_i, __fmul_rn(qn, p.vecp(kVInter)[row]));
  const float dmax = fmaxf(fabsf(den), 1.f);
  const float* dyr = p.dy + row * p.dv_;
  const float* yr = p.y + row * p.dv_;
  float dyy = 0.f;
  for (int d = lane; d < p.dv_; d += 32) dyy = fmaf(dyr[d], yr[d], dyy);
  dyy = warp_sum(dyy);
  const float fac = fabsf(den) > 1.f ? 1.f : (fabsf(den) == 1.f ? 0.5f : 0.f);
  const float sgn = den > 0.f ? 1.f : (den < 0.f ? -1.f : 0.f);
  float* dnr = p.dnum + row * p.dv_;
  for (int d = lane; d < p.dv_; d += 32) dnr[d] = __fdiv_rn(dyr[d], dmax);
  if (lane == 0) {
    p.vecp(kVDden)[row] = __fmul_rn(__fmul_rn(__fdiv_rn(-dyy, dmax), sgn), fac);
    p.vecp(kVQn)[row] = qn;
  }
}

// One thread a column j of chunk c: sum_{t >= j} (dSW[t, j] + dden_t) SW[t, j]
// (run before dsw_kernel overwrites dSW).
__global__ void mlstm_bwd_cols_kernel(const MlBwd p) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x, c = blockIdx.y, bh = blockIdx.z;
  if (j >= p.L) return;
  const long long tile = (static_cast<long long>(bh) * p.nc + c) * p.L * p.L;
  const long long base = static_cast<long long>(bh) * p.S + static_cast<long long>(c) * p.L;
  const float* dden = p.vecp(kVDden) + base;
  float acc = 0.f;
  for (int t = j; t < p.L; ++t) {
    const long long e = tile + static_cast<long long>(t) * p.L + j;
    acc = fmaf(__fadd_rn(p.dsw[e], dden[t]), p.sw[e], acc);
  }
  p.vecp(kVCol)[base + j] = acc;
}

// One warp a row t: dSW = dnum V^T + dden on the triangle, its row sum of
// dSW o SW, and dS = dSW o W in place.
__global__ void mlstm_bwd_dsw_kernel(const MlBwd p) {
  const long long row = static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= static_cast<long long>(p.BH) * p.S) return;
  const int bh = static_cast<int>(row / p.S), pos = static_cast<int>(row % p.S);
  const int c = pos / p.L, t = pos % p.L;
  const long long base = static_cast<long long>(bh) * p.S + static_cast<long long>(c) * p.L;
  const float* g = p.vecp(kVG) + base;
  const float ml = p.vecp(kVMloc)[row];
  const float dd = p.vecp(kVDden)[row];
  const long long off = (static_cast<long long>(bh) * p.nc + c) * p.L * p.L +
                        static_cast<long long>(t) * p.L;
  float* dr = p.dsw + off;
  const float* sr = p.sw + off;
  float acc = 0.f;
  for (int j = lane; j < p.L; j += 32) {
    float x = 0.f;
    if (j <= t) {
      const float ds = __fadd_rn(dr[j], dd);
      acc = fmaf(ds, sr[j], acc);
      x = __fmul_rn(ds, expf(__fsub_rn(g[j], ml)));
    }
    dr[j] = x;
  }
  acc = warp_sum(acc);
  if (lane == 0) p.vecp(kVRow)[row] = acc;
}

// One warp a row t (chunks >= 1; chunk 0 has a zero state): dinter = q .
// prod + dden qn, dq += inter prod + (inter dden) n_in, prod = dnum C_in^T.
__global__ void mlstm_bwd_qinter_kernel(const MlBwd p) {
  const long long row = static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= static_cast<long long>(p.BH) * p.S) return;
  const int bh = static_cast<int>(row / p.S), c = static_cast<int>(row % p.S) / p.L;
  if (c == 0) {
    if (lane == 0) p.vecp(kVDinter)[row] = 0.f;
    return;
  }
  const float inter = p.vecp(kVInter)[row], dd = p.vecp(kVDden)[row];
  const float idd = __fmul_rn(inter, dd);
  const float* nin = p.nstates + (static_cast<long long>(bh) * (p.nc - 1) + c - 1) * p.dk_;
  const float* qr = p.q + row * p.dk_;
  const float* pr = p.prod + row * p.dk_;
  float* dqr = p.dq + row * p.dk_;
  float acc = 0.f;
  for (int d = lane; d < p.dk_; d += 32) {
    acc = fmaf(qr[d], pr[d], acc);
    dqr[d] = __fadd_rn(__fadd_rn(dqr[d], __fmul_rn(inter, pr[d])), __fmul_rn(idd, nin[d]));
  }
  acc = warp_sum(acc);
  if (lane == 0) p.vecp(kVDinter)[row] = __fadd_rn(acc, __fmul_rn(dd, p.vecp(kVQn)[row]));
}

// dn_out[c - 1] = sum_t inter_t dden_t q_t (chunks c >= 1), one thread a
// column d.
__global__ void mlstm_bwd_dn_loc_kernel(const MlBwd p) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x, c = blockIdx.y + 1, bh = blockIdx.z;
  if (d >= p.dk_) return;
  const long long base = static_cast<long long>(bh) * p.S + static_cast<long long>(c) * p.L;
  const float* inter = p.vecp(kVInter) + base;
  const float* dden = p.vecp(kVDden) + base;
  float acc = 0.f;
  for (int t = 0; t < p.L; ++t) {
    acc = fmaf(__fmul_rn(inter[t], dden[t]), p.q[(base + t) * p.dk_ + d], acc);
  }
  p.dn_out[(static_cast<long long>(bh) * p.nc + c - 1) * p.dk_ + d] = acc;
}

// The reverse scan over chunks, one thread an element of (C, n):
// dC_out[nc - 1] = dC (0 if absent); dC_out[c - 1] = decay_c dC_out[c] +
// (the local part already in dC_out[c - 1]).
__global__ void mlstm_bwd_scan_kernel(const MlBwd p) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int bh = blockIdx.y;
  const long long nC = static_cast<long long>(p.dk_) * p.dv_;
  if (e >= nC + p.dk_) return;
  const bool is_n = e >= nC;
  const long long idx = is_n ? e - nC : e;
  float* buf = is_n ? p.dn_out + static_cast<long long>(bh) * p.nc * p.dk_
                    : p.dc_out + static_cast<long long>(bh) * p.nc * nC;
  const long long stride = is_n ? p.dk_ : nC;
  const float* seed = is_n ? p.dn : p.dC;
  float cur = seed ? seed[(is_n ? static_cast<long long>(bh) * p.dk_ : bh * nC) + idx] : 0.f;
  buf[(p.nc - 1) * stride + idx] = cur;
  const float* decay = p.cvecp(kCDecay) + static_cast<long long>(bh) * p.nc;
  for (int c = p.nc - 1; c >= 1; --c) {
    cur = __fadd_rn(__fmul_rn(decay[c], cur), buf[(c - 1) * stride + idx]);
    buf[(c - 1) * stride + idx] = cur;
  }
}

// One warp a row j: p8 = prod + dn_out (prod = V dC_out^T), dwk = k . p8,
// dk += wk p8.
__global__ void mlstm_bwd_kstate_kernel(const MlBwd p) {
  const long long row = static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= static_cast<long long>(p.BH) * p.S) return;
  const int bh = static_cast<int>(row / p.S), c = static_cast<int>(row % p.S) / p.L;
  const float wk = p.vecp(kVWk)[row];
  const float* dno = p.dn_out + (static_cast<long long>(bh) * p.nc + c) * p.dk_;
  const float* kr = p.k + row * p.dk_;
  const float* pr = p.prod + row * p.dk_;
  float* dkr = p.dk + row * p.dk_;
  float acc = 0.f;
  for (int d = lane; d < p.dk_; d += 32) {
    const float p8 = __fadd_rn(pr[d], dno[d]);
    acc = fmaf(kr[d], p8, acc);
    dkr[d] = __fadd_rn(dkr[d], __fmul_rn(wk, p8));
  }
  acc = warp_sum(acc);
  if (lane == 0) p.vecp(kVDwk)[row] = acc;
}

// ddecay_c = <dC_out[c], C_in[c]> + <dn_out[c], n_in[c]>, one block a
// (chunk >= 1, bh); a fixed-order block sum.
__global__ void mlstm_bwd_ddecay_kernel(const MlBwd p) {
  __shared__ float part[kMlThreads];
  const int c = blockIdx.x + 1, bh = blockIdx.y;
  const long long nC = static_cast<long long>(p.dk_) * p.dv_;
  const float* dco = p.dc_out + (static_cast<long long>(bh) * p.nc + c) * nC;
  const float* cin = p.states + (static_cast<long long>(bh) * (p.nc - 1) + c - 1) * nC;
  const float* dno = p.dn_out + (static_cast<long long>(bh) * p.nc + c) * p.dk_;
  const float* nin = p.nstates + (static_cast<long long>(bh) * (p.nc - 1) + c - 1) * p.dk_;
  float acc = 0.f;
  for (long long e = threadIdx.x; e < nC; e += kMlThreads) acc = fmaf(dco[e], cin[e], acc);
  float accn = 0.f;
  for (int e = threadIdx.x; e < p.dk_; e += kMlThreads) accn = fmaf(dno[e], nin[e], accn);
  part[threadIdx.x] = __fadd_rn(acc, accn);
  __syncthreads();
  for (int w = kMlThreads / 2; w >= 1; w >>= 1) {
    if (threadIdx.x < w) part[threadIdx.x] = __fadd_rn(part[threadIdx.x], part[threadIdx.x + w]);
    __syncthreads();
  }
  if (threadIdx.x == 0) p.cvecp(kCDdecay)[static_cast<long long>(bh) * p.nc + c] = part[0];
}

// Block sum of one value a thread (kMlThreads), the same order everywhere.
__device__ float block_sum(float v, float* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int w = kMlThreads / 2; w >= 1; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] = __fadd_rn(red[threadIdx.x], red[threadIdx.x + w]);
    __syncthreads();
  }
  const float out = red[0];
  __syncthreads();
  return out;
}

// The gates, one block a bh, chunk by chunk from the last, carrying dm_out
// (the gradient of the stabilizer leaving the chunk; 0 for the final m).
__global__ void __launch_bounds__(kMlThreads)
mlstm_bwd_gates_kernel(const MlBwd p) {
  __shared__ float m_in[kMlMaxChunks];
  __shared__ float big_m[kMlMaxL], dbig[kMlMaxL], dg[kMlMaxL];
  __shared__ int new_max[kMlMaxL];
  __shared__ float red[kMlThreads];
  __shared__ float dm_l_sh;
  const int bh = blockIdx.x, t = threadIdx.x, L = p.L, nc = p.nc;
  const float* bm = p.cvecp(kCBm) + 2 * static_cast<long long>(bh) * nc;
  if (t == 0) {  // the stabilizer entering each chunk, as the forward's chain
    float m = kMlNeg;
    for (int c = 0; c < nc; ++c) {
      m_in[c] = m;
      m = __fadd_rn(bm[2 * c], fmaxf(bm[2 * c + 1], m));
    }
  }
  __syncthreads();
  const float* decay = p.cvecp(kCDecay) + static_cast<long long>(bh) * nc;
  const float* ddecay = p.cvecp(kCDdecay) + static_cast<long long>(bh) * nc;
  float dm_out = 0.f;
  for (int c = nc - 1; c >= 0; --c) {
    const long long base = static_cast<long long>(bh) * p.S + static_cast<long long>(c) * L;
    const float* g = p.vecp(kVG) + base;
    if (t == 0) {  // running max and where it is set (ties: the latest)
      float run = REPRO_NEG_INF;
      for (int i = 0; i < L; ++i) {
        new_max[i] = g[i] >= run;
        run = fmaxf(run, g[i]);
        big_m[i] = run;
      }
    }
    __syncthreads();
    const float mi = m_in[c];
    float it = 0.f, wt = 0.f, away = 0.f;
    if (t < L) {
      const float f = big_m[t] > mi ? 1.f : (big_m[t] == mi ? 0.5f : 0.f);
      it = __fmul_rn(p.vecp(kVDinter)[base + t], p.vecp(kVInter)[base + t]);
      wt = __fmul_rn(p.vecp(kVDwk)[base + t], p.vecp(kVWk)[base + t]);
      const float dm_loc = __fsub_rn(-p.vecp(kVRow)[base + t], it);
      dbig[t] = __fmul_rn(dm_loc, f);
      away = __fmul_rn(dm_loc, 1.f - f);
      dg[t] = __fadd_rn(p.vecp(kVCol)[base + t], wt);
    }
    const float sum_it = block_sum(it, red);
    const float sum_wt = block_sum(wt, red);
    const float sum_away = block_sum(away, red);
    if (t == 0) {
      const float dd = c > 0 ? __fmul_rn(ddecay[c], decay[c]) : 0.f;
      const float dm_l = __fsub_rn(__fsub_rn(dm_out, sum_wt), dd);
      const float fl = big_m[L - 1] > mi ? 1.f : (big_m[L - 1] == mi ? 0.5f : 0.f);
      dbig[L - 1] = __fadd_rn(dbig[L - 1], __fmul_rn(dm_l, fl));
      dm_l_sh = __fadd_rn(__fadd_rn(__fadd_rn(sum_it, dd), sum_away),
                          __fmul_rn(dm_l, 1.f - fl));
      // the running max's gradient to where each maximum was set
      float acc = 0.f;
      for (int i = L - 1; i >= 0; --i) {
        acc = __fadd_rn(acc, dbig[i]);
        if (new_max[i]) {
          dg[i] = __fadd_rn(dg[i], acc);
          acc = 0.f;
        }
      }
      // dlogi = dg; dlogf = reverse cumsum of db = -dg (+ dm_out at L - 1)
      float run = dm_out;
      for (int i = L - 1; i >= 0; --i) {
        run = __fsub_rn(run, dg[i]);
        p.dlogf[base + i] = run;
        p.dlogi[base + i] = dg[i];
      }
    }
    __syncthreads();
    dm_out = dm_l_sh;
    __syncthreads();
  }
}

template <bool kAKc, bool kBKc>
cudaError_t launch_mma(const GemmOp& op, int batches, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(mlstm_bwd_mma_kernel<kAKc, kBKc>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kMlRingBytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((op.N + kMlTile - 1) / kMlTile, (op.M + kMlTile - 1) / kMlTile, batches);
  mlstm_bwd_mma_kernel<kAKc, kBKc><<<grid, kMlThreads, kMlRingBytes, s>>>(op);
  return cudaGetLastError();
}

inline cudaError_t run_gemm(GemmOp op, int batches, cudaStream_t s) {
  if (batches == 0 || op.M == 0 || op.N == 0) return cudaSuccess;
  if (op.kscale != nullptr && op.tb) return cudaErrorInvalidValue;
  if (!op.ta && op.tb) return launch_mma<true, true>(op, batches, s);
  if (op.ta && !op.tb) return launch_mma<false, false>(op, batches, s);
  if (!op.ta && !op.tb) return launch_mma<true, false>(op, batches, s);
  return cudaErrorInvalidValue;   // both transposed: no product takes it
}

}  // namespace repro_torch

// q, k [BH, S, dk], v, y, dy [BH, S, dv], logi, logf [BH, S], states [BH,
// S/L - 1, dk, dv], nstates [BH, S/L - 1, dk], dC [BH, dk, dv] and dn [BH,
// dk] (either NULL: zero) -> dq, dk, dv, dlogi, dlogf; float32 contiguous.
// Scratch: sw, dsw [BH, S/L, L, L], dnum [BH, S, dv], prod [BH, S, dk],
// dc_out [BH, S/L, dk, dv], dn_out [BH, S/L, dk], vec [10, BH, S], cvec
// [5, BH, S/L]. The limits of repro_mlstm_chunked.
extern "C" int repro_mlstm_chunked_bwd(
    const void* q, const void* k, const void* v, const void* logi,
    const void* logf, const void* y, const void* states, const void* nstates,
    const void* dy, const void* dC, const void* dn, void* dq, void* dk, void* dv,
    void* dlogi, void* dlogf, void* sw, void* dsw, void* dnum, void* prod,
    void* dc_out, void* dn_out, void* vec, void* cvec, int BH, int S, int L,
    int dk_, int dv_, void* stream) {
  using namespace repro_torch;
  if (L < 8 || L > kMlMaxL || L % 8 || S % L || S / L > kMlMaxChunks ||
      static_cast<long long>(BH) * (S / L) > 65535 || dk_ % 4 || dv_ % 4 ||
      dk_ < 4 || dv_ < 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const int nc = S / L;
  const MlBwd p{static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), static_cast<const float*>(y),
                static_cast<const float*>(states), static_cast<const float*>(nstates),
                static_cast<const float*>(dy), static_cast<const float*>(dC),
                static_cast<const float*>(dn), static_cast<float*>(dq),
                static_cast<float*>(dk), static_cast<float*>(dv),
                static_cast<float*>(dlogi), static_cast<float*>(dlogf),
                static_cast<float*>(sw), static_cast<float*>(dsw),
                static_cast<float*>(dnum), static_cast<float*>(prod),
                static_cast<float*>(dc_out), static_cast<float*>(dn_out),
                static_cast<float*>(vec), static_cast<float*>(cvec), BH, S, L, dk_, dv_,
                nc};
  float* fvec = static_cast<float*>(vec);
  float* fcvec = static_cast<float*>(cvec);
  const long long vs = static_cast<long long>(BH) * S, cs = static_cast<long long>(BH) * nc;
  float *g = fvec + kVG * vs, *m_loc = fvec + kVMloc * vs, *inter = fvec + kVInter * vs,
        *wk = fvec + kVWk * vs;
  cudaError_t err;
#define REPRO_CHECK() \
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err)
  // the gates, as the forward computes them
  mlstm_gates_chunk_kernel<<<dim3(nc, BH), kMlThreads, 0, s>>>(
      static_cast<const float*>(logi), static_cast<const float*>(logf), g, m_loc,
      fcvec + kCBm * cs, S, L);
  REPRO_CHECK();
  mlstm_gates_chain_kernel<<<dim3(nc, BH), kMlThreads, 0, s>>>(
      g, m_loc, fcvec + kCBm * cs, inter, wk, fcvec + kCDecay * cs, fcvec + kCMout * cs,
      S, L);
  REPRO_CHECK();
  const long long LL = static_cast<long long>(L) * L;
  const long long Sdk = static_cast<long long>(S) * dk_, Sdv = static_cast<long long>(S) * dv_;
  const long long Ldk = static_cast<long long>(L) * dk_, Ldv = static_cast<long long>(L) * dv_;
  const long long CC = static_cast<long long>(dk_) * dv_;
  const int batches = BH * nc, later = BH * (nc - 1);
  auto op = [&](const float* a, long long lda, long long sa_bh, long long sa_c, int ta,
                const float* b, long long ldb, long long sb_bh, long long sb_c, int tb,
                float* c, long long ldc, long long sc_bh, long long sc_c, int M, int N,
                int K, int nb, int tri = kTriNone) {
    GemmOp o{};
    o.tri = tri;
    o.a = a; o.b = b; o.c = c;
    o.lda = lda; o.ldb = ldb; o.ldc = ldc;
    o.sa_bh = sa_bh; o.sa_c = sa_c; o.sb_bh = sb_bh; o.sb_c = sb_c;
    o.sc_bh = sc_bh; o.sc_c = sc_c;
    o.M = M; o.N = N; o.K = K; o.nb = nb; o.ta = ta; o.tb = tb;
    return o;
  };
  const auto* fq = static_cast<const float*>(q);
  const auto* fk = static_cast<const float*>(k);
  const auto* fv = static_cast<const float*>(v);
  auto* fsw = static_cast<float*>(sw);
  auto* fdsw = static_cast<float*>(dsw);
  auto* fdnum = static_cast<float*>(dnum);
  auto* fprod = static_cast<float*>(prod);
  auto* fdco = static_cast<float*>(dc_out);
  const unsigned row_blocks = static_cast<unsigned>((vs + 7) / 8);
  // S = Q K^T per chunk
  if ((err = run_gemm(op(fq, dk_, Sdk, Ldk, 0, fk, dk_, Sdk, Ldk, 1, fsw, L, nc * LL, LL,
                         L, L, dk_, nc, kTriOut), batches, s)) != cudaSuccess) return static_cast<int>(err);
  mlstm_bwd_rows_kernel<<<row_blocks, 256, 0, s>>>(p);
  REPRO_CHECK();
  // dnum V^T
  if ((err = run_gemm(op(fdnum, dv_, Sdv, Ldv, 0, fv, dv_, Sdv, Ldv, 1, fdsw, L, nc * LL, LL,
                         L, L, dv_, nc, kTriOut), batches, s)) != cudaSuccess) return static_cast<int>(err);
  mlstm_bwd_cols_kernel<<<dim3((L + 127) / 128, nc, BH), 128, 0, s>>>(p);
  REPRO_CHECK();
  mlstm_bwd_dsw_kernel<<<row_blocks, 256, 0, s>>>(p);
  REPRO_CHECK();
  // dv = SW^T dnum, dq = dS K, dk = dS^T Q
  if ((err = run_gemm(op(fsw, L, nc * LL, LL, 1, fdnum, dv_, Sdv, Ldv, 0, p.dv, dv_, Sdv, Ldv,
                         L, dv_, L, nc, kTriAUpper), batches, s)) != cudaSuccess) return static_cast<int>(err);
  if ((err = run_gemm(op(fdsw, L, nc * LL, LL, 0, fk, dk_, Sdk, Ldk, 0, p.dq, dk_, Sdk, Ldk,
                         L, dk_, L, nc, kTriALower), batches, s)) != cudaSuccess) return static_cast<int>(err);
  if ((err = run_gemm(op(fdsw, L, nc * LL, LL, 1, fq, dk_, Sdk, Ldk, 0, p.dk, dk_, Sdk, Ldk,
                         L, dk_, L, nc, kTriAUpper), batches, s)) != cudaSuccess) return static_cast<int>(err);
  if (nc > 1) {
    // prod = dnum C_in^T (chunks >= 1)
    if ((err = run_gemm(op(fdnum + Ldv, dv_, Sdv, Ldv, 0, static_cast<const float*>(states),
                           dv_, (nc - 1) * CC, CC, 1, fprod + Ldk, dk_, Sdk, Ldk, L, dk_, dv_,
                           nc - 1), later, s)) != cudaSuccess) return static_cast<int>(err);
  }
  mlstm_bwd_qinter_kernel<<<row_blocks, 256, 0, s>>>(p);
  REPRO_CHECK();
  if (nc > 1) {
    // dC_out[c - 1] = Q_c^T (inter dnum)_c (chunks c >= 1), dn_out[c - 1]
    GemmOp o = op(fq + Ldk, dk_, Sdk, Ldk, 1, fdnum + Ldv, dv_, Sdv, Ldv, 0, fdco, dv_,
                  nc * CC, CC, dk_, dv_, L, nc - 1);
    o.kscale = inter + L;
    o.sk_bh = S;
    o.sk_c = L;
    if ((err = run_gemm(o, later, s)) != cudaSuccess) return static_cast<int>(err);
    mlstm_bwd_dn_loc_kernel<<<dim3((dk_ + 127) / 128, nc - 1, BH), 128, 0, s>>>(p);
    REPRO_CHECK();
  }
  mlstm_bwd_scan_kernel<<<dim3(static_cast<unsigned>((CC + dk_ + 255) / 256), BH), 256, 0, s>>>(p);
  REPRO_CHECK();
  // prod = V dC_out^T; dk += wk (prod + dn_out), dwk
  if ((err = run_gemm(op(fv, dv_, Sdv, Ldv, 0, fdco, dv_, nc * CC, CC, 1, fprod, dk_, Sdk, Ldk,
                         L, dk_, dv_, nc), batches, s)) != cudaSuccess) return static_cast<int>(err);
  mlstm_bwd_kstate_kernel<<<row_blocks, 256, 0, s>>>(p);
  REPRO_CHECK();
  {  // dv += wk (K dC_out)
    GemmOp o = op(fk, dk_, Sdk, Ldk, 0, fdco, dv_, nc * CC, CC, 0, p.dv, dv_, Sdv, Ldv, L,
                  dv_, dk_, nc);
    o.rscale = wk;
    o.sr_bh = S;
    o.sr_c = L;
    o.accumulate = 1;
    if ((err = run_gemm(o, batches, s)) != cudaSuccess) return static_cast<int>(err);
  }
  if (nc > 1) {
    mlstm_bwd_ddecay_kernel<<<dim3(nc - 1, BH), kMlThreads, 0, s>>>(p);
    REPRO_CHECK();
  }
  mlstm_bwd_gates_kernel<<<BH, kMlThreads, 0, s>>>(p);
  REPRO_CHECK();
#undef REPRO_CHECK
  return 0;
}
