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
// pallas_call at :112). Plain twin: repro_torch.kernels.ref.mlstm_chunked_ref.
//
// Bound on the H100 at the xlstm-1.3b training shape (BH 8, S 4096, dk = dv
// 1024, L 256, 16 chunks): operations. Per (bh, chunk) 2L^2(dk + dv) +
// 4L dk dv = 1.34 GFLOP, 172 GFLOP in all = 2.56 ms at 67 TFLOP/s (float32
// on the CUDA cores); the operands are 0.4 GB = 0.12 ms at 3.35 TB/s.
//
// Design. The TPU kernel keeps C [dk, dv] resident in VMEM along the
// sequential chunk axis of its grid, one (bh) per core. At dk = dv = 1024
// C is 4 MiB, 18x an SM's shared memory, and BH = 8 would leave 124 of 132
// SMs idle. Three kernels, launched back to back:
//  1. gates (one block per bh): the sequential cumsum, g, M and the
//     stabilizer chain over chunks, a scalar recurrence that does not depend
//     on C; writes g, m_loc, exp(m - m_loc), exp(g - m_L) per step and
//     exp(m - m_L) per chunk, and the final m.
//  2. intra (one block per bh, chunk and 64 rows): S[t, j] = (q_t . k_j) *
//     exp(g_j - m_loc_t) for j <= t, else 0, the chunk's [L, L] weights,
//     into a scratch buffer: every chunk at once, no carry involved.
//  3. recurrence (one block per bh and 32 columns of v): the block holds
//     its [dk, 32] slice of C and all of n in shared memory (132 KB at dk
//     1024) through all chunks, 8 * 32 = 256 blocks. Per chunk: q C and
//     q . n (q staged 32 dims at a time), S v and the row sums of S, then
//     y, then C and n advanced by (k exp(g - m_L))^T v; each thread owns an
//     8 x 4 tile of the output and sums with fma chains over the
//     contraction. n (the ones column) is recomputed by every block: 3% of
//     the work, and no block waits on another.
// Rounding follows the reference's operations: separate roundings
// (__fmul_rn / __fadd_rn) where it multiplies and adds separately; the
// dot products sum in another order than torch.matmul.
#include <cuda_runtime.h>

namespace repro_torch {

constexpr float kMlNeg = -1e30f;
// -inf: the start of a running max.
#define REPRO_NEG_INF __int_as_float(0xff800000)
constexpr int kMlThreads = 256;
constexpr int kMlMaxL = 256;    // longest chunk
constexpr int kMlMaxDk = 1024;  // widest key the recurrence block holds
constexpr int kMlMaxChunks = 1024;
constexpr int kMlRows = 64;     // rows of S per intra block
constexpr int kMlSlice = 32;    // contraction slice staged in shared memory
constexpr int kMlTv = 32;       // columns of v (and C) per recurrence block
constexpr int kMlLdq = kMlRows + 4;
constexpr int kMlLds = kMlMaxL + 4;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void put_t(float* st, int ld, int row0, int col,
                                      float4 val) {
  st[(row0 + 0) * ld + col] = val.x;
  st[(row0 + 1) * ld + col] = val.y;
  st[(row0 + 2) * ld + col] = val.z;
  st[(row0 + 3) * ld + col] = val.w;
}

// --- 1. gates --------------------------------------------------------------
__global__ void __launch_bounds__(kMlThreads)
mlstm_gates_kernel(const float* __restrict__ logi, const float* __restrict__ logf,
                   float* __restrict__ g, float* __restrict__ m_loc,
                   float* __restrict__ inter, float* __restrict__ wk,
                   float* __restrict__ decay, float* __restrict__ m_out, int S,
                   int L) {
  __shared__ float b_last[kMlMaxChunks], big_m_last[kMlMaxChunks],
      m_prev[kMlMaxChunks];
  const int bh = blockIdx.x, nc = S / L;
  const long long base = static_cast<long long>(bh) * S;
  for (int c = threadIdx.x; c < nc; c += kMlThreads) {
    float b = 0.f, big_m = REPRO_NEG_INF;
    for (int t = 0; t < L; ++t) {
      const long long i = base + static_cast<long long>(c) * L + t;
      b = __fadd_rn(b, logf[i]);
      const float gv = __fsub_rn(logi[i], b);
      g[i] = gv;
      big_m = fmaxf(big_m, gv);
    }
    b_last[c] = b;
    big_m_last[c] = big_m;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = kMlNeg;
    for (int c = 0; c < nc; ++c) {
      m_prev[c] = m;
      m = __fadd_rn(b_last[c], fmaxf(big_m_last[c], m));
    }
    m_out[bh] = m;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < nc; c += kMlThreads) {
    const float mp = m_prev[c];
    const float m_l = fmaxf(big_m_last[c], mp);
    decay[static_cast<long long>(bh) * nc + c] = expf(__fsub_rn(mp, m_l));
    float big_m = REPRO_NEG_INF;
    for (int t = 0; t < L; ++t) {
      const long long i = base + static_cast<long long>(c) * L + t;
      const float gv = g[i];
      big_m = fmaxf(big_m, gv);
      const float ml = fmaxf(big_m, mp);
      m_loc[i] = ml;
      inter[i] = expf(__fsub_rn(mp, ml));
      wk[i] = expf(__fsub_rn(gv, m_l));
    }
  }
}

// --- 2. intra-chunk weights S ---------------------------------------------
// Block (row tile, chunk, bh); thread: rows 8*(tid % 8).., columns
// 8*(tid / 8)..; a warp covers 32 columns of all 64 rows and skips the
// contraction when they all lie above the tile's last row.
__global__ void __launch_bounds__(kMlThreads)
mlstm_intra_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ g, const float* __restrict__ m_loc,
                   float* __restrict__ sw, int S, int L, int dk) {
  __shared__ __align__(16) float qs[kMlSlice * kMlLdq];
  __shared__ __align__(16) float ks[kMlSlice * kMlLds];
  const int t0 = blockIdx.x * kMlRows, c = blockIdx.y, bh = blockIdx.z;
  const int nc = S / L;
  const long long row0 = static_cast<long long>(bh) * S + static_cast<long long>(c) * L;
  const int tid = threadIdx.x, rg = tid % 8, cg = tid / 8, warp = tid / 32;
  const int j_end = min(L, t0 + kMlRows);           // S[t, j] = 0 past it
  const int j_stage = min(L, (j_end + 31) / 32 * 32);  // what active warps read
  const bool active = warp * 32 < j_end;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int d0 = 0; d0 < dk; d0 += kMlSlice) {
    __syncthreads();
    for (int i = tid; i < kMlRows * 8; i += kMlThreads) {
      const int r = i / 8, dd = (i % 8) * 4;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t0 + r < L && d0 + dd < dk) val = load4(q + (row0 + t0 + r) * dk + d0 + dd);
      put_t(qs, kMlLdq, dd, r, val);
    }
    for (int i = tid; i < kMlMaxL * 8; i += kMlThreads) {
      const int j = i / 8, dd = (i % 8) * 4;
      if (j >= ((j_stage + 31) / 32) * 32) break;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j < j_stage && d0 + dd < dk) val = load4(k + (row0 + j) * dk + d0 + dd);
      put_t(ks, kMlLds, dd, j, val);
    }
    __syncthreads();
    if (active) {
#pragma unroll 4
      for (int dd = 0; dd < kMlSlice; ++dd) {
        const float4 a0 = load4(qs + dd * kMlLdq + rg * 8);
        const float4 a1 = load4(qs + dd * kMlLdq + rg * 8 + 4);
        const float4 b0 = load4(ks + dd * kMlLds + cg * 8);
        const float4 b1 = load4(ks + dd * kMlLds + cg * 8 + 4);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
  }
  float* out = sw + (static_cast<long long>(bh) * nc + c) * L * L;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = t0 + rg * 8 + i;
    if (t < L) {
      const float ml = m_loc[row0 + t];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = cg * 8 + jj;
        if (j < L) {
          float val = 0.f;
          if (j <= t) val = __fmul_rn(acc[i][jj], expf(__fsub_rn(g[row0 + j], ml)));
          out[static_cast<long long>(t) * L + j] = val;
        }
      }
    }
  }
}

// --- 3. the recurrence over chunks ------------------------------------------
// Dynamic shared memory, in floats: C slice [dkp][32], n [dkp], the chunk's
// v slice [256][32], a staging buffer [32][260], exp(m - m_loc) and
// exp(g - m_L) of the chunk [256] each.
inline size_t recur_smem_bytes(int dkp) {
  return sizeof(float) * (static_cast<size_t>(dkp) * kMlTv + dkp + kMlMaxL * kMlTv +
                          kMlSlice * kMlLds + 2 * kMlMaxL);
}

__device__ __forceinline__ float lane8_sum(float x) {
  x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 2));
  x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 4));
  return x;
}

// Block (v column tile, bh); thread: rows (of t, or of d) 8*(tid / 8).., v
// columns 4*(tid % 8)..; the 8 lanes of one row group sum n and the row sums
// between them.
__global__ void __launch_bounds__(kMlThreads)
mlstm_recur_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ sw,
                   const float* __restrict__ inter, const float* __restrict__ wk,
                   const float* __restrict__ decay, float* __restrict__ y,
                   float* __restrict__ c_out, float* __restrict__ n_out, int S,
                   int L, int dk, int dv) {
  extern __shared__ __align__(16) float recur_smem[];
  const int dkp = (dk + kMlSlice - 1) / kMlSlice * kMlSlice;
  float* cs = recur_smem;                     // [dkp][32]
  float* ns = cs + dkp * kMlTv;               // [dkp]
  float* vt = ns + dkp;                       // [256][32]
  float* st = vt + kMlMaxL * kMlTv;           // [32][260]
  float* vis = st + kMlSlice * kMlLds;        // [256]
  float* vwk = vis + kMlMaxL;                 // [256]
  const int v0 = blockIdx.x * kMlTv, bh = blockIdx.y;
  const int nc = S / L;
  const int tid = threadIdx.x, tg = tid / 8, cg = tid % 8;
  const int r0 = tg * 8;                      // first row of the thread
  for (int i = tid; i < dkp * kMlTv; i += kMlThreads) cs[i] = 0.f;
  for (int i = tid; i < dkp; i += kMlThreads) ns[i] = 0.f;

  for (int c = 0; c < nc; ++c) {
    const long long row0 = static_cast<long long>(bh) * S + static_cast<long long>(c) * L;
    __syncthreads();  // the previous chunk's C, n are written; vt, st free
    for (int i = tid; i < L; i += kMlThreads) {
      vis[i] = inter[row0 + i];
      vwk[i] = wk[row0 + i];
    }
    for (int i = tid; i < L * 8; i += kMlThreads) {
      const int j = i / 8, cc = (i % 8) * 4;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (v0 + cc < dv) val = load4(v + (row0 + j) * dv + v0 + cc);
      *reinterpret_cast<float4*>(vt + j * kMlTv + cc) = val;
    }
    const float dec = decay[static_cast<long long>(bh) * nc + c];
    const bool rows = r0 < L;

    // q C and q . n (inter-chunk terms)
    float a1[8][4], dn[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      dn[i] = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) a1[i][j] = 0.f;
    }
    for (int d0 = 0; d0 < dkp; d0 += kMlSlice) {
      __syncthreads();
      for (int i = tid; i < L * 8; i += kMlThreads) {
        const int t = i / 8, dd = (i % 8) * 4;
        float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
        if (d0 + dd < dk) val = load4(q + (row0 + t) * dk + d0 + dd);
        put_t(st, kMlLds, dd, t, val);
      }
      __syncthreads();
      if (rows) {
#pragma unroll 4
        for (int dd = 0; dd < kMlSlice; ++dd) {
          const float4 q0 = load4(st + dd * kMlLds + r0);
          const float4 q1 = load4(st + dd * kMlLds + r0 + 4);
          const float4 cv = load4(cs + (d0 + dd) * kMlTv + cg * 4);
          const float a[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
          const float b[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) a1[i][j] = fmaf(a[i], b[j], a1[i][j]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int dd = cg + 8 * e;
          const float nv = ns[d0 + dd];
#pragma unroll
          for (int i = 0; i < 8; ++i) dn[i] = fmaf(st[dd * kMlLds + r0 + i], nv, dn[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) dn[i] = lane8_sum(dn[i]);

    // S v and the row sums of S (intra-chunk terms)
    const float* swc = sw + (static_cast<long long>(bh) * nc + c) * L * L;
    float a2[8][4], di[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      di[i] = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) a2[i][j] = 0.f;
    }
    for (int j0 = 0; j0 < L; j0 += kMlSlice) {
      __syncthreads();
      for (int i = tid; i < L * 8; i += kMlThreads) {
        const int t = i / 8, jj = (i % 8) * 4;
        float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
        if (j0 + jj < L) val = load4(swc + static_cast<long long>(t) * L + j0 + jj);
        put_t(st, kMlLds, jj, t, val);
      }
      __syncthreads();
      const int jn = min(kMlSlice, L - j0);
      if (rows && j0 <= r0 + 7) {  // S is 0 above the thread's last row
        for (int jj = 0; jj < jn; ++jj) {
          const float4 s0 = load4(st + jj * kMlLds + r0);
          const float4 s1 = load4(st + jj * kMlLds + r0 + 4);
          const float4 vv = load4(vt + (j0 + jj) * kMlTv + cg * 4);
          const float a[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
          const float b[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) a2[i][j] = fmaf(a[i], b[j], a2[i][j]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int jj = cg + 8 * e;
          if (jj < jn) {
#pragma unroll
            for (int i = 0; i < 8; ++i) di[i] = __fadd_rn(di[i], st[jj * kMlLds + r0 + i]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) di[i] = lane8_sum(di[i]);

    // y = (S v + (q C) e) / max(|S 1 + (q . n) e|, 1), e = exp(m - m_loc)
    if (rows && v0 + cg * 4 < dv) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = r0 + i;
        const float e = vis[t];
        const float den = fmaxf(fabsf(__fadd_rn(di[i], __fmul_rn(dn[i], e))), 1.f);
        float4 out;
        out.x = __fadd_rn(a2[i][0], __fmul_rn(a1[i][0], e)) / den;
        out.y = __fadd_rn(a2[i][1], __fmul_rn(a1[i][1], e)) / den;
        out.z = __fadd_rn(a2[i][2], __fmul_rn(a1[i][2], e)) / den;
        out.w = __fadd_rn(a2[i][3], __fmul_rn(a1[i][3], e)) / den;
        *reinterpret_cast<float4*>(y + (row0 + t) * dv + v0 + cg * 4) = out;
      }
    }

    // C = decay C + (k w)^T v, n = decay n + sum_j k_j w_j, w = exp(g - m_L):
    // 256 rows of d at a time.
    for (int p0 = 0; p0 < dkp; p0 += kMlThreads) {
      float a3[8][4], sn[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        sn[i] = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) a3[i][j] = 0.f;
      }
      const bool drows = p0 + r0 < dkp;
      for (int j0 = 0; j0 < L; j0 += kMlSlice) {
        __syncthreads();
        for (int i = tid; i < kMlSlice * 64; i += kMlThreads) {
          const int jj = i / 64, dd = (i % 64) * 4;
          float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
          if (j0 + jj < L && p0 + dd < dk) {
            val = load4(k + (row0 + j0 + jj) * dk + p0 + dd);
            const float w = vwk[j0 + jj];
            val.x = __fmul_rn(val.x, w);
            val.y = __fmul_rn(val.y, w);
            val.z = __fmul_rn(val.z, w);
            val.w = __fmul_rn(val.w, w);
          }
          *reinterpret_cast<float4*>(st + jj * kMlLds + dd) = val;
        }
        __syncthreads();
        const int jn = min(kMlSlice, L - j0);
        if (drows) {
          for (int jj = 0; jj < jn; ++jj) {
            const float4 k0 = load4(st + jj * kMlLds + r0);
            const float4 k1 = load4(st + jj * kMlLds + r0 + 4);
            const float4 vv = load4(vt + (j0 + jj) * kMlTv + cg * 4);
            const float a[8] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
            const float b[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) a3[i][j] = fmaf(a[i], b[j], a3[i][j]);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int jj = cg + 8 * e;
            if (jj < jn) {
#pragma unroll
              for (int i = 0; i < 8; ++i) sn[i] = __fadd_rn(sn[i], st[jj * kMlLds + r0 + i]);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) sn[i] = lane8_sum(sn[i]);
      if (drows) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int d = p0 + r0 + i;
          float4 cv = load4(cs + d * kMlTv + cg * 4);
          cv.x = __fadd_rn(__fmul_rn(dec, cv.x), a3[i][0]);
          cv.y = __fadd_rn(__fmul_rn(dec, cv.y), a3[i][1]);
          cv.z = __fadd_rn(__fmul_rn(dec, cv.z), a3[i][2]);
          cv.w = __fadd_rn(__fmul_rn(dec, cv.w), a3[i][3]);
          *reinterpret_cast<float4*>(cs + d * kMlTv + cg * 4) = cv;
          if (cg == 0) ns[d] = __fadd_rn(__fmul_rn(dec, ns[d]), sn[i]);
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < dk * 8; i += kMlThreads) {
    const int d = i / 8, cc = (i % 8) * 4;
    if (v0 + cc < dv) {
      *reinterpret_cast<float4*>(c_out + (static_cast<long long>(bh) * dk + d) * dv + v0 + cc) =
          load4(cs + d * kMlTv + cc);
    }
  }
  if (blockIdx.x == 0) {
    for (int d = tid; d < dk; d += kMlThreads) n_out[static_cast<long long>(bh) * dk + d] = ns[d];
  }
}

}  // namespace repro_torch

// q, k [BH, S, dk], v [BH, S, dv], logi, logf [BH, S] -> y [BH, S, dv],
// C [BH, dk, dv], n [BH, dk], m [BH]; float32, contiguous, 16-byte aligned.
// Scratch: sw [BH, S/L, L, L], g, m_loc, inter, wk [BH, S], decay [BH, S/L].
// S % L == 0, L % 8 == 0, L <= 256, S/L <= 1024, dk % 4 == dv % 4 == 0,
// dk <= 1024.
extern "C" int repro_mlstm_chunked(const void* q, const void* k, const void* v,
                                   const void* logi, const void* logf, void* y,
                                   void* c_out, void* n_out, void* m_out,
                                   void* sw, void* g, void* m_loc, void* inter,
                                   void* wk, void* decay, int BH, int S, int L,
                                   int dk, int dv, void* stream) {
  using namespace repro_torch;
  if (L < 8 || L > kMlMaxL || L % 8 || S % L || S / L > kMlMaxChunks ||
      dk % 4 || dv % 4 || dk > kMlMaxDk || dk < 4 || dv < 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* fq = static_cast<const float*>(q);
  const auto* fk = static_cast<const float*>(k);
  auto* fg = static_cast<float*>(g);
  auto* fm = static_cast<float*>(m_loc);
  auto* fi = static_cast<float*>(inter);
  auto* fw = static_cast<float*>(wk);
  auto* fd = static_cast<float*>(decay);
  auto* fsw = static_cast<float*>(sw);
  const int nc = S / L;
  mlstm_gates_kernel<<<BH, kMlThreads, 0, s>>>(
      static_cast<const float*>(logi), static_cast<const float*>(logf), fg, fm,
      fi, fw, fd, static_cast<float*>(m_out), S, L);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mlstm_intra_kernel<<<dim3((L + kMlRows - 1) / kMlRows, nc, BH), kMlThreads, 0, s>>>(
      fq, fk, fg, fm, fsw, S, L, dk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int dkp = (dk + kMlSlice - 1) / kMlSlice * kMlSlice;
  const size_t smem = recur_smem_bytes(dkp);
  err = cudaFuncSetAttribute(mlstm_recur_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  mlstm_recur_kernel<<<dim3((dv + kMlTv - 1) / kMlTv, BH), kMlThreads, smem, s>>>(
      fq, fk, static_cast<const float*>(v), fsw, fi, fw, fd,
      static_cast<float*>(y), static_cast<float*>(c_out),
      static_cast<float*>(n_out), S, L, dk, dv);
  return static_cast<int>(cudaGetLastError());
}
