// The backward of flash_attention.cu: dQ, dK, dV of causal (or full)
// attention from q, k, v [BH, S*, Dh], the forward's output o, its row
// log-sum-exp lse [BH, Sq] (float32) and the output gradient dO, by FA2's
// split into three launches:
//   1. delta: D = rowsum(dO o) per query row, in float32;
//   2. dkdv: one block per 64-key tile of one (batch, head), looping over
//      the 64-row query tiles from the causal diagonal on: p = exp(s - lse)
//      with s = (q . k in float32) * scale masked as the forward masks,
//      dV += round(p)^T dO, dP = dO V^T, dS = p (dP - D), dK += round(dS)^T Q;
//   3. dq: one block per 64-row query tile, looping over the key tiles up to
//      the diagonal: the same p, dP and dS, dQ += round(dS) K.
// dK and dQ are scaled once at the end; every sum is float32 and lands in
// the block that owns it, so there are no atomics and the gradients are
// deterministic. round() is to v's (p) and q's (dS) dtype, as the twin
// rounds: jax.grad of the reference path treats the forward's rounding of
// p as the identity, so dV = round(p)^T dO and dP is float32.
//
// Replaces no Pallas kernel: the JAX package has no backward for its
// `flash_attention` (src/repro/kernels/flash_attention.py); this kernel
// computes jax.grad of the reference path `_attend_chunked`
// (src/repro/models/attention.py:84). Plain twin:
// repro_torch.kernels.ref.flash_attention_bwd_ref.
//
// Bound on the H100 at the smollm-360m training shape (BH 60, S 4096, Dh
// 64, bf16, causal): operations. The five products over the lower
// triangle (S and dP recomputed, dV, dK, dQ) are 2.5x the forward's two:
// 5 * BH * S^2 * Dh = 322 GFLOP = 0.326 ms at 989 TFLOP/s.
//
// Design, bf16. A block of 4 warps owns 64 keys (dkdv) or 64 query rows
// (dq), 16 per warp, with its own rows' fragments loaded once by ldmatrix;
// the other operand's 64-row tiles are staged in shared memory by cp.async
// (one stage: a simple first kernel). Every product runs on the tensor
// cores as mma.sync m16n8k16 (bf16 in, float32 out), the forward's
// fragment tricks reused: the C fragments of S^T (dkdv) or S (dq) turn
// into the A fragments of the next product after rounding to bf16, and
// ldmatrix.trans reads a row-major [rows, Dh] tile as the B operand of a
// product over its rows. Float32: the same loops on the CUDA cores, two
// threads a key (or row), each holding half of Dh in registers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma.cuh"

namespace repro_torch {

constexpr int kBwdRows = 64;     // keys (dkdv) or query rows (dq) per block
constexpr int kBwdWarps = 4;     // 16 rows each
constexpr int kBwdThreads = 32 * kBwdWarps;

// --- 1. D = rowsum(dO o) --------------------------------------------------
template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void flash_bwd_delta_kernel(const T* __restrict__ o,
                                       const T* __restrict__ dout,
                                       float* __restrict__ delta, long long rows,
                                       int DH) {
  const long long row = static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* orow = o + row * DH;
  const T* drow = dout + row * DH;
  float acc = 0.f;
  for (int d = lane; d < DH; d += 32) acc = fmaf(to_f(drow[d]), to_f(orow[d]), acc);
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// --- bf16 -----------------------------------------------------------------
template <int DH>
struct BwdBf16Smem {
  static constexpr int kLd = DH + 8;  // bf16 per staged row (16-byte pad)
  static constexpr int kTile = kBwdRows * kLd;
  // two operand tiles of the block's own rows, two streamed ones
  static constexpr size_t kBytes = size_t(4 * kTile) * sizeof(__nv_bfloat16) +
                                   2 * kBwdRows * sizeof(float);
};

// Rows [row0, row0 + 64) of a [rows, DH] bf16 matrix into a [64][kLd] tile
// by cp.async (committed, not waited for); rows past `rows` are zero.
template <int DH>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src, int row0,
                                           int rows) {
  constexpr int kPerRow = DH / 8;
  constexpr int kLd = BwdBf16Smem<DH>::kLd;
  for (int i = threadIdx.x; i < kBwdRows * kPerRow; i += kBwdThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * 8;
    const bool ok = row0 + r < rows;
    cp_async16(dst + r * kLd + c, src + (ok ? static_cast<long long>(row0 + r) * DH + c : 0),
               ok ? 16 : 0);
  }
}

// lse and D of query rows [row0, row0 + 64) into shared memory; rows past
// Sq get lse = +inf, so their p is exactly 0.
__device__ __forceinline__ void stage_row_stats(float* s_lse, float* s_d,
                                                const float* lse,
                                                const float* delta, int row0,
                                                int Sq) {
  for (int i = threadIdx.x; i < kBwdRows; i += kBwdThreads) {
    const bool ok = row0 + i < Sq;
    s_lse[i] = ok ? lse[row0 + i] : __int_as_float(0x7f800000);
    s_d[i] = ok ? delta[row0 + i] : 0.f;
  }
}

template <int DH>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dkdv_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const __nv_bfloat16* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int Sq, int Skv,
                           int causal, float scale) {
  using Smem = BwdBf16Smem<DH>;
  constexpr int kLd = Smem::kLd;
  constexpr int kDt = DH / 8, kDk = DH / 16, kNt = kBwdRows / 8;
  extern __shared__ __align__(128) unsigned char bwd_smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(bwd_smem);
  __nv_bfloat16* sV = sK + Smem::kTile;
  __nv_bfloat16* sQ = sV + Smem::kTile;
  __nv_bfloat16* sO = sQ + Smem::kTile;   // dO
  float* s_lse = reinterpret_cast<float*>(sO + Smem::kTile);
  float* s_d = s_lse + kBwdRows;

  const int bh = blockIdx.x, k0 = blockIdx.y * kBwdRows;
  const long long qoff = static_cast<long long>(bh) * Sq * DH;
  const long long koff = static_cast<long long>(bh) * Skv * DH;
  const float* lb = lse + static_cast<long long>(bh) * Sq;
  const float* db = delta + static_cast<long long>(bh) * Sq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int key_a = k0 + warp * 16 + g, key_b = key_a + 8;
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_col = ((lane >> 3) & 1) * 8;

  stage_rows<DH>(sK, k + koff, k0, Skv);
  stage_rows<DH>(sV, v + koff, k0, Skv);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t kf[kDk][4], vf[kDk][4];
#pragma unroll
  for (int kk = 0; kk < kDk; ++kk) {
    ldmatrix_x4(kf[kk], sK + (warp * 16 + a_row) * kLd + kk * 16 + a_col);
    ldmatrix_x4(vf[kk], sV + (warp * 16 + a_row) * kLd + kk * 16 + a_col);
  }
  float acc_k[kDt][4], acc_v[kDt][4];
#pragma unroll
  for (int d = 0; d < kDt; ++d)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_k[d][i] = acc_v[d][i] = 0.f;

  const int i_start = causal ? k0 : 0;   // no query before k0 sees these keys
  for (int i0 = i_start; i0 < Sq; i0 += kBwdRows) {
    __syncthreads();   // every warp is done with the previous Q, dO tiles
    stage_rows<DH>(sQ, q + qoff, i0, Sq);
    stage_rows<DH>(sO, dout + qoff, i0, Sq);
    cp_async_commit();
    stage_row_stats(s_lse, s_d, lb, db, i0, Sq);
    cp_async_wait<0>();
    __syncthreads();
    // the warp's keys all lie past the tile's last query: p = 0 throughout
    if (causal && k0 + warp * 16 > i0 + kBwdRows - 1) continue;

    // S^T = K Q^T and dP^T = V dO^T: [16 keys, 64 queries] each
    float st[kNt][4], dpt[kNt][4];
#pragma unroll
    for (int j = 0; j < kNt; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) st[j][i] = dpt[j][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDk; ++kk) {
#pragma unroll
      for (int np = 0; np < kNt / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, sQ + (np * 16 + b_row) * kLd + kk * 16 + b_col);
        mma_bf16(st[2 * np], kf[kk], b[0], b[1]);
        mma_bf16(st[2 * np + 1], kf[kk], b[2], b[3]);
        ldmatrix_x4(b, sO + (np * 16 + b_row) * kLd + kk * 16 + b_col);
        mma_bf16(dpt[2 * np], vf[kk], b[0], b[1]);
        mma_bf16(dpt[2 * np + 1], vf[kk], b[2], b[3]);
      }
    }
    // p and dS (float32), rounded to bf16 as the A fragments of the
    // products over the tile's queries
    uint32_t pf[kNt / 2][4], sf[kNt / 2][4];
#pragma unroll
    for (int j = 0; j < kNt; ++j) {
      float p[4], ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = j * 8 + 2 * t + (i & 1);
        const int key = i < 2 ? key_a : key_b;
        const bool keep = key < Skv && (!causal || key <= i0 + qi);
        p[i] = keep ? expf(__fsub_rn(__fmul_rn(st[j][i], scale), s_lse[qi])) : 0.f;
        ds[i] = __fmul_rn(p[i], __fsub_rn(dpt[j][i], s_d[qi]));
      }
      pf[j / 2][(j & 1) * 2] = pack_bf16x2(p[0], p[1]);
      pf[j / 2][(j & 1) * 2 + 1] = pack_bf16x2(p[2], p[3]);
      sf[j / 2][(j & 1) * 2] = pack_bf16x2(ds[0], ds[1]);
      sf[j / 2][(j & 1) * 2 + 1] = pack_bf16x2(ds[2], ds[3]);
    }
    // dV += P^T dO, dK += dS^T Q (dO, Q read transposed as B operands)
#pragma unroll
    for (int dp = 0; dp < kDt / 2; ++dp) {
#pragma unroll
      for (int c = 0; c < kNt / 2; ++c) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, sO + (c * 16 + a_row) * kLd + dp * 16 + a_col);
        mma_bf16(acc_v[2 * dp], pf[c], b[0], b[1]);
        mma_bf16(acc_v[2 * dp + 1], pf[c], b[2], b[3]);
        ldmatrix_x4_trans(b, sQ + (c * 16 + a_row) * kLd + dp * 16 + a_col);
        mma_bf16(acc_k[2 * dp], sf[c], b[0], b[1]);
        mma_bf16(acc_k[2 * dp + 1], sf[c], b[2], b[3]);
      }
    }
  }

  __nv_bfloat16* dkb = dk + koff;
  __nv_bfloat16* dvb = dv + koff;
#pragma unroll
  for (int d = 0; d < kDt; ++d) {
    const int col = d * 8 + 2 * t;
    if (key_a < Skv) {
      const long long o = static_cast<long long>(key_a) * DH + col;
      *reinterpret_cast<uint32_t*>(dkb + o) =
          pack_bf16x2(__fmul_rn(acc_k[d][0], scale), __fmul_rn(acc_k[d][1], scale));
      *reinterpret_cast<uint32_t*>(dvb + o) = pack_bf16x2(acc_v[d][0], acc_v[d][1]);
    }
    if (key_b < Skv) {
      const long long o = static_cast<long long>(key_b) * DH + col;
      *reinterpret_cast<uint32_t*>(dkb + o) =
          pack_bf16x2(__fmul_rn(acc_k[d][2], scale), __fmul_rn(acc_k[d][3], scale));
      *reinterpret_cast<uint32_t*>(dvb + o) = pack_bf16x2(acc_v[d][2], acc_v[d][3]);
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dq, int Sq, int Skv,
                         int causal, float scale) {
  using Smem = BwdBf16Smem<DH>;
  constexpr int kLd = Smem::kLd;
  constexpr int kDt = DH / 8, kDk = DH / 16, kNt = kBwdRows / 8;
  extern __shared__ __align__(128) unsigned char bwd_smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(bwd_smem);
  __nv_bfloat16* sO = sQ + Smem::kTile;   // dO
  __nv_bfloat16* sK = sO + Smem::kTile;
  __nv_bfloat16* sV = sK + Smem::kTile;
  float* s_lse = reinterpret_cast<float*>(sV + Smem::kTile);
  float* s_d = s_lse + kBwdRows;

  const int bh = blockIdx.x;
  const int q_tiles = (Sq + kBwdRows - 1) / kBwdRows;
  const int q0 = (q_tiles - 1 - blockIdx.y) * kBwdRows;  // heaviest first
  const long long qoff = static_cast<long long>(bh) * Sq * DH;
  const long long koff = static_cast<long long>(bh) * Skv * DH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int w0 = q0 + warp * 16;
  const int row_a = w0 + g, row_b = row_a + 8;
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_col = ((lane >> 3) & 1) * 8;

  stage_rows<DH>(sQ, q + qoff, q0, Sq);
  stage_rows<DH>(sO, dout + qoff, q0, Sq);
  cp_async_commit();
  stage_row_stats(s_lse, s_d, lse + static_cast<long long>(bh) * Sq,
                  delta + static_cast<long long>(bh) * Sq, q0, Sq);
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[kDk][4], of[kDk][4];
#pragma unroll
  for (int kk = 0; kk < kDk; ++kk) {
    ldmatrix_x4(qf[kk], sQ + (warp * 16 + a_row) * kLd + kk * 16 + a_col);
    ldmatrix_x4(of[kk], sO + (warp * 16 + a_row) * kLd + kk * 16 + a_col);
  }
  const float lse_a = s_lse[warp * 16 + g], lse_b = s_lse[warp * 16 + g + 8];
  const float d_a = s_d[warp * 16 + g], d_b = s_d[warp * 16 + g + 8];
  float acc[kDt][4];
#pragma unroll
  for (int d = 0; d < kDt; ++d)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[d][i] = 0.f;

  int k_end = Skv;
  if (causal) k_end = min(Skv, q0 + kBwdRows);  // keys <= the block's last row
  for (int k0 = 0; k0 < k_end; k0 += kBwdRows) {
    __syncthreads();   // every warp is done with the previous K, V tiles
    stage_rows<DH>(sK, k + koff, k0, Skv);
    stage_rows<DH>(sV, v + koff, k0, Skv);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (causal && k0 > w0 + 15) continue;   // wholly above the warp's rows

    float s[kNt][4], dp[kNt][4];
#pragma unroll
    for (int j = 0; j < kNt; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDk; ++kk) {
#pragma unroll
      for (int np = 0; np < kNt / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, sK + (np * 16 + b_row) * kLd + kk * 16 + b_col);
        mma_bf16(s[2 * np], qf[kk], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qf[kk], b[2], b[3]);
        ldmatrix_x4(b, sV + (np * 16 + b_row) * kLd + kk * 16 + b_col);
        mma_bf16(dp[2 * np], of[kk], b[0], b[1]);
        mma_bf16(dp[2 * np + 1], of[kk], b[2], b[3]);
      }
    }
    uint32_t sf[kNt / 2][4];
#pragma unroll
    for (int j = 0; j < kNt; ++j) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + j * 8 + 2 * t + (i & 1);
        const int row = i < 2 ? row_a : row_b;
        const bool keep = key < Skv && (!causal || key <= row);
        const float p = keep ? expf(__fsub_rn(__fmul_rn(s[j][i], scale),
                                              i < 2 ? lse_a : lse_b))
                             : 0.f;
        ds[i] = __fmul_rn(p, __fsub_rn(dp[j][i], i < 2 ? d_a : d_b));
      }
      sf[j / 2][(j & 1) * 2] = pack_bf16x2(ds[0], ds[1]);
      sf[j / 2][(j & 1) * 2 + 1] = pack_bf16x2(ds[2], ds[3]);
    }
    // dQ += dS K (K read transposed as the B operand)
#pragma unroll
    for (int dd = 0; dd < kDt / 2; ++dd) {
#pragma unroll
      for (int c = 0; c < kNt / 2; ++c) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, sK + (c * 16 + a_row) * kLd + dd * 16 + a_col);
        mma_bf16(acc[2 * dd], sf[c], b[0], b[1]);
        mma_bf16(acc[2 * dd + 1], sf[c], b[2], b[3]);
      }
    }
  }

  __nv_bfloat16* dqb = dq + qoff;
#pragma unroll
  for (int d = 0; d < kDt; ++d) {
    const int col = d * 8 + 2 * t;
    if (row_a < Sq) {
      *reinterpret_cast<uint32_t*>(dqb + static_cast<long long>(row_a) * DH + col) =
          pack_bf16x2(__fmul_rn(acc[d][0], scale), __fmul_rn(acc[d][1], scale));
    }
    if (row_b < Sq) {
      *reinterpret_cast<uint32_t*>(dqb + static_cast<long long>(row_b) * DH + col) =
          pack_bf16x2(__fmul_rn(acc[d][2], scale), __fmul_rn(acc[d][3], scale));
    }
  }
}

// --- float32 --------------------------------------------------------------
// Two threads a key (dkdv) or a query row (dq), each holding half of Dh of
// its row's operands and gradients in registers; the other operand's
// 64-row tiles in shared memory, read as broadcasts.
template <int DH>
struct BwdF32Smem {
  static constexpr size_t kBytes =
      size_t(2 * kBwdRows * DH + 2 * kBwdRows) * sizeof(float);
};

// rows [row0, row0 + 64) of a [rows, DH] float32 matrix into a dense
// [64][DH] tile; rows past `rows` are zero.
template <int DH>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              int row0, int rows) {
  constexpr int kPerRow = DH / 4;
  for (int i = threadIdx.x; i < kBwdRows * kPerRow; i += kBwdThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < rows) {
      val = *reinterpret_cast<const float4*>(src + static_cast<long long>(row0 + r) * DH + c);
    }
    *reinterpret_cast<float4*>(dst + r * DH + c) = val;
  }
}

// dot of this thread's half row with half h of a shared row, summed with
// the partner lane's half (lanes 2r, 2r + 1)
template <int DH>
__device__ __forceinline__ float half_dot(const float (&mine)[DH / 2],
                                          const float* row, int h) {
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < DH / 2; ++d) acc = fmaf(mine[d], row[h * (DH / 2) + d], acc);
  return __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, 1));
}

template <int DH>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta, float* __restrict__ dk,
                          float* __restrict__ dv, int Sq, int Skv, int causal,
                          float scale) {
  constexpr int kHalf = DH / 2;
  extern __shared__ __align__(16) float fbwd_smem[];
  float* sQ = fbwd_smem;
  float* sO = sQ + kBwdRows * DH;
  float* s_lse = sO + kBwdRows * DH;
  float* s_d = s_lse + kBwdRows;
  const int bh = blockIdx.x, k0 = blockIdx.y * kBwdRows;
  const int h = threadIdx.x & 1, key = k0 + threadIdx.x / 2;
  const long long qoff = static_cast<long long>(bh) * Sq * DH;
  const long long koff = static_cast<long long>(bh) * Skv * DH;
  float kr[kHalf], vr[kHalf], gk[kHalf], gv[kHalf];
#pragma unroll
  for (int d = 0; d < kHalf; ++d) {
    const bool ok = key < Skv;
    kr[d] = ok ? k[koff + static_cast<long long>(key) * DH + h * kHalf + d] : 0.f;
    vr[d] = ok ? v[koff + static_cast<long long>(key) * DH + h * kHalf + d] : 0.f;
    gk[d] = gv[d] = 0.f;
  }
  const int i_start = causal ? k0 : 0;
  for (int i0 = i_start; i0 < Sq; i0 += kBwdRows) {
    __syncthreads();
    load_rows_f32<DH>(sQ, q + qoff, i0, Sq);
    load_rows_f32<DH>(sO, dout + qoff, i0, Sq);
    stage_row_stats(s_lse, s_d, lse + static_cast<long long>(bh) * Sq,
                    delta + static_cast<long long>(bh) * Sq, i0, Sq);
    __syncthreads();
    for (int i = 0; i < kBwdRows; ++i) {
      const float s = half_dot<DH>(kr, sQ + i * DH, h);
      const float dp = half_dot<DH>(vr, sO + i * DH, h);
      const bool keep = key < Skv && (!causal || key <= i0 + i);
      const float p = keep ? expf(__fsub_rn(__fmul_rn(s, scale), s_lse[i])) : 0.f;
      const float ds = __fmul_rn(p, __fsub_rn(dp, s_d[i]));
#pragma unroll
      for (int d = 0; d < kHalf; ++d) {
        gv[d] = fmaf(p, sO[i * DH + h * kHalf + d], gv[d]);
        gk[d] = fmaf(ds, sQ[i * DH + h * kHalf + d], gk[d]);
      }
    }
  }
  if (key < Skv) {
#pragma unroll
    for (int d = 0; d < kHalf; ++d) {
      const long long o = koff + static_cast<long long>(key) * DH + h * kHalf + d;
      dk[o] = __fmul_rn(gk[d], scale);
      dv[o] = gv[d];
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, float* __restrict__ dq,
                        int Sq, int Skv, int causal, float scale) {
  constexpr int kHalf = DH / 2;
  extern __shared__ __align__(16) float fbwd_smem[];
  float* sK = fbwd_smem;
  float* sV = sK + kBwdRows * DH;
  const int bh = blockIdx.x;
  const int q_tiles = (Sq + kBwdRows - 1) / kBwdRows;
  const int q0 = (q_tiles - 1 - blockIdx.y) * kBwdRows;  // heaviest first
  const int h = threadIdx.x & 1, row = q0 + threadIdx.x / 2;
  const bool live = row < Sq;
  const long long qoff = static_cast<long long>(bh) * Sq * DH;
  const long long koff = static_cast<long long>(bh) * Skv * DH;
  float qr[kHalf], orow[kHalf], gq[kHalf];
#pragma unroll
  for (int d = 0; d < kHalf; ++d) {
    qr[d] = live ? q[qoff + static_cast<long long>(row) * DH + h * kHalf + d] : 0.f;
    orow[d] = live ? dout[qoff + static_cast<long long>(row) * DH + h * kHalf + d] : 0.f;
    gq[d] = 0.f;
  }
  const float lse_r = live ? lse[static_cast<long long>(bh) * Sq + row]
                           : __int_as_float(0x7f800000);
  const float d_r = live ? delta[static_cast<long long>(bh) * Sq + row] : 0.f;
  int k_end = Skv;
  if (causal) k_end = min(Skv, q0 + kBwdRows);
  for (int k0 = 0; k0 < k_end; k0 += kBwdRows) {
    __syncthreads();
    load_rows_f32<DH>(sK, k + koff, k0, Skv);
    load_rows_f32<DH>(sV, v + koff, k0, Skv);
    __syncthreads();
    for (int j = 0; j < kBwdRows; ++j) {
      const float s = half_dot<DH>(qr, sK + j * DH, h);
      const float dp = half_dot<DH>(orow, sV + j * DH, h);
      const int key = k0 + j;
      const bool keep = key < Skv && (!causal || key <= row);
      const float p = keep ? expf(__fsub_rn(__fmul_rn(s, scale), lse_r)) : 0.f;
      const float ds = __fmul_rn(p, __fsub_rn(dp, d_r));
#pragma unroll
      for (int d = 0; d < kHalf; ++d) gq[d] = fmaf(ds, sK[j * DH + h * kHalf + d], gq[d]);
    }
  }
  if (live) {
#pragma unroll
    for (int d = 0; d < kHalf; ++d) {
      dq[qoff + static_cast<long long>(row) * DH + h * kHalf + d] = __fmul_rn(gq[d], scale);
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int DH>
cudaError_t launch_flash_bwd(const void* q, const void* k, const void* v,
                             const void* o, const float* lse, const void* dout,
                             float* delta, void* dq, void* dk, void* dv, int BH,
                             int Sq, int Skv, int causal, int is_bf16,
                             float scale, cudaStream_t s) {
  const long long rows = static_cast<long long>(BH) * Sq;
  const dim3 kv_grid(BH, (Skv + kBwdRows - 1) / kBwdRows);
  const dim3 q_grid(BH, (Sq + kBwdRows - 1) / kBwdRows);
  cudaError_t err;
  if (is_bf16) {
    using T = __nv_bfloat16;
    flash_bwd_delta_kernel<T><<<static_cast<unsigned>((rows + 7) / 8), 256, 0, s>>>(
        static_cast<const T*>(o), static_cast<const T*>(dout), delta, rows, DH);
    const size_t smem = BwdBf16Smem<DH>::kBytes;
    if ((err = allow_smem(flash_bwd_dkdv_bf16_kernel<DH>, smem)) != cudaSuccess) return err;
    if ((err = allow_smem(flash_bwd_dq_bf16_kernel<DH>, smem)) != cudaSuccess) return err;
    flash_bwd_dkdv_bf16_kernel<DH><<<kv_grid, kBwdThreads, smem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk),
        static_cast<T*>(dv), Sq, Skv, causal, scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    flash_bwd_dq_bf16_kernel<DH><<<q_grid, kBwdThreads, smem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), Sq, Skv,
        causal, scale);
    return cudaGetLastError();
  }
  flash_bwd_delta_kernel<float><<<static_cast<unsigned>((rows + 7) / 8), 256, 0, s>>>(
      static_cast<const float*>(o), static_cast<const float*>(dout), delta, rows, DH);
  const size_t smem = BwdF32Smem<DH>::kBytes;
  if ((err = allow_smem(flash_bwd_dkdv_f32_kernel<DH>, smem)) != cudaSuccess) return err;
  if ((err = allow_smem(flash_bwd_dq_f32_kernel<DH>, smem)) != cudaSuccess) return err;
  flash_bwd_dkdv_f32_kernel<DH><<<kv_grid, kBwdThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse, delta,
      static_cast<float*>(dk), static_cast<float*>(dv), Sq, Skv, causal, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_bwd_dq_f32_kernel<DH><<<q_grid, kBwdThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse, delta,
      static_cast<float*>(dq), Sq, Skv, causal, scale);
  return cudaGetLastError();
}

}  // namespace repro_torch

// q, o, dout, dq [BH, Sq, Dh]; k, v, dk, dv [BH, Skv, Dh]; contiguous,
// 16-byte aligned, all bfloat16 (is_bf16) or all float32; lse [BH, Sq]
// float32 from the forward; delta [BH, Sq] float32 scratch. Dh in {16, 32,
// 64, 128}; 64 keys or query rows per block.
extern "C" int repro_flash_attention_bwd(const void* q, const void* k,
                                         const void* v, const void* o,
                                         const void* lse, const void* dout,
                                         void* delta, void* dq, void* dk,
                                         void* dv, int BH, int Sq, int Skv,
                                         int dh, int causal, int is_bf16,
                                         float scale, void* stream) {
  using namespace repro_torch;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* l = static_cast<const float*>(lse);
  auto* d = static_cast<float*>(delta);
  cudaError_t err;
  switch (dh) {
    case 16: err = launch_flash_bwd<16>(q, k, v, o, l, dout, d, dq, dk, dv, BH, Sq, Skv, causal, is_bf16, scale, s); break;
    case 32: err = launch_flash_bwd<32>(q, k, v, o, l, dout, d, dq, dk, dv, BH, Sq, Skv, causal, is_bf16, scale, s); break;
    case 64: err = launch_flash_bwd<64>(q, k, v, o, l, dout, d, dq, dk, dv, BH, Sq, Skv, causal, is_bf16, scale, s); break;
    case 128: err = launch_flash_bwd<128>(q, k, v, o, l, dout, d, dq, dk, dv, BH, Sq, Skv, causal, is_bf16, scale, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
