// Causal (or full) attention by online softmax over KV tiles:
//   s = (q . k in float32) * scale, masked with -1e30 (causal: key position
//   <= query position; always: key position < Skv); per tile
//   m' = max(m, max s), p = exp(s - m'), l = l * exp(m - m') + sum p,
//   acc = acc * exp(m - m') + (p rounded to v's dtype) . v in float32;
//   out = acc / max(l, 1e-30) in q's dtype,
// for q [BH, Sq, Dh], k, v [BH, Skv, Dh] (contiguous, bf16 or float32, Dh in
// {16, 32, 64, 128}) -> out [BH, Sq, Dh], and the row log-sum-exp
// lse = m + log(l) [BH, Sq] in float32 that the backward
// (flash_attention_bwd.cu) takes, when an lse pointer is given.
//
// Replaces the Pallas kernel `flash_attention`
// (src/repro/kernels/flash_attention.py, pallas_call at :102). Plain twin:
// repro_torch.kernels.ref.flash_attention_ref with block_kv = kFlashKeys
// (64 keys, both types), which rounds where this kernel rounds.
//
// Bound on the H100 at the smollm-360m training shape (BH 60, S 4096, Dh
// 64, bf16, causal): operations. QK^T and PV over the lower triangle are
// 2 * BH * S^2 * Dh = 129 GFLOP = 0.130 ms at 989 TFLOP/s (bf16 tensor
// cores); Q, K, V and O are 126 MB = 0.038 ms at 3.35 TB/s. The exps
// (BH * S^2 / 2 = 503 M) take 0.12 ms on the MUFU units.
//
// Design, bf16. On the TPU one grid step holds a [512, Dh] query tile and a
// [512, Dh] KV tile in VMEM and carries (acc, m, l) in scratch across the
// sequential KV grid axis. Here one block of 8 warps owns 128 query rows of
// one (batch, head), 16 rows per warp, and loops over 64-key tiles itself,
// so (acc, m, l) stay in registers. Both products run on the tensor cores
// as mma.sync m16n8k16 (bf16 in, float32 out) with operands from ldmatrix:
// the warp's Q fragments are loaded once; S = Q K^T lands in registers
// (K [keys, Dh] row-major is the K-major B operand as it is); row max and
// row sum are quad shuffles over the accumulator fragments; p is rounded
// to bf16 and packed in registers, where the C fragments of S are already
// the A fragments of P V; V [keys, Dh] row-major is read as the B operand
// by ldmatrix.trans. Nothing of S, p or the PV product goes through
// shared memory. K and V tiles arrive by cp.async into a ring of three
// stages, two tiles ahead: each tile's copy is issued two tiles before its
// math, and one barrier a tile both publishes the landed tile and frees
// the stage read by the last. Shared memory at Dh 64: Q 18 KB + 3 x (K 9
// KB + V 9 KB) = 72 KB, two blocks an SM; rows padded by 16 bytes so the
// ldmatrix rows hit distinct banks.
//
// Numbers, as in the reference: each tile's PV product is a fresh float32
// sum (a new accumulator per tile) added to acc * exp(m - m') with a
// separate multiply and add; p = expf(s - m') is rounded to bf16 before
// it, while l sums the float32 p. Only the order of the float32 sums
// inside q . k, inside a tile's PV and of a row's p differs from the
// twin's (cuBLAS and torch.sum on the card). Two exact shortcuts: with a
// power-of-two scale (Dh 16 and 64) q . k * scale is exact, so unmasked
// tiles take the max over the dots and s - m' as one fma (the rounding of
// the subtraction); where no row of a warp moved its max, exp(m - m') is 1
// and the rescale of acc is skipped.
//
// Measured on an H100 (PERF.md, scripts/kernel_ablation.py): the online
// softmax of the unmasked tiles is some 37% of the time (the accurate
// expf of p, 8 instructions where __expf is 2, 10-12%); the products,
// loads and barriers take the rest, twice the tensor cores' floor, and
// the two overlap little.
//
// Causal masking is applied only on the tiles that cross a warp's
// diagonal or the end of the keys. Tiles wholly above a block's last row
// are not loaded, and tiles wholly above a warp's last row are skipped by
// that warp: there the reference's update is the exact identity (p = 0,
// exp(m - m') = 1). Blocks are ordered heaviest first (the last query
// tiles see the most keys). Ragged Sq and Skv: rows past Sq are zero-filled
// and not written, keys past Skv are zero-filled and masked.
//
// Design, float32 (no tensor-core type holds float32 to its tolerance):
// one block of 4 warps owns 64 query rows, each lane half of one row's
// accumulator; K and V tiles are staged in shared memory by the whole
// block, and the two products run on the CUDA cores (a sequential fma
// chain per dot) through per-warp shared-memory tiles of scores and p.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma.cuh"

namespace repro_torch {

constexpr int kFlashKeys = 64;  // keys per KV tile, both types
constexpr float kFlashNeg = -1e30f;

// ---------------------------------------------------------------- bf16
constexpr int kFlashRowsBf16 = 128;  // query rows per block
constexpr int kFlashWarpsBf16 = 8;   // 16 query rows each
constexpr int kFlashThreadsBf16 = 32 * kFlashWarpsBf16;
constexpr int kFlashStages = 3;      // K/V tiles in the ring, 2 in flight

template <int DH>
struct FlashBf16Smem {
  static constexpr int kLd = DH + 8;  // bf16 elements per staged row
  static constexpr int kQ = kFlashRowsBf16 * kLd;
  static constexpr int kKV = kFlashKeys * kLd;
  static constexpr size_t kBytes =
      size_t(kQ + 2 * kFlashStages * kKV) * sizeof(__nv_bfloat16);
};

// Rows [row0, row0 + ROWS) of a [rows, DH] bf16 matrix into a [ROWS][kLd]
// tile by cp.async, 16 bytes per copy; rows past `rows` are zero-filled.
template <int DH, int ROWS>
__device__ __forceinline__ void copy_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int row0,
                                          int rows) {
  constexpr int kPerRow = DH / 8;
  constexpr int kChunks = ROWS * kPerRow;
  constexpr int kLd = FlashBf16Smem<DH>::kLd;
#pragma unroll
  for (int j = 0; j < (kChunks + kFlashThreadsBf16 - 1) / kFlashThreadsBf16; ++j) {
    const int i = threadIdx.x + j * kFlashThreadsBf16;
    if (kChunks % kFlashThreadsBf16 == 0 || i < kChunks) {
      const int r = i / kPerRow, c = (i % kPerRow) * 8;
      const bool ok = row0 + r < rows;   // rows * DH < 2^31 (the wrapper)
      cp_async16(dst + r * kLd + c, src + (ok ? (row0 + r) * DH + c : 0), ok ? 16 : 0);
    }
  }
}

// One tile's online-softmax update for the two rows (a: g, b: g + 8) of
// this lane: s = dot * scale, masked with kFlashNeg (kMask), m' = max(m,
// max s), corr = exp(m - m'), p = exp(s - m') packed to bf16 as the A
// fragments of P V, l = l * corr + sum p (over the float32 p). kFold, for a
// power-of-two scale on an unmasked tile: dot * scale is exact, so the max
// is taken over the dots and scaled once, and s - m' is one fma with the
// rounding of __fsub_rn(s, m').
template <int kNt, bool kMask, bool kFold>
__device__ __forceinline__ void online_softmax(
    float (&s)[kNt][4], uint32_t (&pf)[kNt / 2][4], float scale, int k0, int t,
    int row_a, int row_b, int Skv, int causal, float& m_a, float& m_b,
    float& l_a, float& l_b, float& corr_a, float& corr_b) {
  float mx_a[kNt], mx_b[kNt];   // row maxima, reduced as a tree
#pragma unroll
  for (int j = 0; j < kNt; ++j) {
    if (!kFold) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = __fmul_rn(s[j][i], scale);
        if (kMask) {
          const int key = k0 + j * 8 + 2 * t + (i & 1);
          const int row = i < 2 ? row_a : row_b;
          if (key >= Skv || (causal && key > row)) x = kFlashNeg;
        }
        s[j][i] = x;
      }
    }
    mx_a[j] = fmaxf(s[j][0], s[j][1]);
    mx_b[j] = fmaxf(s[j][2], s[j][3]);
  }
#pragma unroll
  for (int w = kNt / 2; w >= 1; w /= 2)
#pragma unroll
    for (int j = 0; j < w; ++j) {
      mx_a[j] = fmaxf(mx_a[j], mx_a[j + w]);
      mx_b[j] = fmaxf(mx_b[j], mx_b[j + w]);
    }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    mx_a[0] = fmaxf(mx_a[0], __shfl_xor_sync(0xffffffffu, mx_a[0], o));
    mx_b[0] = fmaxf(mx_b[0], __shfl_xor_sync(0xffffffffu, mx_b[0], o));
  }
  if (kFold) {
    mx_a[0] = __fmul_rn(mx_a[0], scale);
    mx_b[0] = __fmul_rn(mx_b[0], scale);
  }
  const float mn_a = fmaxf(m_a, mx_a[0]), mn_b = fmaxf(m_b, mx_b[0]);
  corr_a = expf(__fsub_rn(m_a, mn_a));
  corr_b = expf(__fsub_rn(m_b, mn_b));
  m_a = mn_a;
  m_b = mn_b;

  float ps_a[kNt], ps_b[kNt];   // row sums of the float32 p, as a tree
#pragma unroll
  for (int j = 0; j < kNt; ++j) {
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float m = i < 2 ? mn_a : mn_b;
      p[i] = expf(kFold ? __fmaf_rn(s[j][i], scale, -m) : __fsub_rn(s[j][i], m));
    }
    ps_a[j] = __fadd_rn(p[0], p[1]);
    ps_b[j] = __fadd_rn(p[2], p[3]);
    pf[j / 2][(j & 1) * 2] = pack_bf16x2(p[0], p[1]);
    pf[j / 2][(j & 1) * 2 + 1] = pack_bf16x2(p[2], p[3]);
  }
#pragma unroll
  for (int w = kNt / 2; w >= 1; w /= 2)
#pragma unroll
    for (int j = 0; j < w; ++j) {
      ps_a[j] = __fadd_rn(ps_a[j], ps_a[j + w]);
      ps_b[j] = __fadd_rn(ps_b[j], ps_b[j + w]);
    }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    ps_a[0] = __fadd_rn(ps_a[0], __shfl_xor_sync(0xffffffffu, ps_a[0], o));
    ps_b[0] = __fadd_rn(ps_b[0], __shfl_xor_sync(0xffffffffu, ps_b[0], o));
  }
  l_a = __fadd_rn(__fmul_rn(l_a, corr_a), ps_a[0]);
  l_b = __fadd_rn(__fmul_rn(l_b, corr_b), ps_b[0]);
}

template <int DH>
__global__ void __launch_bounds__(kFlashThreadsBf16, DH <= 64 ? 2 : 1)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                  int Sq, int Skv, int causal, float scale) {
  using Smem = FlashBf16Smem<DH>;
  constexpr int kLd = Smem::kLd;
  constexpr int kDt = DH / 8;    // n-tiles of the output
  constexpr int kDk = DH / 16;   // k-steps of q . k
  constexpr int kNt = kFlashKeys / 8;   // n-tiles of the scores
  extern __shared__ __align__(128) unsigned char flash_smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(flash_smem);
  __nv_bfloat16* sK = sQ + Smem::kQ;                       // [stage][keys][kLd]
  __nv_bfloat16* sV = sK + kFlashStages * Smem::kKV;

  const int bh = blockIdx.x;
  const int q_tiles = (Sq + kFlashRowsBf16 - 1) / kFlashRowsBf16;
  const int q0 = (q_tiles - 1 - blockIdx.y) * kFlashRowsBf16;  // heaviest first
  const __nv_bfloat16* qb = q + static_cast<long long>(bh) * Sq * DH;
  const __nv_bfloat16* kb = k + static_cast<long long>(bh) * Skv * DH;
  const __nv_bfloat16* vb = v + static_cast<long long>(bh) * Skv * DH;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int w0 = q0 + warp * 16;          // the warp's first query row
  const int row_a = w0 + g, row_b = w0 + g + 8;

  int k_end = Skv;
  if (causal) k_end = min(Skv, q0 + kFlashRowsBf16);  // keys <= the last row
  const uint32_t scale_bits = __float_as_uint(scale);
  const bool exact_scale = (scale_bits & 0x007FFFFFu) == 0u &&
                           scale_bits - 0x00800000u < 0x7F000000u;  // normal 2^e > 0
  const int n_tiles = (k_end + kFlashKeys - 1) / kFlashKeys;

  // Prologue: Q with tile 0, then tiles 1 .. kFlashStages - 2, one group
  // each (a group may be empty: the wait counts stay uniform).
  copy_rows<DH, kFlashRowsBf16>(sQ, qb, q0, Sq);
#pragma unroll
  for (int st = 0; st < kFlashStages - 1; ++st) {
    if (st < n_tiles) {
      copy_rows<DH, kFlashKeys>(sK + st * Smem::kKV, kb, st * kFlashKeys, Skv);
      copy_rows<DH, kFlashKeys>(sV + st * Smem::kKV, vb, st * kFlashKeys, Skv);
    }
    cp_async_commit();
  }

  uint32_t qf[kDk][4];
  float acc[kDt][4];
#pragma unroll
  for (int d = 0; d < kDt; ++d)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[d][i] = 0.f;
  float m_a = kFlashNeg, m_b = kFlashNeg, l_a = 0.f, l_b = 0.f;

  // ldmatrix lane offsets: A (Q) and V^T pick rows by bits 0-3 of the lane
  // and a column half by bit 4; K's B fragments rows by bits 0-2 and 4.
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_col = ((lane >> 3) & 1) * 8;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int stage = kt % kFlashStages;
    cp_async_wait<kFlashStages - 2>();   // tile kt (and Q) landed
    // Every thread's tile kt landed, and every warp is done with tile
    // kt - 1, whose stage is refilled now with tile kt + kFlashStages - 1:
    // its copy runs during the math of this tile and the next.
    __syncthreads();
    const int ahead = kt + kFlashStages - 1;
    if (ahead < n_tiles) {
      const int st = ahead % kFlashStages;
      copy_rows<DH, kFlashKeys>(sK + st * Smem::kKV, kb, ahead * kFlashKeys, Skv);
      copy_rows<DH, kFlashKeys>(sV + st * Smem::kKV, vb, ahead * kFlashKeys, Skv);
    }
    cp_async_commit();
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < kDk; ++kk)
        ldmatrix_x4(qf[kk], sQ + (warp * 16 + a_row) * kLd + kk * 16 + a_col);
    }

    const int k0 = kt * kFlashKeys;
    // Skip tiles wholly above the warp's last row (exact identity).
    if (!causal || k0 <= w0 + 15) {
      const __nv_bfloat16* tK = sK + stage * Smem::kKV;
      const __nv_bfloat16* tV = sV + stage * Smem::kKV;
      float s[kNt][4];
#pragma unroll
      for (int j = 0; j < kNt; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kDk; ++kk) {
#pragma unroll
        for (int np = 0; np < kNt / 2; ++np) {
          uint32_t b[4];
          ldmatrix_x4(b, tK + (np * 16 + b_row) * kLd + kk * 16 + b_col);
          mma_bf16(s[2 * np], qf[kk], b[0], b[1]);
          mma_bf16(s[2 * np + 1], qf[kk], b[2], b[3]);
        }
      }

      // Online softmax (masked only where the tile crosses the diagonal
      // or Skv); p leaves as the bf16 A fragments of P V.
      uint32_t pf[kNt / 2][4];
      float corr_a, corr_b;
      if (k0 + kFlashKeys > Skv || (causal && k0 + kFlashKeys - 1 > w0)) {
        online_softmax<kNt, true, false>(s, pf, scale, k0, t, row_a, row_b, Skv,
                                         causal, m_a, m_b, l_a, l_b, corr_a, corr_b);
      } else if (exact_scale) {
        online_softmax<kNt, false, true>(s, pf, scale, k0, t, row_a, row_b, Skv,
                                         causal, m_a, m_b, l_a, l_b, corr_a, corr_b);
      } else {
        online_softmax<kNt, false, false>(s, pf, scale, k0, t, row_a, row_b, Skv,
                                          causal, m_a, m_b, l_a, l_b, corr_a, corr_b);
      }

      // acc * corr, then + P V (a fresh float32 sum per pair of output
      // n-tiles). Where no row of the warp moved its max, corr is 1 and
      // the product exact: skipped.
      if (__any_sync(0xffffffffu, corr_a != 1.f || corr_b != 1.f)) {
#pragma unroll
        for (int d = 0; d < kDt; ++d) {
          acc[d][0] = __fmul_rn(acc[d][0], corr_a);
          acc[d][1] = __fmul_rn(acc[d][1], corr_a);
          acc[d][2] = __fmul_rn(acc[d][2], corr_b);
          acc[d][3] = __fmul_rn(acc[d][3], corr_b);
        }
      }
#pragma unroll
      for (int dp = 0; dp < kDt / 2; ++dp) {
        float pv[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int c = 0; c < kNt / 2; ++c) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, tV + (c * 16 + a_row) * kLd + dp * 16 + a_col);
          mma_bf16(pv[0], pf[c], b[0], b[1]);
          mma_bf16(pv[1], pf[c], b[2], b[3]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[2 * dp + h][i] = __fadd_rn(acc[2 * dp + h][i], pv[h][i]);
        }
      }
    }
  }

  const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
  if (lse != nullptr && t == 0) {  // the quad's four lanes hold one row's m, l
    float* lb = lse + static_cast<long long>(bh) * Sq;
    if (row_a < Sq) lb[row_a] = __fadd_rn(m_a, logf(l_a));
    if (row_b < Sq) lb[row_b] = __fadd_rn(m_b, logf(l_b));
  }
  __nv_bfloat16* ob = out + static_cast<long long>(bh) * Sq * DH;
#pragma unroll
  for (int d = 0; d < kDt; ++d) {
    const int col = d * 8 + 2 * t;
    if (row_a < Sq) {
      *reinterpret_cast<uint32_t*>(ob + static_cast<long long>(row_a) * DH + col) =
          pack_bf16x2(acc[d][0] / den_a, acc[d][1] / den_a);
    }
    if (row_b < Sq) {
      *reinterpret_cast<uint32_t*>(ob + static_cast<long long>(row_b) * DH + col) =
          pack_bf16x2(acc[d][2] / den_b, acc[d][3] / den_b);
    }
  }
}

template <int DH>
cudaError_t launch_flash_bf16(const void* q, const void* k, const void* v,
                              void* o, float* lse, int BH, int Sq, int Skv,
                              int causal, float scale, cudaStream_t stream) {
  const size_t smem = FlashBf16Smem<DH>::kBytes;
  auto kernel = flash_bf16_kernel<DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (Sq + kFlashRowsBf16 - 1) / kFlashRowsBf16);
  kernel<<<grid, kFlashThreadsBf16, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse,
      Sq, Skv, causal, scale);
  return cudaGetLastError();
}

// ------------------------------------------------------------- float32
constexpr int kFlashRowsF32 = 64;  // query rows per block
constexpr int kFlashWarpsF32 = 4;  // 16 query rows each
constexpr int kFlashThreadsF32 = 32 * kFlashWarpsF32;

// Shared memory of one block, in floats: Q, K, V tiles [64][DH + 8]; per
// warp scores [16][64 + 4], p [16][64 + 8] and the PV product [16][DH + 4].
template <int DH>
struct FlashF32Smem {
  static constexpr int kLd = DH + 8;
  static constexpr int kSLd = kFlashKeys + 4;
  static constexpr int kPLd = kFlashKeys + 8;
  static constexpr int kOLd = DH + 4;
  static constexpr size_t kTile = size_t(kFlashRowsF32) * kLd * sizeof(float);
  static constexpr size_t kS = size_t(16) * kSLd * sizeof(float);
  static constexpr size_t kP = size_t(16) * kPLd * sizeof(float);
  static constexpr size_t kO = size_t(16) * kOLd * sizeof(float);
  static constexpr size_t kBytes = 3 * kTile + kFlashWarpsF32 * (kS + kP + kO);
};

// rows [row0, row0 + 64) of a [rows, DH] matrix into a [64][kLd] tile, 16
// bytes per thread and load; rows past `rows` are zero.
template <int DH>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              int row0, int rows) {
  constexpr int kPerRow = DH / 4;
  constexpr int kLd = FlashF32Smem<DH>::kLd;
  for (int i = threadIdx.x; i < kFlashRowsF32 * kPerRow; i += kFlashThreadsF32) {
    const int r = i / kPerRow, c = (i % kPerRow) * 4;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows) {
      val = *reinterpret_cast<const uint4*>(
          src + static_cast<long long>(row0 + r) * DH + c);
    }
    *reinterpret_cast<uint4*>(dst + r * kLd + c) = val;
  }
}

template <int DH>
__global__ void __launch_bounds__(kFlashThreadsF32)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int Sq, int Skv, int causal,
                 float scale) {
  using Smem = FlashF32Smem<DH>;
  constexpr int kLd = Smem::kLd, kSLd = Smem::kSLd, kPLd = Smem::kPLd,
                kOLd = Smem::kOLd;
  constexpr int kHalf = DH / 2;
  extern __shared__ __align__(128) unsigned char flash_smem[];
  float* sQ = reinterpret_cast<float*>(flash_smem);
  float* sK = reinterpret_cast<float*>(flash_smem + Smem::kTile);
  float* sV = reinterpret_cast<float*>(flash_smem + 2 * Smem::kTile);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  unsigned char* wbase = flash_smem + 3 * Smem::kTile +
                         warp * (Smem::kS + Smem::kP + Smem::kO);
  float* sS = reinterpret_cast<float*>(wbase);
  float* sP = reinterpret_cast<float*>(wbase + Smem::kS);
  float* sO = reinterpret_cast<float*>(wbase + Smem::kS + Smem::kP);

  const int bh = blockIdx.x;
  const int q_tiles = (Sq + kFlashRowsF32 - 1) / kFlashRowsF32;
  const int q0 = (q_tiles - 1 - blockIdx.y) * kFlashRowsF32;  // heaviest first
  const float* qb = q + static_cast<long long>(bh) * Sq * DH;
  const float* kb = k + static_cast<long long>(bh) * Skv * DH;
  const float* vb = v + static_cast<long long>(bh) * Skv * DH;

  // lane -> (row r of the warp's 16, half h of the keys / of Dh)
  const int r = lane >> 1, h = lane & 1;
  const int qpos = q0 + warp * 16 + r;
  float acc[kHalf];
#pragma unroll
  for (int c = 0; c < kHalf; ++c) acc[c] = 0.f;
  float m_run = kFlashNeg, l_run = 0.f;

  load_tile_f32<DH>(sQ, qb, q0, Sq);
  int k_end = Skv;
  if (causal) k_end = min(Skv, q0 + kFlashRowsF32);  // keys <= the last row
  const int n_tiles = (k_end + kFlashKeys - 1) / kFlashKeys;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kFlashKeys;
    __syncthreads();  // every warp is done with the previous K, V tiles
    load_tile_f32<DH>(sK, kb, k0, Skv);
    load_tile_f32<DH>(sV, vb, k0, Skv);
    __syncthreads();

    // scores of the warp's 16 rows against the tile's 64 keys -> sS
    const float* qrow = sQ + (warp * 16 + r) * kLd;
    for (int c = 0; c < kFlashKeys / 2; ++c) {
      const float* krow = sK + (h * (kFlashKeys / 2) + c) * kLd;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < DH; ++d) dot = fmaf(qrow[d], krow[d], dot);
      sS[r * kSLd + h * (kFlashKeys / 2) + c] = dot;
    }
    __syncwarp();

    // online softmax: lanes 2r, 2r+1 hold the two halves of row r's keys
    float sv[kFlashKeys / 2];
    float mx = kFlashNeg;
#pragma unroll
    for (int c = 0; c < kFlashKeys / 2; ++c) {
      const int kpos = k0 + h * (kFlashKeys / 2) + c;
      float x = __fmul_rn(sS[r * kSLd + h * (kFlashKeys / 2) + c], scale);
      const bool keep = kpos < Skv && (!causal || kpos <= qpos);
      x = keep ? x : kFlashNeg;
      sv[c] = x;
      mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_run, mx);
    const float corr = expf(__fsub_rn(m_run, m_new));
    float psum = 0.f;
#pragma unroll
    for (int c = 0; c < kFlashKeys / 2; ++c) {
      const float p = expf(__fsub_rn(sv[c], m_new));
      psum = __fadd_rn(psum, p);
      sP[r * kPLd + h * (kFlashKeys / 2) + c] = p;
    }
    psum = __fadd_rn(psum, __shfl_xor_sync(0xffffffffu, psum, 1));
    l_run = __fadd_rn(__fmul_rn(l_run, corr), psum);
    m_run = m_new;
    __syncwarp();

    // PV of the tile (a fresh float32 sum) -> sO
    for (int c = 0; c < kHalf; ++c) {
      const float* vcol = sV + h * kHalf + c;
      float dot = 0.f;
#pragma unroll 8
      for (int j = 0; j < kFlashKeys; ++j) {
        dot = fmaf(sP[r * kPLd + j], vcol[j * kLd], dot);
      }
      sO[r * kOLd + h * kHalf + c] = dot;
    }
    __syncwarp();
#pragma unroll
    for (int c = 0; c < kHalf; ++c) {
      acc[c] = __fadd_rn(__fmul_rn(acc[c], corr), sO[r * kOLd + h * kHalf + c]);
    }
  }

  if (qpos < Sq) {
    if (lse != nullptr && h == 0) {
      lse[static_cast<long long>(bh) * Sq + qpos] = __fadd_rn(m_run, logf(l_run));
    }
    const float den = fmaxf(l_run, 1e-30f);
    float* orow = out + (static_cast<long long>(bh) * Sq + qpos) * DH + h * kHalf;
#pragma unroll
    for (int c = 0; c < kHalf; ++c) orow[c] = acc[c] / den;
  }
}

template <int DH>
cudaError_t launch_flash_f32(const void* q, const void* k, const void* v,
                             void* o, float* lse, int BH, int Sq, int Skv,
                             int causal, float scale, cudaStream_t stream) {
  const size_t smem = FlashF32Smem<DH>::kBytes;
  auto kernel = flash_f32_kernel<DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (Sq + kFlashRowsF32 - 1) / kFlashRowsF32);
  kernel<<<grid, kFlashThreadsF32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, Sq, Skv,
      causal, scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_flash(const void* q, const void* k, const void* v, void* o,
                         float* lse, int BH, int Sq, int Skv, int causal,
                         int is_bf16, float scale, cudaStream_t s) {
  return is_bf16 ? launch_flash_bf16<DH>(q, k, v, o, lse, BH, Sq, Skv, causal, scale, s)
                 : launch_flash_f32<DH>(q, k, v, o, lse, BH, Sq, Skv, causal, scale, s);
}

}  // namespace repro_torch

// q [BH, Sq, Dh], k, v [BH, Skv, Dh], out [BH, Sq, Dh], contiguous, 16-byte
// aligned; lse [BH, Sq] float32, or NULL; is_bf16 selects bfloat16 (else
// float32); Dh in {16, 32, 64, 128}. Query rows per block: 128 in bf16, 64
// in float32 (ops._FLASH_ROWS).
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, void* lse_out,
                                     int BH, int Sq, int Skv, int dh, int causal,
                                     int is_bf16, float scale, void* stream) {
  using namespace repro_torch;
  const auto s = static_cast<cudaStream_t>(stream);
  auto* lse = static_cast<float*>(lse_out);
  cudaError_t err;
  switch (dh) {
    case 16: err = launch_flash<16>(q, k, v, out, lse, BH, Sq, Skv, causal, is_bf16, scale, s); break;
    case 32: err = launch_flash<32>(q, k, v, out, lse, BH, Sq, Skv, causal, is_bf16, scale, s); break;
    case 64: err = launch_flash<64>(q, k, v, out, lse, BH, Sq, Skv, causal, is_bf16, scale, s); break;
    case 128: err = launch_flash<128>(q, k, v, out, lse, BH, Sq, Skv, causal, is_bf16, scale, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
