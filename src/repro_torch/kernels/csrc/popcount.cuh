// Device functions shared by the three xnor kernels of this directory.
//
// Replaces src/repro/kernels/popcount.py of the JAX package, which has no
// launch of its own either: `_word_pc` becomes xnor_popc, the fused epilogue
// `sign_repack_m` becomes bn_affine + a warp ballot, and the K-word loops of
// `accum_popcount_km` become gemm_tile_accumulate below.
//
// Conventions (the JAX package's, see repro.core.bitops):
//   * 32 sign bits pack LSB-first into one 32-bit word; bit = (value >= 0).
//   * dot = 2 * sum popc(~(w ^ x)) - k_bits, with k_bits the TRUE K.
//   * Pads are xnor-neutral: weight word 0 against activation word ~0u gives
//     popc(~(0 ^ ~0)) = 0, so padded words add nothing.
//   * The affine epilogue rounds twice, y = (a * dot) + b, never as an FMA.
#pragma once

#include <cuda_runtime.h>

namespace repro_torch {

// Output rows one warp owns: one row per lane, so a ballot over the warp is
// exactly one packed output word (lane i -> bit i, LSB-first).
constexpr int kRowsPerWarp = 32;

__device__ __forceinline__ int xnor_popc(unsigned w, unsigned x) {
  return __popc(~(w ^ x));
}

__device__ __forceinline__ float bn_affine(float a, int dot, float b) {
  // __fmul_rn/__fadd_rn are never contracted into an FMA.
  return __fadd_rn(__fmul_rn(a, static_cast<float>(dot)), b);
}

__device__ __forceinline__ unsigned sign_repack_warp(float y) {
  return __ballot_sync(0xffffffffu, y >= 0.f);
}

// ---------------------------------------------------------------------------
// GEMM tile: W [M, KW] x X [KW, N], both row-major packed words.
//
// A block of kGemmWarps warps owns a kRowsPerWarp x kGemmBN output tile:
// lane l holds row m0 + l, warp w holds columns n0 + w*kGemmCPW .. +kGemmCPW.
// The K loop walks kGemmBK-word slabs through shared memory; out-of-range
// words load as the xnor-neutral pair (w = 0, x = ~0).
// ---------------------------------------------------------------------------
constexpr int kGemmWarps = 8;
constexpr int kGemmThreads = kGemmWarps * 32;
constexpr int kGemmCPW = 4;                       // columns per warp
constexpr int kGemmBN = kGemmWarps * kGemmCPW;    // 32 columns per block
constexpr int kGemmBK = 32;                       // K words per slab

__device__ __forceinline__ void gemm_tile_accumulate(
    const unsigned* __restrict__ W, const unsigned* __restrict__ X,
    int M, int KW, int N, int m0, int n0, int (&acc)[kGemmCPW]) {
  __shared__ unsigned Ws[kRowsPerWarp][kGemmBK + 1];          // +1: no bank conflicts
  __shared__ __align__(16) unsigned Xs[kGemmBK][kGemmBN];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < kGemmCPW; ++j) acc[j] = 0;

  for (int k0 = 0; k0 < KW; k0 += kGemmBK) {
    for (int i = threadIdx.x; i < kRowsPerWarp * kGemmBK; i += kGemmThreads) {
      const int r = i / kGemmBK, c = i % kGemmBK;
      const int m = m0 + r, k = k0 + c;
      Ws[r][c] = (m < M && k < KW) ? W[static_cast<size_t>(m) * KW + k] : 0u;
    }
    for (int i = threadIdx.x; i < kGemmBK * kGemmBN; i += kGemmThreads) {
      const int r = i / kGemmBN, c = i % kGemmBN;
      const int k = k0 + r, n = n0 + c;
      Xs[r][c] = (k < KW && n < N) ? X[static_cast<size_t>(k) * N + n] : ~0u;
    }
    __syncthreads();
    const int kk = min(kGemmBK, KW - k0);
    if (kk == kGemmBK) {
#pragma unroll 8
      for (int k = 0; k < kGemmBK; ++k) {
        const unsigned w = Ws[lane][k];
        const uint4 x = *reinterpret_cast<const uint4*>(&Xs[k][warp * kGemmCPW]);
        acc[0] += xnor_popc(w, x.x);
        acc[1] += xnor_popc(w, x.y);
        acc[2] += xnor_popc(w, x.z);
        acc[3] += xnor_popc(w, x.w);
      }
    } else {
      for (int k = 0; k < kk; ++k) {
        const unsigned w = Ws[lane][k];
        const uint4 x = *reinterpret_cast<const uint4*>(&Xs[k][warp * kGemmCPW]);
        acc[0] += xnor_popc(w, x.x);
        acc[1] += xnor_popc(w, x.y);
        acc[2] += xnor_popc(w, x.z);
        acc[3] += xnor_popc(w, x.w);
      }
    }
    __syncthreads();
  }
}

}  // namespace repro_torch
