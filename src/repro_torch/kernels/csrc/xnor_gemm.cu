// xnor-popcount GEMM: packed W [M, KW] x packed X [KW, N] -> int32 [M, N],
// out = 2 * sum_k popc(~(w_mk ^ x_kn)) - k_bits.
//
// Replaces the Pallas kernel `xnor_gemm` (src/repro/kernels/xnor_gemm.py,
// pallas_call at :105). Plain twin: repro_torch.core.bitops.xnor_popcount_matmul.
//
// On the main path it carries the float-boundary head (fc2, [10, 32] x
// [32, N]): a few thousand words, so the launch itself bounds it. At large
// shapes it is bounded by the popc issue rate (the H100 issues 16 popc per SM
// per clock), not by bytes: each loaded word feeds 32 popcs through the
// shared-memory tile of popcount.cuh. The TPU kernel's sequential K grid axis
// with its VMEM accumulator is the K loop inside the block here.
#include "popcount.cuh"

namespace repro_torch {

__global__ void __launch_bounds__(kGemmThreads)
xnor_gemm_kernel(const unsigned* __restrict__ W, const unsigned* __restrict__ X,
                 int* __restrict__ out, int M, int KW, int N, int k_bits) {
  const int m0 = blockIdx.y * kRowsPerWarp;
  const int n0 = blockIdx.x * kGemmBN;
  int acc[kGemmCPW];
  gemm_tile_accumulate(W, X, M, KW, N, m0, n0, acc);
  const int m = m0 + (threadIdx.x & 31);
  const int nb = n0 + (threadIdx.x >> 5) * kGemmCPW;
  if (m >= M) return;
#pragma unroll
  for (int j = 0; j < kGemmCPW; ++j) {
    if (nb + j < N) out[static_cast<size_t>(m) * N + nb + j] = 2 * acc[j] - k_bits;
  }
}

}  // namespace repro_torch

extern "C" int repro_xnor_gemm(const void* w, const void* x, void* out, int M,
                               int KW, int N, int k_bits, void* stream) {
  const dim3 grid((N + repro_torch::kGemmBN - 1) / repro_torch::kGemmBN,
                  (M + repro_torch::kRowsPerWarp - 1) / repro_torch::kRowsPerWarp);
  repro_torch::xnor_gemm_kernel<<<grid, repro_torch::kGemmThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(w), static_cast<const unsigned*>(x),
      static_cast<int*>(out), M, KW, N, k_bits);
  return static_cast<int>(cudaGetLastError());
}
