// Fused binary layer: packed W [M, KW] x packed X [KW, N], then the folded-BN
// affine y = a[m] * dot + b[m], then sign, repacked along M ->
// int32 [ceil(M/32), N] (bit m%32 of word m/32 is y_m >= 0).
//
// Replaces the Pallas kernel `fused_xnor_gemm` (src/repro/kernels/fused_gemm.py,
// pallas_call at :125). Plain twin: repro_torch.core.bitops.fused_xnor_layer.
//
// On the main path it carries fc0 ([1024, 256] x [256, N]), fc1 ([1024, 32]),
// and every im2col conv (M = D, KW = 9*CW, N = batch*OH*OW). Like xnor_gemm it
// is bounded by the popc issue rate, not by bytes: the output is 32x smaller
// than the dot. The repack costs nothing extra: each warp owns 32 consecutive
// rows (one per lane), so one __ballot_sync is one output word, the
// LSB-first word of `sign_repack_m`. Rows past M take y = +1 (the a = 0,
// b = +1 pad rows of the JAX wrapper), so their bits are 1.
#include "popcount.cuh"

namespace repro_torch {

__global__ void __launch_bounds__(kGemmThreads)
fused_xnor_gemm_kernel(const unsigned* __restrict__ W,
                       const unsigned* __restrict__ X,
                       const float* __restrict__ a, const float* __restrict__ b,
                       unsigned* __restrict__ out, int M, int KW, int N,
                       int k_bits) {
  const int m0 = blockIdx.y * kRowsPerWarp;
  const int n0 = blockIdx.x * kGemmBN;
  int acc[kGemmCPW];
  gemm_tile_accumulate(W, X, M, KW, N, m0, n0, acc);
  const int lane = threadIdx.x & 31;
  const int m = m0 + lane;
  const int nb = n0 + (threadIdx.x >> 5) * kGemmCPW;
  const float am = m < M ? a[m] : 0.f;
  const float bm = m < M ? b[m] : 1.f;
#pragma unroll
  for (int j = 0; j < kGemmCPW; ++j) {
    const float y = m < M ? bn_affine(am, 2 * acc[j] - k_bits, bm) : 1.f;
    const unsigned word = sign_repack_warp(y);
    if (lane == 0 && nb + j < N) {
      out[static_cast<size_t>(blockIdx.y) * N + nb + j] = word;
    }
  }
}

}  // namespace repro_torch

extern "C" int repro_fused_xnor_gemm(const void* w, const void* x, const void* a,
                                     const void* b, void* out, int M, int KW,
                                     int N, int k_bits, void* stream) {
  const dim3 grid((N + repro_torch::kGemmBN - 1) / repro_torch::kGemmBN,
                  (M + repro_torch::kRowsPerWarp - 1) / repro_torch::kRowsPerWarp);
  repro_torch::fused_xnor_gemm_kernel<<<grid, repro_torch::kGemmThreads, 0,
                                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(w), static_cast<const unsigned*>(x),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<unsigned*>(out), M, KW, N, k_bits);
  return static_cast<int>(cudaGetLastError());
}
