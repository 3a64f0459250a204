// Direct binary convolution: channel-packed map X [N, Hp, Wp, CW] (spatial
// all-ones border already applied), tap-aligned packed filters
// W [D, kh*kw*CW] (word (i*kw + j)*CW + cw). No patch matrix is ever written.
// Two kernels share one gather and popcount loop (a template on the
// epilogue):
//   * fused: folded-BN affine a, b [D] -> packed int32 [N, OH, OW, ceil(D/32)],
//     bit d%32 of word d/32 being a[d] * dot + b[d] >= 0;
//   * dot: the int32 ±1 dot 2*acc - k_bits -> [N, OH, OW, D], for the
//     unfused PACKED layers, which apply bias and BN in float themselves.
//
// Replace the Pallas kernels `fused_direct_conv` and `direct_conv_dot`
// (src/repro/kernels/direct_conv.py, pallas_call at :171 and :235). Plain
// twins: repro_torch.core.bitops.direct_conv_oracle and direct_conv_dot.
//
// Design: one block per (image, output row, 32-channel word). The block
// stages the 32 filters' words transposed in shared memory (pitch 33, so both
// the coalesced fill and the per-lane reads are free of bank conflicts) and
// the kh input rows the output row needs. Lane l owns channel d0 + l, warps
// stride over the output columns; every activation word is a broadcast read.
// Fused: one __ballot_sync per pixel is the packed output word; channels past
// D take y = +1 (the JAX wrapper's a = 0, b = +1 pad rows). Dot: the 32 lanes
// store 32 consecutive channels of one pixel (one 128-byte store); channels
// past D are not written.
//
// Bound on the H100: the popc issue rate (16 per SM per clock) — each
// activation word staged once feeds 32 lanes x up to kh*kw taps. Bytes are
// small for the fused kernel (packed map and output); the dot's int32 output
// is 32x its packed twin and can make it bytes-bound at wide maps.
#include "popcount.cuh"

namespace repro_torch {

constexpr int kConvWarps = 8;
constexpr int kConvThreads = kConvWarps * 32;
constexpr int kConvPitch = kRowsPerWarp + 1;

template <bool kFused>
__global__ void __launch_bounds__(kConvThreads)
direct_conv_kernel(const unsigned* __restrict__ X,
                   const unsigned* __restrict__ W,
                   const float* __restrict__ a,
                   const float* __restrict__ b,
                   void* __restrict__ out, int Hp, int Wp, int CW, int D,
                   int kh, int kw, int stride, int OH, int OW, int k_bits) {
  extern __shared__ unsigned smem[];
  const int kwords = kh * kw * CW;
  unsigned* Ws = smem;                          // [kwords][kConvPitch]
  unsigned* Xs = smem + kwords * kConvPitch;    // [kh][Wp][CW]

  const int n = blockIdx.x / OH;
  const int oh = blockIdx.x % OH;
  const int dw = blockIdx.y;
  const int d0 = dw * kRowsPerWarp;
  const int DW = gridDim.y;

  for (int i = threadIdx.x; i < kRowsPerWarp * kwords; i += kConvThreads) {
    const int r = i / kwords, c = i % kwords;
    const int d = d0 + r;
    Ws[c * kConvPitch + r] = d < D ? W[static_cast<size_t>(d) * kwords + c] : 0u;
  }
  const int row_words = Wp * CW;
  const unsigned* xrow =
      X + (static_cast<size_t>(n) * Hp + static_cast<size_t>(oh) * stride) * row_words;
  for (int i = threadIdx.x; i < kh * row_words; i += kConvThreads) {
    Xs[i] = xrow[i];   // kh consecutive rows are contiguous in X
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int d = d0 + lane;
  float ad = 0.f, bd = 1.f;
  if (kFused && d < D) {
    ad = a[d];
    bd = b[d];
  }
  for (int ow = threadIdx.x >> 5; ow < OW; ow += kConvWarps) {
    int acc = 0;
    for (int i = 0; i < kh; ++i) {
      for (int j = 0; j < kw; ++j) {
        const unsigned* xs = Xs + (i * Wp + ow * stride + j) * CW;
        const unsigned* ws = Ws + ((i * kw + j) * CW) * kConvPitch + lane;
        for (int c = 0; c < CW; ++c) {
          acc += xnor_popc(ws[c * kConvPitch], xs[c]);
        }
      }
    }
    const size_t pixel = (static_cast<size_t>(n) * OH + oh) * OW + ow;
    if (kFused) {
      const float y = d < D ? bn_affine(ad, 2 * acc - k_bits, bd) : 1.f;
      const unsigned word = sign_repack_warp(y);
      if (lane == 0) static_cast<unsigned*>(out)[pixel * DW + dw] = word;
    } else if (d < D) {
      static_cast<int*>(out)[pixel * D + d] = 2 * acc - k_bits;
    }
  }
}

}  // namespace repro_torch

extern "C" int repro_fused_direct_conv_smem_bytes(int CW, int Wp, int kh, int kw) {
  return (kh * kw * CW * repro_torch::kConvPitch + kh * Wp * CW) *
         static_cast<int>(sizeof(unsigned));
}

namespace repro_torch {

template <bool kFused>
int launch_direct_conv(const void* x, const void* w, const void* a, const void* b,
                       void* out, int N, int Hp, int Wp, int CW, int D, int kh,
                       int kw, int stride, int k_bits, void* stream) {
  const int OH = (Hp - kh) / stride + 1;
  const int OW = (Wp - kw) / stride + 1;
  const int smem = repro_fused_direct_conv_smem_bytes(CW, Wp, kh, kw);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        direct_conv_kernel<kFused>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(N * OH, (D + kRowsPerWarp - 1) / kRowsPerWarp);
  direct_conv_kernel<kFused><<<grid, kConvThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(x), static_cast<const unsigned*>(w),
      static_cast<const float*>(a), static_cast<const float*>(b), out, Hp, Wp,
      CW, D, kh, kw, stride, OH, OW, k_bits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

extern "C" int repro_fused_direct_conv(const void* x, const void* w, const void* a,
                                       const void* b, void* out, int N, int Hp,
                                       int Wp, int CW, int D, int kh, int kw,
                                       int stride, int k_bits, void* stream) {
  return repro_torch::launch_direct_conv<true>(x, w, a, b, out, N, Hp, Wp, CW, D,
                                               kh, kw, stride, k_bits, stream);
}

extern "C" int repro_direct_conv_dot(const void* x, const void* w, void* out,
                                     int N, int Hp, int Wp, int CW, int D, int kh,
                                     int kw, int stride, int k_bits, void* stream) {
  return repro_torch::launch_direct_conv<false>(x, w, nullptr, nullptr, out, N, Hp,
                                                Wp, CW, D, kh, kw, stride, k_bits,
                                                stream);
}
