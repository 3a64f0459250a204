// Direct binary convolution: channel-packed map X [N, H, W, CW] and
// tap-aligned packed filters W [D, kh*kw*CW] (word (i*kw + j)*CW + cw). No
// patch matrix is ever written. Two kernels:
//   * fused: folded-BN affine a, b [D] -> packed int32 [N, OH, OW, ceil(D/32)],
//     bit d%32 of word d/32 being a[d] * dot + b[d] >= 0. Takes the map
//     unpadded and lays the all-ones spatial border itself;
//   * dot: the int32 ±1 dot 2*acc - k_bits -> [N, OH, OW, D], for the
//     unfused PACKED layers, which apply bias and BN in float themselves.
//     Takes the map with its all-ones border already applied.
//
// Replace the Pallas kernels `fused_direct_conv` and `direct_conv_dot`
// (src/repro/kernels/direct_conv.py, pallas_call at :171 and :235). Plain
// twins: repro_torch.core.bitops.direct_conv_oracle and direct_conv_dot.
//
// Fused design: an implicit GEMM on xnor_tc.cuh's tensor-core tile (1-bit
// mma.sync and.popc), M = D, N = the batch's N*OH*OW output pixels, K = the
// kh*kw*CW window words in tap-major order. Only the X side differs from
// fused_gemm.cu: ConvGatherX gathers each 32-word K slab of the block's
// pixel columns from the map with 4-byte cp.async (one pixel a thread, the
// K words' map offsets and taps from a table in shared memory), writes
// all-ones words where a tap falls on the spatial border and zeros past K.
// Border words are real operand words (the +1 padding), so the count
// identity of xnor_tc.cuh holds as for any words. The epilogue ballots
// 32 channels of one pixel (tc_sign_words) and stores the pixel-major
// word out[pixel * DW + d / 32]; channels past D are +1 bits. Tile width
// as fused_gemm.cu's (tile_n). Bound on the H100: the bit products at the
// 1-bit mma's rate (8x the int8 peak) or the packed map, filters and
// output once through HBM, whichever is larger; the gather re-reads each
// map word up to kh*kw times, from L2 and L1.
//
// Dot design (CUDA cores): one block per (image, output row, 32-channel
// word). The block stages the 32 filters' words transposed in shared
// memory (pitch 33, so both the coalesced fill and the per-lane reads are
// free of bank conflicts) and the kh input rows the output row needs.
// Lane l owns channel d0 + l, warps stride over the output columns; every
// activation word is a broadcast read. The 32 lanes store 32 consecutive
// channels of one pixel (one 128-byte store); channels past D are not
// written. Bound: the popc issue rate (16 per SM per clock); its int32
// output is 32x the packed one and can make it bytes-bound at wide maps.
#include <cstdint>

#include "popcount.cuh"
#include "xnor_tc.cuh"

namespace repro_torch {

// ---------------------------------------------------------------------------
// fused: the implicit GEMM
// ---------------------------------------------------------------------------

// X slab loader of the implicit patch matrix [K, npix]: word (k, n) is
// word k of output pixel n's window. A thread owns one pixel column (cc =
// threadIdx.x % BN) for every slab; `tab[k]` holds word k's offset from
// the window's top-left word, (i*W + j)*CW + c, and its tap (i << 16) | j.
template <int BN>
struct ConvGatherX {
  const unsigned* img;  // the thread's pixel's image in the map
  const int2* tab;
  int off0;             // (y0*W + x0)*CW, the window's top-left word (may lie outside)
  int y0, x0, H, W;
  bool live;            // the thread's pixel is below npix
  __device__ __forceinline__ void operator()(uint32_t* xs, int k0, int k_end) const {
    const int cc = threadIdx.x % BN;
    for (int kk = threadIdx.x / BN; kk < kTcSlab; kk += kTcThreads / BN) {
      const int k = k0 + kk;
      uint32_t* dst = xs + kk * TcTile<BN>::kLdx + cc;
      if (!live || k >= k_end) {
        *dst = 0u;
        continue;
      }
      const int2 e = tab[k];
      const bool inside = static_cast<unsigned>(y0 + (e.y >> 16)) < static_cast<unsigned>(H) &&
                          static_cast<unsigned>(x0 + (e.y & 0xffff)) < static_cast<unsigned>(W);
      const unsigned* src = img + (off0 + e.x);
      if (inside) {
        cp_async4(dst, src, true);
      } else {
        *dst = ~0u;  // the all-ones spatial border
      }
    }
  }
};

template <int BN>
__global__ void __launch_bounds__(kTcThreads, 2)
fused_direct_conv_kernel(const unsigned* __restrict__ X, const unsigned* __restrict__ Wt,
                         const float* __restrict__ a, const float* __restrict__ b,
                         unsigned* __restrict__ out, int npix, int H, int W, int CW,
                         int D, int kh, int kw, int stride, int pad, int OH, int OW,
                         int k_bits, int vec_w) {
  extern __shared__ __align__(16) uint32_t tc_ring[];
  const int KW = kh * kw * CW;
  int2* tab = reinterpret_cast<int2*>(tc_ring + TcTile<BN>::kSmemBytes / sizeof(uint32_t));
  for (int k = threadIdx.x; k < KW; k += kTcThreads) {
    const int tap = k / CW, c = k - tap * CW;
    const int i = tap / kw, j = tap - i * kw;
    tab[k] = make_int2((i * W + j) * CW + c, (i << 16) | j);
  }
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * kTcBM;
  const int n = n0 + static_cast<int>(threadIdx.x) % BN;
  const int pix = min(n, npix - 1);
  const int img = pix / (OH * OW), rem = pix - img * (OH * OW);
  const int oh = rem / OW, ow = rem - oh * OW;
  ConvGatherX<BN> gather;
  gather.img = X + static_cast<long long>(img) * H * W * CW;
  gather.tab = tab;
  gather.y0 = oh * stride - pad;
  gather.x0 = ow * stride - pad;
  gather.off0 = (gather.y0 * W + gather.x0) * CW;
  gather.H = H;
  gather.W = W;
  gather.live = n < npix;
  __syncthreads();  // the table is complete before the first slab loads
  tc_xnor_counts<BN>(tc_ring, Wt, D, KW, m0, 0, KW, vec_w != 0, gather);
  // A warp takes 32 channels (one per lane) of 32 pixels: lane j keeps
  // pixel j's word.
  const int* dots = reinterpret_cast<const int*>(tc_ring);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int DW = (D + kRowsPerWarp - 1) / kRowsPerWarp;
  for (int grp = warp; grp < (kTcBM / 32) * (BN / 32); grp += kTcThreads / 32) {
    const int rg = grp % (kTcBM / 32), c = grp / (kTcBM / 32) * 32;
    const int mr = m0 + rg * 32, m = mr + lane;
    if (mr >= D) continue;
    const bool real = m < D;
    const unsigned word = tc_sign_words(dots, rg * 32, c, real, real ? a[m] : 0.f,
                                        real ? b[m] : 1.f, k_bits);
    if (n0 + c + lane < npix) {
      out[static_cast<long long>(n0 + c + lane) * DW + mr / kRowsPerWarp] = word;
    }
  }
}

template <int BN>
cudaError_t launch_fused_conv(const unsigned* x, const unsigned* w, const float* a,
                              const float* b, unsigned* out, int npix, int H, int W,
                              int CW, int D, int kh, int kw, int stride, int pad, int OH,
                              int OW, int k_bits, int vec_w, cudaStream_t s) {
  const size_t smem = TcTile<BN>::kSmemBytes + sizeof(int2) * kh * kw * CW;
  cudaError_t err = cudaFuncSetAttribute(fused_direct_conv_kernel<BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((npix + BN - 1) / BN, (D + kTcBM - 1) / kTcBM);
  fused_direct_conv_kernel<BN><<<grid, kTcThreads, smem, s>>>(
      x, w, a, b, out, npix, H, W, CW, D, kh, kw, stride, pad, OH, OW, k_bits, vec_w);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// dot: the popc loop on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kConvWarps = 8;
constexpr int kConvThreads = kConvWarps * 32;
constexpr int kConvPitch = kRowsPerWarp + 1;

__global__ void __launch_bounds__(kConvThreads)
direct_conv_dot_kernel(const unsigned* __restrict__ X, const unsigned* __restrict__ W,
                       int* __restrict__ out, int Hp, int Wp, int CW, int D, int kh,
                       int kw, int stride, int OH, int OW, int k_bits) {
  extern __shared__ unsigned smem[];
  const int kwords = kh * kw * CW;
  unsigned* Ws = smem;                          // [kwords][kConvPitch]
  unsigned* Xs = smem + kwords * kConvPitch;    // [kh][Wp][CW]

  const int n = blockIdx.x / OH;
  const int oh = blockIdx.x % OH;
  const int dw = blockIdx.y;
  const int d0 = dw * kRowsPerWarp;

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
    if (d < D) out[pixel * D + d] = 2 * acc - k_bits;
  }
}

}  // namespace repro_torch

// (CW, Wp, kh, kw) -> dynamic shared memory bytes of one dot block.
extern "C" int repro_direct_conv_dot_smem_bytes(int CW, int Wp, int kh, int kw) {
  return (kh * kw * CW * repro_torch::kConvPitch + kh * Wp * CW) *
         static_cast<int>(sizeof(unsigned));
}

// x: the unpadded map [N, H, W, CW]; out [N, OH, OW, ceil(D/32)].
extern "C" int repro_fused_direct_conv(const void* x, const void* w, const void* a,
                                       const void* b, void* out, int N, int H, int W,
                                       int CW, int D, int kh, int kw, int stride, int pad,
                                       int k_bits, void* stream) {
  using namespace repro_torch;
  const int OH = (H + 2 * pad - kh) / stride + 1;
  const int OW = (W + 2 * pad - kw) / stride + 1;
  const long long npix = static_cast<long long>(N) * OH * OW;
  if (OH < 1 || OW < 1 || npix > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int vec_w = (kh * kw * CW) % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const auto* fx = static_cast<const unsigned*>(x);
  const auto* fw = static_cast<const unsigned*>(w);
  const auto* fa = static_cast<const float*>(a);
  const auto* fb = static_cast<const float*>(b);
  auto* fo = static_cast<unsigned*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(npix);
  switch (tile_n(D, n, sm_count())) {
    case 32:
      return launch_fused_conv<32>(fx, fw, fa, fb, fo, n, H, W, CW, D, kh, kw, stride, pad,
                                   OH, OW, k_bits, vec_w, s);
    case 64:
      return launch_fused_conv<64>(fx, fw, fa, fb, fo, n, H, W, CW, D, kh, kw, stride, pad,
                                   OH, OW, k_bits, vec_w, s);
    default:
      return launch_fused_conv<128>(fx, fw, fa, fb, fo, n, H, W, CW, D, kh, kw, stride, pad,
                                    OH, OW, k_bits, vec_w, s);
  }
}

// x: the padded map [N, Hp, Wp, CW]; out int32 [N, OH, OW, D].
extern "C" int repro_direct_conv_dot(const void* x, const void* w, void* out,
                                     int N, int Hp, int Wp, int CW, int D, int kh,
                                     int kw, int stride, int k_bits, void* stream) {
  using namespace repro_torch;
  const int OH = (Hp - kh) / stride + 1;
  const int OW = (Wp - kw) / stride + 1;
  const int smem = repro_direct_conv_dot_smem_bytes(CW, Wp, kh, kw);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        direct_conv_dot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(N * OH, (D + kRowsPerWarp - 1) / kRowsPerWarp);
  direct_conv_dot_kernel<<<grid, kConvThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(x), static_cast<const unsigned*>(w),
      static_cast<int*>(out), Hp, Wp, CW, D, kh, kw, stride, OH, OW, k_bits);
  return static_cast<int>(cudaGetLastError());
}
