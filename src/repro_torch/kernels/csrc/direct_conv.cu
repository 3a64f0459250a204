// Direct binary convolution: channel-packed map X [N, H, W, CW] and
// tap-aligned packed filters W [D, kh*kw*CW] (word (i*kw + j)*CW + cw). No
// patch matrix is ever written. Both kernels take the map unpadded and lay
// the all-ones spatial border down themselves:
//   * fused: folded-BN affine a, b [D] -> packed int32 [N, OH, OW, ceil(D/32)],
//     bit d%32 of word d/32 being a[d] * dot + b[d] >= 0;
//   * dot: the int32 ±1 dot 2*count - k_bits -> [N, OH, OW, D], for the
//     unfused PACKED layers, which apply bias and BN in float themselves.
//
// Replace the Pallas kernels `fused_direct_conv` and `direct_conv_dot`
// (src/repro/kernels/direct_conv.py, pallas_call at :171 and :235). Plain
// twins: repro_torch.core.bitops.direct_conv_oracle and direct_conv_dot.
//
// Design: one implicit GEMM on xnor_tc.cuh's tensor-core tile (1-bit
// mma.sync and.popc), M = D, N = the batch's N*OH*OW output pixels, K = the
// kh*kw*CW window words in tap-major order; the two kernels differ only in
// their epilogue. Only the X side differs from fused_gemm.cu: ConvGatherX
// gathers each 32-word K slab of the block's pixel columns from the map
// with 4-byte cp.async (one pixel a thread, the K words' map offsets and
// taps from a table in shared memory), writes all-ones words where a tap
// falls on the spatial border and zeros past K. Border words are real
// operand words (the +1 padding), so the count identity of xnor_tc.cuh
// holds as for any words. Tile width as fused_gemm.cu's (tile_n); the only
// shared memory beside the tile is the K table (8 bytes a word), so no map
// is too wide.
//
// Fused epilogue: a warp ballots 32 channels of one pixel (tc_sign_words)
// and stores the pixel-major word out[pixel * DW + d / 32]; channels past D
// are +1 bits. Bound on the H100: the bit products at the 1-bit mma's rate
// (8x the int8 peak).
//
// Dot epilogue: a warp takes one pixel's 128 channels at a time from the
// staged counts (lane l channels 4l..4l+3, one 16-byte shared load) and
// stores 2*count - k_bits as one 16-byte store a lane, the warp's 512 bytes
// contiguous (4-byte stores where D % 4 != 0); channels past D are not
// written. Bound on the H100: the int32 output, 32x the packed one, through
// HBM. Two blocks an SM, so one block's stores stream while the other's
// products run.
#include <cstdint>

#include "xnor_tc.cuh"

namespace repro_torch {

// Sizes of one direct conv of the unpadded map [N, H, W, CW]: OH, OW its
// output's (the border of width pad counted), npix = N*OH*OW.
struct ConvShape {
  int npix, H, W, CW, D, kh, kw, stride, pad, OH, OW, k_bits;
};

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

// Shared memory of a block: the tile's ring (or its staged counts) and the
// K table.
template <int BN>
size_t conv_smem_bytes(const ConvShape& s) {
  return TcTile<BN>::kSmemBytes + sizeof(int2) * s.kh * s.kw * s.CW;
}

// The xnor counts of the block's tile (filter rows [m0, m0 + 128), output
// pixels [n0, n0 + BN)), staged in `tc_ring` as dots[n * kTcLdd + m] (m, n
// local) and readable by every thread on return.
template <int BN>
__device__ __forceinline__ void conv_tile_counts(uint32_t* tc_ring, const unsigned* __restrict__ X,
                                                 const unsigned* __restrict__ Wt,
                                                 const ConvShape& s, int n0, int m0, bool vec_w) {
  const int KW = s.kh * s.kw * s.CW;
  int2* tab = reinterpret_cast<int2*>(tc_ring + TcTile<BN>::kSmemBytes / sizeof(uint32_t));
  for (int k = threadIdx.x; k < KW; k += kTcThreads) {
    const int tap = k / s.CW, c = k - tap * s.CW;
    const int i = tap / s.kw, j = tap - i * s.kw;
    tab[k] = make_int2((i * s.W + j) * s.CW + c, (i << 16) | j);
  }
  const int n = n0 + static_cast<int>(threadIdx.x) % BN;
  const int pix = min(n, s.npix - 1);
  const int img = pix / (s.OH * s.OW), rem = pix - img * (s.OH * s.OW);
  const int oh = rem / s.OW, ow = rem - oh * s.OW;
  ConvGatherX<BN> gather;
  gather.img = X + static_cast<long long>(img) * s.H * s.W * s.CW;
  gather.tab = tab;
  gather.y0 = oh * s.stride - s.pad;
  gather.x0 = ow * s.stride - s.pad;
  gather.off0 = (gather.y0 * s.W + gather.x0) * s.CW;
  gather.H = s.H;
  gather.W = s.W;
  gather.live = n < s.npix;
  __syncthreads();  // the table is complete before the first slab loads
  tc_xnor_counts<BN>(tc_ring, Wt, s.D, KW, m0, 0, KW, vec_w, gather);
}

template <int BN>
__global__ void __launch_bounds__(kTcThreads, 2)
fused_direct_conv_kernel(const unsigned* __restrict__ X, const unsigned* __restrict__ Wt,
                         const float* __restrict__ a, const float* __restrict__ b,
                         unsigned* __restrict__ out, ConvShape s, int vec_w) {
  extern __shared__ __align__(16) uint32_t tc_ring[];
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * kTcBM;
  conv_tile_counts<BN>(tc_ring, X, Wt, s, n0, m0, vec_w != 0);
  // A warp takes 32 channels (one per lane) of 32 pixels: lane j keeps
  // pixel j's word.
  const int* dots = reinterpret_cast<const int*>(tc_ring);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int DW = (s.D + kRowsPerWarp - 1) / kRowsPerWarp;
  for (int grp = warp; grp < (kTcBM / 32) * (BN / 32); grp += kTcThreads / 32) {
    const int rg = grp % (kTcBM / 32), c = grp / (kTcBM / 32) * 32;
    const int mr = m0 + rg * 32, m = mr + lane;
    if (mr >= s.D) continue;
    const bool real = m < s.D;
    const unsigned word = tc_sign_words(dots, rg * 32, c, real, real ? a[m] : 0.f,
                                        real ? b[m] : 1.f, s.k_bits);
    if (n0 + c + lane < s.npix) {
      out[static_cast<long long>(n0 + c + lane) * DW + mr / kRowsPerWarp] = word;
    }
  }
}

template <int BN>
__global__ void __launch_bounds__(kTcThreads, 2)
direct_conv_dot_kernel(const unsigned* __restrict__ X, const unsigned* __restrict__ Wt,
                       int* __restrict__ out, ConvShape s, int vec_w, int vec_out) {
  extern __shared__ __align__(16) uint32_t tc_ring[];
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * kTcBM;
  conv_tile_counts<BN>(tc_ring, X, Wt, s, n0, m0, vec_w != 0);
  // A warp stores one pixel's 128 channels at a time, lane l channels
  // m0 + 4l .. m0 + 4l + 3: the warp's stores cover one contiguous run.
  const int* dots = reinterpret_cast<const int*>(tc_ring);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m = m0 + 4 * lane;
  const int pixels = min(BN, s.npix - n0);
  if (m >= s.D) return;
  for (int c = warp; c < pixels; c += kTcThreads / 32) {
    const int4 cnt = *reinterpret_cast<const int4*>(dots + c * kTcLdd + 4 * lane);
    const int4 dot = make_int4(2 * cnt.x - s.k_bits, 2 * cnt.y - s.k_bits,
                               2 * cnt.z - s.k_bits, 2 * cnt.w - s.k_bits);
    int* dst = out + static_cast<long long>(n0 + c) * s.D + m;
    if (vec_out && m + 3 < s.D) {
      *reinterpret_cast<int4*>(dst) = dot;
    } else {
      dst[0] = dot.x;
      if (m + 1 < s.D) dst[1] = dot.y;
      if (m + 2 < s.D) dst[2] = dot.z;
      if (m + 3 < s.D) dst[3] = dot.w;
    }
  }
}

template <int BN>
cudaError_t launch_fused_conv(const unsigned* x, const unsigned* w, const float* a,
                              const float* b, unsigned* out, const ConvShape& s, int vec_w,
                              cudaStream_t stream) {
  const size_t smem = conv_smem_bytes<BN>(s);
  cudaError_t err = cudaFuncSetAttribute(fused_direct_conv_kernel<BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((s.npix + BN - 1) / BN, (s.D + kTcBM - 1) / kTcBM);
  fused_direct_conv_kernel<BN><<<grid, kTcThreads, smem, stream>>>(x, w, a, b, out, s, vec_w);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_conv_dot(const unsigned* x, const unsigned* w, int* out, const ConvShape& s,
                            int vec_w, int vec_out, cudaStream_t stream) {
  const size_t smem = conv_smem_bytes<BN>(s);
  cudaError_t err = cudaFuncSetAttribute(direct_conv_dot_kernel<BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((s.npix + BN - 1) / BN, (s.D + kTcBM - 1) / kTcBM);
  direct_conv_dot_kernel<BN><<<grid, kTcThreads, smem, stream>>>(x, w, out, s, vec_w, vec_out);
  return cudaGetLastError();
}

// The sizes of a conv of the unpadded map [N, H, W, CW]; false where the
// output is empty or its pixels exceed 32-bit ints.
inline bool conv_shape(ConvShape* s, int N, int H, int W, int CW, int D, int kh, int kw,
                       int stride, int pad, int k_bits) {
  const int OH = (H + 2 * pad - kh) / stride + 1;
  const int OW = (W + 2 * pad - kw) / stride + 1;
  const long long npix = static_cast<long long>(N) * OH * OW;
  if (OH < 1 || OW < 1 || npix > 0x7fffffffLL) return false;
  *s = ConvShape{static_cast<int>(npix), H, W, CW, D, kh, kw, stride, pad, OH, OW, k_bits};
  return true;
}

}  // namespace repro_torch

// x: the unpadded map [N, H, W, CW]; out [N, OH, OW, ceil(D/32)].
extern "C" int repro_fused_direct_conv(const void* x, const void* w, const void* a,
                                       const void* b, void* out, int N, int H, int W,
                                       int CW, int D, int kh, int kw, int stride, int pad,
                                       int k_bits, void* stream) {
  using namespace repro_torch;
  ConvShape s;
  if (!conv_shape(&s, N, H, W, CW, D, kh, kw, stride, pad, k_bits)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int vec_w = (kh * kw * CW) % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const auto* fx = static_cast<const unsigned*>(x);
  const auto* fw = static_cast<const unsigned*>(w);
  const auto* fa = static_cast<const float*>(a);
  const auto* fb = static_cast<const float*>(b);
  auto* fo = static_cast<unsigned*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (tile_n(D, s.npix, sm_count())) {
    case 32:
      return launch_fused_conv<32>(fx, fw, fa, fb, fo, s, vec_w, st);
    case 64:
      return launch_fused_conv<64>(fx, fw, fa, fb, fo, s, vec_w, st);
    default:
      return launch_fused_conv<128>(fx, fw, fa, fb, fo, s, vec_w, st);
  }
}

// x: the unpadded map [N, H, W, CW]; out int32 [N, OH, OW, D].
extern "C" int repro_direct_conv_dot(const void* x, const void* w, void* out, int N, int H,
                                     int W, int CW, int D, int kh, int kw, int stride,
                                     int pad, int k_bits, void* stream) {
  using namespace repro_torch;
  ConvShape s;
  if (!conv_shape(&s, N, H, W, CW, D, kh, kw, stride, pad, k_bits)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int vec_w = (kh * kw * CW) % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const int vec_out = D % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const auto* fx = static_cast<const unsigned*>(x);
  const auto* fw = static_cast<const unsigned*>(w);
  auto* fo = static_cast<int*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (tile_n(D, s.npix, sm_count())) {
    case 32:
      return launch_conv_dot<32>(fx, fw, fo, s, vec_w, vec_out, st);
    case 64:
      return launch_conv_dot<64>(fx, fw, fo, s, vec_w, vec_out, st);
    default:
      return launch_conv_dot<128>(fx, fw, fo, s, vec_w, vec_out, st);
  }
}
