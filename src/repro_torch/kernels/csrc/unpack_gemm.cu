// Packed-weight GEMM: packed W [M, KW] (32 sign bits a word, LSB-first along
// K) times a real input X [KW*32, N] of float32 or bfloat16, read through its
// strides (sk, sn) in elements -> float32 [M, N], accumulated in float32.
//
// Replaces the Pallas kernel `unpack_gemm` (src/repro/kernels/unpack_gemm.py,
// pallas_call at :74). Plain twin: repro_torch.core.bitops.packed_matmul_unpack
// (wp, x, compute_dtype=x.dtype).
//
// Design: a block owns a 64 x 64 output tile; 256 threads hold 4 x 4 outputs
// each (rows ty + 16i, columns tx + 16j, so the shared-memory reads are
// broadcasts or consecutive words). The K loop walks one weight word (32 K
// values) per step: 64 threads read the tile's 64 words and unpack them to
// ±1.0 floats in shared memory (the unpacked weights never reach device
// memory), the block stages the matching 32 x 64 slab of X, converting bf16
// to float, with consecutive threads on X's unit-stride axis (K for the
// transposed activations of the PACKED layers, N for a contiguous X). Pitch
// 65 keeps both fills free of bank conflicts. CUDA cores, no TF32: a TF32
// product would not hold a float32 input to float32 tolerances.
//
// Numbers: with ±1 or 0 activations, as on every binary layer, each product
// is exact and each partial sum an integer below 2^24, so the result is exact
// and equals the xnor engine's dot. With real input, each thread sums the 32
// products of a word into a fresh float32 partial and adds the partials to
// its total with Kahan compensation (float32 registers, __fadd_rn/__fsub_rn so
// nothing is reassociated or contracted): at K = 8192 the result stays within
// about 1e-5 of the exact dot, where a plain float32 running sum (or a
// library GEMM) drifts by 1e-4 and more. Rows past M load weight word 0 and
// columns past N load X = 0; neither is stored. K is exactly KW*32.
//
// Bound on the H100: 2*M*N*K flops against M*KW*4 + K*N*4 + M*N*4 bytes. The
// binary layers' ±1 operands are exact in bf16, so the card's floor is the
// bf16 tensor-core rate (989 TFLOP/s), where the float32 activations' bytes
// bound every conv layer. This simple kernel runs on the float32 CUDA cores
// (67 TFLOP/s), so operations bound it; tensor cores are a later version's.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_torch {

constexpr int kUnpackTile = 64;
constexpr int kUnpackThreads = 256;
constexpr int kUnpackPitch = kUnpackTile + 1;
constexpr int kUnpackPerThread = 4;   // outputs per thread along M and along N

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(kUnpackThreads)
unpack_gemm_kernel(const unsigned* __restrict__ W, const T* __restrict__ X,
                   float* __restrict__ out, int M, int KW, int N, long long sk,
                   long long sn) {
  __shared__ float Ws[32][kUnpackPitch];   // [k][m]: ±1.0
  __shared__ float Xs[32][kUnpackPitch];   // [k][n]
  const int m0 = blockIdx.y * kUnpackTile;
  const int n0 = blockIdx.x * kUnpackTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const bool k_unit = sk == 1;

  float acc[kUnpackPerThread][kUnpackPerThread];
  float comp[kUnpackPerThread][kUnpackPerThread];   // Kahan compensation
#pragma unroll
  for (int i = 0; i < kUnpackPerThread; ++i)
#pragma unroll
    for (int j = 0; j < kUnpackPerThread; ++j) acc[i][j] = comp[i][j] = 0.f;

  for (int kw = 0; kw < KW; ++kw) {
    // Weights: thread (g, r) unpacks bits 8g..8g+7 of row m0 + r's word.
    {
      const int r = threadIdx.x & (kUnpackTile - 1), g = threadIdx.x >> 6;
      const int m = m0 + r;
      const unsigned word = m < M ? W[static_cast<size_t>(m) * KW + kw] : 0u;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int bit = g * 8 + q;
        Ws[bit][r] = (word >> bit) & 1u ? 1.f : -1.f;
      }
    }
    // Activations: the 32 x 64 slab at rows 32*kw.., columns n0..
    const long long k0 = static_cast<long long>(kw) * 32;
#pragma unroll
    for (int i = 0; i < 32 * kUnpackTile / kUnpackThreads; ++i) {
      const int idx = threadIdx.x + i * kUnpackThreads;
      const int kk = k_unit ? idx & 31 : idx / kUnpackTile;
      const int nn = k_unit ? idx >> 5 : idx % kUnpackTile;
      const int n = n0 + nn;
      Xs[kk][nn] = n < N ? to_float(X[(k0 + kk) * sk + n * sn]) : 0.f;
    }
    __syncthreads();
    float part[kUnpackPerThread][kUnpackPerThread];
#pragma unroll
    for (int i = 0; i < kUnpackPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kUnpackPerThread; ++j) part[i][j] = 0.f;
#pragma unroll 8
    for (int kk = 0; kk < 32; ++kk) {
      float wv[kUnpackPerThread], xv[kUnpackPerThread];
#pragma unroll
      for (int i = 0; i < kUnpackPerThread; ++i) wv[i] = Ws[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kUnpackPerThread; ++j) xv[j] = Xs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kUnpackPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kUnpackPerThread; ++j)
          part[i][j] = fmaf(wv[i], xv[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kUnpackPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kUnpackPerThread; ++j) {
        const float y = __fsub_rn(part[i][j], comp[i][j]);
        const float t = __fadd_rn(acc[i][j], y);
        comp[i][j] = __fsub_rn(__fsub_rn(t, acc[i][j]), y);
        acc[i][j] = t;
      }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kUnpackPerThread; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < kUnpackPerThread; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) out[static_cast<size_t>(m) * N + n] = acc[i][j];
    }
  }
}

template <typename T>
int launch_unpack_gemm(const void* w, const void* x, void* out, int M, int KW,
                       int N, long long sk, long long sn, void* stream) {
  const dim3 grid((N + kUnpackTile - 1) / kUnpackTile, (M + kUnpackTile - 1) / kUnpackTile);
  unpack_gemm_kernel<T><<<grid, kUnpackThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(w), static_cast<const T*>(x),
      static_cast<float*>(out), M, KW, N, sk, sn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

// x_is_bf16: 0 for float32 input, 1 for bfloat16.
extern "C" int repro_unpack_gemm(const void* w, const void* x, void* out, int M,
                                 int KW, int N, long long sk, long long sn,
                                 int x_is_bf16, void* stream) {
  if (x_is_bf16) {
    return repro_torch::launch_unpack_gemm<__nv_bfloat16>(w, x, out, M, KW, N, sk, sn,
                                                          stream);
  }
  return repro_torch::launch_unpack_gemm<float>(w, x, out, M, KW, N, sk, sn, stream);
}
