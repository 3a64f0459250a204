// Fused binary layer: packed W [M, KW] x packed X [KW, N], then the folded-BN
// affine y = a[m] * dot + b[m], then sign, repacked along M ->
// int32 [ceil(M/32), N] (bit m%32 of word m/32 is y_m >= 0).
//
// Replaces the Pallas kernel `fused_xnor_gemm` (src/repro/kernels/fused_gemm.py,
// pallas_call at :125). Plain twin: repro_torch.core.bitops.fused_xnor_layer.
//
// On the main path it carries fc0 ([1024, 256] x [256, N]), fc1 ([1024, 32]),
// and every im2col conv (M = D, KW = 9*CW, N = batch*OH*OW). Bound on the
// H100: the bit products at the 1-bit mma's rate, taken as 8x the int8
// tensor-core peak (NVIDIA publishes no 1-bit rate; the 1-bit mma.sync
// measures at the int8 one's instruction rate with 8x its bits), against
// W, X and the output, 32x smaller than the dot. At batch 32 that makes
// fc0, fc1 and conv1-3 bound by bytes, conv4-5 by operations.
//
// Design. The product runs on the tensor cores as 1-bit mma.sync with
// and.popc (xnor_tc.cuh: 8x the int8 mma's bits an instruction, 41x the
// popc loop of the CUDA cores on this card), one block a 128 x 128 tile
// (128 x 64 where 128-wide tiles would not give every SM one, 128 x 32
// where N <= 32), 32-word K slabs in flight through a cp.async ring. The
// epilogue takes the staged xnor counts one column and 32 rows at a time,
// a row a lane, and ballots the output word (tc_sign_words); rows past M
// are +1 bits. Where the tiles cannot fill the card and K is long (fc0),
// K is split: each split writes its integer counts to scratch [splits,
// N, M], and a second kernel, one warp an output word, adds them in split
// order (exact in any order) and runs the epilogue once.
#include <cstdint>

#include "xnor_tc.cuh"

namespace repro_torch {

template <int BN>
__global__ void __launch_bounds__(kTcThreads, 2)
fused_xnor_gemm_kernel(const unsigned* __restrict__ W, const unsigned* __restrict__ X,
                       const float* __restrict__ a, const float* __restrict__ b,
                       unsigned* __restrict__ out, int* __restrict__ partial, int M,
                       int KW, int N, int k_bits, int split_words, int vec) {
  extern __shared__ __align__(16) uint32_t tc_ring[];
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * kTcBM, split = blockIdx.z;
  const int k_begin = min(KW, split * split_words);
  const int k_end = min(KW, k_begin + split_words);
  tc_xnor_counts<BN>(tc_ring, W, M, KW, m0, k_begin, k_end, vec & 1,
                     TcGemmX<BN>{X, N, n0, (vec & 2) != 0});
  // A warp takes a group of 32 rows (one per lane) and 32 columns: the
  // counts of one column at a time, and lane j keeps column j's word, so
  // the stores are whole 128-byte rows of the output.
  const int* dots = reinterpret_cast<const int*>(tc_ring);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int grp = warp; grp < (kTcBM / 32) * (BN / 32); grp += kTcThreads / 32) {
    const int rg = grp % (kTcBM / 32), nc = n0 + grp / (kTcBM / 32) * 32;
    const int mr = m0 + rg * 32, m = mr + lane;
    if (mr >= M) continue;
    if (partial != nullptr) {
      if (m < M) {
        const int* col = dots + (nc - n0) * kTcLdd + rg * 32 + lane;
        int* dst = partial + (static_cast<long long>(split) * N + nc) * M + m;
        for (int j = 0; j < 32 && nc + j < N; ++j) {
          dst[static_cast<long long>(j) * M] = col[j * kTcLdd];
        }
      }
      continue;
    }
    const bool real = m < M;
    const unsigned mine = tc_sign_words(dots, rg * 32, nc - n0, real, real ? a[m] : 0.f,
                                        real ? b[m] : 1.f, k_bits);
    if (nc + lane < N) out[static_cast<long long>(mr / kRowsPerWarp) * N + nc + lane] = mine;
  }
}

// The split-K epilogue: one warp an output word (32 rows of one column),
// a row a lane, the splits' counts added in split order.
__global__ void __launch_bounds__(kTcThreads)
fused_xnor_reduce_kernel(const int* __restrict__ partial, const float* __restrict__ a,
                         const float* __restrict__ b, unsigned* __restrict__ out, int M,
                         int N, int k_bits, int splits) {
  const int word = blockIdx.x * (kTcThreads / 32) + (threadIdx.x >> 5);
  if (word >= ((M + 31) / 32) * N) return;
  const int n = word % N, m = (word / N) * 32 + (threadIdx.x & 31);
  const long long plane = static_cast<long long>(N) * M;
  int total = 0;
  if (m < M) {
    const int* p = partial + static_cast<long long>(n) * M + m;
#pragma unroll 8
    for (int s = 0; s < splits; ++s) total += p[s * plane];
  }
  const float y = m < M ? bn_affine(a[m], 2 * total - k_bits, b[m]) : 1.f;
  const unsigned bits = sign_repack_warp(y);
  if ((threadIdx.x & 31) == 0) out[word] = bits;
}

template <int BN>
cudaError_t launch_fused(const unsigned* w, const unsigned* x, const float* a,
                         const float* b, unsigned* out, int* partial, int M, int KW,
                         int N, int k_bits, int splits, int vec, cudaStream_t s) {
  const size_t smem = TcTile<BN>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(fused_xnor_gemm_kernel<BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int split_words = tc_split_words(KW, splits);
  const dim3 grid((N + BN - 1) / BN, (M + kTcBM - 1) / kTcBM, splits);
  fused_xnor_gemm_kernel<BN><<<grid, kTcThreads, smem, s>>>(
      w, x, a, b, out, splits > 1 ? partial : nullptr, M, KW, N, k_bits, split_words, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int words = ((M + 31) / 32) * N;
  fused_xnor_reduce_kernel<<<(words + 7) / 8, kTcThreads, 0, s>>>(partial, a, b, out, M,
                                                                 N, k_bits, splits);
  return cudaGetLastError();
}

}  // namespace repro_torch

// partial: int32 [splits, N, M] when splits > 1 (else unused). tile_n: 0
// (tile_n's choice), 32, 64 or 128; splits: 1, or tc_splits_ok's. Any
// other request returns cudaErrorInvalidValue.
extern "C" int repro_fused_xnor_gemm(const void* w, const void* x, const void* a,
                                     const void* b, void* out, void* partial, int M,
                                     int KW, int N, int k_bits, int splits, int tile_n_req,
                                     void* stream) {
  using namespace repro_torch;
  const int bn = tc_resolve_tile_n(tile_n_req, M, N, sm_count());
  if (bn < 0 || !tc_splits_ok(KW, splits) || (splits > 1 && partial == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int vec = (KW % 4 == 0 && aligned(w) ? 1 : 0) | (N % 4 == 0 && aligned(x) ? 2 : 0);
  const auto* fw = static_cast<const unsigned*>(w);
  const auto* fx = static_cast<const unsigned*>(x);
  const auto* fa = static_cast<const float*>(a);
  const auto* fb = static_cast<const float*>(b);
  auto* fo = static_cast<unsigned*>(out);
  auto* fp = static_cast<int*>(partial);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 32:
      return launch_fused<32>(fw, fx, fa, fb, fo, fp, M, KW, N, k_bits, splits, vec, s);
    case 64:
      return launch_fused<64>(fw, fx, fa, fb, fo, fp, M, KW, N, k_bits, splits, vec, s);
    default:
      return launch_fused<128>(fw, fx, fa, fb, fo, fp, M, KW, N, k_bits, splits, vec, s);
  }
}
