// xnor-popcount GEMM: packed W [M, KW] x packed X [KW, N] -> int32 [M, N],
// out = 2 * sum_k popc(~(w_mk ^ x_kn)) - k_bits.
//
// Replaces the Pallas kernel `xnor_gemm` (src/repro/kernels/xnor_gemm.py,
// pallas_call at :105). Plain twin: repro_torch.core.bitops.xnor_popcount_matmul.
//
// On the main path it carries every binary layer of the unfused PACKED
// forward (Table 2's PAPER_KERNEL: the five im2col convs, fc0, fc1 and the
// head at batch 64, eight launches a forward) and the float-boundary head
// of the served xnor paths ([10, 32] x [32, N]). Bound on the H100: bytes,
// set by the int32 output, 32x the packed X (conv1 at batch 64 writes
// 33.5 MB); the bit products at the 1-bit mma's rate (8x the int8 peak)
// take a fourth of that time.
//
// Design: fused_gemm.cu's tensor-core tile (xnor_tc.cuh: 1-bit mma.sync
// with and.popc, the xnor count from 32 KW - P(w) - P(x) + 2 popc(w & x),
// 128 x BN tiles with BN from tile_n, 32-word K slabs through a 2-stage
// cp.async ring), with an int32 epilogue: the counts are staged row-major
// (dots[m][n]) and a warp stores 128 / BN rows at a time, each row's BN
// columns as one contiguous run of 16-byte stores (4-byte where N % 4 !=
// 0); rows past M and columns past N are not written. Two blocks an SM, so
// one block's stores stream while the other's products run. Where the
// tiles cannot fill the card and K is long (fc0: 8 tiles, KW 256), K is
// split as in fused_gemm.cu (tc_k_splits): each split stores its integer
// counts to a scratch [splits, M, N], and a second kernel adds them in
// split order (integers: exact in any order) and writes 2 count - k_bits.
#include <cstdint>

#include "xnor_tc.cuh"

namespace repro_torch {

// vec bits: 1 W rows 16-byte aligned (KW % 4 == 0), 2 X rows likewise
// (N % 4 == 0), 4 output rows likewise (N % 4 == 0, out and partial
// aligned).
template <int BN>
__global__ void __launch_bounds__(kTcThreads, 2)
xnor_gemm_kernel(const unsigned* __restrict__ W, const unsigned* __restrict__ X,
                 int* __restrict__ out, int* __restrict__ partial, int M, int KW, int N,
                 int k_bits, int split_words, int vec) {
  extern __shared__ __align__(16) uint32_t tc_ring[];
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * kTcBM, split = blockIdx.z;
  const int k_begin = min(KW, split * split_words);
  const int k_end = min(KW, k_begin + split_words);
  tc_xnor_counts<BN, true>(tc_ring, W, M, KW, m0, k_begin, k_end, vec & 1,
                           TcGemmX<BN>{X, N, n0, (vec & 2) != 0});
  // A split stores its raw counts, a whole K the ±1 dot.
  int* dst = out;
  int scale = 2, bias = k_bits;
  if (partial != nullptr) {
    dst = partial + static_cast<long long>(split) * M * N;
    scale = 1;
    bias = 0;
  }
  // A row's BN columns are BN / 4 lanes of 4 columns each; a warp takes
  // 32 / (BN / 4) rows at a time.
  constexpr int kLanesRow = BN / 4, kRowsStep = 32 / kLanesRow;
  const int* dots = reinterpret_cast<const int*>(tc_ring);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = (lane % kLanesRow) * 4, n = n0 + c;
  if (n >= N) return;
  const bool vec_out = (vec & 4) != 0 && n + 3 < N;
  for (int r = warp * kRowsStep + lane / kLanesRow; r < kTcBM;
       r += (kTcThreads / 32) * kRowsStep) {
    const int m = m0 + r;
    if (m >= M) break;
    const int4 cnt = *reinterpret_cast<const int4*>(dots + r * TcTile<BN>::kRowLdd + c);
    const int4 v = make_int4(scale * cnt.x - bias, scale * cnt.y - bias,
                             scale * cnt.z - bias, scale * cnt.w - bias);
    int* o = dst + static_cast<long long>(m) * N + n;
    if (vec_out) {
      *reinterpret_cast<int4*>(o) = v;
    } else {
      o[0] = v.x;
      if (n + 1 < N) o[1] = v.y;
      if (n + 2 < N) o[2] = v.z;
      if (n + 3 < N) o[3] = v.w;
    }
  }
}

// The split-K epilogue: one thread an output, the splits' counts added in
// split order.
__global__ void __launch_bounds__(kTcThreads)
xnor_gemm_reduce_kernel(const int* __restrict__ partial, int* __restrict__ out,
                        long long total, int k_bits, int splits) {
  const long long i = static_cast<long long>(blockIdx.x) * kTcThreads + threadIdx.x;
  if (i >= total) return;
  int count = 0;
#pragma unroll 8
  for (int s = 0; s < splits; ++s) count += partial[s * total + i];
  out[i] = 2 * count - k_bits;
}

template <int BN>
cudaError_t launch_xnor_gemm(const unsigned* w, const unsigned* x, int* out, int* partial,
                             int M, int KW, int N, int k_bits, int splits, int vec,
                             cudaStream_t s) {
  const size_t smem = TcTile<BN>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(xnor_gemm_kernel<BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BN - 1) / BN, (M + kTcBM - 1) / kTcBM, splits);
  xnor_gemm_kernel<BN><<<grid, kTcThreads, smem, s>>>(
      w, x, out, splits > 1 ? partial : nullptr, M, KW, N, k_bits,
      tc_split_words(KW, splits), vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long total = static_cast<long long>(M) * N;
  xnor_gemm_reduce_kernel<<<static_cast<unsigned>((total + kTcThreads - 1) / kTcThreads),
                            kTcThreads, 0, s>>>(partial, out, total, k_bits, splits);
  return cudaGetLastError();
}

}  // namespace repro_torch

// K splits of an [M, KW] x [KW, N] product on the current device (1, or
// more where the tiles cannot fill the card and K is long: fc0), the
// heuristic behind a request of 0 (the wrapper mirrors it in Python,
// kernels/autotune.py). The caller allocates an int32 scratch [splits, M,
// N] when it is above 1.
extern "C" int repro_xnor_gemm_splits(int M, int KW, int N) {
  using namespace repro_torch;
  return tc_k_splits(M, KW, N, sm_count());
}

// The tile width tile_n picks for [M, KW] x [KW, N] on the current device.
extern "C" int repro_xnor_gemm_tile_n(int M, int N) {
  using namespace repro_torch;
  return tile_n(M, N, sm_count());
}

// partial: int32 [splits, M, N] when splits > 1 (else unused). tile_n: 0
// (tile_n's choice), 32, 64 or 128; splits: 1, or tc_splits_ok's. Any
// other request returns cudaErrorInvalidValue.
extern "C" int repro_xnor_gemm(const void* w, const void* x, void* out, void* partial, int M,
                               int KW, int N, int k_bits, int splits, int tile_n_req,
                               void* stream) {
  using namespace repro_torch;
  const int bn = tc_resolve_tile_n(tile_n_req, M, N, sm_count());
  if (bn < 0 || !tc_splits_ok(KW, splits) || (splits > 1 && partial == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool out_ok = N % 4 == 0 && aligned(out) && (splits == 1 || aligned(partial));
  const int vec = (KW % 4 == 0 && aligned(w) ? 1 : 0) | (N % 4 == 0 && aligned(x) ? 2 : 0) |
                  (out_ok ? 4 : 0);
  const auto* fw = static_cast<const unsigned*>(w);
  const auto* fx = static_cast<const unsigned*>(x);
  auto* fo = static_cast<int*>(out);
  auto* fp = static_cast<int*>(partial);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 32:
      return launch_xnor_gemm<32>(fw, fx, fo, fp, M, KW, N, k_bits, splits, vec, s);
    case 64:
      return launch_xnor_gemm<64>(fw, fx, fo, fp, M, KW, N, k_bits, splits, vec, s);
    default:
      return launch_xnor_gemm<128>(fw, fx, fo, fp, M, KW, N, k_bits, splits, vec, s);
  }
}
