// Sign-encode a real matrix along its first axis: float32 X [K, N] with
// unit stride along K and stride sn (in elements) along N -> int32
// [K/32, N], bit b of word w being X[32w + b, n] >= 0 (LSB-first; -0.0
// sets the bit, NaN clears it).
//
// Replaces the Pallas kernel `pack_rows` (src/repro/kernels/pack.py,
// pallas_call at :44). Plain twin: repro_torch.core.bitops.pack_bits(x,
// axis=0).
//
// Bound on the H100: bytes. It reads 4 bytes and writes 1/8 byte per
// element and does one compare, so HBM bandwidth (3.35 TB/s) is the limit.
// The unfused PACKED layers hand over the transposed [N, K] patch matrix
// as x2d.T, which is K-contiguous: lane l of a warp reads X[32w + l, n],
// one 128-byte read per word, and __ballot_sync is the word itself. A warp
// walks kBallotWords words of one column with all their reads in flight
// before the first ballot. The patch matrix is read in place: no
// transposed copy exists.
#include <cuda_runtime.h>

namespace repro_torch {

constexpr int kPackThreads = 256;
constexpr int kPackWarps = kPackThreads / 32;
constexpr int kBallotWords = 8;

__global__ void __launch_bounds__(kPackThreads)
pack_rows_ballot_kernel(const float* __restrict__ X, unsigned* __restrict__ out,
                        int KW, int N, long long sn) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kPackWarps + (threadIdx.x >> 5);
  const int w0 = blockIdx.y * kBallotWords;
  if (n >= N) return;  // n is uniform over the warp: the ballots stay full
  const float* row = X + n * sn + static_cast<long long>(w0) * 32 + lane;
  float v[kBallotWords];
#pragma unroll
  for (int q = 0; q < kBallotWords; ++q) {
    v[q] = w0 + q < KW ? row[q * 32] : 0.f;
  }
  unsigned mine = 0;
#pragma unroll
  for (int q = 0; q < kBallotWords; ++q) {
    const unsigned word = __ballot_sync(0xffffffffu, v[q] >= 0.f);
    if (lane == q) mine = word;
  }
  // Lanes 0..7 store one word each; the block's 8 warps are 8 consecutive
  // columns, so each row of the output gets one 32-byte sector per block.
  if (lane < kBallotWords && w0 + lane < KW) {
    out[static_cast<size_t>(w0 + lane) * N + n] = mine;
  }
}

}  // namespace repro_torch

extern "C" int repro_pack_rows(const void* x, void* out, int KW, int N,
                               long long sn, void* stream) {
  const dim3 grid((N + repro_torch::kPackWarps - 1) / repro_torch::kPackWarps,
                  (KW + repro_torch::kBallotWords - 1) / repro_torch::kBallotWords);
  repro_torch::pack_rows_ballot_kernel<<<grid, repro_torch::kPackThreads, 0,
                                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<unsigned*>(out), KW, N, sn);
  return static_cast<int>(cudaGetLastError());
}
