// The packed ±1 product on the tensor cores: 1-bit mma.sync m16n8k256 with
// and.popc, for the xnor kernels of this directory (fused_gemm.cu and the
// two direct convs of direct_conv.cu; megakernel_conv_stage.cu runs the
// same mma on operands resident in shared memory).
//
// On the H100 the 1-bit mma.sync with and.popc issues at the rate of the
// int8 one (same instructions a second) with 8x the bits each: 5,146 T
// bit products/s against 648 T for int8 m16n8k32, 770 T for the 1-bit
// mma with xor.popc and 126 T for the popc loop (NVIDIA H100 80GB HBM3,
// 700 W, `chip_smoke.py`'s inner-loop rates). So the tile counts
// popc(w & x) and recovers the xnor count per output from the row and
// column popcounts:
//   sum_words popc(~(w ^ x)) = 32 KW - P(w) - P(x) + 2 sum_words popc(w & x),
// bit by bit 1 - w - x + 2wx, so it holds for any words, pads included
// (reference: repro_torch.kernels.ref.xnor_dot_and_popc). Words past
// the operand's K load as 0 and add nothing to any term.
//
// The tile: W [M, KW] row-major packed words against an X operand [KW, N]
// that a loader brings in slab by slab (TcGemmX: a row-major matrix; the
// direct conv's loader gathers the implicit patch matrix from the map),
// one block of 8 warps a kTcBM x BN output tile (BN 128, 64 or 32:
// tile_n), 32-word K slabs through a 2-stage cp.async ring. W lands as
// rows of kTcLdw words (36: ldmatrix's 16-byte rows of 8 neighbours hit
// distinct banks) and ldmatrix.x4 gives the A fragment directly; X lands
// as [k][n] (stride BN + 8 = 8 mod 32), so each lane's B words (k = t,
// n = g) are one conflict-free 32-bit load. The row popcounts come from
// the A fragments of the warps at the first N position, the column
// popcounts from the B fragments of the warps at the first M position.
// The counts are staged through shared memory as dots[n][m], so a warp
// can then take one column and 32 consecutive rows, one row a lane, and
// ballot the sign word (tc_sign_words); or, for an int32 epilogue that
// stores rows (xnor_gemm.cu), as dots[m][n] (pitch BN + 8: the fragments'
// 8-byte stores are conflict-free), so a warp reads a row's consecutive
// counts as 16-byte loads.
#pragma once

#include "mma.cuh"
#include "popcount.cuh"

namespace repro_torch {

constexpr int kTcBM = 128;     // rows of W a block
constexpr int kTcSlab = 32;    // K words a stage (4 mma k-steps of 8 words)
constexpr int kTcStages = 2;
constexpr int kTcLdw = kTcSlab + 4;
constexpr int kTcThreads = 256;
constexpr int kTcLdd = kTcBM + 4;  // staged counts dots[n][m]

template <int BN>
struct TcTile {
  static constexpr int kWn = BN / 32;             // warps along N
  static constexpr int kWm = 8 / kWn;             // warps along M
  static constexpr int kMt = kTcBM / kWm / 16;    // m16 tiles a warp
  static constexpr int kNt = 4;                   // n8 tiles a warp
  static constexpr int kLdx = BN + 8;
  static constexpr int kStageWords = kTcBM * kTcLdw + kTcSlab * kLdx;
  static constexpr int kRingWords = kTcStages * kStageWords;
  static constexpr int kDotWords = BN * kTcLdd;
  static constexpr int kRowLdd = BN + 8;          // staged counts dots[m][n]
  static constexpr int kRowDotWords = kTcBM * kRowLdd;
  static constexpr int kMaxDots = kDotWords > kRowDotWords ? kDotWords : kRowDotWords;
  static constexpr size_t kSmemBytes =
      sizeof(int) * (kRingWords > kMaxDots ? kRingWords : kMaxDots);
};

// c += popc(A & B) over 256 bits of K (A row-major 16 x 256, B 256 x 8).
__device__ __forceinline__ void mma_b1_and_popc(int (&c)[4], const uint32_t (&a)[4],
                                                uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One K slab [k0, k0 + 32) of W rows [m0, m0 + 128) into `ws`; words
// outside W or past k_end are 0. `vec`: whole 16-byte copies (KW a
// multiple of 4 and W 16-byte aligned), else one word a copy.
__device__ __forceinline__ void tc_load_w_slab(uint32_t* ws, const unsigned* __restrict__ W,
                                               int M, int KW, int m0, int k0, int k_end,
                                               bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
#pragma unroll
    for (int q = 0; q < kTcBM * kTcSlab / 4 / kTcThreads; ++q) {
      const int idx = tid + q * kTcThreads;
      const int r = idx >> 3, kk = (idx & 7) * 4;
      const bool ok = m0 + r < M && k0 + kk < k_end;
      cp_async16(ws + r * kTcLdw + kk,
                 ok ? W + static_cast<long long>(m0 + r) * KW + k0 + kk : W, ok ? 16 : 0);
    }
  } else {
    for (int idx = tid; idx < kTcBM * kTcSlab; idx += kTcThreads) {
      const int r = idx >> 5, kk = idx & 31;
      const bool ok = m0 + r < M && k0 + kk < k_end;
      cp_async4(ws + r * kTcLdw + kk,
                ok ? W + static_cast<long long>(m0 + r) * KW + k0 + kk : W, ok);
    }
  }
}

// The X slab loader of a row-major X [KW, N]: slab [k0, k0 + 32) of
// columns [n0, n0 + BN) into xs[k][n] (stride TcTile<BN>::kLdx); words
// outside X or past k_end are 0. `vec`: 16-byte copies (N a multiple of 4
// and X 16-byte aligned).
template <int BN>
struct TcGemmX {
  const unsigned* X;
  int N, n0;
  bool vec;
  __device__ __forceinline__ void operator()(uint32_t* xs, int k0, int k_end) const {
    constexpr int kLdx = TcTile<BN>::kLdx;
    const int tid = threadIdx.x;
    if (vec) {
      for (int idx = tid; idx < kTcSlab * BN / 4; idx += kTcThreads) {
        const int kk = idx / (BN / 4), cc = (idx % (BN / 4)) * 4;
        const bool ok = k0 + kk < k_end && n0 + cc < N;
        cp_async16(xs + kk * kLdx + cc,
                   ok ? X + static_cast<long long>(k0 + kk) * N + n0 + cc : X, ok ? 16 : 0);
      }
    } else {
      for (int idx = tid; idx < kTcSlab * BN; idx += kTcThreads) {
        const int kk = idx / BN, cc = idx % BN;
        const bool ok = k0 + kk < k_end && n0 + cc < N;
        cp_async4(xs + kk * kLdx + cc,
                  ok ? X + static_cast<long long>(k0 + kk) * N + n0 + cc : X, ok);
      }
    }
  }
};

// The xnor counts sum_{k in [k_begin, k_end)} popc(~(W[m][k] ^ X[k][n])) of
// the block's tile, staged into `ring` as dots[n * kTcLdd + m] (m, n
// local), or with kRowMajor as dots[m * TcTile<BN>::kRowLdd + n].
// `load_x(xs, k0, k_end)` brings X's slab [k0, k0 + 32) of the block's
// columns into xs[k][n] with cp.async or plain stores, words past k_end
// as 0. Ends with a barrier: the counts are readable by every thread.
template <int BN, bool kRowMajor = false, class XSlab>
__device__ __forceinline__ void tc_xnor_counts(uint32_t* ring, const unsigned* __restrict__ W,
                                               int M, int KW, int m0, int k_begin,
                                               int k_end, bool vec_w,
                                               const XSlab& load_x) {
  using T = TcTile<BN>;
  __shared__ int pw_s[kTcBM];
  __shared__ int px_s[BN];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / T::kWn, wn = warp % T::kWn;
  const int g = lane >> 2, t = lane & 3;
  const int row_w = wm * T::kMt * 16, col_w = wn * 32;
  int acc[T::kMt][T::kNt][4];
#pragma unroll
  for (int i = 0; i < T::kMt; ++i)
#pragma unroll
    for (int j = 0; j < T::kNt; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
  int pw[T::kMt][2] = {}, px[T::kNt] = {};
  const int slabs = (k_end - k_begin + kTcSlab - 1) / kTcSlab;
  // ldmatrix.x4: lanes 8i..8i+7 address matrix i = (rows +8 if i odd,
  // words +4 if i >= 2), so r[0..3] = a0..a3 of m16n8k256.
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_word = (lane >> 4) * 4;
#pragma unroll
  for (int s = 0; s < kTcStages - 1; ++s) {
    if (s < slabs) {
      uint32_t* st = ring + s * T::kStageWords;
      tc_load_w_slab(st, W, M, KW, m0, k_begin + s * kTcSlab, k_end, vec_w);
      load_x(st + kTcBM * kTcLdw, k_begin + s * kTcSlab, k_end);
    }
    cp_async_commit();
  }
  for (int s = 0; s < slabs; ++s) {
    cp_async_wait<kTcStages - 2>();
    __syncthreads();  // slab s has landed; slab s - 1's stage is free
    const int next = s + kTcStages - 1;
    if (next < slabs) {
      uint32_t* st = ring + (next % kTcStages) * T::kStageWords;
      tc_load_w_slab(st, W, M, KW, m0, k_begin + next * kTcSlab, k_end, vec_w);
      load_x(st + kTcBM * kTcLdw, k_begin + next * kTcSlab, k_end);
    }
    cp_async_commit();
    const uint32_t* ws = ring + (s % kTcStages) * T::kStageWords;
    const uint32_t* xs = ws + kTcBM * kTcLdw;
    const int words = min(kTcSlab, k_end - k_begin - s * kTcSlab);
#pragma unroll
    for (int kk = 0; kk < kTcSlab; kk += 8) {
      if (kk >= words) break;  // the rest of the slab is zeros
      uint32_t a[T::kMt][4];
#pragma unroll
      for (int i = 0; i < T::kMt; ++i) {
        ldmatrix_x4(a[i], ws + (row_w + i * 16 + a_row) * kTcLdw + kk + a_word);
        if (wn == 0) {
          pw[i][0] += __popc(a[i][0]) + __popc(a[i][2]);
          pw[i][1] += __popc(a[i][1]) + __popc(a[i][3]);
        }
      }
#pragma unroll
      for (int j = 0; j < T::kNt; ++j) {
        const uint32_t* xc = xs + col_w + j * 8 + g;
        const uint32_t b0 = xc[(kk + t) * T::kLdx];
        const uint32_t b1 = xc[(kk + 4 + t) * T::kLdx];
        if (wm == 0) px[j] += __popc(b0) + __popc(b1);
#pragma unroll
        for (int i = 0; i < T::kMt; ++i) mma_b1_and_popc(acc[i][j], a[i], b0, b1);
      }
    }
  }
  // Popcounts: the 4 lanes of a quad hold one row (column) over different
  // words; add them.
#pragma unroll
  for (int i = 0; i < T::kMt; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      pw[i][h] += __shfl_xor_sync(0xffffffffu, pw[i][h], 1);
      pw[i][h] += __shfl_xor_sync(0xffffffffu, pw[i][h], 2);
    }
#pragma unroll
  for (int j = 0; j < T::kNt; ++j) {
    px[j] += __shfl_xor_sync(0xffffffffu, px[j], 1);
    px[j] += __shfl_xor_sync(0xffffffffu, px[j], 2);
  }
  if (wn == 0 && t == 0) {
#pragma unroll
    for (int i = 0; i < T::kMt; ++i) {
      pw_s[row_w + i * 16 + g] = pw[i][0];
      pw_s[row_w + i * 16 + g + 8] = pw[i][1];
    }
  }
  if (wm == 0 && t == 0) {
#pragma unroll
    for (int j = 0; j < T::kNt; ++j) px_s[col_w + j * 8 + g] = px[j];
  }
  cp_async_wait<0>();
  __syncthreads();  // popcounts visible; the ring is free for the counts
  int* dots = reinterpret_cast<int*>(ring);
  const int bits = 32 * (k_end - k_begin);
#pragma unroll
  for (int i = 0; i < T::kMt; ++i)
#pragma unroll
    for (int j = 0; j < T::kNt; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = row_w + i * 16 + g + h * 8;
        const int n = col_w + j * 8 + 2 * t;
        const int c0 = bits - pw_s[m] - px_s[n] + 2 * acc[i][j][2 * h];
        const int c1 = bits - pw_s[m] - px_s[n + 1] + 2 * acc[i][j][2 * h + 1];
        if constexpr (kRowMajor) {
          *reinterpret_cast<int2*>(dots + m * T::kRowLdd + n) = make_int2(c0, c1);
        } else {
          dots[n * kTcLdd + m] = c0;
          dots[(n + 1) * kTcLdd + m] = c1;
        }
      }
  __syncthreads();
}

// The sign words of the staged counts' columns [c, c + 32), rows [r, r +
// 32) (local; one row a lane, `real` when the lane's row is below M):
// dot = 2 count - k_bits, y = (a dot) + b rounded twice (never an FMA),
// rows past M y = +1 (the a = 0, b = +1 pad rows of the JAX wrappers), and
// one __ballot_sync of y >= 0 is one word, the LSB-first word of
// `sign_repack_m`. Lane j returns column c + j's word.
__device__ __forceinline__ unsigned tc_sign_words(const int* dots, int r, int c, bool real,
                                                  float a, float b, int k_bits) {
  const int lane = threadIdx.x & 31;
  const int* col = dots + c * kTcLdd + r + lane;
  unsigned mine = 0;
#pragma unroll 4
  for (int j = 0; j < 32; ++j) {
    const float y = real ? bn_affine(a, 2 * col[j * kTcLdd] - k_bits, b) : 1.f;
    const unsigned word = sign_repack_warp(y);
    if (lane == j) mine = word;
  }
  return mine;
}

// Columns of a block's tile: 128, or 64 where 128-wide tiles would not
// give every SM one, or 32 for N <= 32.
inline int tile_n(int M, int N, int sms) {
  if (N <= 32) return 32;
  const long long tiles = static_cast<long long>((M + kTcBM - 1) / kTcBM) * ((N + 127) / 128);
  return tiles >= sms ? 128 : 64;
}

// K splits of an [M, KW] x [KW, N] tile GEMM: 1 when there are at least
// 33 output tiles or K is at most two slabs (a second launch would cost
// more than it saves), else enough to fill the SMs once, each split at
// least one 8-word mma step. tc_split_words gives each split's width.
inline int tc_split_words(int KW, int splits) {
  return splits > 1 ? ((KW + splits - 1) / splits + 7) & ~7 : KW;
}

inline int tc_k_splits(int M, int KW, int N, int sms) {
  const int bn = tile_n(M, N, sms);
  const long long tiles = static_cast<long long>((M + kTcBM - 1) / kTcBM) * ((N + bn - 1) / bn);
  if (tiles > 32 || KW <= 2 * kTcSlab) return 1;
  const int steps = (KW + 7) / 8;
  const long long want = (sms + tiles - 1) / tiles;
  const int splits = static_cast<int>(want < steps ? want : steps);
  if (splits <= 1) return 1;
  // the splits that the rounded split width really gives
  const int split_words = tc_split_words(KW, splits);
  return (KW + split_words - 1) / split_words;
}

// The K splits a caller may request: 1, or more where every split of
// the rounded width tc_split_words holds at least one word (no empty
// split) and the grid's z extent takes them.
inline bool tc_splits_ok(int KW, int splits) {
  if (splits == 1) return true;
  if (splits < 1 || splits > 65535 || KW < 1) return false;
  const int split_words = tc_split_words(KW, splits);
  return (KW + split_words - 1) / split_words == splits;
}

// A requested tile width: 0 takes tile_n's, 32, 64 and 128 are compiled
// (TcTile<BN>); anything else is -1, which the launchers refuse with
// cudaErrorInvalidValue.
inline int tc_resolve_tile_n(int requested, int M, int N, int sms) {
  if (requested == 0) return tile_n(M, N, sms);
  return requested == 32 || requested == 64 || requested == 128 ? requested : -1;
}

inline int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

}  // namespace repro_torch
