// Packed-weight GEMM: packed W [M, KW] (32 sign bits a word, LSB-first along
// K) times a real input X [KW*32, N] of float32 or bfloat16, read through its
// strides (sk, sn) in elements -> float32 [M, N], accumulated in float32.
//
// Replaces the Pallas kernel `unpack_gemm` (src/repro/kernels/unpack_gemm.py,
// pallas_call at :74). Plain twin: repro_torch.core.bitops.packed_matmul_unpack
// (wp, x, compute_dtype=x.dtype).
//
// Bound on the H100: 2*M*N*K flops against M*KW*4 + K*N*es + M*N*4 bytes.
// The ±1 weights are exact in bf16, so the card's floor is the bf16
// tensor-core rate (989 TFLOP/s); at the Table 2 shapes X's float32 bytes
// bound every conv layer (conv1 at batch 64: 0.100 ms), the packed weights
// bound the small-N products (fc0, decode).
//
// Design. A block of 8 warps owns a 128 x 64 output tile (4 x 2 warps of
// 32 x 32; two blocks per SM, so one block's conversion overlaps the other's
// products) and walks K in tiles of 64 (two weight words). Each K tile's X
// slab [64, 64] and weight words [128, 2] arrive by cp.async into a ring of
// two stages, so the copies of the next two tiles are in flight during a
// tile's math: 16-byte copies along X's unit-stride axis (K for the
// transposed activations of the PACKED layers, N for a contiguous X), or,
// where strides or alignment allow no 16-byte copy, 4-byte copies of
// single float32 elements (bf16 then loads synchronously). The
// block then converts the slab once into bf16 operand tiles in shared
// memory, [n][k] (the K-major B operand of mma.sync m16n8k16), and unpacks
// the words straight to bf16 ±1 (0x3F80 for a set bit, 0xBF80 for a clear
// one: exact). Warps load both operands with ldmatrix (each fragment once
// a tile) and multiply on the tensor cores with float32 accumulation.
// Shared memory: 79 KB a block (float32 X), 54 KB (bf16).
//
// Float32 X is split by truncation into three bf16 pieces, hi = x with its
// low 16 bits cleared, mid = (x - hi) truncated the same way, lo = x - hi
// - mid, so x == hi + mid + lo exactly for every finite x with |x| >= 2^-110
// (below, the pieces lose less than 2^-126). Rounding hi to nearest instead
// would send |x| above bf16's largest value to inf. Each piece goes through
// its own bf16 product against the same ±1 weights; every product is exact,
// so the only rounding is the float32 accumulation. Where every mid and lo
// of a K tile is 0 (X already bf16-exact, as the binarized ±1/0 activations
// of every binary layer), the block skips their two products: adding exact
// zeros changes nothing. NaN and inf keep hi (a NaN as bf16's quiet NaN)
// with mid = lo = 0. Bf16 X is its own single piece.
//
// Numbers: each K tile's product is a fresh float32 partial on the tensor
// cores, added to the register total with Kahan compensation (__fadd_rn /
// __fsub_rn, so nothing is reassociated or contracted). With ±1 or 0
// activations every partial is an integer below 2^24, so the result is
// exact and equals the xnor engine's dot. With real input in [-1, 1] it
// stays within about 6e-5 of the exact dot at K = 8192 (the tensor cores'
// float32 sums inside a tile; measured on an H100, PERF.md).
//
// Split-K: where the output tiles cannot fill the card (fewer than two
// per SM: fc0, fc1 and the head at batch 64, decode with N <= 8),
// blockIdx.y splits the K tiles into `splits` contiguous ranges; each
// writes its total to a float32 scratch [splits, M, N] (allocated by the
// caller), and a second kernel adds the splits in order with Kahan
// compensation. No atomics: two calls give bit-equal results on any
// input. Rows past M load zero words and are not stored; columns past N
// are not copied (their operand columns hold stale values, which reach
// only outputs that are not stored); K past KW*32 loads zeros.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "mma.cuh"

namespace repro_torch {

constexpr int kUgBM = 128, kUgBN = 64, kUgBK = 64;
constexpr int kUgWords = kUgBK / 32;          // weight words per row and K tile
constexpr int kUgThreads = 256;               // 8 warps: 4 along M x 2 along N
constexpr int kUgStages = 2;
constexpr int kUgPitch = kUgBK + 8;           // bf16 per operand-tile row (144 B)

// How X is copied into a stage: 16 bytes at a time along K (unit stride
// along K), along N (unit stride along N), or element by element.
enum UgMode : int { kAlongK = 0, kAlongN = 1, kElements = 2 };

template <typename T>
struct UgSmem {
  static constexpr int kPieces = sizeof(T) == 4 ? 3 : 1;
  static constexpr size_t kRaw = size_t(kUgBN) * kUgBK * sizeof(T);
  static constexpr size_t kWordsBytes = size_t(kUgBM) * kUgWords * 4;
  static constexpr size_t kW = size_t(kUgBM) * kUgPitch * 2;
  static constexpr size_t kPiece = size_t(kUgBN) * kUgPitch * 2;
  static constexpr size_t kBytes =
      kUgStages * (kRaw + kWordsBytes) + kW + kPieces * kPiece;
};

// Issue the copies of K tile `kt` (weights and X) into one stage. The raw
// X stage is [k][n] along N, else [n][k].
template <typename T, int MODE>
__device__ __forceinline__ void ug_load_stage(
    T* raw, unsigned* words, const unsigned* __restrict__ W,
    const T* __restrict__ X, int m0, int n0, int kt, int M, int KW, int N,
    long long sk, long long sn) {
  const int tid = threadIdx.x;
  const int kw0 = kt * kUgWords;
  static_assert(kUgBM * kUgWords == kUgThreads, "one weight word a thread");
  {
    const int r = tid / kUgWords, w = tid % kUgWords;
    const bool ok = m0 + r < M && kw0 + w < KW;
    cp_async4(words + tid, ok ? W + static_cast<long long>(m0 + r) * KW + kw0 + w : W, ok);
  }
  const int K = KW * 32, k0 = kt * kUgBK;
  constexpr int kVec = 16 / sizeof(T);
  if constexpr (MODE == kAlongK) {
    constexpr int kPerRow = kUgBK / kVec;
#pragma unroll
    for (int j = 0; j < kUgBN * kPerRow / kUgThreads; ++j) {
      const int c = tid + j * kUgThreads;
      const int n = c / kPerRow, k = (c % kPerRow) * kVec;
      if (n0 + n >= N) continue;                  // never read
      const bool ok = k0 + k < K;                 // K is a multiple of 32
      cp_async16(raw + n * kUgBK + k,
                 ok ? X + static_cast<long long>(k0 + k) + (n0 + n) * sn : X,
                 ok ? 16 : 0);
    }
  } else if constexpr (MODE == kAlongN) {
    constexpr int kPerRow = kUgBN / kVec;
#pragma unroll
    for (int j = 0; j < kUgBK * kPerRow / kUgThreads; ++j) {
      const int c = tid + j * kUgThreads;
      const int k = c / kPerRow, n = (c % kPerRow) * kVec;
      if (n0 + n >= N) continue;                  // never read
      const int valid = k0 + k < K ? min(kVec, N - (n0 + n)) : 0;
      cp_async16(raw + k * kUgBN + n,
                 valid ? X + (k0 + k) * sk + static_cast<long long>(n0 + n) : X,
                 valid * static_cast<int>(sizeof(T)));
    }
  } else {
#pragma unroll 4
    for (int e = tid; e < kUgBN * kUgBK; e += kUgThreads) {
      const int n = e / kUgBK, k = e % kUgBK;
      if (n0 + n >= N) continue;                  // never read
      const bool ok = k0 + k < K;
      const T* src = ok ? X + (k0 + k) * sk + (n0 + n) * sn : X;
      if constexpr (sizeof(T) == 4) {
        cp_async4(raw + e, src, ok);
      } else {
        raw[e] = ok ? *src : __float2bfloat16(0.f);
      }
    }
  }
}

// The pair (n, k..k+1) number p of a stage: its first element; the second
// is the next along K (+1, or +kUgBN in a [k][n] stage).
template <int MODE, typename T>
__device__ __forceinline__ const T* ug_pair(const T* rs, int p, int& n, int& k) {
  if constexpr (MODE == kAlongN) {   // neighbouring threads on neighbouring n
    n = p % kUgBN;
    k = 2 * (p / kUgBN);
    return rs + k * kUgBN + n;
  } else {
    n = p / (kUgBK / 2);
    k = 2 * (p % (kUgBK / 2));
    return rs + n * kUgBK + k;
  }
}

// x -> (hi, mid, lo) bf16 bit patterns, hi + mid + lo == x (see the header).
__device__ __forceinline__ void split3(float x, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const uint32_t b = __float_as_uint(x);
  uint32_t hb = b & 0xFFFF0000u;
  const float r = __fsub_rn(x, __uint_as_float(hb));
  uint32_t mb = __float_as_uint(r) & 0xFFFF0000u;
  uint32_t lb = __float_as_uint(__fsub_rn(r, __uint_as_float(mb)));
  if ((b & 0x7F800000u) == 0x7F800000u) {     // inf or NaN
    if (b & 0x007FFFFFu) hb = 0x7FC00000u;
    mb = lb = 0u;
  }
  hi = hb >> 16;
  mid = mb >> 16;
  lo = lb >> 16;
}

template <typename T, int MODE>
__global__ void __launch_bounds__(kUgThreads, 2)
unpack_gemm_kernel(const unsigned* __restrict__ W, const T* __restrict__ X,
                   float* __restrict__ out, int M, int KW, int N, long long sk,
                   long long sn, int splits) {
  using Smem = UgSmem<T>;
  extern __shared__ __align__(128) unsigned char ug_smem[];
  T* raw = reinterpret_cast<T*>(ug_smem);                                  // [stage]
  unsigned* words = reinterpret_cast<unsigned*>(ug_smem + kUgStages * Smem::kRaw);
  __nv_bfloat16* wtile = reinterpret_cast<__nv_bfloat16*>(
      ug_smem + kUgStages * (Smem::kRaw + Smem::kWordsBytes));             // [m][k]
  __nv_bfloat16* piece = wtile + kUgBM * kUgPitch;                         // [p][n][k]
  constexpr int kRawElems = kUgBN * kUgBK;
  constexpr int kWordElems = kUgBM * kUgWords;
  constexpr int kPairs = kUgBN * kUgBK / 2;
  constexpr int kP = kUgBN * kUgPitch / 2;   // one piece, in uint32
  constexpr int kNextK = MODE == kAlongN ? kUgBN : 1;   // a pair's second element

  const int m_tiles = (M + kUgBM - 1) / kUgBM;
  const int m0 = (blockIdx.x % m_tiles) * kUgBM;   // neighbours share X's tile
  const int n0 = (blockIdx.x / m_tiles) * kUgBN;
  const int k_tiles = (KW + kUgWords - 1) / kUgWords;
  const int split = blockIdx.y;
  const int kt_begin = static_cast<int>(static_cast<long long>(split) * k_tiles / splits);
  const int kt_end = static_cast<int>(static_cast<long long>(split + 1) * k_tiles / splits);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp & 3, wn = warp >> 2;   // 32 x 32 outputs per warp
  const int g = lane >> 2, t = lane & 3;
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_col = ((lane >> 3) & 1) * 8;

  // The warp's 16-column slices that reach a column below N; a warp with
  // none, or with no row below M, skips the products (outputs past M or N
  // are never stored).
  const bool rows_live = m0 + wm * 32 < M;
  const int n_live = max(0, min(2, (N - n0 - wn * 32 + 15) / 16));
  float acc[2][4][4], comp[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][j][i] = comp[mt][j][i] = 0.f;

  for (int s = 0; s < kUgStages; ++s) {
    if (kt_begin + s < kt_end) {
      ug_load_stage<T, MODE>(raw + s * kRawElems, words + s * kWordElems, W, X,
                             m0, n0, kt_begin + s, M, KW, N, sk, sn);
    }
    cp_async_commit();
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int stage = (kt - kt_begin) % kUgStages;
    const T* rs = raw + stage * kRawElems;
    const unsigned* ws = words + stage * kWordElems;
    cp_async_wait<kUgStages - 1>();   // this tile landed; the next in flight
    __syncthreads();                  // ... for every thread; last tile's math done

    // Weights: job (row r, word w, half h) unpacks 16 bits to bf16 ±1.
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int job = tid + j * kUgThreads;
      const int r = job >> 2, w = (job >> 1) & 1, h = job & 1;
      // A clear bit sets the sign of 0x3F80 (+1.0): bit 2b of the half
      // goes to bit 15 of v[b], bit 2b + 1 to bit 31.
      const unsigned clear = ~ws[r * kUgWords + w] >> (16 * h);
      uint32_t v[8];
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        v[b] = 0x3F803F80u | ((clear << (15 - 2 * b)) & 0x8000u) |
               ((clear << (30 - 2 * b)) & 0x80000000u);
      }
      uint4* dst = reinterpret_cast<uint4*>(wtile + r * kUgPitch + w * 32 + h * 16);
      dst[0] = make_uint4(v[0], v[1], v[2], v[3]);
      dst[1] = make_uint4(v[4], v[5], v[6], v[7]);
    }
    // X: pairs (n, k..k+1) of the slab to bf16 pieces [p][n][k]. First hi
    // (the float32 word with its low half cleared) or the bf16 pair itself;
    // where any float32 value of the tile has low bits (a nonzero mid or
    // lo, or a NaN), all three pieces again from split3.
    unsigned low = 0u;
#pragma unroll 4
    for (int j = 0; j < kPairs / kUgThreads; ++j) {
      int n, k;
      const T* x = ug_pair<MODE>(rs, tid + j * kUgThreads, n, k);
      uint32_t* dst = reinterpret_cast<uint32_t*>(piece + n * kUgPitch + k);
      if constexpr (sizeof(T) == 4) {
        const uint32_t b0 = __float_as_uint(x[0]);
        const uint32_t b1 = __float_as_uint(x[kNextK]);
        dst[0] = __byte_perm(b0, b1, 0x7632);   // high halves: b0's low, b1's high
        low |= (b0 | b1) & 0xFFFFu;
      } else {
        dst[0] = static_cast<uint32_t>(__bfloat16_as_ushort(x[0])) |
                 (static_cast<uint32_t>(__bfloat16_as_ushort(x[kNextK])) << 16);
      }
    }
    int pieces = 1;
    if constexpr (sizeof(T) == 4) {
      if (__syncthreads_or(low != 0u)) {
        pieces = 3;
        for (int j = 0; j < kPairs / kUgThreads; ++j) {
          int n, k;
          const T* x = ug_pair<MODE>(rs, tid + j * kUgThreads, n, k);
          uint32_t* dst = reinterpret_cast<uint32_t*>(piece + n * kUgPitch + k);
          uint32_t h0, m0b, l0, h1, m1b, l1;
          split3(x[0], h0, m0b, l0);
          split3(x[kNextK], h1, m1b, l1);
          dst[0] = h0 | (h1 << 16);
          dst[kP] = m0b | (m1b << 16);
          dst[2 * kP] = l0 | (l1 << 16);
        }
        __syncthreads();
      }
    } else {
      __syncthreads();
    }
    // Stage `stage` is consumed: refill it with tile kt + 2.
    if (kt + kUgStages < kt_end) {
      ug_load_stage<T, MODE>(raw + stage * kRawElems, words + stage * kWordElems,
                             W, X, m0, n0, kt + kUgStages, M, KW, N, sk, sn);
    }
    cp_async_commit();

    // A fresh float32 partial over the tile on the tensor cores (each A
    // and B fragment loaded once), then added to the total with Kahan
    // compensation.
    if (rows_live && n_live > 0) {
      float part[2][4][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) part[mt][j][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kUgBK / 16; ++kk) {
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          ldmatrix_x4(a[mt], wtile + (wm * 32 + mt * 16 + a_row) * kUgPitch + kk * 16 + a_col);
        }
#pragma unroll
        for (int pc = 0; pc < Smem::kPieces; ++pc) {
          if (pc >= pieces) break;
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            if (np >= n_live) break;
            uint32_t b[4];
            ldmatrix_x4(b, piece + pc * kUgBN * kUgPitch +
                               (wn * 32 + np * 16 + b_row) * kUgPitch + kk * 16 + b_col);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              mma_bf16(part[mt][2 * np], a[mt], b[0], b[1]);
              mma_bf16(part[mt][2 * np + 1], a[mt], b[2], b[3]);
            }
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float y = __fsub_rn(part[mt][j][i], comp[mt][j][i]);
            const float sum = __fadd_rn(acc[mt][j][i], y);
            comp[mt][j][i] = __fsub_rn(__fsub_rn(sum, acc[mt][j][i]), y);
            acc[mt][j][i] = sum;
          }
    }
  }
  cp_async_wait<0>();

  float* dst = splits > 1 ? out + static_cast<long long>(split) * M * N : out;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = m0 + wm * 32 + mt * 16 + g + (i >> 1) * 8;
        const int n = n0 + wn * 32 + j * 8 + 2 * t + (i & 1);
        if (m < M && n < N) dst[static_cast<long long>(m) * N + n] = acc[mt][j][i];
      }
    }
  }
}

// out[i] = the splits' totals added in order, with Kahan compensation.
__global__ void __launch_bounds__(256)
unpack_gemm_reduce(const float* __restrict__ parts, float* __restrict__ out,
                   long long mn, int splits) {
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < mn;
       i += static_cast<long long>(gridDim.x) * 256) {
    float sum = 0.f, c = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float y = __fsub_rn(parts[s * mn + i], c);
      const float tot = __fadd_rn(sum, y);
      c = __fsub_rn(__fsub_rn(tot, sum), y);
      sum = tot;
    }
    out[i] = sum;
  }
}

template <typename T, int MODE>
cudaError_t launch_mode(const void* w, const void* x, float* dst, int M, int KW,
                        int N, long long sk, long long sn, int splits,
                        cudaStream_t stream) {
  const size_t smem = UgSmem<T>::kBytes;
  auto kernel = unpack_gemm_kernel<T, MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long tiles = static_cast<long long>((M + kUgBM - 1) / kUgBM) *
                          ((N + kUgBN - 1) / kUgBN);
  kernel<<<dim3(static_cast<unsigned>(tiles), splits), kUgThreads, smem, stream>>>(
      static_cast<const unsigned*>(w), static_cast<const T*>(x), dst, M, KW, N,
      sk, sn, splits);
  return cudaGetLastError();
}

template <typename T>
int launch_unpack_gemm(const void* w, const void* x, void* out, void* scratch,
                       int M, int KW, int N, long long sk, long long sn,
                       int splits, cudaStream_t stream) {
  constexpr long long es = sizeof(T);
  const bool aligned = reinterpret_cast<unsigned long long>(x) % 16 == 0;
  float* dst = static_cast<float*>(splits > 1 ? scratch : out);
  cudaError_t err;
  if (sk == 1 && aligned && (sn * es) % 16 == 0) {
    err = launch_mode<T, kAlongK>(w, x, dst, M, KW, N, sk, sn, splits, stream);
  } else if (sn == 1 && aligned && (sk * es) % 16 == 0) {
    err = launch_mode<T, kAlongN>(w, x, dst, M, KW, N, sk, sn, splits, stream);
  } else {
    err = launch_mode<T, kElements>(w, x, dst, M, KW, N, sk, sn, splits, stream);
  }
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long mn = static_cast<long long>(M) * N;
  const int blocks = static_cast<int>(std::min<long long>((mn + 255) / 256, 4096));
  unpack_gemm_reduce<<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(scratch), static_cast<float*>(out), mn, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

// K splits of an [M, KW] x [KW*32, N] product on the current device: 1 when
// its 128 x 64 output tiles fill the SMs (two blocks each), else as many as
// fit in one wave (at most one per K tile of 64). The caller allocates a
// float32 scratch of [splits, M, N] when it is above 1.
extern "C" int repro_unpack_gemm_splits(int M, int KW, int N) {
  using namespace repro_torch;
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const long long tiles = static_cast<long long>((M + kUgBM - 1) / kUgBM) *
                          ((N + kUgBN - 1) / kUgBN);
  const int k_tiles = (KW + kUgWords - 1) / kUgWords;
  const long long slots = 2LL * sms;
  if (tiles >= slots) return 1;
  return static_cast<int>(std::max<long long>(
      1, std::min<long long>(k_tiles, slots / tiles)));
}

// x_is_bf16: 0 for float32 input, 1 for bfloat16. scratch: float32
// [splits, M, N] when splits > 1 (else unused).
extern "C" int repro_unpack_gemm(const void* w, const void* x, void* out,
                                 void* scratch, int M, int KW, int N,
                                 long long sk, long long sn, int x_is_bf16,
                                 int splits, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (splits < 1 || (splits > 1 && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (x_is_bf16) {
    return repro_torch::launch_unpack_gemm<__nv_bfloat16>(w, x, out, scratch, M, KW,
                                                          N, sk, sn, splits, s);
  }
  return repro_torch::launch_unpack_gemm<float>(w, x, out, scratch, M, KW, N, sk,
                                                sn, splits, s);
}
