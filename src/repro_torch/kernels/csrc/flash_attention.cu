// Causal (or full) attention by online softmax over KV tiles:
//   s = (q . k in float32) * scale, masked with -1e30 (causal: key position
//   <= query position; always: key position < Skv); per tile
//   m' = max(m, max s), p = exp(s - m'), l = l * exp(m - m') + sum p,
//   acc = acc * exp(m - m') + (p rounded to v's dtype) . v in float32;
//   out = acc / max(l, 1e-30) in q's dtype,
// for q [BH, Sq, Dh], k, v [BH, Skv, Dh] (contiguous, bf16 or float32, Dh in
// {16, 32, 64, 128}) -> out [BH, Sq, Dh].
//
// Replaces the Pallas kernel `flash_attention`
// (src/repro/kernels/flash_attention.py, pallas_call at :102). Plain twin:
// repro_torch.kernels.ref.flash_attention_ref with block_kv = kFlashKeys,
// which rounds where this kernel rounds.
//
// Bound on the H100 at the smollm-360m training shape (BH 60, S 4096, Dh
// 64, bf16, causal): operations. QK^T and PV over the lower triangle are
// 2 * BH * S^2 * Dh = 129 GFLOP = 0.130 ms at 989 TFLOP/s (bf16 tensor
// cores); Q, K, V and O are 126 MB = 0.038 ms at 3.35 TB/s. The exps
// (BH * S^2 / 2 = 503 M) take 0.12 ms on the MUFU units.
//
// Design. On the TPU one grid step holds a [512, Dh] query tile and a
// [512, Dh] KV tile in VMEM and carries (acc, m, l) in scratch across the
// sequential KV grid axis. Here one block of 4 warps owns 64 query rows of
// one (batch, head), 16 rows per warp, and loops over 64-key tiles itself,
// so (acc, m, l) stay in registers: each lane holds half of one row's
// accumulator (Dh/2 floats), its m and l. K and V tiles are staged in
// shared memory by the whole block; in bf16 the two products run on the
// tensor cores (WMMA m16n16k16, float32 accumulation) through per-warp
// shared-memory tiles of scores, p and the PV product; in float32 on the
// CUDA cores (a sequential fma chain per dot). As in the reference, the
// PV product of a tile is a fresh float32 sum added to acc * exp(m - m'),
// and p is rounded to v's dtype before it, while l sums the float32 p.
// Causal tiles wholly above a block's last row are skipped: there the
// reference's update is exact identity (p = 0, exp(m - m') = 1). Blocks
// are ordered heaviest first (the last query tiles see the most keys).
// Ragged Sq and Skv are masked in the kernel: rows past Sq are not
// written, keys past Skv are masked like causal ones (and zero-filled).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

namespace repro_torch {

constexpr int kFlashRows = 64;  // query rows per block
constexpr int kFlashKeys = 64;  // keys per KV tile
constexpr int kFlashWarps = 4;  // 16 query rows each
constexpr int kFlashThreads = 32 * kFlashWarps;
constexpr float kFlashNeg = -1e30f;

// Shared memory of one block, in elements: Q, K, V tiles [64][DH + 8] of T;
// per warp scores [16][64 + 4] float, p [16][64 + 8] of T and the PV
// product [16][DH + 4] float. Every leading dimension keeps rows 16-byte
// aligned (WMMA) and breaks the 128-byte stride of an unpadded row.
template <typename T, int DH>
struct FlashSmem {
  static constexpr int kLd = DH + 8;
  static constexpr int kSLd = kFlashKeys + 4;
  static constexpr int kPLd = kFlashKeys + 8;
  static constexpr int kOLd = DH + 4;
  static constexpr size_t kTile = size_t(kFlashRows) * kLd * sizeof(T);
  static constexpr size_t kS = size_t(16) * kSLd * sizeof(float);
  static constexpr size_t kP = size_t(16) * kPLd * sizeof(T);
  static constexpr size_t kO = size_t(16) * kOLd * sizeof(float);
  static constexpr size_t kBytes = 3 * kTile + kFlashWarps * (kS + kP + kO);
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

// rows [row0, row0 + 64) of a [rows, DH] matrix into a [64][kLd] tile, 16
// bytes per thread and load; rows past `rows` are zero.
template <typename T, int DH>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0,
                                          int rows) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = DH / kVec;
  constexpr int kLd = FlashSmem<T, DH>::kLd;
  for (int i = threadIdx.x; i < kFlashRows * kPerRow; i += kFlashThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows) {
      val = *reinterpret_cast<const uint4*>(
          src + static_cast<long long>(row0 + r) * DH + c);
    }
    *reinterpret_cast<uint4*>(dst + r * kLd + c) = val;
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kFlashThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int Sq, int Skv,
             int causal, float scale) {
  using Smem = FlashSmem<T, DH>;
  constexpr int kLd = Smem::kLd, kSLd = Smem::kSLd, kPLd = Smem::kPLd,
                kOLd = Smem::kOLd;
  constexpr int kHalf = DH / 2;
  extern __shared__ __align__(128) unsigned char flash_smem[];
  T* sQ = reinterpret_cast<T*>(flash_smem);
  T* sK = reinterpret_cast<T*>(flash_smem + Smem::kTile);
  T* sV = reinterpret_cast<T*>(flash_smem + 2 * Smem::kTile);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  unsigned char* wbase = flash_smem + 3 * Smem::kTile +
                         warp * (Smem::kS + Smem::kP + Smem::kO);
  float* sS = reinterpret_cast<float*>(wbase);
  T* sP = reinterpret_cast<T*>(wbase + Smem::kS);
  float* sO = reinterpret_cast<float*>(wbase + Smem::kS + Smem::kP);

  const int bh = blockIdx.x;
  const int q_tiles = (Sq + kFlashRows - 1) / kFlashRows;
  const int q0 = (q_tiles - 1 - blockIdx.y) * kFlashRows;  // heaviest first
  const T* qb = q + static_cast<long long>(bh) * Sq * DH;
  const T* kb = k + static_cast<long long>(bh) * Skv * DH;
  const T* vb = v + static_cast<long long>(bh) * Skv * DH;

  // lane -> (row r of the warp's 16, half h of the keys / of Dh)
  const int r = lane >> 1, h = lane & 1;
  const int qpos = q0 + warp * 16 + r;
  float acc[kHalf];
#pragma unroll
  for (int c = 0; c < kHalf; ++c) acc[c] = 0.f;
  float m_run = kFlashNeg, l_run = 0.f;

  load_tile<T, DH>(sQ, qb, q0, Sq);
  int k_end = Skv;
  if (causal) k_end = min(Skv, q0 + kFlashRows);  // keys <= the last row
  const int n_tiles = (k_end + kFlashKeys - 1) / kFlashKeys;

  using namespace nvcuda;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kFlashKeys;
    __syncthreads();  // every warp is done with the previous K, V tiles
    load_tile<T, DH>(sK, kb, k0, Skv);
    load_tile<T, DH>(sV, vb, k0, Skv);
    __syncthreads();

    // scores of the warp's 16 rows against the tile's 64 keys -> sS
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> fc;
#pragma unroll
      for (int nt = 0; nt < kFlashKeys / 16; ++nt) {
        wmma::fill_fragment(fc, 0.f);
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
          wmma::load_matrix_sync(fa, sQ + warp * 16 * kLd + kk * 16, kLd);
          wmma::load_matrix_sync(fb, sK + nt * 16 * kLd + kk * 16, kLd);
          wmma::mma_sync(fc, fa, fb, fc);
        }
        wmma::store_matrix_sync(sS + nt * 16, fc, kSLd, wmma::mem_row_major);
      }
    } else {
      const float* qrow = sQ + (warp * 16 + r) * kLd;
      for (int c = 0; c < kFlashKeys / 2; ++c) {
        const float* krow = sK + (h * (kFlashKeys / 2) + c) * kLd;
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < DH; ++d) dot = fmaf(qrow[d], krow[d], dot);
        sS[r * kSLd + h * (kFlashKeys / 2) + c] = dot;
      }
    }
    __syncwarp();

    // online softmax: lanes 2r, 2r+1 hold the two halves of row r's keys
    float sv[kFlashKeys / 2];
    float mx = kFlashNeg;
#pragma unroll
    for (int c = 0; c < kFlashKeys / 2; ++c) {
      const int kpos = k0 + h * (kFlashKeys / 2) + c;
      float x = __fmul_rn(sS[r * kSLd + h * (kFlashKeys / 2) + c], scale);
      const bool keep = kpos < Skv && (!causal || kpos <= qpos);
      x = keep ? x : kFlashNeg;
      sv[c] = x;
      mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_run, mx);
    const float corr = expf(__fsub_rn(m_run, m_new));
    float psum = 0.f;
#pragma unroll
    for (int c = 0; c < kFlashKeys / 2; ++c) {
      const float p = expf(__fsub_rn(sv[c], m_new));
      psum = __fadd_rn(psum, p);
      sP[r * kPLd + h * (kFlashKeys / 2) + c] = from_float<T>(p);
    }
    psum = __fadd_rn(psum, __shfl_xor_sync(0xffffffffu, psum, 1));
    l_run = __fadd_rn(__fmul_rn(l_run, corr), psum);
    m_run = m_new;
    __syncwarp();

    // PV of the tile (a fresh float32 sum) -> sO
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> fc;
#pragma unroll
      for (int nt = 0; nt < DH / 16; ++nt) {
        wmma::fill_fragment(fc, 0.f);
#pragma unroll
        for (int kk = 0; kk < kFlashKeys / 16; ++kk) {
          wmma::load_matrix_sync(fa, sP + kk * 16, kPLd);
          wmma::load_matrix_sync(fb, sV + kk * 16 * kLd + nt * 16, kLd);
          wmma::mma_sync(fc, fa, fb, fc);
        }
        wmma::store_matrix_sync(sO + nt * 16, fc, kOLd, wmma::mem_row_major);
      }
    } else {
      for (int c = 0; c < kHalf; ++c) {
        const float* vcol = sV + h * kHalf + c;
        float dot = 0.f;
#pragma unroll 8
        for (int j = 0; j < kFlashKeys; ++j) {
          dot = fmaf(to_float(sP[r * kPLd + j]), to_float(vcol[j * kLd]), dot);
        }
        sO[r * kOLd + h * kHalf + c] = dot;
      }
    }
    __syncwarp();
#pragma unroll
    for (int c = 0; c < kHalf; ++c) {
      acc[c] = __fadd_rn(__fmul_rn(acc[c], corr), sO[r * kOLd + h * kHalf + c]);
    }
  }

  if (qpos < Sq) {
    const float den = fmaxf(l_run, 1e-30f);
    T* orow = out + (static_cast<long long>(bh) * Sq + qpos) * DH + h * kHalf;
#pragma unroll
    for (int c = 0; c < kHalf; ++c) orow[c] = from_float<T>(acc[c] / den);
  }
}

template <typename T, int DH>
cudaError_t launch_flash(const void* q, const void* k, const void* v, void* o,
                         int BH, int Sq, int Skv, int causal, float scale,
                         cudaStream_t stream) {
  const size_t smem = FlashSmem<T, DH>::kBytes;
  auto kernel = flash_kernel<T, DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (Sq + kFlashRows - 1) / kFlashRows);
  kernel<<<grid, kFlashThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_flash(const void* q, const void* k, const void* v,
                           void* o, int BH, int Sq, int Skv, int dh,
                           int causal, float scale, cudaStream_t s) {
  switch (dh) {
    case 16: return launch_flash<T, 16>(q, k, v, o, BH, Sq, Skv, causal, scale, s);
    case 32: return launch_flash<T, 32>(q, k, v, o, BH, Sq, Skv, causal, scale, s);
    case 64: return launch_flash<T, 64>(q, k, v, o, BH, Sq, Skv, causal, scale, s);
    case 128: return launch_flash<T, 128>(q, k, v, o, BH, Sq, Skv, causal, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace repro_torch

// q [BH, Sq, Dh], k, v [BH, Skv, Dh], out [BH, Sq, Dh], contiguous, 16-byte
// aligned; is_bf16 selects bfloat16 (else float32); Dh in {16, 32, 64, 128}.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int BH, int Sq,
                                     int Skv, int dh, int causal, int is_bf16,
                                     float scale, void* stream) {
  using namespace repro_torch;
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dispatch_flash<__nv_bfloat16>(q, k, v, out, BH, Sq, Skv, dh,
                                              causal, scale, s)
              : dispatch_flash<float>(q, k, v, out, BH, Sq, Skv, dh, causal,
                                      scale, s);
  return static_cast<int>(err);
}
