// Warpgroup-level tensor-core building blocks for Hopper (sm_90a), used by
// flash_attention_bwd.cu: wgmma.mma_async with bf16 operands and float32
// accumulation, its shared-memory operand descriptors and fences, and the
// swizzled layout the descriptors name.
//
// Layout of a bf16 tile of R rows of DH columns in shared memory: panels of
// W = min(DH, 64) columns, each [R][W] with rows of 2W bytes (32, 64 or 128),
// 16-byte chunks XOR-swizzled within every 2^(7 + B) bytes (B = 1, 2, 3:
// the SWIZZLE_32B / 64B / 128B modes): byte offset o -> o ^ (((o >> 7) &
// (2^B - 1)) << 4). Tiles start at 1024-byte boundaries. The same tile is
// read two ways:
//   - K-major (its columns are the product's contraction, e.g. Q as the B
//     operand of S^T = K Q^T): a k16 step is 32 bytes along the row (the
//     next panel every W / 16 steps); 8-row groups SBO = 8 rows apart.
//   - MN-major (its rows are the contraction, its columns the product's N,
//     e.g. dO as the B operand of dV = P^T dO; imm-trans-b = 1): a k16 step
//     is 16 rows; 8-row groups SBO apart, N panels LBO = R rows apart.
//
// Accumulator fragments (lane = 4g + t, warp w of the warpgroup): m64nNk16
// holds d[4j + e] = (row 16w + g + 8 (e >> 1), column 8j + 2t + (e & 1)),
// j < N / 8, as mma.sync's C per n-tile. Every operand here is read from
// shared memory: a product of p or dS takes them rounded to bf16 from a
// tile the threads store (store_acc_bf16), which holds no registers, so
// three blocks of the flash backward fit an SM.
#pragma once

#include <cstdint>

#include "mma.cuh"

namespace repro_torch {

template <int DH>
struct WgTile {
  static constexpr int kW = DH < 64 ? DH : 64;        // columns a panel
  static constexpr int kRowBytes = 2 * kW;            // 32, 64 or 128
  static constexpr int kSwizzle = kRowBytes / 16 - 1;  // 1, 3, 7
  static constexpr int kAtom = 8 * kRowBytes;         // 8 rows: SBO
  // descriptor layout type: 1 = 128-byte, 2 = 64-byte, 3 = 32-byte swizzle
  static constexpr uint64_t kMode = kRowBytes == 128 ? 1 : (kRowBytes == 64 ? 2 : 3);
  static constexpr int kSteps = DH / 16;              // k16 steps along DH
  static constexpr int kStepsPerPanel = kW / 16;
  static_assert(DH == 16 || DH == 32 || DH == 64 || DH == 128, "DH");

  static constexpr int bytes(int rows) { return rows * DH * 2; }

  // Byte offset of the 16-byte chunk c (8 columns) of row r in a tile of
  // `rows` rows.
  __device__ static __forceinline__ int chunk(int r, int c, int rows) {
    const int o = (c / (kW / 8)) * rows * kRowBytes + r * kRowBytes + (c % (kW / 8)) * 16;
    return o ^ (((o >> 7) & kSwizzle) << 4);
  }

  // Rows [row0, row0 + rows) of a [*, DH] bf16 matrix into the tile at
  // `dst` by cp.async (committed by the caller); rows at or past `end` are
  // zero. Threads tid, tid + nthr, ... of the block take a chunk each.
  __device__ static __forceinline__ void stage(unsigned char* dst,
                                               const __nv_bfloat16* src, int row0,
                                               int end, int rows, int tid, int nthr) {
    for (int i = tid; i < rows * (DH / 8); i += nthr) {
      const int r = i / (DH / 8), c = i % (DH / 8);
      const bool ok = row0 + r < end;
      cp_async16(dst + chunk(r, c, rows),
                 src + (ok ? static_cast<long long>(row0 + r) * DH + c * 8 : 0), ok ? 16 : 0);
    }
  }
};

// A tile of ROWS rows streamed again and again by NTHR threads. Thread i
// takes chunk column i % (DH / 8) of rows i / (DH / 8) + u R (R = NTHR /
// (DH / 8), a multiple of 8, so the swizzle is the same in each): its first
// shared-memory and global offsets are worked out once, the rest are
// constant strides, and a load is a bounds test and a cp.async a chunk.
template <int DH, int ROWS, int NTHR>
struct WgStream {
  static constexpr int kR = NTHR / (DH / 8);
  static constexpr int kPer = ROWS / kR;
  static_assert(kR % 8 == 0 && ROWS % kR == 0, "WgStream");
  int soff, goff, row;

  __device__ __forceinline__ explicit WgStream(int tid)
      : soff(WgTile<DH>::chunk(tid / (DH / 8), tid % (DH / 8), ROWS)),
        goff(tid / (DH / 8) * DH + tid % (DH / 8) * 8),
        row(tid / (DH / 8)) {}
  // rows [row0, row0 + ROWS) of src into dst; rows at or past `end` zero
  __device__ __forceinline__ void load(unsigned char* dst, const __nv_bfloat16* src, int row0,
                                       int end) const {
    const __nv_bfloat16* base = src + static_cast<long long>(row0) * DH + goff;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const bool ok = row0 + row + u * kR < end;
      cp_async16(dst + soff + u * kR * WgTile<DH>::kRowBytes, ok ? base + u * kR * DH : src,
                 ok ? 16 : 0);
    }
  }
};

__device__ __forceinline__ uint64_t wg_desc(const void* p, int lbo, int sbo,
                                            uint64_t mode) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (mode << 62);
}

// Descriptor of k16 step `kk` of a K-major tile of `rows` rows, from row r0.
template <int DH>
__device__ __forceinline__ uint64_t desc_kmajor(const unsigned char* tile, int rows,
                                                int r0, int kk) {
  using T = WgTile<DH>;
  const unsigned char* p = tile + (kk / T::kStepsPerPanel) * rows * T::kRowBytes +
                           r0 * T::kRowBytes + (kk % T::kStepsPerPanel) * 32;
  return wg_desc(p, 16, T::kAtom, T::kMode);
}

// Descriptor of k16 step `kk` (rows 16 kk..) of an MN-major tile of `rows`
// rows, N = DH.
template <int DH>
__device__ __forceinline__ uint64_t desc_mnmajor(const unsigned char* tile, int rows,
                                                 int kk) {
  using T = WgTile<DH>;
  return wg_desc(tile + kk * 16 * T::kRowBytes, rows * T::kRowBytes, T::kAtom, T::kMode);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Shared-memory writes of this thread (cp.async landed) made visible to the
// async proxy that wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Keeps the compiler from moving reads or writes of accumulator registers
// across a wgmma wait.
template <int N>
__device__ __forceinline__ void wg_hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A . B, m64nNk16: A K-major in shared memory, B in shared memory
// K-major (kTransB 0) or MN-major (kTransB 1).
template <int kTransB>
__device__ __forceinline__ void wgmma_ss_n16(float (&d)[8], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "},"
      " %8, %9, p, 1, 1, 0, %11;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(accumulate), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "},"
      " %16, %17, p, 1, 1, 0, %19;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "},"
      " %32, %33, p, 1, 1, 0, %35;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "},"
      " %64, %65, p, 1, 1, 0, %67;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate), "n"(kTransB));
}


template <int N, int kTransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int accumulate) {
  if constexpr (N == 16) wgmma_ss_n16<kTransB>(d, da, db, accumulate);
  else if constexpr (N == 32) wgmma_ss_n32<kTransB>(d, da, db, accumulate);
  else if constexpr (N == 64) wgmma_ss_n64<kTransB>(d, da, db, accumulate);
  else wgmma_ss_n128<kTransB>(d, da, db, accumulate);
}

// This thread's share of a warpgroup's [64, N] accumulator (warp w's rows
// 16w + g, 16w + g + 8; columns 8j + 2t, 8j + 2t + 1), rounded to bf16 into
// a tile of 64 rows of N columns (WgTile<N>), where a later wgmma reads it
// as a K-major A operand. The caller fences (fence_proxy_async) and
// synchronizes the warpgroup before that wgmma.
template <int N>
__device__ __forceinline__ void store_acc_bf16(unsigned char* tile, const float (&d)[N / 2]) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      *reinterpret_cast<uint32_t*>(tile + WgTile<N>::chunk(16 * warp + g + 8 * h, j, 64) + 4 * t) =
          pack_bf16x2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
    }
  }
}

// Barrier of the 128 threads of warpgroup `wg` (named barrier 1 + wg).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

}  // namespace repro_torch
