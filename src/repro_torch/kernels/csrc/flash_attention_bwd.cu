// The backward of flash_attention.cu: dQ, dK, dV of causal (or full)
// attention from q, k, v [BH, S*, Dh], the forward's output o, its row
// log-sum-exp lse [BH, Sq] (float32) and the output gradient dO, by FA2's
// split into three launches:
//   1. stats: D = rowsum(dO o) per query row in float32 (and, bf16, the
//      row's lse in base 2, both padded to whole row tiles);
//   2. dkdv: one block per key tile of one (batch, head), looping over the
//      query tiles from the causal diagonal on: p = exp(s - lse) with s =
//      (q . k in float32) * scale masked as the forward masks,
//      dV += round(p)^T dO, dP = dO V^T, dS = p (dP - D), dK += round(dS)^T Q;
//   3. dq: one block per query tile, looping over the key tiles up to the
//      diagonal: the same p, dP and dS, dQ += round(dS) K.
// dK and dQ are scaled once at the end; every sum is float32 and lands in
// the block that owns it, so there are no atomics and the gradients are
// deterministic. round() is to v's (p) and q's (dS) dtype, as the twin
// rounds: jax.grad of the reference path treats the forward's rounding of
// p as the identity, so dV = round(p)^T dO and dP is float32.
//
// Replaces no Pallas kernel: the JAX package has no backward for its
// `flash_attention` (src/repro/kernels/flash_attention.py); this kernel
// computes jax.grad of the reference path `_attend_chunked`
// (src/repro/models/attention.py:84). Plain twin:
// repro_torch.kernels.ref.flash_attention_bwd_ref.
//
// Bound on the H100 at the smollm-360m training shape (BH 60, S 4096, Dh
// 64, bf16, causal): operations. The five products over the lower
// triangle (S and dP recomputed, dV, dK, dQ) are 2.5x the forward's two:
// 5 * BH * S^2 * Dh = 322 GFLOP = 0.326 ms at 989 TFLOP/s.
//
// Design, bf16 (wgmma.cuh's building blocks). The split without atomics
// computes S and dP twice (7 products where the bound counts 5), so the
// products have to run near the tensor cores' rate: every one is a
// warpgroup wgmma (m64nNk16, float32 accumulation), both operands in
// shared memory in the swizzled layout the descriptors name. A block is
// one warpgroup (4 warps). dkdv: 64 keys a block; S^T = K Q^T and dP^T =
// V dO^T read K, V (staged once) and the query tile K-major; p and dS are
// rounded to bf16 into a [64, tile] shared tile each, the A operands of
// dV += P^T dO and dK += dS^T Q, whose B (dO, Q) is the same staged tile
// read MN-major. dq: 64 query rows a block; S = Q K^T, dP = dO V^T (Q, dO
// staged once), then dQ += dS K with the key tile read MN-major. The
// streamed tiles (query tiles of 64 rows, 32 at Dh 128, with their lse
// and D; key tiles of 64) arrive by cp.async in a ring of two stages, the
// next tile in flight during this one's math, one barrier a tile; each
// thread's copy offsets are worked out once a block (WgStream). Within a
// tile the products are issued in groups so the elementwise work
// overlaps the tensor cores (p while dP^T runs, dS while dV runs).
// Holding p and dS in shared memory rather than registers leaves the
// accumulators and two score tiles a thread: 3 blocks (12 warps) an SM at
// Dh <= 64 (__launch_bounds__ caps the registers at 170), 1 at Dh 128.
// p = 2^(s * scale * log2(e) - lse * log2(e)) by ex2.approx (one fma and
// one MUFU op; within 2 float32 ulps of expf plus the fma's rounding of
// the exponent, far below p's bf16 rounding). Masks only on the tiles
// that cross the causal diagonal or the last key (rows past Sq have lse
// = +inf in the padded stats, so their p is exactly 0).
//
// Measured on an H100 (PERF.md, scripts/flash_bwd_ablation.py, bf16 [60,
// 4096, 64] causal): 1.22 ms, dK/dV 0.65 and dQ 0.46 of it, against the
// first design's 3.01 (one cp.async stage, mma.sync, 4 warps a block) and
// SDPA's backward 0.94. expf in place of ex2.approx adds 0.26 ms; copy
// addresses worked out a chunk at a time add 0.21.
//
// Float32: the same loops on the CUDA cores, two threads a key (or row),
// each holding half of Dh in registers (a first design; no training path
// runs flash in float32).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma.cuh"
#include "wgmma.cuh"

namespace repro_torch {

// --- 1. row statistics ------------------------------------------------------
template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// One warp a row (bh, i) of [BH, ld]: delta = rowsum(dO o) (0 past Sq) and,
// where lse2 is given, lse * log2(e) (+inf past Sq).
template <typename T>
__global__ void flash_bwd_stats_kernel(const T* __restrict__ o,
                                       const T* __restrict__ dout,
                                       const float* __restrict__ lse,
                                       float* __restrict__ delta,
                                       float* __restrict__ lse2, int BH, int Sq,
                                       int ld, int DH) {
  const long long row = static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= static_cast<long long>(BH) * ld) return;
  const int bh = static_cast<int>(row / ld), i = static_cast<int>(row % ld);
  float acc = 0.f;
  if (i < Sq) {
    const long long src = (static_cast<long long>(bh) * Sq + i) * DH;
    for (int d = lane; d < DH; d += 32) acc = fmaf(to_f(dout[src + d]), to_f(o[src + d]), acc);
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) {
    delta[row] = acc;
    if (lse2 != nullptr) {
      lse2[row] = i < Sq ? __fmul_rn(lse[static_cast<long long>(bh) * Sq + i], 1.4426950408889634f)
                         : __int_as_float(0x7f800000);
    }
  }
}

// --- bf16 -----------------------------------------------------------------
// Two tunings, set from scripts/flash_bwd_ablation.py's readings on an
// H100 (PERF.md): the ring's stages, and the blocks an SM must hold (which
// caps the registers: 3 at Dh <= 64, where the accumulators fit in 170;
// 1 at Dh 128).
constexpr int kWgStages = 2;   // streamed tiles in flight
template <int DH>
constexpr int kMinBlocks = DH <= 64 ? 3 : 1;
constexpr int kDqKeys = 64;       // keys of a streamed tile (dq)
constexpr float kLog2e = 1.4426950408889634f;

// One warpgroup a block: 64 keys (dkdv) or query rows (dq).
template <int DH>
struct DkdvCfg {
  static constexpr int kQt = DH <= 64 ? 64 : 32;   // query rows of a streamed tile
  static constexpr int kTile = WgTile<DH>::bytes(kQt);
  static constexpr int kOwn = WgTile<DH>::bytes(64);
  static constexpr int kScore = WgTile<kQt>::bytes(64);   // P^T or dS^T
  // K, V; the ring of (Q, dO) tiles; P^T and dS^T; lse2 and D of each
  // stage; 1024 to align
  static constexpr size_t kBytes = 2 * kOwn + kWgStages * 2 * kTile + 2 * kScore +
                                   kWgStages * 2 * kQt * sizeof(float) + 1024;
};

template <int DH>
struct DqCfg {
  static constexpr int kTile = WgTile<DH>::bytes(kDqKeys);
  static constexpr int kOwn = WgTile<DH>::bytes(64);
  static constexpr int kScore = WgTile<kDqKeys>::bytes(64);   // dS
  static constexpr size_t kBytes = 2 * kOwn + kWgStages * 2 * kTile + kScore + 1024;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_addr(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

template <int DH>
__global__ void __launch_bounds__(128, kMinBlocks<DH>)
flash_bwd_dkdv_wg_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse2,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int Sq, int Skv, int ld,
                         int causal, float scale) {
  using Cfg = DkdvCfg<DH>;
  using Tl = WgTile<DH>;
  constexpr int kQt = Cfg::kQt;
  extern __shared__ unsigned char wg_smem_raw[];
  unsigned char* sK = align1024(wg_smem_raw);
  unsigned char* sV = sK + Cfg::kOwn;
  unsigned char* ring = sV + Cfg::kOwn;               // [stage][Q, dO]
  unsigned char* sP = ring + kWgStages * 2 * Cfg::kTile;   // P^T
  unsigned char* sS = sP + Cfg::kScore;                    // dS^T
  float* stats = reinterpret_cast<float*>(sS + Cfg::kScore);  // [stage][lse2, D][kQt]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, k0 = blockIdx.y * 64;
  const long long qoff = static_cast<long long>(bh) * Sq * DH;
  const long long koff = static_cast<long long>(bh) * Skv * DH;
  const float* lb = lse2 + static_cast<long long>(bh) * ld;
  const float* db = delta + static_cast<long long>(bh) * ld;
  const int n_q = (Sq + kQt - 1) / kQt;
  const int i_start = causal ? k0 / kQt : 0;   // no query before k0 sees these keys
  const int steps = n_q > i_start ? n_q - i_start : 0;

  const WgStream<DH, kQt, 128> stream(tid);
  auto load = [&](int it) {
    const int st = it % kWgStages, q0 = (i_start + it) * kQt;
    unsigned char* tq = ring + st * 2 * Cfg::kTile;
    stream.load(tq, q + qoff, q0, Sq);
    stream.load(tq + Cfg::kTile, dout + qoff, q0, Sq);
    if (tid < kQt / 2) {   // lse2 and D, 4 rows a copy (padded: no bounds)
      const int which = tid / (kQt / 4), c = (tid % (kQt / 4)) * 4;
      cp_async16(stats + (st * 2 + which) * kQt + c, (which ? db : lb) + q0 + c, 16);
    }
  };
  Tl::stage(sK, k + koff, k0, Skv, 64, tid, 128);
  Tl::stage(sV, v + koff, k0, Skv, 64, tid, 128);
#pragma unroll
  for (int s = 0; s < kWgStages - 1; ++s) {
    if (s < steps) load(s);
    cp_async_commit();
  }

  float acc_k[DH / 2], acc_v[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
  const float c2 = __fmul_rn(scale, kLog2e);
  const int key_a = k0 + 16 * warp + g;   // this thread's keys: key_a, key_a + 8

  for (int it = 0; it < steps; ++it) {
    cp_async_wait<kWgStages - 2>();   // tile it (and K, V) landed
    fence_proxy_async();
    __syncthreads();                  // ... for every thread; stage it - 1 is free
    if (it + kWgStages - 1 < steps) load(it + kWgStages - 1);
    cp_async_commit();
    const int st = it % kWgStages, q0 = (i_start + it) * kQt;
    const unsigned char* tq = ring + st * 2 * Cfg::kTile;
    const unsigned char* to = tq + Cfg::kTile;
    const float* sl = stats + st * 2 * kQt;
    const float* sd = sl + kQt;

    // S^T = K Q^T, dP^T = V dO^T: [64 keys, kQt queries]
    float s_t[kQt / 2], dp_t[kQt / 2];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < Tl::kSteps; ++kk) {
      wgmma_ss<kQt, 0>(s_t, desc_kmajor<DH>(sK, 64, 0, kk), desc_kmajor<DH>(tq, kQt, 0, kk), kk);
    }
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < Tl::kSteps; ++kk) {
      wgmma_ss<kQt, 0>(dp_t, desc_kmajor<DH>(sV, 64, 0, kk), desc_kmajor<DH>(to, kQt, 0, kk),
                       kk);
    }
    wg_commit();
    wg_wait<1>();   // S^T done, dP^T in flight
    wg_hold(s_t);
    const bool diag = causal && k0 + 63 > q0;
#pragma unroll
    for (int j = 0; j < kQt / 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(sl + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = ex2(fmaf(s_t[4 * j + e], c2, -((e & 1) ? l2.y : l2.x)));
        if (diag && key_a + 8 * (e >> 1) > q0 + 8 * j + 2 * t + (e & 1)) p = 0.f;
        s_t[4 * j + e] = p;
      }
    }
    store_acc_bf16<kQt>(sP, s_t);
    fence_proxy_async();
    wg_sync(0);
    // dV += P^T dO (P^T K-major, dO read MN-major)
    wg_hold(acc_v);
    wg_fence();
#pragma unroll
    for (int c = 0; c < kQt / 16; ++c) {
      wgmma_ss<DH, 1>(acc_v, desc_kmajor<kQt>(sP, 64, 0, c), desc_mnmajor<DH>(to, kQt, c), 1);
    }
    wg_commit();
    wg_wait<1>();   // dP^T done, dV in flight
    wg_hold(dp_t);
#pragma unroll
    for (int j = 0; j < kQt / 8; ++j) {
      const float2 dd = *reinterpret_cast<const float2*>(sd + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dp_t[4 * j + e] =
            __fmul_rn(s_t[4 * j + e], __fsub_rn(dp_t[4 * j + e], (e & 1) ? dd.y : dd.x));
      }
    }
    store_acc_bf16<kQt>(sS, dp_t);
    fence_proxy_async();
    wg_sync(0);
    // dK += dS^T Q (Q read MN-major)
    wg_hold(acc_k);
    wg_fence();
#pragma unroll
    for (int c = 0; c < kQt / 16; ++c) {
      wgmma_ss<DH, 1>(acc_k, desc_kmajor<kQt>(sS, 64, 0, c), desc_mnmajor<DH>(tq, kQt, c), 1);
    }
    wg_commit();
    wg_wait<0>();   // the stage and sP, sS are free after the next barrier
    wg_hold(acc_v);
    wg_hold(acc_k);
  }
  cp_async_wait<0>();   // nothing lands after the block has left

  __nv_bfloat16* dkb = dk + koff;
  __nv_bfloat16* dvb = dv + koff;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const int col = 8 * j + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = key_a + 8 * h;
      if (key >= Skv) continue;
      const long long o = static_cast<long long>(key) * DH + col;
      *reinterpret_cast<uint32_t*>(dkb + o) = pack_bf16x2(
          __fmul_rn(acc_k[4 * j + 2 * h], scale), __fmul_rn(acc_k[4 * j + 2 * h + 1], scale));
      *reinterpret_cast<uint32_t*>(dvb + o) =
          pack_bf16x2(acc_v[4 * j + 2 * h], acc_v[4 * j + 2 * h + 1]);
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(128, kMinBlocks<DH>)
flash_bwd_dq_wg_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ lse2,
                       const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dq, int Sq, int Skv, int ld,
                       int causal, float scale) {
  using Cfg = DqCfg<DH>;
  using Tl = WgTile<DH>;
  constexpr int kKt = kDqKeys;
  extern __shared__ unsigned char wg_smem_raw[];
  unsigned char* sQ = align1024(wg_smem_raw);
  unsigned char* sO = sQ + Cfg::kOwn;   // dO
  unsigned char* ring = sO + Cfg::kOwn;  // [stage][K, V]
  unsigned char* sS = ring + kWgStages * 2 * Cfg::kTile;   // dS

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int q_blocks = (Sq + 63) / 64;
  const int q0 = (q_blocks - 1 - blockIdx.y) * 64;  // heaviest first
  const long long qoff = static_cast<long long>(bh) * Sq * DH;
  const long long koff = static_cast<long long>(bh) * Skv * DH;
  const int k_end = causal ? min(Skv, q0 + 64) : Skv;   // keys <= the block's last row
  const int steps = (k_end + kKt - 1) / kKt;

  const WgStream<DH, kKt, 128> stream(tid);
  auto load = [&](int it) {
    unsigned char* tk = ring + (it % kWgStages) * 2 * Cfg::kTile;
    stream.load(tk, k + koff, it * kKt, Skv);
    stream.load(tk + Cfg::kTile, v + koff, it * kKt, Skv);
  };
  Tl::stage(sQ, q + qoff, q0, Sq, 64, tid, 128);
  Tl::stage(sO, dout + qoff, q0, Sq, 64, tid, 128);
#pragma unroll
  for (int s = 0; s < kWgStages - 1; ++s) {
    if (s < steps) load(s);
    cp_async_commit();
  }
  const int row_a = q0 + 16 * warp + g;   // this thread's rows: row_a, row_a + 8
  const long long sb = static_cast<long long>(bh) * ld;
  const float l2[2] = {lse2[sb + row_a], lse2[sb + row_a + 8]};   // padded rows: +inf
  const float dd[2] = {delta[sb + row_a], delta[sb + row_a + 8]};
  const float c2 = __fmul_rn(scale, kLog2e);
  float acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;

  for (int it = 0; it < steps; ++it) {
    cp_async_wait<kWgStages - 2>();
    fence_proxy_async();
    __syncthreads();
    if (it + kWgStages - 1 < steps) load(it + kWgStages - 1);
    cp_async_commit();
    const int k0 = it * kKt;
    const unsigned char* tk = ring + (it % kWgStages) * 2 * Cfg::kTile;
    const unsigned char* tv = tk + Cfg::kTile;

    // S = Q K^T, dP = dO V^T: [64 rows, 64 keys]
    float s[kKt / 2], dp[kKt / 2];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < Tl::kSteps; ++kk) {
      wgmma_ss<kKt, 0>(s, desc_kmajor<DH>(sQ, 64, 0, kk), desc_kmajor<DH>(tk, kKt, 0, kk), kk);
    }
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < Tl::kSteps; ++kk) {
      wgmma_ss<kKt, 0>(dp, desc_kmajor<DH>(sO, 64, 0, kk), desc_kmajor<DH>(tv, kKt, 0, kk), kk);
    }
    wg_commit();
    wg_wait<1>();
    wg_hold(s);
    const bool edge = k0 + kKt > Skv || (causal && k0 + kKt - 1 > q0);
#pragma unroll
    for (int j = 0; j < kKt / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = ex2(fmaf(s[4 * j + e], c2, -l2[e >> 1]));
        const int key = k0 + 8 * j + 2 * t + (e & 1);
        if (edge && (key >= Skv || (causal && key > row_a + 8 * (e >> 1)))) p = 0.f;
        s[4 * j + e] = p;
      }
    }
    wg_wait<0>();
    wg_hold(dp);
#pragma unroll
    for (int j = 0; j < kKt / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dp[4 * j + e] = __fmul_rn(s[4 * j + e], __fsub_rn(dp[4 * j + e], dd[e >> 1]));
      }
    }
    store_acc_bf16<kKt>(sS, dp);
    fence_proxy_async();
    wg_sync(0);
    // dQ += dS K (dS K-major, K read MN-major)
    wg_hold(acc);
    wg_fence();
#pragma unroll
    for (int c = 0; c < kKt / 16; ++c) {
      wgmma_ss<DH, 1>(acc, desc_kmajor<kKt>(sS, 64, 0, c), desc_mnmajor<DH>(tk, kKt, c), 1);
    }
    wg_commit();
    wg_wait<0>();
    wg_hold(acc);
  }
  cp_async_wait<0>();

  __nv_bfloat16* dqb = dq + qoff;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const int col = 8 * j + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row_a + 8 * h;
      if (row >= Sq) continue;
      *reinterpret_cast<uint32_t*>(dqb + static_cast<long long>(row) * DH + col) =
          pack_bf16x2(__fmul_rn(acc[4 * j + 2 * h], scale),
                      __fmul_rn(acc[4 * j + 2 * h + 1], scale));
    }
  }
}

// --- float32 --------------------------------------------------------------
constexpr int kBwdRows = 64;     // keys (dkdv) or query rows (dq) per block
constexpr int kBwdThreads = 128;

// lse and D of query rows [row0, row0 + 64) into shared memory; rows past
// Sq get lse = +inf, so their p is exactly 0.
__device__ __forceinline__ void stage_row_stats(float* s_lse, float* s_d,
                                                const float* lse,
                                                const float* delta, int row0,
                                                int Sq) {
  for (int i = threadIdx.x; i < kBwdRows; i += kBwdThreads) {
    const bool ok = row0 + i < Sq;
    s_lse[i] = ok ? lse[row0 + i] : __int_as_float(0x7f800000);
    s_d[i] = ok ? delta[row0 + i] : 0.f;
  }
}

// Two threads a key (dkdv) or a query row (dq), each holding half of Dh of
// its row's operands and gradients in registers; the other operand's
// 64-row tiles in shared memory, read as broadcasts.
template <int DH>
struct BwdF32Smem {
  static constexpr size_t kBytes =
      size_t(2 * kBwdRows * DH + 2 * kBwdRows) * sizeof(float);
};

// rows [row0, row0 + 64) of a [rows, DH] float32 matrix into a dense
// [64][DH] tile; rows past `rows` are zero.
template <int DH>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              int row0, int rows) {
  constexpr int kPerRow = DH / 4;
  for (int i = threadIdx.x; i < kBwdRows * kPerRow; i += kBwdThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < rows) {
      val = *reinterpret_cast<const float4*>(src + static_cast<long long>(row0 + r) * DH + c);
    }
    *reinterpret_cast<float4*>(dst + r * DH + c) = val;
  }
}

// dot of this thread's half row with half h of a shared row, summed with
// the partner lane's half (lanes 2r, 2r + 1)
template <int DH>
__device__ __forceinline__ float half_dot(const float (&mine)[DH / 2],
                                          const float* row, int h) {
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < DH / 2; ++d) acc = fmaf(mine[d], row[h * (DH / 2) + d], acc);
  return __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, 1));
}

template <int DH>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta, float* __restrict__ dk,
                          float* __restrict__ dv, int Sq, int Skv, int causal,
                          float scale) {
  constexpr int kHalf = DH / 2;
  extern __shared__ __align__(16) float fbwd_smem[];
  float* sQ = fbwd_smem;
  float* sO = sQ + kBwdRows * DH;
  float* s_lse = sO + kBwdRows * DH;
  float* s_d = s_lse + kBwdRows;
  const int bh = blockIdx.x, k0 = blockIdx.y * kBwdRows;
  const int h = threadIdx.x & 1, key = k0 + threadIdx.x / 2;
  const long long qoff = static_cast<long long>(bh) * Sq * DH;
  const long long koff = static_cast<long long>(bh) * Skv * DH;
  float kr[kHalf], vr[kHalf], gk[kHalf], gv[kHalf];
#pragma unroll
  for (int d = 0; d < kHalf; ++d) {
    const bool ok = key < Skv;
    kr[d] = ok ? k[koff + static_cast<long long>(key) * DH + h * kHalf + d] : 0.f;
    vr[d] = ok ? v[koff + static_cast<long long>(key) * DH + h * kHalf + d] : 0.f;
    gk[d] = gv[d] = 0.f;
  }
  const int i_start = causal ? k0 : 0;
  for (int i0 = i_start; i0 < Sq; i0 += kBwdRows) {
    __syncthreads();
    load_rows_f32<DH>(sQ, q + qoff, i0, Sq);
    load_rows_f32<DH>(sO, dout + qoff, i0, Sq);
    stage_row_stats(s_lse, s_d, lse + static_cast<long long>(bh) * Sq,
                    delta + static_cast<long long>(bh) * Sq, i0, Sq);
    __syncthreads();
    for (int i = 0; i < kBwdRows; ++i) {
      const float s = half_dot<DH>(kr, sQ + i * DH, h);
      const float dp = half_dot<DH>(vr, sO + i * DH, h);
      const bool keep = key < Skv && (!causal || key <= i0 + i);
      const float p = keep ? expf(__fsub_rn(__fmul_rn(s, scale), s_lse[i])) : 0.f;
      const float ds = __fmul_rn(p, __fsub_rn(dp, s_d[i]));
#pragma unroll
      for (int d = 0; d < kHalf; ++d) {
        gv[d] = fmaf(p, sO[i * DH + h * kHalf + d], gv[d]);
        gk[d] = fmaf(ds, sQ[i * DH + h * kHalf + d], gk[d]);
      }
    }
  }
  if (key < Skv) {
#pragma unroll
    for (int d = 0; d < kHalf; ++d) {
      const long long o = koff + static_cast<long long>(key) * DH + h * kHalf + d;
      dk[o] = __fmul_rn(gk[d], scale);
      dv[o] = gv[d];
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, float* __restrict__ dq,
                        int Sq, int Skv, int causal, float scale) {
  constexpr int kHalf = DH / 2;
  extern __shared__ __align__(16) float fbwd_smem[];
  float* sK = fbwd_smem;
  float* sV = sK + kBwdRows * DH;
  const int bh = blockIdx.x;
  const int q_tiles = (Sq + kBwdRows - 1) / kBwdRows;
  const int q0 = (q_tiles - 1 - blockIdx.y) * kBwdRows;  // heaviest first
  const int h = threadIdx.x & 1, row = q0 + threadIdx.x / 2;
  const bool live = row < Sq;
  const long long qoff = static_cast<long long>(bh) * Sq * DH;
  const long long koff = static_cast<long long>(bh) * Skv * DH;
  float qr[kHalf], orow[kHalf], gq[kHalf];
#pragma unroll
  for (int d = 0; d < kHalf; ++d) {
    qr[d] = live ? q[qoff + static_cast<long long>(row) * DH + h * kHalf + d] : 0.f;
    orow[d] = live ? dout[qoff + static_cast<long long>(row) * DH + h * kHalf + d] : 0.f;
    gq[d] = 0.f;
  }
  const float lse_r = live ? lse[static_cast<long long>(bh) * Sq + row]
                           : __int_as_float(0x7f800000);
  const float d_r = live ? delta[static_cast<long long>(bh) * Sq + row] : 0.f;
  int k_end = Skv;
  if (causal) k_end = min(Skv, q0 + kBwdRows);
  for (int k0 = 0; k0 < k_end; k0 += kBwdRows) {
    __syncthreads();
    load_rows_f32<DH>(sK, k + koff, k0, Skv);
    load_rows_f32<DH>(sV, v + koff, k0, Skv);
    __syncthreads();
    for (int j = 0; j < kBwdRows; ++j) {
      const float s = half_dot<DH>(qr, sK + j * DH, h);
      const float dp = half_dot<DH>(orow, sV + j * DH, h);
      const int key = k0 + j;
      const bool keep = key < Skv && (!causal || key <= row);
      const float p = keep ? expf(__fsub_rn(__fmul_rn(s, scale), lse_r)) : 0.f;
      const float ds = __fmul_rn(p, __fsub_rn(dp, d_r));
#pragma unroll
      for (int d = 0; d < kHalf; ++d) gq[d] = fmaf(ds, sK[j * DH + h * kHalf + d], gq[d]);
    }
  }
  if (live) {
#pragma unroll
    for (int d = 0; d < kHalf; ++d) {
      dq[qoff + static_cast<long long>(row) * DH + h * kHalf + d] = __fmul_rn(gq[d], scale);
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int DH>
cudaError_t launch_flash_bwd(const void* q, const void* k, const void* v,
                             const void* o, const float* lse, const void* dout,
                             float* stats, void* dq, void* dk, void* dv, int BH,
                             int Sq, int Skv, int causal, int is_bf16,
                             float scale, cudaStream_t s) {
  cudaError_t err;
  if (is_bf16) {
    using T = __nv_bfloat16;
    auto* dkdv = flash_bwd_dkdv_wg_kernel<DH>;
    auto* dqk = flash_bwd_dq_wg_kernel<DH>;
    // lse2 [BH, ld] then D [BH, ld], rows padded to whole 128-row blocks
    const int ld = (Sq + 127) / 128 * 128;
    float* lse2 = stats;
    float* delta = stats + static_cast<long long>(BH) * ld;
    const long long rows = static_cast<long long>(BH) * ld;
    flash_bwd_stats_kernel<T><<<static_cast<unsigned>((rows + 7) / 8), 256, 0, s>>>(
        static_cast<const T*>(o), static_cast<const T*>(dout), lse, delta, lse2, BH, Sq,
        ld, DH);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if ((err = allow_smem(dkdv, DkdvCfg<DH>::kBytes)) != cudaSuccess) return err;
    if ((err = allow_smem(dqk, DqCfg<DH>::kBytes)) != cudaSuccess) return err;
    dkdv<<<dim3(BH, (Skv + 63) / 64), 128, DkdvCfg<DH>::kBytes, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), lse2, delta, static_cast<T*>(dk), static_cast<T*>(dv),
        Sq, Skv, ld, causal, scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    dqk<<<dim3(BH, (Sq + 63) / 64), 128, DqCfg<DH>::kBytes, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), lse2, delta, static_cast<T*>(dq), Sq, Skv, ld, causal,
        scale);
    return cudaGetLastError();
  }
  // float32: D [BH, Sq] alone
  const long long rows = static_cast<long long>(BH) * Sq;
  flash_bwd_stats_kernel<float><<<static_cast<unsigned>((rows + 7) / 8), 256, 0, s>>>(
      static_cast<const float*>(o), static_cast<const float*>(dout), lse, stats, nullptr,
      BH, Sq, Sq, DH);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 kv_grid(BH, (Skv + kBwdRows - 1) / kBwdRows);
  const dim3 q_grid(BH, (Sq + kBwdRows - 1) / kBwdRows);
  const size_t smem = BwdF32Smem<DH>::kBytes;
  if ((err = allow_smem(flash_bwd_dkdv_f32_kernel<DH>, smem)) != cudaSuccess) return err;
  if ((err = allow_smem(flash_bwd_dq_f32_kernel<DH>, smem)) != cudaSuccess) return err;
  flash_bwd_dkdv_f32_kernel<DH><<<kv_grid, kBwdThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse, stats,
      static_cast<float*>(dk), static_cast<float*>(dv), Sq, Skv, causal, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_bwd_dq_f32_kernel<DH><<<q_grid, kBwdThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse, stats,
      static_cast<float*>(dq), Sq, Skv, causal, scale);
  return cudaGetLastError();
}

}  // namespace repro_torch

// q, o, dout, dq [BH, Sq, Dh]; k, v, dk, dv [BH, Skv, Dh]; contiguous,
// 16-byte aligned, all bfloat16 (is_bf16) or all float32; lse [BH, Sq]
// float32 from the forward; stats float32 scratch of 2 BH ceil(Sq / 128) 128
// (bf16: lse2 and D; float32: D [BH, Sq]). Dh in {16, 32, 64, 128}.
extern "C" int repro_flash_attention_bwd(const void* q, const void* k,
                                         const void* v, const void* o,
                                         const void* lse, const void* dout,
                                         void* stats, void* dq, void* dk,
                                         void* dv, int BH, int Sq, int Skv,
                                         int dh, int causal, int is_bf16,
                                         float scale, void* stream) {
  using namespace repro_torch;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* l = static_cast<const float*>(lse);
  auto* d = static_cast<float*>(stats);
  cudaError_t err;
  switch (dh) {
    case 16: err = launch_flash_bwd<16>(q, k, v, o, l, dout, d, dq, dk, dv, BH, Sq, Skv, causal, is_bf16, scale, s); break;
    case 32: err = launch_flash_bwd<32>(q, k, v, o, l, dout, d, dq, dk, dv, BH, Sq, Skv, causal, is_bf16, scale, s); break;
    case 64: err = launch_flash_bwd<64>(q, k, v, o, l, dout, d, dq, dk, dv, BH, Sq, Skv, causal, is_bf16, scale, s); break;
    case 128: err = launch_flash_bwd<128>(q, k, v, o, l, dout, d, dq, dk, dv, BH, Sq, Skv, causal, is_bf16, scale, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
