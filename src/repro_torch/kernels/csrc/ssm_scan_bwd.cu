// The backward of ssm_scan.cu: the gradients of the S6 scan over one chunk,
//   h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t,   y_t = sum_s h_t[:, s] C_t[s],
// with respect to dt, x [B, C, di], B_t, C_t [B, C, ds], A [di, ds] and h0
// [B, di, ds], from dy [B, C, di] and dh_last [B, di, ds]. Per channel and
// state, in reverse from dh = dh_last:
//   g_t = dh + dy_t C_t (the gradient of h_t),
//   dC_t = sum_di dy_t h_t,  dB_t = sum_di g_t dt_t x_t,
//   d dt_t = sum_s g_t h_{t-1} exp(dt_t A) A + x_t sum_s g_t B_t,
//   dx_t = dt_t sum_s g_t B_t,  dA += g_t h_{t-1} exp(dt_t A) dt_t,
//   dh = g_t exp(dt_t A),  and dh0 = dh at the end.
//
// Replaces no Pallas kernel: the JAX package has no backward for its
// `ssm_scan_chunk` (src/repro/kernels/ssm_scan.py); this kernel computes
// jax.grad of the reference path `_selective_scan_chunk`
// (src/repro/models/mamba.py:67). Plain twin:
// repro_torch.kernels.ref.ssm_scan_chunk_bwd_ref; this kernel's order of
// work in plain torch: ref.ssm_scan_chunk_bwd_segmented.
//
// Bound on the H100 at the jamba chunk (B 1, C 256, di 16384, ds 16). It
// must read dt, x, dy (16.8 MB each) and write d dt, dx (16.8 MB each):
// 84 MB, 25 us at 3.35 TB/s. It takes B C di ds = 67 M exps, 16 us at 16
// MUFU.EX2 a clock per SM. The issue slots are scarcer than either: with
// two exps an element (expf is 8 instructions) each (t, d, s) issues ~12
// instructions in the forward pass to the checkpoints, ~12 in the
// segment's recompute and ~9 in the reverse step, plus ~12 a lane and step
// shared by its four states (staged loads, shuffles, stores) and a quarter
// of the ~28 of the sums over channels, ~48 in all: 3.2 G instructions,
// ~100 us at one warp instruction a clock per scheduler (1.98 GHz).
//
// Design. Each channel (b, d) is split over G lanes of a warp, NS = DS/G
// states a lane (G 4 at the compiled width 16, 8 at 32: four states a
// lane), CPB channels a block (64 at width 16, 32 at 32: 256 threads). No
// state is stored for every step: a forward pass from h0 keeps only the
// state entering every K-th step (K 8: a segment's checkpoint) in shared
// memory; the reverse pass walks the segments from last to first,
// recomputes each segment's K states and their decays da = exp(dt A) from
// its checkpoint into registers, then runs its K reverse steps reusing
// each da: two expf an element. The recompute rounds as the forward kernel
// does (expf, __fmul_rn/__fadd_rn, no FMA contraction), so its states are
// bit-identical to the forward kernel's and the twin's. A block holds
// kBwdSpan / K checkpoints: a longer chunk is walked in spans of that many
// steps, last first, each span's forward pass starting again from h0.
// Staging: a segment's dt, x, dy tiles [K][CPB] and B, C rows [K][DS] are
// copied into shared memory kBwdStages - 1 segments ahead of use, by one
// thread through 3-D tensor maps (TMA, one copy a tile, landing on the
// stage's mbarrier; channels past di, steps past C and states past ds read
// as zeros), or, where a base or stride is not 16-byte aligned, by every
// thread's cp.async (16-byte pieces where they allow, else 4-byte); a
// copy width, not a fallback to the twin. Operands are read through their
// batch and time strides, so chunk views and x_proj's column slices need
// no copy. Sums over a channel's states (d dt, dx) are xor shuffles over
// its lanes; sums over a warp's channels (dB_t, dC_t) a transposed
// butterfly of shuffles, each pairwise in a fixed order. One __syncthreads
// a segment: past it the segment's operands have landed, the stage before
// it refills, and the block adds the last segment's warp sums (warps in
// order) into one partial a block and step, [B, C, blocks, 2 DS]. A
// second launch adds the blocks' partials (a strided serial sum per thread
// group, then the groups in order) and, for B > 1, dA's batch rows in
// order (at B 1 the first launch writes dA itself). No atomics: two calls
// on the same inputs give the same bits. Ragged di is masked per lane
// (dead lanes see zeros and still take part in the shuffles); ds is padded
// to the compiled width with A = B = C = h0 = dh_last = 0, whose states
// stay exactly 0 and add exact zeros.
//
// Shared memory at C >= 256: 158 KB (width 16), 170 KB (width 32), one
// block and 8 warps an SM; registers (ptxas -v, sm_90a): 236 at width 16,
// 216 at width 32, 32 in the second kernel, 0 spill bytes. Measured at the
// jamba chunk (PERF.md, scripts/scan_bwd_ablation.py): 0.20 ms, ~60% of
// the issue slots; G 2 or 8, K 16, 32 channels a block, 3 or 4 stages and
// the copies by every thread were slower or no faster.
#include <cuda.h>
#include <cuda_runtime.h>

#include "mma.cuh"

namespace repro_torch {
// Internal linkage: a library built from an edited copy of this source
// (scripts/scan_bwd_ablation.py loads several into one process) keeps
// its own kernels and its own "attribute set" flags.
namespace {

// Tunings per compiled width {G lanes a channel, K steps a segment,
// channels a block}: scripts/scan_bwd_ablation.py edits these two lines.
constexpr int kBwd16[3] = {4, 8, 64};
constexpr int kBwd32[3] = {8, 8, 32};
constexpr int kBwdSpan = 256;      // steps whose checkpoints a block holds
constexpr int kBwdStages = 2;      // segments staged at once (a ring)
constexpr int kBwdSumThreads = 256;
constexpr size_t kMaxSmem = 232448;

struct ScanBwdArgs {
  const float *dt, *xh, *bm, *cm, *A, *h0, *dy, *dh_last;
  float *ddt, *dxh, *dh0, *d_a, *part, *a_part;
  int batch, C, di, ds, nblk;
  long long dt_sb, dt_st, xh_sb, xh_st, b_sb, b_st, c_sb, c_st;
  int vec_ch;  // dt, x, dy in 16-byte pieces (aligned, strides and di % 4 == 0)
  int vec_bc;  // B and C rows in 16-byte pieces (aligned, ds % 4 == 0)
  int tma;     // staged by the tensor maps below (else by every thread's cp.async)
};

// Tensor maps of dt, x, dy [B][C][di] and B, C [B][C][ds] (3-D, innermost
// first), boxes of [1][K][CPB] and [1][K][DS].
struct ScanBwdMaps {
  CUtensorMap dt, xh, dy, bm, cm;
};

// Shared memory of one block, in floats: a ring of kBwdStages stages of
// a segment (dt, x, dy [K][CPB], then the B and C rows [K][DS]; each
// 128-byte aligned), their mbarriers, the warps' sums of two segments
// ([2][K][WARPS][2 DS]), then the checkpoints ([slot][NS][THREADS]).
template <int DS, int G, int K, int CPB>
struct BwdShape {
  static constexpr int LANES = G;            // lanes a channel
  static constexpr int NS = DS / G;          // states a lane
  static constexpr int CPW = 32 / G;         // channels a warp
  static constexpr int THREADS = CPB * G;
  static constexpr int WARPS = THREADS / 32;
  static constexpr int SLOTS = kBwdSpan / K;
  static constexpr int STAGE = K * (3 * CPB + 2 * DS);
  static constexpr int OFF_BAR = kBwdStages * STAGE;  // a stage's mbarrier, 8 bytes each
  static constexpr int OFF_RED = OFF_BAR + 4 * ((kBwdStages + 1) / 2);
  static constexpr int RED = K * WARPS * 2 * DS;  // a segment's warp sums
  static constexpr int OFF_CK = OFF_RED + 2 * RED;
  static_assert(NS % 2 == 0 && 32 % G == 0, "an even number of states a lane");
  static_assert(THREADS % 32 == 0 && THREADS <= 1024 && CPB % 4 == 0, "whole warps");
  static_assert(kBwdSpan % K == 0, "the span holds whole segments");
  static_assert(K * CPB % 32 == 0 && K * DS % 32 == 0, "tiles 128-byte aligned");
  static constexpr size_t bytes(int slots) {
    return (static_cast<size_t>(OFF_CK) + static_cast<size_t>(slots) * NS * THREADS) *
           sizeof(float);
  }
};

// exp(dt * a) as the forward kernel rounds it.
__device__ __forceinline__ float decay(float dtv, float a) {
  return expf(__fmul_rn(dtv, a));
}

// NS consecutive floats of shared memory, in the widest pieces they allow.
template <int NS>
__device__ __forceinline__ void load_row(float (&v)[NS], const float* p) {
  if constexpr (NS % 4 == 0) {
#pragma unroll
    for (int j = 0; j < NS; j += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + j);
      v[j] = q.x;
      v[j + 1] = q.y;
      v[j + 2] = q.z;
      v[j + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < NS; j += 2) {
      const float2 q = *reinterpret_cast<const float2*>(p + j);
      v[j] = q.x;
      v[j + 1] = q.y;
    }
  }
}

// Steps [t0, t0 + tn) of dt, x (and, kRev: for the reverse pass, dy) of
// the block's channels [d0, d0 + CPB) and of the rows of B (and C) into
// one stage; channels past di read as zeros, B and C columns past ds are
// not written (they were zeroed once). Each thread's pieces follow from
// its index by compile-time divisors (a runtime division in this loop
// cost a third of the kernel's time).
template <class S, int DS, int K, int CPB, bool kRev>
__device__ __forceinline__ void stage_steps(float* st, const ScanBwdArgs& p, int b, int d0,
                                            int t0, int tn) {
  constexpr int T = S::THREADS, ARR = kRev ? 3 : 2, ROWS = kRev ? 2 : 1;
  const int tid = threadIdx.x;
  const float* dt_b = p.dt + b * p.dt_sb;
  const float* xh_b = p.xh + b * p.xh_sb;
  const float* dy_b = p.dy + static_cast<long long>(b) * p.C * p.di;
  if (p.vec_ch) {
    constexpr int PER = CPB / 4, N = ARR * K * PER;  // 16-byte pieces
#pragma unroll
    for (int i0 = 0; i0 < N; i0 += T) {
      const int i = i0 + tid, arr = i / (K * PER), tt = i / PER % K, c = i % PER * 4;
      if ((N % T == 0 || i < N) && tt < tn) {
        const long long t = t0 + tt;
        const float* src = arr == 0 ? dt_b + t * p.dt_st
                           : arr == 1 ? xh_b + t * p.xh_st : dy_b + t * p.di;
        const bool on = d0 + c < p.di;  // di % 4 == 0 here: wholly in or out
        cp_async16(st + arr * K * CPB + tt * CPB + c, on ? src + d0 + c : p.dt, on ? 16 : 0);
      }
    }
  } else {
    constexpr int N = ARR * K * CPB;
#pragma unroll
    for (int i0 = 0; i0 < N; i0 += T) {
      const int i = i0 + tid, arr = i / (K * CPB), tt = i / CPB % K, c = i % CPB;
      if ((N % T == 0 || i < N) && tt < tn) {
        const long long t = t0 + tt;
        const float* src = arr == 0 ? dt_b + t * p.dt_st
                           : arr == 1 ? xh_b + t * p.xh_st : dy_b + t * p.di;
        const bool on = d0 + c < p.di;
        cp_async4(st + arr * K * CPB + tt * CPB + c, on ? src + d0 + c : p.dt, on);
      }
    }
  }
  const float* bm_b = p.bm + b * p.b_sb;
  const float* cm_b = p.cm + b * p.c_sb;
  float* srow = st + 3 * K * CPB;
  if (p.vec_bc) {
    constexpr int PER = DS / 4, N = ROWS * K * PER;
#pragma unroll
    for (int i0 = 0; i0 < N; i0 += T) {
      const int i = i0 + tid, arr = i / (K * PER), tt = i / PER % K, c = i % PER * 4;
      if ((N % T == 0 || i < N) && tt < tn && c < p.ds) {
        const long long t = t0 + tt;
        const float* src = arr == 0 ? bm_b + t * p.b_st : cm_b + t * p.c_st;
        cp_async16(srow + arr * K * DS + tt * DS + c, src + c, 16);
      }
    }
  } else {
    constexpr int N = ROWS * K * DS;
#pragma unroll
    for (int i0 = 0; i0 < N; i0 += T) {
      const int i = i0 + tid, arr = i / (K * DS), tt = i / DS % K, c = i % DS;
      if ((N % T == 0 || i < N) && tt < tn && c < p.ds) {
        const long long t = t0 + tt;
        const float* src = arr == 0 ? bm_b + t * p.b_st : cm_b + t * p.c_st;
        cp_async4(srow + arr * K * DS + tt * DS + c, src + c, true);
      }
    }
  }
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the completion of the barrier's phase of this parity (a copy
// that never lands traps rather than hangs).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  for (int spin = 0;; ++spin) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > (1 << 22)) __trap();
  }
}

// The tile of a tensor map at (c0, c1, c2) into shared memory (128-byte
// aligned), completing on bar; parts past the tensor's extent read as 0.
__device__ __forceinline__ void tma_load(float* dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_addr(bar))
      : "memory");
}

// stage_steps by the tensor maps, one thread issuing a tile an operand: dt,
// x (and, kRev, dy) [K steps][CPB channels] from (d0, t0, b), B (and C)
// [K][DS] from (0, t0, b); channels past di, steps past C and states past
// ds land as zeros.
template <int DS, int K, int CPB, bool kRev>
__device__ __forceinline__ void tma_stage(float* st, uint64_t* bar, const ScanBwdMaps& m, int b,
                                          int d0, int t0) {
  constexpr int ARR = kRev ? 3 : 2, ROWS = kRev ? 2 : 1;
  mbar_expect_tx(bar, (ARR * K * CPB + ROWS * K * DS) * 4);
  tma_load(st, &m.dt, d0, t0, b, bar);
  tma_load(st + K * CPB, &m.xh, d0, t0, b, bar);
  if (kRev) tma_load(st + 2 * K * CPB, &m.dy, d0, t0, b, bar);
  tma_load(st + 3 * K * CPB, &m.bm, 0, t0, b, bar);
  if (kRev) tma_load(st + 3 * K * CPB + K * DS, &m.cm, 0, t0, b, bar);
}

// The forward pass over one staged segment of tn steps (kFull: tn == K),
// advancing the lane's states h.
template <class S, int DS, int K, int CPB, bool kFull>
__device__ __forceinline__ void advance(float (&h)[S::NS], const float (&a)[S::NS],
                                        const float* st, int g, int cl, int tn) {
  constexpr int NS = S::NS;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (kFull || j < tn) {
      const float dtv = st[j * CPB + cl];
      const float dtx = __fmul_rn(dtv, st[K * CPB + j * CPB + cl]);
      float bv[NS];
      load_row<NS>(bv, st + 3 * K * CPB + j * DS + g * NS);
#pragma unroll
      for (int q = 0; q < NS; ++q) {
        const float da = decay(dtv, a[q]);
        h[q] = __fadd_rn(__fmul_rn(h[q], da), __fmul_rn(dtx, bv[q]));
      }
    }
  }
}

// The sums over a warp's channels of V values a lane, by a transposed
// butterfly over the lane bits that number its channel (offsets OFF = G,
// 2G, ..., 16): each level pairs channels c and c ^ (OFF / G), and the
// lower lane keeps the first HALF of its values, the upper the rest, so a
// lane ends with V / CPW sums, each pairwise in channel order (((c0 + c1)
// + (c2 + c3)) + ...), as the shared-memory sums add them.
template <int OFF, int HALF, int V>
__device__ __forceinline__ void transpose_sums(float (&v)[V], int lane) {
  if constexpr (OFF < 32) {
    const bool upper = (lane & OFF) != 0;
#pragma unroll
    for (int i = 0; i < HALF; ++i) {
      const float send = upper ? v[i] : v[i + HALF];
      const float keep = upper ? v[i + HALF] : v[i];
      v[i] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, OFF));
    }
    transpose_sums<OFF * 2, HALF / 2, V>(v, lane);
  }
}

// One segment of tn steps from t0 (kFull: tn == K), last step first: its
// states and decays recomputed from the checkpoint hc, then the reverse
// steps. Writes d dt and dx of the lane's channel, carries dh and dA's sum,
// and leaves the warp's channel sums of dC_t, dB_t in red[j][warp][.].
template <class S, int DS, int K, int CPB, bool kFull>
__device__ __forceinline__ void reverse_segment(
    const ScanBwdArgs& p, const float* st, const float (&hc)[S::NS], const float (&a)[S::NS],
    float (&dh)[S::NS], float (&gacc)[S::NS], float* red, int g, int lane, int warp, int cl,
    bool live, long long out0, int tn) {
  constexpr int NS = S::NS, CPW = S::CPW, W2 = 2 * DS;
  float hs[K + 1][NS], das[K][NS], dts[K], xs[K];
#pragma unroll
  for (int q = 0; q < NS; ++q) hs[0][q] = hc[q];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (kFull || j < tn) {
      const float dtv = st[j * CPB + cl];
      dts[j] = dtv;
      xs[j] = st[K * CPB + j * CPB + cl];
      const float dtx = __fmul_rn(dtv, xs[j]);
      float bv[NS];
      load_row<NS>(bv, st + 3 * K * CPB + j * DS + g * NS);
#pragma unroll
      for (int q = 0; q < NS; ++q) {
        das[j][q] = decay(dtv, a[q]);
        hs[j + 1][q] = __fadd_rn(__fmul_rn(hs[j][q], das[j][q]), __fmul_rn(dtx, bv[q]));
      }
    }
  }
  // The columns of a step's warp sums this lane ends with (transpose_sums):
  // value index (its channel's bits, level by level) + r, dC first, dB.
  int cols[2 * NS / CPW];
  {
    const int ch = lane / S::LANES;
    int base = 0;
#pragma unroll
    for (int l = 0; (S::LANES << l) < 32; ++l) base += ((ch >> l) & 1) * (2 * NS >> (l + 1));
#pragma unroll
    for (int r = 0; r < 2 * NS / CPW; ++r) {
      const int idx = base + r;
      cols[r] = idx < NS ? g * NS + idx : DS + g * NS + idx - NS;
    }
  }
#pragma unroll
  for (int j = K - 1; j >= 0; --j) {
    if (kFull || j < tn) {
      const float dtv = dts[j], xv = xs[j];
      const float dyv = st[2 * K * CPB + j * CPB + cl];
      const float dtx = __fmul_rn(dtv, xv);
      float bv[NS], cv[NS], vc[NS], vb[NS];
      load_row<NS>(bv, st + 3 * K * CPB + j * DS + g * NS);
      load_row<NS>(cv, st + 3 * K * CPB + K * DS + j * DS + g * NS);
      float gb = 0.f, ga = 0.f;
#pragma unroll
      for (int q = 0; q < NS; ++q) {
        const float gq = fmaf(dyv, cv[q], dh[q]);
        vc[q] = __fmul_rn(dyv, hs[j + 1][q]);
        vb[q] = __fmul_rn(gq, dtx);
        gb = fmaf(gq, bv[q], gb);
        dh[q] = __fmul_rn(gq, das[j][q]);
        const float gda = __fmul_rn(dh[q], hs[j][q]);  // g h_{t-1} da
        ga = fmaf(gda, a[q], ga);
        gacc[q] = fmaf(gda, dtv, gacc[q]);
      }
      // the sums over the channel's states (its lanes, xor order) and over
      // the warp's channels (the warp's partial of dC_t and dB_t)
#pragma unroll
      for (int o = 1; o < S::LANES; o <<= 1) {
        gb = __fadd_rn(gb, __shfl_xor_sync(0xffffffffu, gb, o));
        ga = __fadd_rn(ga, __shfl_xor_sync(0xffffffffu, ga, o));
      }
      float v[2 * NS];
#pragma unroll
      for (int q = 0; q < NS; ++q) {
        v[q] = vc[q];
        v[NS + q] = vb[q];
      }
      transpose_sums<S::LANES, NS, 2 * NS>(v, lane);
#pragma unroll
      for (int r = 0; r < 2 * NS / CPW; ++r) red[(j * S::WARPS + warp) * W2 + cols[r]] = v[r];
      if (live && g == 0) {
        const long long o = out0 + static_cast<long long>(j) * p.di;
        p.ddt[o] = fmaf(xv, gb, ga);
        p.dxh[o] = __fmul_rn(dtv, gb);
      }
    }
  }
}

// The block's sums of a segment's tn steps from t0, its warps in order:
// one partial a block and step, part[b][t][blockIdx.x][2 DS].
template <class S, int DS, int K>
__device__ __forceinline__ void block_sums(const ScanBwdArgs& p, const float* red, int t0,
                                           int tn) {
  constexpr int W2 = 2 * DS;
  for (int i = threadIdx.x; i < tn * W2; i += S::THREADS) {
    const int j = i / W2, col = i - j * W2;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < S::WARPS; ++w) sum = __fadd_rn(sum, red[(j * S::WARPS + w) * W2 + col]);
    p.part[((static_cast<long long>(blockIdx.y) * p.C + t0 + j) * p.nblk + blockIdx.x) * W2 +
           col] = sum;
  }
}

template <int DS, int G, int K, int CPB>
__global__ void __launch_bounds__(CPB * G, 1)
    ssm_scan_bwd_kernel(const ScanBwdArgs p, const __grid_constant__ ScanBwdMaps maps) {
  using S = BwdShape<DS, G, K, CPB>;
  constexpr int NS = S::NS, T = S::THREADS;
  extern __shared__ __align__(128) float smem[];
  float* const red = smem + S::OFF_RED;
  float* const ck = smem + S::OFF_CK;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane % G, cl = warp * S::CPW + lane / G;
  const int b = blockIdx.y, d0 = blockIdx.x * CPB, d = d0 + cl;
  const int C = p.C, di = p.di, ds = p.ds;
  const bool live = d < di;
  const long long chan = static_cast<long long>(b) * di + d;

  float a[NS], h0[NS], dh[NS], gacc[NS];
#pragma unroll
  for (int q = 0; q < NS; ++q) {
    const int s = g * NS + q;
    const bool on = live && s < ds;
    a[q] = on ? p.A[static_cast<long long>(d) * ds + s] : 0.f;
    h0[q] = on ? p.h0[chan * ds + s] : 0.f;
    dh[q] = on ? p.dh_last[chan * ds + s] : 0.f;
    gacc[q] = 0.f;
  }
  // The padded states' B and C columns stay 0 in every stage.
  if (ds < DS) {
    for (int i = tid; i < kBwdStages * 2 * K * DS; i += T) {
      const int stage = i / (2 * K * DS), r = i - stage * 2 * K * DS;
      if (r % DS >= ds) smem[stage * S::STAGE + 3 * K * CPB + r] = 0.f;
    }
  }
  // Segment s is staged in stage s % kBwdStages, kBwdStages - 1 segments
  // ahead of its use: by the tensor maps on the stage's mbarrier where the
  // operands allow (tma), else one cp.async group a segment (empty past
  // the span). One __syncthreads a segment: past it, its operands have landed
  // and every thread is done with the segment before it, whose stage then
  // refills.
  uint64_t* const bars = reinterpret_cast<uint64_t*>(smem + S::OFF_BAR);
  const bool tma = p.tma != 0;
  if (tma) {
    if (tid == 0) {
      for (int i = 0; i < kBwdStages; ++i) mbar_init(&bars[i]);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();  // the barriers are set up before any thread waits on one
  }
  unsigned parity = 0;  // bit i: the phase of bars[i] to wait for next
  const auto stage = [&](int s) { return smem + (s % kBwdStages) * S::STAGE; };
  const auto issue = [&](int s, bool rev) {
    const int t0 = s * K, tn = min(K, C - t0);
    if (tma) {
      if (tid == 0) {
        if (rev) {
          tma_stage<DS, K, CPB, true>(stage(s), &bars[s % kBwdStages], maps, b, d0, t0);
        } else {
          tma_stage<DS, K, CPB, false>(stage(s), &bars[s % kBwdStages], maps, b, d0, t0);
        }
      }
    } else if (rev) {
      stage_steps<S, DS, K, CPB, true>(stage(s), p, b, d0, t0, tn);
    } else {
      stage_steps<S, DS, K, CPB, false>(stage(s), p, b, d0, t0, tn);
    }
  };
  const auto landed = [&](int s) {  // then the barrier of the segment
    cp_async_wait<kBwdStages - 2>();
    if (tma) {
      const int i = s % kBwdStages;
      mbar_wait(&bars[i], (parity >> i) & 1u);
      parity ^= 1u << i;
    }
    __syncthreads();
  };
  const int nseg = (C + K - 1) / K;
  for (int span = (nseg + S::SLOTS - 1) / S::SLOTS - 1; span >= 0; --span) {
    const int seg0 = span * S::SLOTS, seg1 = min(nseg, seg0 + S::SLOTS);
    // forward from h0: the state entering each segment of the span
    float h[NS];
#pragma unroll
    for (int q = 0; q < NS; ++q) h[q] = h0[q];
    for (int s = 0; s < kBwdStages - 1; ++s) {
      if (s < seg1) issue(s, false);
      cp_async_commit();
    }
    for (int sg = 0; sg < seg1; ++sg) {
      landed(sg);
      const int sn = sg + kBwdStages - 1;
      if (sn < seg1) issue(sn, false);
      cp_async_commit();
      if (sg >= seg0) {
#pragma unroll
        for (int q = 0; q < NS; ++q) ck[((sg - seg0) * NS + q) * T + tid] = h[q];
      }
      const int tn = min(K, C - sg * K);
      if (tn == K) {
        advance<S, DS, K, CPB, true>(h, a, stage(sg), g, cl, tn);
      } else {
        advance<S, DS, K, CPB, false>(h, a, stage(sg), g, cl, tn);
      }
    }
    // reverse, segment by segment, last first; past a segment's barrier
    // the last segment's warp sums are complete, and the block adds them
    // while this segment runs (red alternates by segment)
    cp_async_wait<0>();
    __syncthreads();  // every thread is done with the forward pass's stages
    for (int s = seg1 - 1; s > seg1 - kBwdStages; --s) {
      if (s >= seg0) issue(s, true);
      cp_async_commit();
    }
    for (int sg = seg1 - 1; sg >= seg0; --sg) {
      landed(sg);
      const int sn = sg - (kBwdStages - 1);
      if (sn >= seg0) issue(sn, true);
      cp_async_commit();
      if (sg + 1 < seg1) {  // the segment after: the chunk's last may be short
        const int tp = (sg + 1) * K;
        block_sums<S, DS, K>(p, red + ((sg + 1) & 1) * S::RED, tp, min(K, C - tp));
      }
      const int t0 = sg * K, tn = min(K, C - t0);
      float hc[NS];
#pragma unroll
      for (int q = 0; q < NS; ++q) hc[q] = ck[((sg - seg0) * NS + q) * T + tid];
      const long long out0 = (static_cast<long long>(b) * C + t0) * di + d;
      float* rs = red + (sg & 1) * S::RED;
      if (tn == K) {
        reverse_segment<S, DS, K, CPB, true>(p, stage(sg), hc, a, dh, gacc, rs, g, lane, warp,
                                             cl, live, out0, tn);
      } else {
        reverse_segment<S, DS, K, CPB, false>(p, stage(sg), hc, a, dh, gacc, rs, g, lane, warp,
                                              cl, live, out0, tn);
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the first segment's warp sums
    block_sums<S, DS, K>(p, red + (seg0 & 1) * S::RED, seg0 * K, min(K, C - seg0 * K));
  }
  if (live) {
    float* a_out = p.batch == 1 ? p.d_a + static_cast<long long>(d) * ds : p.a_part + chan * ds;
#pragma unroll
    for (int q = 0; q < NS; ++q) {
      const int s = g * NS + q;
      if (s < ds) {
        p.dh0[chan * ds + s] = dh[q];
        a_out[s] = gacc[q];
      }
    }
  }
}

// dC [B, C, ds] and dB from the blocks' partials [B, C, nblk, 2 DS]: a
// block a (b, t), each thread group adding every GROUPS-th block's
// partial in order, then the groups in order. Blocks past B C: dA [di, ds]
// from the batch rows' partials, in batch order.
template <int DS>
__global__ void __launch_bounds__(kBwdSumThreads) ssm_scan_bwd_sum_kernel(
    const float* __restrict__ part, const float* __restrict__ a_part, float* __restrict__ dbm,
    float* __restrict__ dcm, float* __restrict__ d_a, int B, int C, int di, int ds, int nblk) {
  constexpr int W2 = 2 * DS, GROUPS = kBwdSumThreads / W2;
  __shared__ float acc[GROUPS][W2];
  const long long bt = blockIdx.x;
  if (bt < static_cast<long long>(B) * C) {
    const int col = threadIdx.x % W2, grp = threadIdx.x / W2;
    const float* row = part + bt * nblk * W2;
    float sum = 0.f;
    for (int k = grp; k < nblk; k += GROUPS) sum = __fadd_rn(sum, row[k * W2 + col]);
    acc[grp][col] = sum;
    __syncthreads();
    if (threadIdx.x < W2) {
      float tot = 0.f;
#pragma unroll
      for (int k = 0; k < GROUPS; ++k) tot = __fadd_rn(tot, acc[k][col]);
      if (col < DS) {
        if (col < ds) dcm[bt * ds + col] = tot;
      } else if (col - DS < ds) {
        dbm[bt * ds + col - DS] = tot;
      }
    }
    return;
  }
  const long long i = (bt - static_cast<long long>(B) * C) * kBwdSumThreads + threadIdx.x;
  const long long n = static_cast<long long>(di) * ds;
  if (i >= n) return;
  float sum = 0.f;
  for (int k = 0; k < B; ++k) sum = __fadd_rn(sum, a_part[k * n + i]);
  d_a[i] = sum;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled (null where the driver lacks it).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  static bool looked = false;
  if (!looked) {
    looked = true;
    void* entry = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &entry, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(entry);
    }
  }
  return fn;
}

// A float32 tensor map of [n2][n1][n0] with element strides (s2, s1, 1)
// and boxes of [1][b1][b0]; false where a tensor map cannot describe it
// (an unaligned base or stride), and the kernel then stages by cp.async.
bool encode3(CUtensorMap* map, const void* base, long long n0, long long n1, long long n2,
             long long s1, long long s2, int b0, int b1) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr || reinterpret_cast<uintptr_t>(base) % 16 != 0 || s1 <= 0 || s2 <= 0 ||
      s1 % 4 != 0 || s2 % 4 != 0) {
    return false;
  }
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(n0), static_cast<cuuint64_t>(n1),
                              static_cast<cuuint64_t>(n2)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(s1) * 4,
                                 static_cast<cuuint64_t>(s2) * 4};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(b0), static_cast<cuuint32_t>(b1), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(base), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DS, int G, int K, int CPB>
cudaError_t launch_scan_bwd(ScanBwdArgs args, float* dbm, float* dcm, cudaStream_t s) {
  // tensor maps of the operands where they allow one (boxes of K steps)
  const int B = args.batch, C = args.C, di = args.di, ds = args.ds;
  ScanBwdMaps maps{};
  args.tma =
      C > 0 &&
      encode3(&maps.dt, args.dt, di, C, B, args.dt_st, B > 1 ? args.dt_sb : C * args.dt_st, CPB,
              K) &&
      encode3(&maps.xh, args.xh, di, C, B, args.xh_st, B > 1 ? args.xh_sb : C * args.xh_st, CPB,
              K) &&
      encode3(&maps.dy, args.dy, di, C, B, di, static_cast<long long>(C) * di, CPB, K) &&
      encode3(&maps.bm, args.bm, ds, C, B, args.b_st, B > 1 ? args.b_sb : C * args.b_st, DS, K) &&
      encode3(&maps.cm, args.cm, ds, C, B, args.c_st, B > 1 ? args.c_sb : C * args.c_st, DS, K);
  using S = BwdShape<DS, G, K, CPB>;
  static_assert(S::bytes(S::SLOTS) <= kMaxSmem, "a block's shared memory");
  static bool sized = false;  // the kernel's dynamic shared memory limit, set once
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(ssm_scan_bwd_kernel<DS, G, K, CPB>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(S::bytes(S::SLOTS)));
    if (err != cudaSuccess) return err;
    sized = true;
  }
  const int nseg = (args.C + K - 1) / K;
  const int slots = nseg < S::SLOTS ? nseg : S::SLOTS;
  const dim3 grid(args.nblk, args.batch);
  ssm_scan_bwd_kernel<DS, G, K, CPB><<<grid, S::THREADS, S::bytes(slots), s>>>(args, maps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n_a = static_cast<long long>(args.di) * args.ds;
  const long long blocks = static_cast<long long>(args.batch) * args.C +
                           (args.batch > 1 ? (n_a + kBwdSumThreads - 1) / kBwdSumThreads : 0);
  if (blocks > 0) {
    ssm_scan_bwd_sum_kernel<DS><<<static_cast<unsigned>(blocks), kBwdSumThreads, 0, s>>>(
        args.part, args.a_part, dbm, dcm, args.d_a, args.batch, args.C, args.di, args.ds,
        args.nblk);
    err = cudaGetLastError();
  }
  return err;
}

// Channels a block at the width that holds ds states (0: ds too wide).
int bwd_channels(int ds) { return ds <= 16 ? kBwd16[2] : ds <= 32 ? kBwd32[2] : 0; }

}  // namespace
}  // namespace repro_torch

// Floats of scratch repro_ssm_scan_chunk_bwd needs: the blocks' partials
// [B, C, ceil(di / channels a block), 2 * compiled width], then for B > 1
// the batch rows' dA [B, di, ds]. Written to *floats (a long long).
extern "C" int repro_ssm_scan_chunk_bwd_scratch(int B, int C, int di, int ds, void* floats) {
  const int cpb = repro_torch::bwd_channels(ds);
  if (cpb == 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long width = ds <= 16 ? 16 : 32;
  const long long nblk = (di + cpb - 1) / cpb;
  *static_cast<long long*>(floats) = static_cast<long long>(B) * C * nblk * 2 * width +
                                     (B > 1 ? static_cast<long long>(B) * di * ds : 0);
  return 0;
}

// Inputs as repro_ssm_scan_chunk takes them (element strides (batch, time)
// of dt, xh, B and C, unit stride along their last axes; A and h0
// contiguous); dy [B, C, di] and dh_last [B, di, ds] contiguous; outputs
// d dt, dx [B, C, di], dB, dC [B, C, ds], dA [di, ds], dh0 [B, di, ds]
// contiguous; scratch as repro_ssm_scan_chunk_bwd_scratch sizes it. ds <= 32.
extern "C" int repro_ssm_scan_chunk_bwd(
    const void* dt, const void* xh, const void* bm, const void* cm, const void* A,
    const void* h0, const void* dy, const void* dh_last, void* ddt, void* dxh, void* dbm,
    void* dcm, void* d_a, void* dh0, void* scratch, int B, int C, int di, int ds,
    long long dt_sb, long long dt_st, long long xh_sb, long long xh_st, long long b_sb,
    long long b_st, long long c_sb, long long c_st, void* stream) {
  using namespace repro_torch;
  const int cpb = bwd_channels(ds);
  if (cpb == 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto a16 = [](const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; };
  const bool vec_ch = a16(dt) && a16(xh) && a16(dy) && di % 4 == 0 &&
                      (dt_sb | dt_st | xh_sb | xh_st) % 4 == 0;
  const bool vec_bc = a16(bm) && a16(cm) && ds % 4 == 0 && (b_sb | b_st | c_sb | c_st) % 4 == 0;
  const int nblk = (di + cpb - 1) / cpb;
  const int width = ds <= 16 ? 16 : 32;
  auto* part = static_cast<float*>(scratch);
  ScanBwdArgs args{static_cast<const float*>(dt), static_cast<const float*>(xh),
                   static_cast<const float*>(bm), static_cast<const float*>(cm),
                   static_cast<const float*>(A),  static_cast<const float*>(h0),
                   static_cast<const float*>(dy), static_cast<const float*>(dh_last),
                   static_cast<float*>(ddt),      static_cast<float*>(dxh),
                   static_cast<float*>(dh0),      static_cast<float*>(d_a),
                   part,
                   part + static_cast<long long>(B) * C * nblk * 2 * width,
                   B, C, di, ds, nblk, dt_sb, dt_st, xh_sb, xh_st, b_sb, b_st, c_sb, c_st,
                   vec_ch ? 1 : 0, vec_bc ? 1 : 0, 0};
  const auto s = static_cast<cudaStream_t>(stream);
  auto* fb = static_cast<float*>(dbm);
  auto* fc = static_cast<float*>(dcm);
  cudaError_t err;
  if (ds <= 16) {
    err = launch_scan_bwd<16, kBwd16[0], kBwd16[1], kBwd16[2]>(args, fb, fc, s);
  } else {
    err = launch_scan_bwd<32, kBwd32[0], kBwd32[1], kBwd32[2]>(args, fb, fc, s);
  }
  return static_cast<int>(err);
}
