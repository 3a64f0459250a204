// Mamba S6 selective scan over one chunk, carrying the state h:
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t,   y_t = sum_n h_t[:, n] * C_t[n]
// for dt, x [B, C, di], B_t, C_t [B, C, ds], A [di, ds], h0 [B, di, ds],
// all float32 -> y [B, C, di] and h_last [B, di, ds] (both contiguous).
//
// Replaces the Pallas kernel `ssm_scan_chunk` (src/repro/kernels/ssm_scan.py,
// pallas_call at :70). Plain twin: repro_torch.kernels.ref.ssm_scan_chunk_ref;
// this kernel's order of work in plain torch: ref.ssm_scan_chunk_chain.
//
// Bound on the H100 at the jamba prefill chunk (B 4, C 256, di 16384, ds
// 16): operations. It moves 211 MB (dt, x, y 67 MB each, h0/h_last 4 MB
// each, A 1 MB) = 63 us at 3.35 TB/s, and takes 268 M exps = 64 us at 16
// MUFU.EX2 per clock per SM (132 SMs, 1.98 GHz). The issue slots are
// scarcer still: each (t, d, n) issues the exp's argument, expf's eight
// instructions (its range reduction, the MUFU.EX2 and the scaling), dbx,
// h*da, + and y's fma, 13 in all, ~118 us for the prefill chunk at one
// instruction a clock per scheduler (1.755 GHz under load).
//
// Design. On the TPU the di/128 grid axis is the parallelism and t a
// sequential loop over a VMEM-resident tile. Here the t loop stays
// sequential, and each channel (b, d) is split over G lanes of a warp,
// eight states a lane (G = ds / 8 for the compiled widths 16 and 32, one
// lane at ds <= 8; B_t and C_t of a lane are two float4 each). A lane
// keeps its states h and A in registers. The arithmetic is the twin's
// where it can be: da = expf(dt * A) rounds as torch.exp on the card and
// the update h*da + dbx uses __fmul_rn/__fadd_rn (no FMA contraction), so
// h is bit-identical to the twin's; y is one fma chain over the states in
// order, as with one thread a channel (the kernel's outputs are
// bit-identical to that design's), carried from lane to lane by shuffle.
// The bf16 jamba prefill amplifies ulps of y into its logits: with
// ex2.approx for the exps (1.5x faster at the prefill chunk), or with y
// summed as a tree over the lanes, its logits left the kernel-vs-twin
// tolerance of chip_smoke.py (JAMBA_LOGIT_TOL). Measured at the prefill
// chunk (scripts/kernel_ablation.py): 2 lanes a channel beat 1 (too few
// warps), 4 and 8 (each lane runs all G passes of the chain).
// dt and x are loaded once per channel: lane l of a warp loads step
// l / (32/G) of channel l % (32/G) of a group of G steps (kScanLoads
// groups ahead of use, through running pointers), and each step's values
// are broadcast to the channel's lanes by shuffle. A group whose steps all
// lie in the chunk is one branch-free block, so its steps' exps and loads
// can issue ahead of the dependent updates. B_t and C_t rows are staged in
// shared memory kScanTile steps at a time with cp.async, double-buffered:
// the next tile lands while this one is read. Ragged di is masked per lane
// (dead lanes still take part in the shuffles); ds is padded to the
// compiled width with A = B = C = 0 (those states stay 0 and add exact
// zeros to the chain). Operands are read through their batch and time
// strides, so the chunk views of a [B, S, di] sequence (batch stride S*di)
// and of the x_proj output (B and C are column slices) are read in place.
// y differs from the twin's torch.sum by float32 rounding (held to
// rtol/atol 1e-5).
#include <cuda_runtime.h>

#include "mma.cuh"

namespace repro_torch {

constexpr int kScanThreads = 256;  // a block: kScanThreads / G channels
constexpr int kScanTile = 64;      // time steps of B_t, C_t a stage
constexpr int kScanLoads = 4;      // groups of G steps of dt, x loaded ahead
constexpr int kScanMinBlocks = 3;  // blocks an SM (at most 85 registers a thread)
constexpr bool kScanEx2 = false;   // exp as ex2.approx of dt * (A log2 e), not expf
constexpr float kLog2e = 1.4426950408889634f;

struct ScanArgs {
  const float *dt, *xh, *bm, *cm, *A, *h0;
  float *y, *h_out;
  int C, di, ds;
  long long dt_sb, dt_st, xh_sb, xh_st, b_sb, b_st, c_sb, c_st;
  int vec_bc;  // B and C rows in 16-byte pieces (ds % 4 == 0, aligned)
};

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// NS consecutive floats of shared memory, in the widest loads they allow
// (float2 only where 8 lanes share 16 states).
template <int NS>
__device__ __forceinline__ void load_row(float (&v)[NS], const float* p) {
  static_assert(NS % 2 == 0, "a lane holds an even number of states");
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

// Rows [t0, t0 + tn) of one batch element's B (or C) into s[tt][n], n < ds.
template <int DS>
__device__ __forceinline__ void stage_rows(float (*s)[DS], const float* src, long long st,
                                           int t0, int tn, int ds, bool vec) {
  if (vec) {
    const int per = ds / 4;
    for (int i = threadIdx.x; i < tn * per; i += kScanThreads) {
      const int tt = i / per, n = (i - tt * per) * 4;
      cp_async16(&s[tt][n], src + (t0 + tt) * st + n, 16);
    }
  } else {
    for (int i = threadIdx.x; i < tn * ds; i += kScanThreads) {
      const int tt = i / ds, n = i - tt * ds;
      cp_async4(&s[tt][n], src + (t0 + tt) * st + n, true);
    }
  }
}

// The next L groups of G steps of the lane's dt and x loads (zeros past
// the chunk or di), advancing its pointers and step by L groups.
template <int L, int G>
__device__ __forceinline__ void load_groups(float (&dv)[L], float (&xv)[L], const float*& dq,
                                            const float*& xq, long long dgs, long long xgs,
                                            int& tq, int C, bool on_d) {
#pragma unroll
  for (int u = 0; u < L; ++u) {
    const bool on = on_d && tq < C;
    dv[u] = on ? *dq : 0.f;
    xv[u] = on ? *xq : 0.f;
    dq += dgs;
    xq += xgs;
    tq += G;
  }
}

// One group of G steps of a lane: rows rb, rc of the staged B and C at
// the group's first step (the lane's states), its dt and x in lane
// q * (32/G) + ch of dv, xv for step q. kFull: all G steps lie in the
// chunk, and the group is one branch-free block; else only the first
// `left`. y of a step is one fma chain over the channel's states in order
// (the parent kernel's, with one thread a channel): lane 0 runs it over
// its states from 0, hands it to lane 1 by shuffle, and so on; every lane
// runs each of the G passes (G - 1 of them idle work), and lane G - 1
// stores y of step q to yq[q * di].
template <int DS, int G, bool kFull>
__device__ __forceinline__ void scan_group(float (&h)[DS / G], const float (&a)[DS / G],
                                           const float* rb, const float* rc, float dv,
                                           float xv, int ch, int g, int left, float* yq,
                                           int di, bool live) {
  constexpr int NS = DS / G, CPW = 32 / G;
#pragma unroll
  for (int q = 0; q < G; ++q) {
    if (kFull || q < left) {
      const float dtv = G == 1 ? dv : __shfl_sync(0xffffffffu, dv, q * CPW + ch);
      const float xq = G == 1 ? xv : __shfl_sync(0xffffffffu, xv, q * CPW + ch);
      float bv[NS], cv[NS], da[NS];
      load_row<NS>(bv, rb + q * DS);
      load_row<NS>(cv, rc + q * DS);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        da[j] = kScanEx2 ? ex2_approx(__fmul_rn(dtv, a[j])) : expf(__fmul_rn(dtv, a[j]));
      }
      const float dtx = __fmul_rn(dtv, xq);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const float dbx = __fmul_rn(dtx, bv[j]);
        h[j] = __fadd_rn(__fmul_rn(h[j], da[j]), dbx);
      }
      float acc = 0.f, y = 0.f;
#pragma unroll
      for (int k = 0; k < G; ++k) {
        y = acc;
#pragma unroll
        for (int j = 0; j < NS; ++j) y = fmaf(h[j], cv[j], y);
        if (k + 1 < G) acc = __shfl_up_sync(0xffffffffu, y, 1, G);
      }
      if (live && g == G - 1) yq[q * di] = y;
    }
  }
}

template <int DS, int G>
__global__ void __launch_bounds__(kScanThreads, kScanMinBlocks) ssm_scan_kernel(ScanArgs p) {
  constexpr int NS = DS / G;                 // states a lane
  constexpr int CPW = 32 / G;                // channels a warp
  constexpr int CPB = kScanThreads / G;      // channels a block
  constexpr int STEPS = G * kScanLoads;      // steps of one round of dt, x loads
  static_assert(kScanTile % STEPS == 0, "a tile holds whole rounds of loads");
  __shared__ __align__(16) float sB[2][kScanTile][DS];
  __shared__ __align__(16) float sC[2][kScanTile][DS];
  const int C = p.C, di = p.di, ds = p.ds;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane % G;                    // the lane's slice of the states
  const int ch = lane / G;                   // its channel in the warp
  const int b = blockIdx.y;
  const int dwarp = blockIdx.x * CPB + warp * CPW;
  const int d = dwarp + ch;
  const bool live = d < di;

  const long long state = (static_cast<long long>(b) * di + d) * ds + g * NS;
  float a[NS], h[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const bool on = live && g * NS + j < ds;
    const float av = on ? p.A[static_cast<long long>(d) * ds + g * NS + j] : 0.f;
    a[j] = kScanEx2 ? __fmul_rn(av, kLog2e) : av;
    h[j] = on ? p.h0[state + j] : 0.f;
  }
  // The padded states' B and C columns stay 0 (the copies write n < ds).
  for (int i = threadIdx.x; i < 2 * kScanTile * DS; i += kScanThreads) {
    if (i % DS >= ds) {
      (&sB[0][0][0])[i] = 0.f;
      (&sC[0][0][0])[i] = 0.f;
    }
  }
  const float* bp = p.bm + b * p.b_sb;
  const float* cp = p.cm + b * p.c_sb;
  const bool vec = p.vec_bc != 0;
  // The lane's loads of dt and x: channel dwarp + lane % CPW, step
  // lane / CPW of each group of G steps, through running pointers; yq: its
  // channel's y at the first step of the next group.
  const int ld_d = dwarp + lane % CPW;
  int tq = lane / CPW;
  const float* dq = p.dt + b * p.dt_sb + ld_d + tq * p.dt_st;
  const float* xq = p.xh + b * p.xh_sb + ld_d + tq * p.xh_st;
  const long long dgs = G * p.dt_st, xgs = G * p.xh_st;
  float* yq = p.y + static_cast<long long>(b) * C * di + d;
  const long long ygs = static_cast<long long>(G) * di;

  const int tiles = (C + kScanTile - 1) / kScanTile;
  if (tiles > 0) {
    stage_rows<DS>(sB[0], bp, p.b_st, 0, min(kScanTile, C), ds, vec);
    stage_rows<DS>(sC[0], cp, p.c_st, 0, min(kScanTile, C), ds, vec);
  }
  cp_async_commit();
  float dcur[kScanLoads], xcur[kScanLoads];
  load_groups<kScanLoads, G>(dcur, xcur, dq, xq, dgs, xgs, tq, C, ld_d < di);

  for (int tile = 0; tile < tiles; ++tile) {
    const int t0 = tile * kScanTile, tn = min(kScanTile, C - t0);
    if (tile + 1 < tiles) {
      const int t1 = t0 + kScanTile, tn1 = min(kScanTile, C - t1);
      stage_rows<DS>(sB[(tile + 1) & 1], bp, p.b_st, t1, tn1, ds, vec);
      stage_rows<DS>(sC[(tile + 1) & 1], cp, p.c_st, t1, tn1, ds, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // this tile's rows have landed for every thread
    const float* rb = &sB[tile & 1][0][g * NS];
    const float* rc = &sC[tile & 1][0][g * NS];
    for (int s0 = 0; s0 < tn; s0 += STEPS) {
      float dnxt[kScanLoads], xnxt[kScanLoads];
      load_groups<kScanLoads, G>(dnxt, xnxt, dq, xq, dgs, xgs, tq, C, ld_d < di);
      if (s0 + STEPS <= tn) {
#pragma unroll
        for (int u = 0; u < kScanLoads; ++u) {
          scan_group<DS, G, true>(h, a, rb + u * G * DS, rc + u * G * DS, dcur[u], xcur[u],
                                  ch, g, G, yq, di, live);
          yq += ygs;
        }
      } else {  // the chunk's last, partial round
#pragma unroll
        for (int u = 0; u < kScanLoads; ++u) {
          scan_group<DS, G, false>(h, a, rb + u * G * DS, rc + u * G * DS, dcur[u], xcur[u],
                                   ch, g, tn - s0 - u * G, yq, di, live);
          yq += ygs;
        }
      }
      rb += STEPS * DS;
      rc += STEPS * DS;
#pragma unroll
      for (int u = 0; u < kScanLoads; ++u) {
        dcur[u] = dnxt[u];
        xcur[u] = xnxt[u];
      }
    }
    __syncthreads();  // every thread is done with this stage before it refills
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      if (g * NS + j < ds) p.h_out[state + j] = h[j];
    }
  }
}

template <int DS, int G>
cudaError_t launch(const ScanArgs& args, int B, cudaStream_t stream) {
  constexpr int CPB = kScanThreads / G;
  const dim3 grid((args.di + CPB - 1) / CPB, B);
  ssm_scan_kernel<DS, G><<<grid, kScanThreads, 0, stream>>>(args);
  return cudaGetLastError();
}

}  // namespace repro_torch

// Element strides (batch, time) of dt, xh, B and C; the last axis of each
// is unit-stride, A and h0 are contiguous. ds <= 32.
extern "C" int repro_ssm_scan_chunk(
    const void* dt, const void* xh, const void* bm, const void* cm,
    const void* A, const void* h0, void* y, void* h_out, int B, int C, int di,
    int ds, long long dt_sb, long long dt_st, long long xh_sb, long long xh_st,
    long long b_sb, long long b_st, long long c_sb, long long c_st,
    void* stream) {
  using namespace repro_torch;
  const bool aligned = reinterpret_cast<uintptr_t>(bm) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(cm) % 16 == 0 && ds % 4 == 0 &&
                       (b_sb | b_st | c_sb | c_st) % 4 == 0;
  const ScanArgs args{static_cast<const float*>(dt), static_cast<const float*>(xh),
                      static_cast<const float*>(bm), static_cast<const float*>(cm),
                      static_cast<const float*>(A),  static_cast<const float*>(h0),
                      static_cast<float*>(y),        static_cast<float*>(h_out),
                      C, di, ds, dt_sb, dt_st, xh_sb, xh_st, b_sb, b_st, c_sb, c_st,
                      aligned ? 1 : 0};
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (ds <= 4) {
    err = launch<4, 1>(args, B, s);
  } else if (ds <= 8) {
    err = launch<8, 1>(args, B, s);
  } else if (ds <= 16) {
    err = launch<16, 2>(args, B, s);
  } else if (ds <= 32) {
    err = launch<32, 4>(args, B, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
