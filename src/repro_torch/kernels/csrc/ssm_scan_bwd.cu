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
// repro_torch.kernels.ref.ssm_scan_chunk_bwd_ref.
//
// Bound on the H100 at the jamba chunk (B 1, C 256, di 16384, ds 16):
// bytes and exps alike. It must read dt, x, dy (16.8 MB each) and write
// d dt, dx (16.8 MB each), 84 MB = 25 us at 3.35 TB/s; it takes B C di ds
// = 67 M exps, 16 us at the MUFU rate, and some 20 issue slots per (t, d,
// s) on top.
//
// Design. One thread a channel (b, d), its ds states, their gradients and
// dA's partial sum in registers; 128 channels a block. h_{t-1} cannot be
// had from h_t by dividing the recurrence (exp(dt A) underflows), so a
// forward pass first recomputes the states, with the forward kernel's
// roundings (h is bit-identical to its), and writes the state entering
// every step to a scratch [B, C, ds, di] (coalesced over the channels);
// the reverse pass reads them back. The sums across channels (dB_t, dC_t)
// are reduced within each warp by a transposed butterfly, 31 shuffles for
// 32 values, lane l ending with value l, and written as one partial per
// warp and step; dA's partial per batch row. A second launch adds the
// partials in a fixed order (warps, then batch rows): no atomics, the
// gradients are deterministic.
#include <cuda_runtime.h>

namespace repro_torch {

constexpr int kScanBwdThreads = 128;   // channels a block
constexpr int kScanBwdSlots = 64;      // 2 * ops.MAX_SCAN_STATE per partial

// v[i] summed over the warp's lanes lands in lane i (32 values).
__device__ __forceinline__ float transpose_reduce32(float (&v)[32], int lane) {
#pragma unroll
  for (int w = 16; w >= 1; w >>= 1) {
    const bool upper = (lane & w) != 0;
#pragma unroll
    for (int i = 0; i < w; ++i) {
      const float send = upper ? v[i] : v[i + w];
      const float keep = upper ? v[i + w] : v[i];
      v[i] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, w));
    }
  }
  return v[0];
}

struct ScanBwdArgs {
  const float *dt, *xh, *bm, *cm, *A, *h0, *dy, *dh_last;
  float *ddt, *dxh, *hs, *part, *a_part, *dh0;
  int C, di, ds;
  long long dt_sb, dt_st, xh_sb, xh_st, b_sb, b_st, c_sb, c_st;
};

template <int DS>
__global__ void __launch_bounds__(kScanBwdThreads)
ssm_scan_bwd_kernel(const ScanBwdArgs p) {
  const int b = blockIdx.y, lane = threadIdx.x % 32;
  const int d = blockIdx.x * kScanBwdThreads + threadIdx.x;
  const bool live = d < p.di;
  const int di = p.di, ds = p.ds, C = p.C;
  const int warps = (di + 31) / 32, warp = d / 32;
  const long long chan = static_cast<long long>(b) * di + d;
  float a[DS], h[DS];
#pragma unroll
  for (int s = 0; s < DS; ++s) {
    a[s] = live && s < ds ? p.A[static_cast<long long>(d) * ds + s] : 0.f;
    h[s] = live && s < ds ? p.h0[chan * ds + s] : 0.f;
  }
  const float* dt_b = p.dt + b * p.dt_sb;
  const float* xh_b = p.xh + b * p.xh_sb;
  const float* bm_b = p.bm + b * p.b_sb;
  const float* cm_b = p.cm + b * p.c_sb;
  float* hs_b = p.hs + static_cast<long long>(b) * C * ds * di;

  // forward: the state entering each step
  for (int t = 0; t < C; ++t) {
    const float dtv = live ? dt_b[t * p.dt_st + d] : 0.f;
    const float xv = live ? xh_b[t * p.xh_st + d] : 0.f;
    const float dtx = __fmul_rn(dtv, xv);
#pragma unroll
    for (int s = 0; s < DS; ++s) {
      if (s < ds) {
        if (live) hs_b[(static_cast<long long>(t) * ds + s) * di + d] = h[s];
        const float da = expf(__fmul_rn(dtv, a[s]));
        h[s] = __fadd_rn(__fmul_rn(h[s], da), __fmul_rn(dtx, bm_b[t * p.b_st + s]));
      }
    }
  }

  // reverse
  float dh[DS], gacc[DS];
#pragma unroll
  for (int s = 0; s < DS; ++s) {
    dh[s] = live && s < ds ? p.dh_last[chan * ds + s] : 0.f;
    gacc[s] = 0.f;
  }
  for (int t = C - 1; t >= 0; --t) {
    const float dtv = live ? dt_b[t * p.dt_st + d] : 0.f;
    const float xv = live ? xh_b[t * p.xh_st + d] : 0.f;
    const float dyv = live ? p.dy[(static_cast<long long>(b) * C + t) * di + d] : 0.f;
    const float dtx = __fmul_rn(dtv, xv);
    float dcv[DS], dbv[DS];
    float gb = 0.f, ga = 0.f;
#pragma unroll
    for (int s = 0; s < DS; ++s) {
      dcv[s] = dbv[s] = 0.f;
      if (s < ds) {
        const float hp = live ? hs_b[(static_cast<long long>(t) * ds + s) * di + d] : 0.f;
        const float bv = bm_b[t * p.b_st + s], cv = cm_b[t * p.c_st + s];
        const float da = expf(__fmul_rn(dtv, a[s]));
        const float ht = __fadd_rn(__fmul_rn(hp, da), __fmul_rn(dtx, bv));
        const float g = __fadd_rn(dh[s], __fmul_rn(dyv, cv));
        dcv[s] = __fmul_rn(dyv, ht);
        dbv[s] = __fmul_rn(g, dtx);
        gb = fmaf(g, bv, gb);
        const float gda = __fmul_rn(__fmul_rn(g, hp), da);
        ga = fmaf(gda, a[s], ga);
        gacc[s] = fmaf(gda, dtv, gacc[s]);
        dh[s] = __fmul_rn(g, da);
      }
    }
    if (live) {
      const long long o = (static_cast<long long>(b) * C + t) * di + d;
      p.ddt[o] = fmaf(xv, gb, ga);
      p.dxh[o] = __fmul_rn(dtv, gb);
    }
    // the warp's sums of dC_t and dB_t (dead lanes add zeros; a warp
    // wholly past di writes none)
    if (warp >= warps) continue;
    float* out = p.part + ((static_cast<long long>(b) * C + t) * warps + warp) * kScanBwdSlots;
    if (DS == 16) {
      float v[32];
#pragma unroll
      for (int s = 0; s < 16; ++s) {
        v[s] = dcv[s];
        v[16 + s] = dbv[s];
      }
      out[lane] = transpose_reduce32(v, lane);
    } else {
      float v[32];
#pragma unroll
      for (int s = 0; s < 32; ++s) v[s] = dcv[s % DS];
      out[lane] = transpose_reduce32(v, lane);
#pragma unroll
      for (int s = 0; s < 32; ++s) v[s] = dbv[s % DS];
      out[32 + lane] = transpose_reduce32(v, lane);
    }
  }
  if (live) {
#pragma unroll
    for (int s = 0; s < DS; ++s) {
      if (s < ds) {
        p.dh0[chan * ds + s] = dh[s];
        p.a_part[chan * ds + s] = gacc[s];
      }
    }
  }
}

// dC [B, C, ds] and dB from the per-warp partials (slots [dC_0..DS-1,
// dB_0..DS-1] of each), in warp order.
__global__ void ssm_scan_bwd_bc_kernel(const float* __restrict__ part,
                                       float* __restrict__ dbm,
                                       float* __restrict__ dcm, int B, int C,
                                       int ds, int warps, int half) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(B) * C * ds) return;
  const long long bt = i / ds;
  const int s = static_cast<int>(i % ds);
  const float* pp = part + bt * warps * kScanBwdSlots;
  float c_sum = 0.f, b_sum = 0.f;
  for (int w = 0; w < warps; ++w) {
    c_sum = __fadd_rn(c_sum, pp[w * kScanBwdSlots + s]);
    b_sum = __fadd_rn(b_sum, pp[w * kScanBwdSlots + half + s]);
  }
  dcm[i] = c_sum;
  dbm[i] = b_sum;
}

// dA [di, ds] from the batch rows' partials, in batch order.
__global__ void ssm_scan_bwd_a_kernel(const float* __restrict__ a_part,
                                      float* __restrict__ d_a, int B, int di,
                                      int ds) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long n = static_cast<long long>(di) * ds;
  if (i >= n) return;
  float acc = 0.f;
  for (int b = 0; b < B; ++b) acc = __fadd_rn(acc, a_part[b * n + i]);
  d_a[i] = acc;
}

template <int DS>
cudaError_t launch_scan_bwd(const ScanBwdArgs& args, int B, float* dbm,
                            float* dcm, float* d_a, cudaStream_t s) {
  const dim3 grid((args.di + kScanBwdThreads - 1) / kScanBwdThreads, B);
  ssm_scan_bwd_kernel<DS><<<grid, kScanBwdThreads, 0, s>>>(args);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n_bc = static_cast<long long>(B) * args.C * args.ds;
  if (n_bc > 0) {
    ssm_scan_bwd_bc_kernel<<<static_cast<unsigned>((n_bc + 255) / 256), 256, 0, s>>>(
        args.part, dbm, dcm, B, args.C, args.ds, (args.di + 31) / 32, DS);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const long long n_a = static_cast<long long>(args.di) * args.ds;
  ssm_scan_bwd_a_kernel<<<static_cast<unsigned>((n_a + 255) / 256), 256, 0, s>>>(
      args.a_part, d_a, B, args.di, args.ds);
  return cudaGetLastError();
}

}  // namespace repro_torch

// Inputs as repro_ssm_scan_chunk takes them (element strides (batch, time)
// of dt, xh, B and C; A and h0 contiguous); dy [B, C, di] and dh_last [B,
// di, ds] contiguous; outputs d dt, dx [B, C, di], dB, dC [B, C, ds], dA
// [di, ds], dh0 [B, di, ds] contiguous. Scratch: hs [B, C, ds, di], part
// [B, C, ceil(di/32), 64], a_part [B, di, ds]. ds <= 32.
extern "C" int repro_ssm_scan_chunk_bwd(
    const void* dt, const void* xh, const void* bm, const void* cm,
    const void* A, const void* h0, const void* dy, const void* dh_last,
    void* ddt, void* dxh, void* dbm, void* dcm, void* d_a, void* dh0, void* hs,
    void* part, void* a_part, int B, int C, int di, int ds, long long dt_sb,
    long long dt_st, long long xh_sb, long long xh_st, long long b_sb,
    long long b_st, long long c_sb, long long c_st, void* stream) {
  using namespace repro_torch;
  const ScanBwdArgs args{
      static_cast<const float*>(dt), static_cast<const float*>(xh),
      static_cast<const float*>(bm), static_cast<const float*>(cm),
      static_cast<const float*>(A),  static_cast<const float*>(h0),
      static_cast<const float*>(dy), static_cast<const float*>(dh_last),
      static_cast<float*>(ddt),      static_cast<float*>(dxh),
      static_cast<float*>(hs),       static_cast<float*>(part),
      static_cast<float*>(a_part),   static_cast<float*>(dh0),
      C, di, ds, dt_sb, dt_st, xh_sb, xh_st, b_sb, b_st, c_sb, c_st};
  const auto s = static_cast<cudaStream_t>(stream);
  auto* fb = static_cast<float*>(dbm);
  auto* fc = static_cast<float*>(dcm);
  auto* fa = static_cast<float*>(d_a);
  cudaError_t err;
  if (ds <= 16) {
    err = launch_scan_bwd<16>(args, B, fb, fc, fa, s);
  } else if (ds <= 32) {
    err = launch_scan_bwd<32>(args, B, fb, fc, fa, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
