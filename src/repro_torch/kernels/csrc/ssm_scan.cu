// Mamba S6 selective scan over one chunk, carrying the state h:
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t,   y_t = sum_n h_t[:, n] * C_t[n]
// for dt, x [B, C, di], B_t, C_t [B, C, ds], A [di, ds], h0 [B, di, ds],
// all float32 -> y [B, C, di] and h_last [B, di, ds] (both contiguous).
//
// Replaces the Pallas kernel `ssm_scan_chunk` (src/repro/kernels/ssm_scan.py,
// pallas_call at :70). Plain twin: repro_torch.kernels.ref.ssm_scan_chunk_ref.
//
// Bound on the H100 at the jamba prefill chunk (B 4, C 256, di 16384, ds
// 16): operations. It moves 211 MB (dt, x, y 67 MB each, h0/h_last 4 MB
// each, A 1 MB) = 63 us at 3.35 TB/s, and takes 268 M exps = 64 us at 16
// MUFU.EX2 per clock per SM (132 SMs, 1.98 GHz); expf's range reduction
// and the 6 FP32 operations of each (t, d, n) come on top, in the FP32
// pipe.
//
// Design. On the TPU the di/128 grid axis is the parallelism and t a
// sequential loop over a VMEM-resident tile. Here one thread owns one
// (b, d) and keeps its ds states h[n] and A[d, n] in registers across the
// whole chunk: the t loop is sequential per thread, the 16 n are
// independent chains, and the exps of a step, which do not depend on h,
// are all issued before the step's dependent multiply-adds. A block is 128
// consecutive d of one batch element: dt and x are read, and y written,
// coalesced along d; the block stages its batch element's B_t, C_t rows
// in shared memory 64 steps at a time (every thread reads the same
// address: broadcast). Loads of dt and x for 8 steps are in flight
// together. Ragged di is masked per thread and ds is padded to the
// template's width with A = B = C = 0 (those states stay 0). Operands are
// read through their batch and time strides, so the chunk views of a
// [B, S, di] sequence (batch stride S*di) and of the x_proj output (B and
// C are column slices) are read in place. The update h*da + dbx uses
// __fmul_rn/__fadd_rn (no FMA contraction), so it rounds where the twin's
// separate torch ops round; y's sum over n runs in another order than
// torch.sum (held to rtol/atol 1e-5).
#include <cuda_runtime.h>

namespace repro_torch {

constexpr int kScanThreads = 128;  // d per block
constexpr int kScanTile = 64;      // time steps of B_t, C_t staged per pass
constexpr int kScanLoads = 8;      // time steps of dt, x loaded together

template <int DS>
__global__ void __launch_bounds__(kScanThreads)
ssm_scan_kernel(const float* __restrict__ dt, const float* __restrict__ xh,
                const float* __restrict__ bm, const float* __restrict__ cm,
                const float* __restrict__ A, const float* __restrict__ h0,
                float* __restrict__ y, float* __restrict__ h_out, int C, int di,
                int ds, long long dt_sb, long long dt_st, long long xh_sb,
                long long xh_st, long long b_sb, long long b_st,
                long long c_sb, long long c_st) {
  __shared__ float sB[kScanTile][DS];
  __shared__ float sC[kScanTile][DS];
  const int b = blockIdx.y;
  const int d = blockIdx.x * kScanThreads + threadIdx.x;
  const bool live = d < di;
  const long long state = (static_cast<long long>(b) * di + d) * ds;
  float a[DS], h[DS];
#pragma unroll
  for (int n = 0; n < DS; ++n) {
    const bool on = live && n < ds;
    a[n] = on ? A[static_cast<long long>(d) * ds + n] : 0.f;
    h[n] = on ? h0[state + n] : 0.f;
  }
  const float* dtp = dt + b * dt_sb + d;
  const float* xhp = xh + b * xh_sb + d;
  float* yp = y + static_cast<long long>(b) * C * di + d;
  const float* bp = bm + b * b_sb;
  const float* cp = cm + b * c_sb;

  for (int t0 = 0; t0 < C; t0 += kScanTile) {
    const int tn = min(kScanTile, C - t0);
    __syncthreads();  // every thread is done with the previous tile
    for (int i = threadIdx.x; i < kScanTile * DS; i += kScanThreads) {
      const int tt = i / DS, n = i % DS;
      const bool on = tt < tn && n < ds;
      const long long t = t0 + tt;
      sB[tt][n] = on ? bp[t * b_st + n] : 0.f;
      sC[tt][n] = on ? cp[t * c_st + n] : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    for (int s0 = 0; s0 < tn; s0 += kScanLoads) {
      float dtv[kScanLoads], xv[kScanLoads];
#pragma unroll
      for (int q = 0; q < kScanLoads; ++q) {
        const long long t = t0 + s0 + q;
        const bool on = s0 + q < tn;
        dtv[q] = on ? dtp[t * dt_st] : 0.f;
        xv[q] = on ? xhp[t * xh_st] : 0.f;
      }
#pragma unroll
      for (int q = 0; q < kScanLoads; ++q) {
        const int tt = s0 + q;
        if (tt >= tn) break;
        float da[DS];
#pragma unroll
        for (int n = 0; n < DS; ++n) da[n] = expf(__fmul_rn(dtv[q], a[n]));
        const float dtx = __fmul_rn(dtv[q], xv[q]);
        float acc = 0.f;
#pragma unroll
        for (int n = 0; n < DS; ++n) {
          const float dbx = __fmul_rn(dtx, sB[tt][n]);
          h[n] = __fadd_rn(__fmul_rn(h[n], da[n]), dbx);
          acc = fmaf(h[n], sC[tt][n], acc);
        }
        yp[static_cast<long long>(t0 + tt) * di] = acc;
      }
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < DS; ++n) {
      if (n < ds) h_out[state + n] = h[n];
    }
  }
}

template <int DS>
cudaError_t launch(const float* dt, const float* xh, const float* bm,
                   const float* cm, const float* A, const float* h0, float* y,
                   float* h_out, int B, int C, int di, int ds,
                   const long long* st, cudaStream_t stream) {
  const dim3 grid((di + kScanThreads - 1) / kScanThreads, B);
  ssm_scan_kernel<DS><<<grid, kScanThreads, 0, stream>>>(
      dt, xh, bm, cm, A, h0, y, h_out, C, di, ds, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7]);
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
  const long long st[8] = {dt_sb, dt_st, xh_sb, xh_st, b_sb, b_st, c_sb, c_st};
  const auto* f_dt = static_cast<const float*>(dt);
  const auto* f_xh = static_cast<const float*>(xh);
  const auto* f_b = static_cast<const float*>(bm);
  const auto* f_c = static_cast<const float*>(cm);
  const auto* f_a = static_cast<const float*>(A);
  const auto* f_h0 = static_cast<const float*>(h0);
  auto* f_y = static_cast<float*>(y);
  auto* f_h = static_cast<float*>(h_out);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (ds <= 4) {
    err = launch<4>(f_dt, f_xh, f_b, f_c, f_a, f_h0, f_y, f_h, B, C, di, ds, st, s);
  } else if (ds <= 8) {
    err = launch<8>(f_dt, f_xh, f_b, f_c, f_a, f_h0, f_y, f_h, B, C, di, ds, st, s);
  } else if (ds <= 16) {
    err = launch<16>(f_dt, f_xh, f_b, f_c, f_a, f_h0, f_y, f_h, B, C, di, ds, st, s);
  } else if (ds <= 32) {
    err = launch<32>(f_dt, f_xh, f_b, f_c, f_a, f_h0, f_y, f_h, B, C, di, ds, st, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
