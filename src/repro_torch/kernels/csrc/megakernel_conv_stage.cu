// One conv stage of the binarized network in one launch: 1-4 fused direct
// binary convs (stride 1, folded-BN affine, sign, repack along D) and an
// optional 2x2 packed-OR maxpool. Intermediate maps never reach global
// memory.
//
//   X    [N, Hp, Wp, CW_0]  channel-packed map, all-ones border applied
//   W_l  [D_l, kh*kw*CW_l]  tap-aligned packed filters, D_l % 32 == 0
//   a_l, b_l [D_l]          folded affine (pad channels a = 0, b = +1)
//   out  [N, OH', OW', D_last/32]  (OH' = OH/2 when pooled)
//
// Replaces the Pallas kernel `_conv_stage_kernel` / `megakernel_conv_stage`
// (src/repro/kernels/megakernel.py, pallas_call at :339). Plain twin:
// repro_torch.core.bitops.conv_stage_xla.
//
// Bound on the H100: the popc issue rate (16 per SM per clock), not bytes —
// the packed maps are a few KB per image and every staged word feeds up to
// 32 lanes x kh*kw taps. The conv dot is computed exactly once.
//
// Residency. The Pallas kernel runs one program per image with every filter
// of the stage resident in VMEM. Here the main path's third stage holds
// 442,368 B of filters, more than one block's 227 KB of shared memory, and
// one block per image would put only N blocks on 132 SMs. So one image is a
// thread-block cluster of S = gcd(8, D_l/32 for every l) CTAs (4 for the
// CIFAR net's first stage, 8 for the others; 8 is the portable limit). CTA r
// owns output words [r*DW_l/S, (r+1)*DW_l/S) of every conv in the stage and
// stages only its slice of the filters (transposed, pitch +1 against bank
// conflicts) and affines in shared memory: 55,296 B for the third stage.
// Every CTA holds a full copy of the padded input map. Between two convs,
// each CTA writes its channel words of the intermediate map into every
// CTA's copy through distributed shared memory, whose all-ones border each
// CTA laid down before the first cluster barrier; a cluster.sync() then
// publishes the map. The pool is an OR of the four ballot words of a 2x2
// output tile in the last conv's epilogue, which writes global memory once.
//
// Work split inside a CTA: a warp owns one (2x2 output tile, channel word)
// item, lane l channel 32*word + l. Each weight word read from shared memory
// serves the tile's 4 pixels; activation words are broadcast reads, 4 words
// at a time, in loops unrolled for the main path's 4, 8 and 16 words per
// pixel.
#include <cooperative_groups.h>

#include "popcount.cuh"

namespace cg = cooperative_groups;

namespace repro_torch {

constexpr int kStageMaxLayers = 4;
constexpr int kStageWarps = 16;
constexpr int kStageThreads = kStageWarps * 32;

struct StageParams {
  const unsigned* w[kStageMaxLayers];
  const float* a[kStageMaxLayers];
  const float* b[kStageMaxLayers];
  int d_words[kStageMaxLayers];   // D_l / 32
  int cw[kStageMaxLayers];        // input words per pixel of conv l
  int k_bits[kStageMaxLayers];    // true kh*kw*C_l
  int n_layers, hp, wp, kh, kw, pad, pool, cluster;
};

// Shared-memory layout of one CTA, in 32-bit words, each region 16-B aligned.
struct StageLayout {
  int w_off[kStageMaxLayers];
  int ab_off[kStageMaxLayers];
  int x_off;
  int inter_off[2];
  int inter_words;
  int total;
};

__host__ __device__ inline int align4(int v) { return (v + 3) & ~3; }

__host__ __device__ inline StageLayout stage_layout(const StageParams& p) {
  StageLayout s{};
  int off = 0;
  for (int l = 0; l < p.n_layers; ++l) {
    const int own_ch = 32 * (p.d_words[l] / p.cluster);
    s.w_off[l] = off;
    off = align4(off + p.kh * p.kw * p.cw[l] * (own_ch + 1));
    s.ab_off[l] = off;
    off = align4(off + 2 * own_ch);
  }
  s.x_off = off;
  off = align4(off + p.hp * p.wp * p.cw[0]);
  // Padded output map of every conv but the last; the largest sizes both
  // ping-pong buffers (a two-conv stage needs one).
  int h = p.hp, w = p.wp, biggest = 0;
  for (int l = 0; l + 1 < p.n_layers; ++l) {
    h = h - p.kh + 1 + 2 * p.pad;
    w = w - p.kw + 1 + 2 * p.pad;
    const int words = h * w * p.d_words[l];
    biggest = words > biggest ? words : biggest;
  }
  s.inter_words = align4(biggest);
  const int n_inter = p.n_layers > 2 ? 2 : p.n_layers - 1;
  for (int i = 0; i < 2; ++i) s.inter_off[i] = off + (i < n_inter ? i : 0) * s.inter_words;
  off += n_inter * s.inter_words;
  s.total = off;
  return s;
}

// The popcount sums of one item: lane's channel against the 4 pixels of a
// 2x2 output tile, over kh x kw taps of CW words. CW > 0 is a compile-time
// word count (unrolled, activation words read 4 at a time when CW % 4 == 0);
// CW == 0 takes the runtime count cw.
template <int CW>
__device__ __forceinline__ void tile_dot(const unsigned* __restrict__ wcol,
                                         int pitch,
                                         const unsigned* __restrict__ src,
                                         int win, int kh, int kw, int cw,
                                         const int (&base)[4], int (&acc)[4]) {
  const int n = CW > 0 ? CW : cw;
  for (int i = 0; i < kh; ++i) {
    for (int j = 0; j < kw; ++j) {
      const unsigned* wt = wcol + (i * kw + j) * n * pitch;
      const int off = (i * win + j) * n;
      if (CW > 0 && CW % 4 == 0) {
#pragma unroll
        for (int c = 0; c < n; c += 4) {
          const unsigned w0 = wt[c * pitch], w1 = wt[(c + 1) * pitch];
          const unsigned w2 = wt[(c + 2) * pitch], w3 = wt[(c + 3) * pitch];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const uint4 x = *reinterpret_cast<const uint4*>(src + base[q] + off + c);
            acc[q] += xnor_popc(w0, x.x) + xnor_popc(w1, x.y) +
                      xnor_popc(w2, x.z) + xnor_popc(w3, x.w);
          }
        }
      } else {
#pragma unroll
        for (int c = 0; c < n; ++c) {
          const unsigned wv = wt[c * pitch];
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[q] += xnor_popc(wv, src[base[q] + off + c]);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kStageThreads)
megakernel_conv_stage_kernel(const unsigned* __restrict__ X,
                             unsigned* __restrict__ out, const StageParams p) {
  extern __shared__ __align__(16) unsigned smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = p.cluster;
  const int rank = static_cast<int>(cluster.block_rank());
  const int img = blockIdx.x / S;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const StageLayout L = stage_layout(p);

  // Stage this CTA's filter and affine slices, the input map, and the
  // all-ones intermediate maps (their border stays all-ones).
  for (int l = 0; l < p.n_layers; ++l) {
    const int own_ch = 32 * (p.d_words[l] / S);
    const int pitch = own_ch + 1;
    const int kwords = p.kh * p.kw * p.cw[l];
    const unsigned* wg = p.w[l] + static_cast<size_t>(rank) * own_ch * kwords;
    unsigned* ws = smem + L.w_off[l];
    // A warp per channel, lanes along K: coalesced reads, conflict-free
    // stores.
    for (int c = warp; c < own_ch; c += kStageWarps) {
      const unsigned* row = wg + static_cast<size_t>(c) * kwords;
#pragma unroll 4
      for (int k = lane; k < kwords; k += 32) ws[k * pitch + c] = __ldg(row + k);
    }
    float* ab = reinterpret_cast<float*>(smem + L.ab_off[l]);
    for (int i = tid; i < own_ch; i += kStageThreads) {
      ab[i] = p.a[l][rank * own_ch + i];
      ab[own_ch + i] = p.b[l][rank * own_ch + i];
    }
  }
  const int x_words = p.hp * p.wp * p.cw[0];
  const unsigned* xg = X + static_cast<size_t>(img) * x_words;
#pragma unroll 4
  for (int i = tid; i < x_words; i += kStageThreads) smem[L.x_off + i] = __ldg(xg + i);
  const int n_inter = p.n_layers > 2 ? 2 : p.n_layers - 1;
  for (int i = tid; i < n_inter * L.inter_words; i += kStageThreads) {
    smem[L.inter_off[0] + i] = ~0u;
  }
  // Every CTA's buffers are initialised before any peer writes into them.
  cluster.sync();

  int hin = p.hp, win = p.wp;
  for (int l = 0; l < p.n_layers; ++l) {
    const bool last = l + 1 == p.n_layers;
    const unsigned* src = smem + (l == 0 ? L.x_off : L.inter_off[(l - 1) & 1]);
    unsigned* dst = smem + L.inter_off[l & 1];
    const int cw = p.cw[l];
    const int oh = hin - p.kh + 1, ow = win - p.kw + 1;
    const int own_w = p.d_words[l] / S;
    const int own_ch = 32 * own_w;
    const int pitch = own_ch + 1;
    const int dw = p.d_words[l];
    const unsigned* ws = smem + L.w_off[l];
    const float* ab = reinterpret_cast<const float*>(smem + L.ab_off[l]);
    const int k_bits = p.k_bits[l];
    const int tiles_h = (oh + 1) / 2, tiles_w = (ow + 1) / 2;
    const int items = tiles_h * tiles_w * own_w;
    // Padded width of the intermediate map this conv writes.
    const int nxt_w = ow + 2 * p.pad;
    if (!last && l >= 2) {
      // A reused buffer: lay this map's all-ones border down again (the
      // previous map had other widths). Peers write only interior cells.
      const int nxt_h = oh + 2 * p.pad;
      for (int i = tid; i < nxt_h * nxt_w * dw; i += kStageThreads) {
        const int cell = i / dw, y = cell / nxt_w, x = cell % nxt_w;
        if (y < p.pad || y >= oh + p.pad || x < p.pad || x >= ow + p.pad) dst[i] = ~0u;
      }
    }

    for (int item = warp; item < items; item += kStageWarps) {
      const int wl = item % own_w;
      const int t = item / own_w;
      const int ty = t / tiles_w, tx = t % tiles_w;
      int base[4];   // first word of each pixel's window, clamped in-map
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int oy = min(2 * ty + (q >> 1), oh - 1);
        const int ox = min(2 * tx + (q & 1), ow - 1);
        base[q] = (oy * win + ox) * cw;
      }
      int acc[4] = {0, 0, 0, 0};
      const unsigned* wcol = ws + 32 * wl + lane;
      switch (cw) {   // the main path's word counts, unrolled
        case 4:
          tile_dot<4>(wcol, pitch, src, win, p.kh, p.kw, cw, base, acc);
          break;
        case 8:
          tile_dot<8>(wcol, pitch, src, win, p.kh, p.kw, cw, base, acc);
          break;
        case 16:
          tile_dot<16>(wcol, pitch, src, win, p.kh, p.kw, cw, base, acc);
          break;
        default:
          tile_dot<0>(wcol, pitch, src, win, p.kh, p.kw, cw, base, acc);
      }
      const int ch = 32 * wl + lane;
      const float a = ab[ch], b = ab[own_ch + ch];
      unsigned words[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        words[q] = sign_repack_warp(bn_affine(a, 2 * acc[q] - k_bits, b));
      }
      const int gw = rank * own_w + wl;   // this word's index in the map
      if (last && p.pool) {
        if (lane == 0) {
          const int ph = oh / 2, pw = ow / 2;
          out[((static_cast<size_t>(img) * ph + ty) * pw + tx) * dw + gw] =
              words[0] | words[1] | words[2] | words[3];
        }
        continue;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int y = 2 * ty + (q >> 1), x = 2 * tx + (q & 1);
        if (y >= oh || x >= ow) continue;   // warp-uniform
        if (last) {
          if (lane == 0) {
            out[((static_cast<size_t>(img) * oh + y) * ow + x) * dw + gw] = words[q];
          }
        } else if (lane < S) {
          unsigned* cell = dst + ((y + p.pad) * nxt_w + x + p.pad) * dw + gw;
          *cluster.map_shared_rank(cell, lane) = words[q];
        }
      }
    }
    if (!last) cluster.sync();   // the next conv reads the whole map
    hin = oh + 2 * p.pad;
    win = nxt_w;
  }
}

StageParams make_params(const void* const* w, const void* const* a,
                        const void* const* b, const int* d_words,
                        const int* cw, const int* k_bits, int n_layers,
                        int hp, int wp, int kh, int kw, int pad, int pool,
                        int cluster) {
  StageParams p{};
  for (int l = 0; l < n_layers && l < kStageMaxLayers; ++l) {
    p.w[l] = w ? static_cast<const unsigned*>(w[l]) : nullptr;
    p.a[l] = a ? static_cast<const float*>(a[l]) : nullptr;
    p.b[l] = b ? static_cast<const float*>(b[l]) : nullptr;
    p.d_words[l] = d_words[l];
    p.cw[l] = cw[l];
    p.k_bits[l] = k_bits ? k_bits[l] : 0;
  }
  p.n_layers = n_layers;
  p.hp = hp;
  p.wp = wp;
  p.kh = kh;
  p.kw = kw;
  p.pad = pad;
  p.pool = pool;
  p.cluster = cluster;
  return p;
}

cudaLaunchConfig_t launch_config(int n_images, int cluster, int smem,
                                 cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_images * cluster, 1, 1);
  cfg.blockDim = dim3(kStageThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace repro_torch

// Shared-memory bytes of one CTA and the number of clusters of that size
// the device can hold at once (0: the launch cannot run). Returns a CUDA
// error code.
extern "C" int repro_megakernel_conv_stage_limits(
    const int* d_words, const int* cw, int n_layers, int hp, int wp, int kh,
    int kw, int pad, int cluster, int* smem_bytes, int* max_clusters) {
  using namespace repro_torch;
  if (n_layers < 1 || n_layers > kStageMaxLayers) return cudaErrorInvalidValue;
  const StageParams p = make_params(nullptr, nullptr, nullptr, d_words, cw,
                                    nullptr, n_layers, hp, wp, kh, kw, pad, 0,
                                    cluster);
  const int smem = stage_layout(p).total * static_cast<int>(sizeof(unsigned));
  *smem_bytes = smem;
  *max_clusters = 0;
  cudaError_t err = cudaFuncSetAttribute(
      megakernel_conv_stage_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = launch_config(1, cluster, smem, nullptr, attr);
  err = cudaOccupancyMaxActiveClusters(max_clusters,
                                       megakernel_conv_stage_kernel, &cfg);
  return static_cast<int>(err);
}

extern "C" int repro_megakernel_conv_stage(
    const void* x, void* out, const void* const* w, const void* const* a,
    const void* const* b, const int* d_words, const int* cw,
    const int* k_bits, int n_layers, int n_images, int hp, int wp, int kh,
    int kw, int pad, int pool, int cluster, void* stream) {
  using namespace repro_torch;
  if (n_layers < 1 || n_layers > kStageMaxLayers) return cudaErrorInvalidValue;
  const StageParams p = make_params(w, a, b, d_words, cw, k_bits, n_layers,
                                    hp, wp, kh, kw, pad, pool, cluster);
  const int smem = stage_layout(p).total * static_cast<int>(sizeof(unsigned));
  cudaError_t err = cudaFuncSetAttribute(
      megakernel_conv_stage_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = launch_config(
      n_images, cluster, smem, static_cast<cudaStream_t>(stream), attr);
  err = cudaLaunchKernelEx(&cfg, megakernel_conv_stage_kernel,
                           static_cast<const unsigned*>(x),
                           static_cast<unsigned*>(out), p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
