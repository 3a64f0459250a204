// A chain of L stacked fused binary layers (xnor-popcount GEMM, folded-BN
// affine, sign, repack along M) and an optional epilogue-free final GEMM, in
// one launch. Packed activations never reach global memory between layers.
//
//   W    [L, M_max, KW_max]  stacked packed weights (pad rows and words 0)
//   a, b [L, M_max]          folded affines (pad rows a = 0, b = +1)
//   X    [KW_act, N]         packed activations, KW_act = max(KW_max,
//                            M_max/32), pad rows all-ones, N % 8 == 0
//   out  [M_max/32, N] packed words, or with the head Wf [Mf, KWf] the int32
//        ±1 dot [Mf, N]. Columns >= n_real are 0 (the masked tail).
//
// Replaces the Pallas kernel `_chain_kernel` / `megakernel_chain`
// (src/repro/kernels/megakernel.py, pallas_call at :229). Plain twins:
// repro_torch.core.bitops.megakernel_chain_xla and, for the masked tail,
// megakernel_chain_ragged_xla.
//
// Bound on the H100: the popc issue rate at large batch; at the batch sizes
// served (<= 32 columns) the weights dominate the bytes (2 MB for the CIFAR
// net's fc0 + fc1), read from L2 once per batch tile.
//
// Residency. The Pallas grid tiles N only, so at batch <= 32 one program
// holds all of fc0 and walks 8.4 M xnor-popcount words on one core. Here a
// batch tile of kChainTileN = 8 columns is one thread-block cluster of
// S = gcd(8, M_max/32) CTAs (8 for the CIFAR trunk); CTA r owns rows
// [r*M_max/S, (r+1)*M_max/S) of every layer and stages only those rows'
// true K words in shared memory (fc0 131,072 B + fc1 16,384 B, transposed,
// pitch +1). Each CTA keeps a ping-pong pair of [KW_act][8] activation
// buffers; after each layer it writes its 4 repacked words per column into
// all S CTAs' next buffer through distributed shared memory, then
// cluster.sync(). Each layer walks only its own ceil(k_bits/32) K words,
// split over two warps per (32 rows, 4 columns) item whose partial sums
// meet in shared memory (16 warps per CTA). The head runs in CTA 0 after
// the last barrier, its weights staged in that CTA's shared memory with the
// rest. Batch 32 is 4 clusters.
#include <cooperative_groups.h>

#include "popcount.cuh"

namespace cg = cooperative_groups;

namespace repro_torch {

constexpr int kChainTileN = 8;     // batch columns per cluster
constexpr int kChainHalf = 4;      // columns one warp item accumulates
constexpr int kChainKSplit = 2;    // warps sharing one item's K words
constexpr int kChainWarps = 16;
constexpr int kChainThreads = kChainWarps * 32;
constexpr int kChainMaxLayers = 8;

struct ChainParams {
  const unsigned* w;
  const float* a;
  const float* b;
  const unsigned* wf;              // head weights [Mf, KWf], or null
  int kw_layer[kChainMaxLayers];   // K words layer l walks
  int k_bits[kChainMaxLayers];     // true K of layer l
  int n_layers, m_max, kw_max, kw_act;
  int mf, kwf, final_k_bits;
  int n, n_real, cluster;
};

struct ChainLayout {
  int w_off[kChainMaxLayers];
  int ab_off;
  int act_off[2];
  int red_off;   // partial sums of the K split, [items][32 lanes][4]
  int wf_off;    // head weights, transposed [KWf][round32(Mf) + 1], CTA 0
  int total;
};

__host__ __device__ inline int chain_align4(int v) { return (v + 3) & ~3; }

__host__ __device__ inline ChainLayout chain_layout(const ChainParams& p) {
  ChainLayout s{};
  const int rows = p.m_max / p.cluster;
  int off = 0;
  for (int l = 0; l < p.n_layers; ++l) {
    s.w_off[l] = off;
    off = chain_align4(off + p.kw_layer[l] * (rows + 1));
  }
  s.ab_off = off;
  off = chain_align4(off + 2 * p.n_layers * rows);
  for (int i = 0; i < 2; ++i) {
    s.act_off[i] = off;
    off += p.kw_act * kChainTileN;
  }
  s.red_off = off;
  off += (rows / 32) * 2 * kChainKSplit * 32 * kChainHalf;
  s.wf_off = off;
  off += p.kwf * (((p.mf + 31) & ~31) + 1);   // 0 without a head
  s.total = off;
  return s;
}

__global__ void __launch_bounds__(kChainThreads)
megakernel_chain_kernel(const unsigned* __restrict__ X,
                        unsigned* __restrict__ out, const ChainParams p) {
  extern __shared__ __align__(16) unsigned smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = p.cluster;
  const int rank = static_cast<int>(cluster.block_rank());
  const int n0 = (blockIdx.x / S) * kChainTileN;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rows = p.m_max / S;         // rows this CTA owns, % 32 == 0
  const int pitch = rows + 1;
  const int m_words = p.m_max / 32;
  const ChainLayout L = chain_layout(p);

  for (int l = 0; l < p.n_layers; ++l) {
    const int kwl = p.kw_layer[l];
    const unsigned* wg =
        p.w + (static_cast<size_t>(l) * p.m_max + rank * rows) * p.kw_max;
    unsigned* ws = smem + L.w_off[l];
    // A warp per row, lanes along K: coalesced reads, conflict-free stores.
    for (int r = warp; r < rows; r += kChainWarps) {
      const unsigned* row = wg + static_cast<size_t>(r) * p.kw_max;
#pragma unroll 8
      for (int k = lane; k < kwl; k += 32) ws[k * pitch + r] = __ldg(row + k);
    }
    float* ab = reinterpret_cast<float*>(smem + L.ab_off) + 2 * l * rows;
    for (int i = tid; i < rows; i += kChainThreads) {
      ab[i] = p.a[l * p.m_max + rank * rows + i];
      ab[rows + i] = p.b[l * p.m_max + rank * rows + i];
    }
  }
  const bool has_final = p.wf != nullptr;
  const int wf_pitch = ((p.mf + 31) & ~31) + 1;
  if (has_final && rank == 0) {
    for (int i = tid; i < p.mf * p.kwf; i += kChainThreads) {
      const int m = i / p.kwf;
      smem[L.wf_off + (i - m * p.kwf) * wf_pitch + m] = __ldg(p.wf + i);
    }
  }
  unsigned* act0 = smem + L.act_off[0];
  unsigned* act1 = smem + L.act_off[1];
#pragma unroll 4
  for (int i = tid; i < p.kw_act * kChainTileN; i += kChainThreads) {
    act0[i] = __ldg(X + static_cast<size_t>(i / kChainTileN) * p.n + n0 +
                    i % kChainTileN);
    act1[i] = ~0u;
  }
  // Every CTA's buffers are initialised before any peer writes into them.
  cluster.sync();

  const int row_groups = rows / 32;
  const int pairs = 2 * row_groups;   // (row group, column half) items
  int4* red = reinterpret_cast<int4*>(smem + L.red_off);
  for (int l = 0; l < p.n_layers; ++l) {
    const bool to_global = l + 1 == p.n_layers && !has_final;
    const unsigned* src = (l & 1) ? act1 : act0;
    unsigned* dst = (l & 1) ? act0 : act1;
    const unsigned* ws = smem + L.w_off[l];
    const float* ab = reinterpret_cast<const float*>(smem + L.ab_off) + 2 * l * rows;
    const int kwl = p.kw_layer[l];
    const int k_bits = p.k_bits[l];
    // Each item's K words are split over kChainKSplit warps; their partial
    // sums meet in shared memory.
    for (int item = warp; item < pairs * kChainKSplit; item += kChainWarps) {
      const int ks = item / pairs, pair = item % pairs;
      const int g = pair >> 1, h = pair & 1;
      const unsigned* wcol = ws + g * 32 + lane;
      const unsigned* xcol = src + h * kChainHalf;
      int acc[kChainHalf] = {0, 0, 0, 0};
#pragma unroll 4
      for (int k = ks * kwl / kChainKSplit; k < (ks + 1) * kwl / kChainKSplit; ++k) {
        const unsigned wv = wcol[k * pitch];
        const uint4 x = *reinterpret_cast<const uint4*>(xcol + k * kChainTileN);
        acc[0] += xnor_popc(wv, x.x);
        acc[1] += xnor_popc(wv, x.y);
        acc[2] += xnor_popc(wv, x.z);
        acc[3] += xnor_popc(wv, x.w);
      }
      red[item * 32 + lane] = make_int4(acc[0], acc[1], acc[2], acc[3]);
    }
    __syncthreads();
    for (int pair = warp; pair < pairs; pair += kChainWarps) {
      const int g = pair >> 1, h = pair & 1;
      int acc[kChainHalf] = {0, 0, 0, 0};
#pragma unroll
      for (int ks = 0; ks < kChainKSplit; ++ks) {
        const int4 part = red[(ks * pairs + pair) * 32 + lane];
        acc[0] += part.x;
        acc[1] += part.y;
        acc[2] += part.z;
        acc[3] += part.w;
      }
      const int r = g * 32 + lane;
      const float a = ab[r], b = ab[rows + r];
      unsigned words[kChainHalf];
#pragma unroll
      for (int j = 0; j < kChainHalf; ++j) {
        words[j] = sign_repack_warp(bn_affine(a, 2 * acc[j] - k_bits, b));
      }
      const int word_row = rank * row_groups + g;
      if (to_global) {
        if (lane < kChainHalf) {
          const int col = n0 + h * kChainHalf + lane;
          out[static_cast<size_t>(word_row) * p.n + col] =
              col < p.n_real ? words[lane] : 0u;
        }
      } else if (lane < S) {
        uint4* cell = reinterpret_cast<uint4*>(dst + word_row * kChainTileN +
                                               h * kChainHalf);
        *cluster.map_shared_rank(cell, lane) =
            make_uint4(words[0], words[1], words[2], words[3]);
      }
    }
    if (to_global) break;
    // Rows past M_max/32 of the next input are all-ones, as in the Pallas
    // kernel; peers write only rows below M_max/32.
    for (int i = m_words * kChainTileN + tid; i < p.kw_act * kChainTileN;
         i += kChainThreads) {
      dst[i] = ~0u;
    }
    cluster.sync();
  }

  if (!has_final || rank != 0) return;
  // Float-boundary head in CTA 0: the exact ±1 dot, no epilogue.
  const unsigned* act = (p.n_layers & 1) ? act1 : act0;
  for (int item = warp; item < 2 * ((p.mf + 31) / 32); item += kChainWarps) {
    const int g = item >> 1, h = item & 1;
    const int m = g * 32 + lane;   // rows past Mf read the pitch's slack
    const unsigned* wcol = smem + L.wf_off + m;
    const unsigned* xcol = act + h * kChainHalf;
    int acc[kChainHalf] = {0, 0, 0, 0};
#pragma unroll 4
    for (int k = 0; k < p.kwf; ++k) {
      const unsigned wv = wcol[k * wf_pitch];
      const uint4 x = *reinterpret_cast<const uint4*>(xcol + k * kChainTileN);
      acc[0] += xnor_popc(wv, x.x);
      acc[1] += xnor_popc(wv, x.y);
      acc[2] += xnor_popc(wv, x.z);
      acc[3] += xnor_popc(wv, x.w);
    }
    if (m < p.mf) {
#pragma unroll
      for (int j = 0; j < kChainHalf; ++j) {
        const int col = n0 + h * kChainHalf + j;
        reinterpret_cast<int*>(out)[static_cast<size_t>(m) * p.n + col] =
            col < p.n_real ? 2 * acc[j] - p.final_k_bits : 0;
      }
    }
  }
}

ChainParams make_chain_params(const void* w, const void* a, const void* b,
                              const void* wf, const int* kw_layer,
                              const int* k_bits, int n_layers, int m_max,
                              int kw_max, int kw_act, int mf, int kwf,
                              int final_k_bits, int n, int n_real,
                              int cluster) {
  ChainParams p{};
  p.w = static_cast<const unsigned*>(w);
  p.a = static_cast<const float*>(a);
  p.b = static_cast<const float*>(b);
  p.wf = static_cast<const unsigned*>(wf);
  for (int l = 0; l < n_layers && l < kChainMaxLayers; ++l) {
    p.kw_layer[l] = kw_layer[l];
    p.k_bits[l] = k_bits ? k_bits[l] : 0;
  }
  p.n_layers = n_layers;
  p.m_max = m_max;
  p.kw_max = kw_max;
  p.kw_act = kw_act;
  p.mf = mf;
  p.kwf = kwf;
  p.final_k_bits = final_k_bits;
  p.n = n;
  p.n_real = n_real;
  p.cluster = cluster;
  return p;
}

cudaLaunchConfig_t chain_launch_config(int tiles, int cluster, int smem,
                                       cudaStream_t stream,
                                       cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * cluster, 1, 1);
  cfg.blockDim = dim3(kChainThreads, 1, 1);
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
extern "C" int repro_megakernel_chain_limits(const int* kw_layer, int n_layers,
                                             int m_max, int kw_act, int mf,
                                             int kwf, int cluster,
                                             int* smem_bytes, int* max_clusters) {
  using namespace repro_torch;
  if (n_layers < 1 || n_layers > kChainMaxLayers) return cudaErrorInvalidValue;
  const ChainParams p = make_chain_params(nullptr, nullptr, nullptr, nullptr,
                                          kw_layer, nullptr, n_layers, m_max, 0,
                                          kw_act, mf, kwf, 0, 0, 0, cluster);
  const int smem = chain_layout(p).total * static_cast<int>(sizeof(unsigned));
  *smem_bytes = smem;
  *max_clusters = 0;
  cudaError_t err = cudaFuncSetAttribute(
      megakernel_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = chain_launch_config(1, cluster, smem, nullptr, attr);
  err = cudaOccupancyMaxActiveClusters(max_clusters, megakernel_chain_kernel, &cfg);
  return static_cast<int>(err);
}

extern "C" int repro_megakernel_chain(
    const void* w, const void* a, const void* b, const void* x,
    const void* wf, void* out, const int* kw_layer, const int* k_bits,
    int n_layers, int m_max, int kw_max, int kw_act, int mf, int kwf,
    int final_k_bits, int n, int n_real, int cluster, void* stream) {
  using namespace repro_torch;
  if (n_layers < 1 || n_layers > kChainMaxLayers || n % kChainTileN != 0) {
    return cudaErrorInvalidValue;
  }
  const ChainParams p = make_chain_params(w, a, b, wf, kw_layer, k_bits,
                                          n_layers, m_max, kw_max, kw_act, mf,
                                          kwf, final_k_bits, n, n_real, cluster);
  const int smem = chain_layout(p).total * static_cast<int>(sizeof(unsigned));
  cudaError_t err = cudaFuncSetAttribute(
      megakernel_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = chain_launch_config(
      n / kChainTileN, cluster, smem, static_cast<cudaStream_t>(stream), attr);
  err = cudaLaunchKernelEx(&cfg, megakernel_chain_kernel,
                           static_cast<const unsigned*>(x),
                           static_cast<unsigned*>(out), p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
