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
// Bound on the H100: at the batches served (<= 32 columns) the weights'
// bytes (1.2 MB for the CIFAR net's fc0 + fc1 + head), far below what one
// launch with a few cluster barriers takes; so the design goes for
// latency: no serial staging, and as many SMs loading as clusters allow.
//
// Design.
//   * Products on the tensor cores: every layer and the head run as 1-bit
//     mma.sync m16n8k256 with and.popc on m16 row tiles; the chain's batch
//     tile of 8 columns is the mma's N. The xnor count comes from 32 K -
//     P(w) - P(x) + 2 popc(w & x) (xnor_tc.cuh), P(w) from the A operand's
//     registers, P(x) from the B operand's. The K order inside a k-group
//     of 16 words is permuted (lane t holds words 4t..4t+3 of its rows and
//     columns; the two mmas of a group take words {4t, 4t + 1} and {4t + 2,
//     4t + 3}), which leaves each sum as it is: A and B use one order.
//   * Weights streamed, not staged: each warp loads its rows' words straight
//     from global memory into registers as 16-byte loads (4 k-groups at a
//     time), so a layer's products start when its first words land; the
//     next layer's (and the head's) first words are loaded before the
//     cluster barrier that ends the current layer, as they do not depend
//     on the activations.
//   * A cluster of S = gcd(16, M_max/32) CTAs (a non-portable cluster of 16
//     for the CIFAR trunk, where the card holds one), one CTA an SM, for
//     each n tile of 8 columns: CTA r owns rows [r M_max/S, (r+1) M_max/S)
//     of every layer (64 of 1024: fc0 64 KB a CTA); batch 32 is four
//     clusters, 64 SMs. One cluster for 32 columns would read the weights
//     once a forward, but it measures slower (scripts/kernel_ablation.py,
//     H100 80GB HBM3 at 700 W: 0.0174 ms against 0.0115 at batch 32): its
//     per-SM column work (B
//     loads, products, ballots, exchange) costs more than three more reads
//     of 1.2 MB from L2. A CTA's 16 warps take (m16 tile, K part) items;
//     their integer partial counts meet in shared memory ([part][row]
//     [column]), where a warp adds them, applies the affine (two
//     roundings, never an FMA) and ballots the sign word, and writes it
//     into every CTA's next activation buffer through distributed shared
//     memory; one cluster barrier a layer (split into arrive and wait
//     around the next layer's loads).
//   * The head in every CTA's share of rows: its K is the last layer's
//     output, so CTA r adds the head's counts over the words it computed
//     itself (CTA 0 also over the all-ones pad words past M_max/32) into
//     CTA 0's accumulator with distributed shared-memory atomics (integers:
//     exact in any order); after the last barrier CTA 0 only stores.
//   Activations live as [column][word] (pitch = 16 mod 32 words, so the
//   B operand's 16-byte loads are conflict-free), X's tile transposed in on
//   entry; words past a layer's K are zero in both operands, so they add
//   nothing to any term. Work splits and offsets come from the host
//   (chain_finish): the kernel divides by nothing it could be told.
#include <cooperative_groups.h>

#include <algorithm>
#include <cstdint>

#include "xnor_tc.cuh"

namespace cg = cooperative_groups;

namespace repro_torch {

constexpr int kChainTileN = 8;      // columns of an mma n tile; N pads to it
constexpr int kChainNTiles = 1;     // n tiles a cluster carries (see above)
constexpr int kChainCols = kChainTileN * kChainNTiles;
constexpr int kChainWarps = 16;
constexpr int kChainThreads = kChainWarps * 32;
constexpr int kChainMaxLayers = 8;
constexpr int kChainMaxCluster = 16;
constexpr int kChainGroup = 16;     // K words of a k-group (two mma k-steps)
constexpr int kChainChunk = 4;      // k-groups a warp holds in registers
constexpr int kChainRedPitch = kChainCols + 1;

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
  int vec_w, vec_f;                // 16-byte loads of W rows / Wf rows
  // Set by chain_finish on the host: the activation pitch and the word
  // offsets of act[1], the staged counts and the head's accumulator; the
  // words past M_max/32 each buffer reads (all-ones); each layer's K parts
  // and k-groups a part.
  int ldx, act1_off, red_off, head_off, pad_end0, pad_end1;
  int parts[kChainMaxLayers], per[kChainMaxLayers];
};

// K parts of a layer's items: as many as the warps left over by the m16
// tiles allow, at most one a k-group; `per` k-groups a part.
struct ChainWork {
  int parts, per;
};

inline ChainWork chain_work(int mtiles, int kw) {
  int groups = (kw + kChainGroup - 1) / kChainGroup;
  groups = groups < 1 ? 1 : groups;
  int parts = kChainWarps / mtiles;
  parts = parts < 1 ? 1 : (parts > groups ? groups : parts);
  const int per = (groups + parts - 1) / parts;
  return {(groups + per - 1) / per, per};
}

// The host-side fields of `p` from its geometry; returns the shared
// memory of a CTA in bytes: two activation buffers [kChainCols][ldx], the
// staged partial counts [parts][rows][kChainRedPitch], the head's
// accumulator [round16(Mf)][kChainCols] (used in CTA 0).
inline int chain_finish(ChainParams& p) {
  const int m_words = p.m_max / 32, rows = p.m_max / p.cluster;
  p.ldx = (p.kw_act + 15) & ~15;
  if (p.ldx % 32 == 0) p.ldx += 16;
  p.act1_off = kChainCols * p.ldx;
  p.red_off = 2 * kChainCols * p.ldx;
  int parts = 1;
  for (int l = 0; l < p.n_layers; ++l) {
    const ChainWork wk = chain_work(rows / 16, p.kw_layer[l]);
    p.parts[l] = wk.parts;
    p.per[l] = wk.per;
    parts = std::max(parts, wk.parts);
  }
  p.head_off = p.red_off + parts * rows * kChainRedPitch;
  // layer l reads act[l % 2], the head act[L % 2]
  int pad_end[2] = {m_words, m_words};
  for (int l = 1; l < p.n_layers; ++l) pad_end[l & 1] = std::max(pad_end[l & 1], p.kw_layer[l]);
  if (p.mf > 0) pad_end[p.n_layers & 1] = std::max(pad_end[p.n_layers & 1], p.kwf);
  p.pad_end0 = pad_end[0];
  p.pad_end1 = pad_end[1];
  const int words = p.head_off + ((p.mf + 15) & ~15) * kChainCols;
  return words * static_cast<int>(sizeof(unsigned));
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// One warp's item: rows g and g + 8 of an m16 tile (null: a row past the
// head's Mf, all zeros) over the words [k_lo, k_hi).
struct ChainItem {
  const unsigned* lo;
  const unsigned* hi;
  int k_lo, k_hi, row0, part;
  bool vec;
};

// The A operand of an item, kChainChunk k-groups: lane t holds words
// 16 q + 4 t .. + 3 of k-group q of rows g (lo) and g + 8 (hi).
struct ChainFrag {
  uint4 lo[kChainChunk], hi[kChainChunk];
};

// Global loads issued where they stand: as volatile asm the compiler does
// not sink them towards their first use (past a cluster barrier, or one
// unit's loads after the previous unit's stores), so a warp's loads are
// in flight together and the next layer's before the barrier.
__device__ __forceinline__ uint4 ldg_now4(const unsigned* p) {
  uint4 v;
  asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ unsigned ldg_now(const unsigned* p) {
  unsigned v;
  asm volatile("ld.global.nc.u32 %0, [%1];\n" : "=r"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ float ldg_now(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];\n" : "=f"(v) : "l"(p));
  return v;
}

// Words k .. k + 3 of a global row; words at or past k_hi are 0.
__device__ __forceinline__ uint4 chain_ldg4(const unsigned* row, int k, int k_hi, bool vec) {
  if (row == nullptr) return make_uint4(0u, 0u, 0u, 0u);
  if (vec && k + 3 < k_hi) return ldg_now4(row + k);
  uint4 v;
  v.x = k < k_hi ? ldg_now(row + k) : 0u;
  v.y = k + 1 < k_hi ? ldg_now(row + k + 1) : 0u;
  v.z = k + 2 < k_hi ? ldg_now(row + k + 2) : 0u;
  v.w = k + 3 < k_hi ? ldg_now(row + k + 3) : 0u;
  return v;
}

// The CTA's dynamic shared memory. Every access goes through this array by
// word offset, so the compiler keeps them shared-memory accesses.
extern __shared__ __align__(16) unsigned chain_smem[];

// Words k .. k + 3 of an activation column (at word `col` of chain_smem);
// words at or past k_hi are 0.
__device__ __forceinline__ uint4 chain_lds4(int col, int k, int k_hi) {
  if ((k & 3) == 0 && k + 3 < k_hi) return *reinterpret_cast<const uint4*>(chain_smem + col + k);
  uint4 v;
  v.x = k < k_hi ? chain_smem[col + k] : 0u;
  v.y = k + 1 < k_hi ? chain_smem[col + k + 1] : 0u;
  v.z = k + 2 < k_hi ? chain_smem[col + k + 2] : 0u;
  v.w = k + 3 < k_hi ? chain_smem[col + k + 3] : 0u;
  return v;
}

__device__ __forceinline__ void chain_load(ChainFrag& f, const ChainItem& it, int k0) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int q = 0; q < kChainChunk; ++q) {
    const int k = k0 + q * kChainGroup + 4 * t;
    f.lo[q] = chain_ldg4(it.lo, k, it.k_hi, it.vec);
    f.hi[q] = chain_ldg4(it.hi, k, it.k_hi, it.vec);
  }
}

// Item `it` of layer l (l == n_layers: the head) for CTA `rank`; false
// where there is none (warp-uniform).
__device__ __forceinline__ bool chain_item(ChainItem& c, const ChainParams& p, int l, int it,
                                           int rank, int rows) {
  const int g = (threadIdx.x & 31) >> 2;
  if (l < p.n_layers) {
    const int mtiles = rows / 16;
    if (it >= mtiles * p.parts[l]) return false;
    c.part = it / mtiles;
    c.row0 = (it - c.part * mtiles) * 16;
    c.lo = p.w + (static_cast<long long>(l) * p.m_max + rank * rows + c.row0 + g) * p.kw_max;
    c.hi = c.lo + 8LL * p.kw_max;
    c.k_lo = c.part * p.per[l] * kChainGroup;
    c.k_hi = min(p.kw_layer[l], c.k_lo + p.per[l] * kChainGroup);
    c.vec = p.vec_w != 0;
    return true;
  }
  if (p.wf == nullptr) return false;
  const int mtiles = (p.mf + 15) / 16;
  if (it >= 2 * mtiles) return false;
  const int m_words = p.m_max / 32, wpc = rows / 32;
  if (it < mtiles) {        // the words this CTA computed
    c.k_lo = rank * wpc;
    c.k_hi = min(p.kwf, c.k_lo + wpc);
  } else {                  // the all-ones pad words past M_max/32, CTA 0
    c.k_lo = m_words;
    c.k_hi = rank == 0 ? p.kwf : m_words;
  }
  if (c.k_lo >= c.k_hi) return false;
  c.row0 = (it % mtiles) * 16;
  c.part = 0;
  const int m = c.row0 + g;
  c.lo = m < p.mf ? p.wf + static_cast<long long>(m) * p.kwf : nullptr;
  c.hi = m + 8 < p.mf ? p.wf + static_cast<long long>(m + 8) * p.kwf : nullptr;
  c.vec = p.vec_f != 0 && (c.k_lo & 3) == 0;
  return true;
}

// The xnor counts of an item's 16 rows against the cluster's nt n tiles of
// the activations at word `act` ([column][word], pitch ldx) over the
// item's words, handed to emit(row in the tile, column, count). `f` holds
// the first chunk when `loaded`.
template <class Emit>
__device__ __forceinline__ void chain_item_counts(ChainFrag& f, bool loaded, const ChainItem& it,
                                                  int act, int ldx, int nt, const Emit& emit) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  int acc[kChainNTiles][4] = {};
  int px[kChainNTiles] = {};
  int pw_lo = 0, pw_hi = 0;
  for (int k0 = it.k_lo; k0 < it.k_hi; k0 += kChainChunk * kChainGroup) {
    if (!loaded) chain_load(f, it, k0);
    loaded = false;
#pragma unroll
    for (int q = 0; q < kChainChunk; ++q) {
      const int kq = k0 + q * kChainGroup;
      if (kq >= it.k_hi) break;
      const uint4 wl = f.lo[q], wh = f.hi[q];
      pw_lo += __popc(wl.x) + __popc(wl.y) + __popc(wl.z) + __popc(wl.w);
      pw_hi += __popc(wh.x) + __popc(wh.y) + __popc(wh.z) + __popc(wh.w);
      const uint32_t a01[4] = {wl.x, wh.x, wl.y, wh.y};
      const uint32_t a23[4] = {wl.z, wh.z, wl.w, wh.w};
#pragma unroll
      for (int j = 0; j < kChainNTiles; ++j) {
        if (j < nt) {
          const uint4 x = chain_lds4(act + (j * kChainTileN + g) * ldx, kq + 4 * t, it.k_hi);
          px[j] += __popc(x.x) + __popc(x.y) + __popc(x.z) + __popc(x.w);
          mma_b1_and_popc(acc[j], a01, x.x, x.y);
          mma_b1_and_popc(acc[j], a23, x.z, x.w);
        }
      }
    }
  }
  // Popcounts: the 4 lanes of a quad hold one row (column) over different
  // words; add them (outside any branch: every lane takes part).
  pw_lo += __shfl_xor_sync(0xffffffffu, pw_lo, 1);
  pw_lo += __shfl_xor_sync(0xffffffffu, pw_lo, 2);
  pw_hi += __shfl_xor_sync(0xffffffffu, pw_hi, 1);
  pw_hi += __shfl_xor_sync(0xffffffffu, pw_hi, 2);
  int px0[kChainNTiles], px1[kChainNTiles];
#pragma unroll
  for (int j = 0; j < kChainNTiles; ++j) {
    px[j] += __shfl_xor_sync(0xffffffffu, px[j], 1);
    px[j] += __shfl_xor_sync(0xffffffffu, px[j], 2);
    // column 2t (+1)'s popcount sits in quad 2t (+1)
    px0[j] = __shfl_sync(0xffffffffu, px[j], 8 * t);
    px1[j] = __shfl_sync(0xffffffffu, px[j], 8 * t + 4);
  }
  const int bits = 32 * (it.k_hi - it.k_lo);
#pragma unroll
  for (int j = 0; j < kChainNTiles; ++j) {
    if (j < nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        emit(g + (e >> 1) * 8, j * kChainTileN + 2 * t + (e & 1),
             bits - ((e >> 1) ? pw_hi : pw_lo) - ((e & 1) ? px1[j] : px0[j]) + 2 * acc[j][e]);
      }
    }
  }
}

__global__ void __launch_bounds__(kChainThreads, 1)
megakernel_chain_kernel(const unsigned* __restrict__ X, unsigned* __restrict__ out,
                        const ChainParams p) {
  cg::cluster_group cluster = cg::this_cluster();
  const int S = p.cluster;
  const int rank = static_cast<int>(cluster.block_rank());
  const int n0 = static_cast<int>(blockIdx.x / S) * kChainCols;
  const int nt = min(kChainNTiles, (p.n - n0) / kChainTileN);
  const int ncols = nt * kChainTileN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rows = p.m_max / S;        // rows this CTA owns, % 32 == 0
  const int wpc = rows / 32;           // their words
  const int m_words = p.m_max / 32;
  const bool has_final = p.wf != nullptr;
  const int ldx = p.ldx, act1 = p.act1_off;   // act[0] at word 0
  int* red = reinterpret_cast<int*>(chain_smem + p.red_off);
  int* head = reinterpret_cast<int*>(chain_smem + p.head_off);

  // The epilogue's split: with G = 16 / wpc, warps below G wpc take row
  // group warp % wpc and every G-th column from warp / wpc; past 16 row
  // groups a warp takes every 16th row group and every column.
  int rg_first = warp, rg_step = kChainWarps, c_first = 0, c_step = 1;
  if (wpc <= kChainWarps) {
    const int G = kChainWarps / wpc;
    rg_first = warp < G * wpc ? warp % wpc : wpc;
    rg_step = wpc;
    c_first = warp / wpc;
    c_step = G;
  }
  const int rg0 = min(rg_first, wpc - 1);

  // The first layer's weights and its affine for this warp's first row
  // group are in flight while X's tile comes in.
  ChainFrag f;
  ChainItem item;
  bool have = chain_item(item, p, 0, warp, rank, rows);
  if (have) chain_load(f, item, item.k_lo);
  const long long ab0 = static_cast<long long>(rank) * rows + rg0 * 32 + lane;
  float a_next = ldg_now(p.a + ab0), b_next = ldg_now(p.b + ab0);

  // X's columns [n0, n0 + 8 nt) into act[0] as [column][word]: lane (g, t)
  // of a unit (an n tile, 16 words) stores words 4t..4t+3 of column g (the
  // B operand's conflict-free pattern); words past KW_act are all-ones. A
  // warp loads 4 units before it stores them.
  {
    const int g = lane >> 2, t = lane & 3;
    const int units = kChainNTiles * ((p.kw_act + 15) / 16);
    for (int u0 = warp; u0 < units; u0 += 4 * kChainWarps) {
      uint4 v[4];
      int at[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int u = u0 + i * kChainWarps;
        const int j = u % kChainNTiles, k = (u / kChainNTiles) * 16 + 4 * t;
        const int col = j * kChainTileN + g;
        at[i] = u < units && j < nt && k < p.kw_act ? col * ldx + k : -1;
        if (at[i] < 0) continue;
        const unsigned* src = X + static_cast<long long>(k) * p.n + n0 + col;
        v[i].x = ldg_now(src);
        v[i].y = k + 1 < p.kw_act ? ldg_now(src + p.n) : ~0u;
        v[i].z = k + 2 < p.kw_act ? ldg_now(src + 2LL * p.n) : ~0u;
        v[i].w = k + 3 < p.kw_act ? ldg_now(src + 3LL * p.n) : ~0u;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (at[i] >= 0) *reinterpret_cast<uint4*>(chain_smem + at[i]) = v[i];
      }
    }
  }
  // The words past M_max/32 that a later layer (or the head) reads from a
  // buffer are all-ones, as in the Pallas kernel: act[1]'s now, act[0]'s
  // (X's words there) once layer 0 has read them. Peers write only words
  // below M_max/32.
  const auto fill_pads = [&](int buf, int end) {
    for (int c = warp; c < ncols; c += kChainWarps) {
      for (int k = m_words + lane; k < end; k += 32) chain_smem[buf + c * ldx + k] = ~0u;
    }
  };
  fill_pads(act1, p.pad_end1);
  if (has_final && rank == 0) {
    for (int i = tid; i < ((p.mf + 15) & ~15) * kChainCols; i += kChainThreads) head[i] = 0;
  }
  __syncthreads();
  // Init: every CTA's buffers are set before any peer writes into them
  // (waited on just before this CTA's first remote access).
  cluster_arrive();

  for (int l = 0; l < p.n_layers; ++l) {
    const int src = (l & 1) ? act1 : 0, dst = (l & 1) ? 0 : act1;
    const bool last = l + 1 == p.n_layers;
    const float a0 = a_next, b0 = b_next;
    if (l > 0) cluster_wait();  // layer l - 1's words have landed
    for (int it = warp, first = 1; have; it += kChainWarps, first = 0) {
      if (!first && !chain_item(item, p, l, it, rank, rows)) break;
      const int base = item.part * rows + item.row0;
      chain_item_counts(f, first != 0, item, src, ldx, nt, [&](int r, int c, int v) {
        red[(base + r) * kChainRedPitch + c] = v;
      });
    }
    // The next layer's (or the head's) first words and the next affine,
    // before the barrier.
    have = chain_item(item, p, l + 1, warp, rank, rows);
    if (have) chain_load(f, item, item.k_lo);
    if (!last) {
      a_next = ldg_now(p.a + (l + 1LL) * p.m_max + ab0);
      b_next = ldg_now(p.b + (l + 1LL) * p.m_max + ab0);
    }
    __syncthreads();  // partial counts staged; src read
    if (l == 0) {
      fill_pads(0, p.pad_end0);
      cluster_wait();  // init
    }
    // A warp adds one column's partials for 32 rows (a row a lane),
    // applies the affine and ballots the word.
    const int parts = p.parts[l];
    const int k_bits = p.k_bits[l];
    const float* al = p.a + static_cast<long long>(l) * p.m_max + rank * rows;
    const float* bl = p.b + static_cast<long long>(l) * p.m_max + rank * rows;
    for (int rg = rg_first; rg < wpc; rg += rg_step) {
      const int r = rg * 32 + lane, wr = rank * wpc + rg;
      const float av = rg == rg0 ? a0 : __ldg(al + r), bv = rg == rg0 ? b0 : __ldg(bl + r);
      for (int c = c_first; c < ncols; c += c_step) {
        int count = 0;
        for (int q = 0; q < parts; ++q) count += red[(q * rows + r) * kChainRedPitch + c];
        const unsigned word = sign_repack_warp(bn_affine(av, 2 * count - k_bits, bv));
        if (last && !has_final) {
          if (lane == 0) {
            out[static_cast<long long>(wr) * p.n + n0 + c] = n0 + c < p.n_real ? word : 0u;
          }
        } else if (last) {
          if (lane == 0) chain_smem[dst + c * ldx + wr] = word;  // the head reads its own words
        } else if (lane < S) {
          *cluster.map_shared_rank(chain_smem + dst + c * ldx + wr, lane) = word;
        }
      }
    }
    if (!last) cluster_arrive();
  }
  if (!has_final) return;

  // The head: this CTA's words of its K into CTA 0's accumulator.
  __syncthreads();
  const int src = (p.n_layers & 1) ? act1 : 0;
  for (int it = warp, first = 1; have; it += kChainWarps, first = 0) {
    if (!first && !chain_item(item, p, p.n_layers, it, rank, rows)) break;
    const int row0 = item.row0;
    chain_item_counts(f, first != 0, item, src, ldx, nt, [&](int r, int c, int v) {
      if (row0 + r < p.mf) atomicAdd(cluster.map_shared_rank(head + (row0 + r) * kChainCols + c, 0), v);
    });
  }
  cluster_arrive();
  cluster_wait();
  if (rank != 0) return;
  int* dots = reinterpret_cast<int*>(out);
  for (int i = tid; i < p.mf * ncols; i += kChainThreads) {
    const int m = i / ncols, c = i % ncols;
    dots[static_cast<long long>(m) * p.n + n0 + c] =
        n0 + c < p.n_real ? 2 * head[m * kChainCols + c] - p.final_k_bits : 0;
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
  const auto aligned = [](const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; };
  p.vec_w = kw_max % 4 == 0 && aligned(w);
  p.vec_f = kwf % 4 == 0 && aligned(wf);
  return p;
}

// The clusters the chain takes: a power of two up to 16 CTAs that divides
// M_max/32, each CTA owning M_max/cluster rows of every layer.
bool chain_geometry_ok(int n_layers, int m_max, int cluster) {
  return n_layers >= 1 && n_layers <= kChainMaxLayers && cluster >= 1 &&
         cluster <= kChainMaxCluster && (cluster & (cluster - 1)) == 0 &&
         m_max % (32 * cluster) == 0;
}

cudaError_t chain_set_attributes(int smem, int cluster) {
  cudaError_t err = cudaFuncSetAttribute(
      megakernel_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess || cluster <= 8) return err;
  return cudaFuncSetAttribute(megakernel_chain_kernel,
                              cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
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
  *smem_bytes = 0;
  *max_clusters = 0;
  if (!chain_geometry_ok(n_layers, m_max, cluster)) return cudaErrorInvalidValue;
  ChainParams p = make_chain_params(nullptr, nullptr, nullptr, nullptr,
                                    kw_layer, nullptr, n_layers, m_max, 0,
                                    kw_act, mf, kwf, 0, 0, 0, cluster);
  const int smem = chain_finish(p);
  *smem_bytes = smem;
  cudaError_t err = chain_set_attributes(smem, cluster);
  if (err != cudaSuccess) {
    cudaGetLastError();  // as repro_megakernel_conv_stage_limits
    return static_cast<int>(err);
  }
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = chain_launch_config(1, cluster, smem, nullptr, attr);
  err = cudaOccupancyMaxActiveClusters(max_clusters, megakernel_chain_kernel, &cfg);
  return static_cast<int>(err);
}

// A cluster of `cluster` CTAs (gcd(16, M_max/32) on the main path unless
// the caller asks for another, chain_geometry_ok's) for every 8 columns of
// N; any other request returns cudaErrorInvalidValue.
extern "C" int repro_megakernel_chain(
    const void* w, const void* a, const void* b, const void* x,
    const void* wf, void* out, const int* kw_layer, const int* k_bits,
    int n_layers, int m_max, int kw_max, int kw_act, int mf, int kwf,
    int final_k_bits, int n, int n_real, int cluster, void* stream) {
  using namespace repro_torch;
  if (!chain_geometry_ok(n_layers, m_max, cluster) || n % kChainTileN != 0) {
    return cudaErrorInvalidValue;
  }
  ChainParams p = make_chain_params(w, a, b, wf, kw_layer, k_bits,
                                    n_layers, m_max, kw_max, kw_act, mf,
                                    kwf, final_k_bits, n, n_real, cluster);
  const int smem = chain_finish(p);
  cudaError_t err = chain_set_attributes(smem, cluster);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = chain_launch_config(
      (n + kChainCols - 1) / kChainCols, cluster, smem,
      static_cast<cudaStream_t>(stream), attr);
  err = cudaLaunchKernelEx(&cfg, megakernel_chain_kernel,
                           static_cast<const unsigned*>(x),
                           static_cast<unsigned*>(out), p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
