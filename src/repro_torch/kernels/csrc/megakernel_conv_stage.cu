// One conv stage of the binarized network in one launch: 1-4 fused direct
// binary convs (stride 1, folded-BN affine, sign, repack along D) and an
// optional 2x2 packed-OR maxpool. Intermediate maps never reach global
// memory.
//
//   X    [N, H, W, CW_0]    channel-packed map (no border: laid down here)
//   W_l  [D_l, kh*kw*CW_l]  tap-aligned packed filters, D_l % 32 == 0
//   a_l, b_l [D_l]          folded affine (pad channels a = 0, b = +1)
//   out  [N, OH', OW', D_last/32]  (OH' = OH/2 when pooled)
//
// Replaces the Pallas kernel `_conv_stage_kernel` / `megakernel_conv_stage`
// (src/repro/kernels/megakernel.py, pallas_call at :339). Plain twin:
// repro_torch.core.bitops.conv_stage_xla.
//
// Bound on the H100: the bit products at the 1-bit mma's rate (8x the int8
// peak), or the packed input map, filters and output once through HBM;
// the maps are a few KB per image and every staged word feeds many
// products.
//
// Residency. The Pallas kernel runs one program per image with every filter
// of the stage resident in VMEM. Here the main path's third stage holds
// 442,368 B of filters, more than one block's 227 KB of shared memory, and
// one block per image would put only N blocks on 132 SMs. So one image is a
// thread-block cluster of S = 8 CTAs (the portable limit). For each conv the
// CTAs form C = gcd(8, D_l/32) channel groups of P = 8 / C parts: CTA r
// stages the filters and affines of output words [g*DW_l/C, (g+1)*DW_l/C),
// g = r % C, and computes them for the 16-pixel chunks c = r / C (mod P).
// (C is 8 at the CIFAR net's stages 2 and 3; at stage 1, 4 channel words
// make 4 groups of 2 parts, so the stage has 256 CTAs, not 128.) Every
// CTA holds a full copy of the padded input map, its all-ones border laid
// down here. Between two convs, each CTA writes its words of the
// intermediate map into every CTA's copy through distributed shared
// memory, whose all-ones border each CTA laid down before the first
// cluster barrier; a cluster.sync() then publishes the map. The last
// conv's words go to the output buffers of the CTAs of their channel
// group, and after a barrier the pool (an OR of the four words of a 2x2
// tile) or a copy writes global memory once, the parts splitting the
// writes.
//
// The product: each conv is an implicit GEMM of the channel group (M)
// against the image's output pixels (N), K the kh*kw*CW window words in
// tap-major order, on the tensor cores as 1-bit mma.sync m16n8k256
// and.popc (xnor_tc.cuh's identity: xnor count = 32 K - P(w) - P(x) +
// 2 popc(w & x)). Both operands are resident in shared memory: A, the
// filter slice, as [channel][K] rows of pitch roundup(K, 8) + 4 words (=
// 4 mod 8: ldmatrix's eight 16-byte rows hit distinct banks; zeros past
// K), read by ldmatrix.x4; B is gathered from the map copy: lane (g, t)
// of m16n8k256's B fragment takes word t of pixel g's window, which is
// what ldmatrix gives for eight pixel rows of 16 bytes, so where CW % 4 ==
// 0 one ldmatrix.x4 at per-lane row addresses (the gather) brings the B
// fragments of two pixel tiles; other CW read one word a lane. A warp's
// unit is 32 channels x 16 pixels (2 x 2 mma tiles), 8 warps a CTA, up to
// 3 CTAs an SM, so the 32 clusters of a batch of 32 are resident at once.
// P(w) is counted once a conv, P(x) from the B fragments. The epilogue
// turns each lane's counts into sign bits (y = (a dot) + b, rounded
// twice) set at their places in the pixel's word, and three xor-shuffles
// gather a word from the eight lanes that hold its channels, so the words
// need no shared-memory staging. Each conv's filters are a cp.async group
// of their own: a conv waits only for its own.
#include <cooperative_groups.h>

#include "xnor_tc.cuh"

namespace cg = cooperative_groups;

namespace repro_torch {

constexpr int kStageMaxLayers = 4;
constexpr int kStageWarps = 8;
constexpr int kStageThreads = kStageWarps * 32;

struct StageParams {
  const unsigned* w[kStageMaxLayers];
  const float* a[kStageMaxLayers];
  const float* b[kStageMaxLayers];
  int d_words[kStageMaxLayers];   // D_l / 32
  int cw[kStageMaxLayers];        // input words per pixel of conv l
  int k_bits[kStageMaxLayers];    // true kh*kw*C_l
  int n_layers, hp, wp, kh, kw, pad, pool, cluster;
  int vec_x;                      // 16-byte copies of the input map
  int vec_w;                      // bit l: 16-byte copies of conv l's filters
};

// Shared-memory layout of one CTA, in 32-bit words, each region 16-B aligned.
struct StageLayout {
  int w_off[kStageMaxLayers];     // filters [own_ch][pitch]
  int pitch[kStageMaxLayers];
  int ab_off[kStageMaxLayers];    // a [own_ch], b [own_ch] (float)
  int pw_off[kStageMaxLayers];    // P(w) [own_ch]
  int tab_off[kStageMaxLayers];   // K words' offsets in the input map
  int x_off;
  int inter_off[2];
  int inter_words;
  int out_off;                    // the last conv's words [OH*OW][own_w]
  int total;
};

__host__ __device__ inline int align4(int v) { return (v + 3) & ~3; }

// Channel groups of conv l's output words in a cluster of S CTAs: CTA r
// owns the words of group r % C and the pixel part r / C of P = S / C.
__host__ __device__ inline int channel_groups(int S, int d_words) {
  int a = S, b = d_words;
  while (b) {
    const int r = a % b;
    a = b;
    b = r;
  }
  return a;
}

__host__ __device__ inline StageLayout stage_layout(const StageParams& p) {
  StageLayout s{};
  int off = 0;
  for (int l = 0; l < p.n_layers; ++l) {
    const int own_ch = 32 * (p.d_words[l] / channel_groups(p.cluster, p.d_words[l]));
    const int k = p.kh * p.kw * p.cw[l];
    s.pitch[l] = ((k + 7) & ~7) + 4;
    s.w_off[l] = off;
    off = align4(off + own_ch * s.pitch[l]);
    s.ab_off[l] = off;
    off = align4(off + 2 * own_ch);
    s.pw_off[l] = off;
    off = align4(off + own_ch);
    s.tab_off[l] = off;
    off = align4(off + k);
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
  const int last = p.n_layers - 1;
  s.out_off = off;
  off = align4(off + (h - p.kh + 1) * (w - p.kw + 1) *
                     (p.d_words[last] / channel_groups(p.cluster, p.d_words[last])));
  s.total = off;
  return s;
}

// The 1-bit products of one unit: channels [ch0, ch0 + 32) of the slice
// `ws` (rows of `pitch` words) against pixels [p0, p0 + 16) of the conv's
// output (`npix` of them, `ow` a row; later ones clamped, their results
// unused), over the K words of the map `src` (`win` pixels a row, CW words
// a pixel; `tab[k]`: word k's offset from the window's first word).
// acc[mi][j] is m16n8k256's C fragment of m16 tile mi and pixel tile j;
// px[j] P(x) of pixel (j, lane / 4).
template <bool kLdm>
__device__ __forceinline__ void unit_counts(const uint32_t* ws, int pitch, int ch0,
                                            const uint32_t* src, const int* tab, int K,
                                            int CW, int win, int ow, int npix, int p0,
                                            int (&acc)[2][2][4], int (&px)[2]) {
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  // ldmatrix.x4 of A: lanes 8i..8i+7 address matrix i = (rows +8 if i odd,
  // words +4 if i >= 2), so r[0..3] = a0..a3 of m16n8k256.
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_word = (lane >> 4) * 4;
  const uint32_t* wa = ws + (ch0 + a_row) * pitch + a_word;
  // B: with ldmatrix, lanes 8r..8r+7 address matrix r = (pixel tile r/2,
  // words +4 if r odd), a row a pixel; else lane (g, t) reads its own
  // pixel's words of each tile.
  int base[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int pix = min(p0 + (kLdm ? 8 * (lane >> 4) + (lane & 7) : 8 * j + (lane >> 2)),
                        npix - 1);
    const int y = pix / ow;
    base[j] = (y * win + pix - y * ow) * CW;
  }
  const int half = (lane >> 3) & 1;
  for (int kk = 0; kk < K; kk += 8) {
    uint32_t a0[4], a1[4], b[2][2];
    ldmatrix_x4(a0, wa + kk);
    ldmatrix_x4(a1, wa + 16 * pitch + kk);
    if (kLdm) {
      uint32_t r[4];
      ldmatrix_x4(r, src + base[0] + tab[min(kk + 4 * half, K - 4)]);
      const bool hi = kk + 4 < K;   // else words kk+4.. are past K (K % 8 == 4)
      b[0][0] = r[0];
      b[0][1] = hi ? r[1] : 0u;
      b[1][0] = r[2];
      b[1][1] = hi ? r[3] : 0u;
    } else {
      const int k0 = kk + t, k1 = kk + 4 + t;
      const int o0 = k0 < K ? tab[k0] : 0, o1 = k1 < K ? tab[k1] : 0;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        b[j][0] = k0 < K ? src[base[j] + o0] : 0u;
        b[j][1] = k1 < K ? src[base[j] + o1] : 0u;
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      px[j] += __popc(b[j][0]) + __popc(b[j][1]);
      mma_b1_and_popc(acc[0][j], a0, b[j][0], b[j][1]);
      mma_b1_and_popc(acc[1][j], a1, b[j][0], b[j][1]);
    }
  }
  // The 4 lanes of a quad hold one pixel over different words; add them.
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    px[j] += __shfl_xor_sync(0xffffffffu, px[j], 1);
    px[j] += __shfl_xor_sync(0xffffffffu, px[j], 2);
  }
}

// Per-conv constants of the unit loop.
struct ConvStep {
  const uint32_t* ws;   // filter slice [own_ch][pitch]
  const float* ab;      // a [own_ch], b [own_ch]
  const int* pw;        // P(w) [own_ch]
  const int* tab;       // K offsets
  const uint32_t* src;  // the input map copy
  uint32_t* dst;        // the next map (its copy in every CTA), or the output buffer
  int pitch, K, cw, win, ow, npix, own_w, dw, nxt_w, k_bits, pad;
  float inv_ow;         // 1 / ow: y = (pix + 0.5) / ow, truncated, is exact below 2^22
  int S, C, group;      // cluster size, channel groups, this CTA's group
  bool last;
};

// One unit of the conv: its counts, then the sign words. Lane (g, t)
// holds channels 32 wl + 16 mi + 8 hh + g of pixels p0 + 8 j + 2 t + q in
// acc[mi][j][2 hh + q]; it sets those bits at their places in the pixel's
// word, and three xor-shuffles over g OR the quad-mates' bits together, so
// every lane of a column quad holds the pixel's word. Lane g < S sends it
// to CTA g's copy of the next map; for the last conv, lane g < P to the
// output buffer of CTA group + C g, the g-th CTA of the channel group.
__device__ __forceinline__ void conv_unit(const ConvStep& c, int wl, int p0,
                                          cg::cluster_group& cluster) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  int acc[2][2][4] = {}, px[2] = {};
  if (c.cw % 4 == 0) {
    unit_counts<true>(c.ws, c.pitch, 32 * wl, c.src, c.tab, c.K, c.cw, c.win, c.ow,
                      c.npix, p0, acc, px);
  } else {
    unit_counts<false>(c.ws, c.pitch, 32 * wl, c.src, c.tab, c.K, c.cw, c.win, c.ow,
                       c.npix, p0, acc, px);
  }
  // dot = 2 (32 K - P(w) - P(x) + 2 acc) - k_bits = rest - 2 P(x) + 4 acc
  float a[2][2], b[2][2];
  int rest[2][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int ch = 32 * wl + 16 * mi + 8 * hh + g;
      a[mi][hh] = c.ab[ch];
      b[mi][hh] = c.ab[32 * c.own_w + ch];
      rest[mi][hh] = 2 * (32 * c.K - c.pw[ch]) - c.k_bits;
    }
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int pxc2 = 2 * __shfl_sync(0xffffffffu, px[j], 4 * (2 * t + q));
      unsigned word = 0u;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int dot = rest[mi][hh] - pxc2 + 4 * acc[mi][j][2 * hh + q];
          if (bn_affine(a[mi][hh], dot, b[mi][hh]) >= 0.f) word |= 1u << (16 * mi + 8 * hh + g);
        }
      word |= __shfl_xor_sync(0xffffffffu, word, 4);
      word |= __shfl_xor_sync(0xffffffffu, word, 8);
      word |= __shfl_xor_sync(0xffffffffu, word, 16);
      const int pix = p0 + 8 * j + 2 * t + q;
      if (pix >= c.npix) continue;
      if (c.last) {
        if (g < c.S / c.C) *cluster.map_shared_rank(c.dst + pix * c.own_w + wl,
                                                      c.group + c.C * g) = word;
      } else if (g < c.S) {
        const int y = __float2int_rz((pix + 0.5f) * c.inv_ow), x = pix - y * c.ow;
        uint32_t* cell =
            c.dst + ((y + c.pad) * c.nxt_w + x + c.pad) * c.dw + c.group * c.own_w + wl;
        *cluster.map_shared_rank(cell, g) = word;
      }
    }
}

template <int N>
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  if (n >= N) {
    cp_async_wait<N>();
  } else if constexpr (N > 0) {
    cp_async_wait_upto<N - 1>(n);
  }
}

__global__ void __launch_bounds__(kStageThreads, 3)
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

  // Stage the input map with its all-ones border (a row at a time: its
  // interior words are one contiguous run of the unpadded map), then each
  // conv's filter slice (a warp a row, zeros past K) as a cp.async group of
  // its own, so a conv waits only for its own filters; affines, K tables
  // and the all-ones intermediate maps (their border stays all-ones) by
  // plain stores.
  const int h = p.hp - 2 * p.pad, w = p.wp - 2 * p.pad, cw0 = p.cw[0];
  const unsigned* xg = X + static_cast<size_t>(img) * h * w * cw0;
  unsigned* xs = smem + L.x_off;
  const int row = p.wp * cw0, lo = p.pad * cw0, hi = (w + p.pad) * cw0;
  const int step = p.vec_x ? 4 : 1;
  for (int y = warp; y < p.hp; y += kStageWarps) {
    const bool inside = y >= p.pad && y < h + p.pad;
    const unsigned* xr = xg + static_cast<size_t>(y - p.pad) * w * cw0 - lo;
    for (int r = lane * step; r < row; r += 32 * step) {
      unsigned* dst = xs + y * row + r;
      if (inside && r >= lo && r < hi) {
        if (p.vec_x) {
          cp_async16(dst, xr + r, 16);
        } else {
          cp_async4(dst, xr + r, true);
        }
      } else if (p.vec_x) {
        *reinterpret_cast<uint4*>(dst) = make_uint4(~0u, ~0u, ~0u, ~0u);
      } else {
        *dst = ~0u;
      }
    }
  }
  int win = p.wp;
  for (int l = 0; l < p.n_layers; ++l) {
    const int group = rank % channel_groups(S, p.d_words[l]);
    const int own_ch = 32 * (p.d_words[l] / channel_groups(S, p.d_words[l]));
    const int cw = p.cw[l];
    const int K = p.kh * p.kw * cw;
    const int pitch = L.pitch[l];
    const unsigned* wg = p.w[l] + static_cast<size_t>(group) * own_ch * K;
    unsigned* ws = smem + L.w_off[l];
    const int wstep = (p.vec_w >> l) & 1 ? 4 : 1;
    for (int r = warp; r < own_ch; r += kStageWarps) {
      for (int k = lane * wstep; k < pitch; k += 32 * wstep) {
        unsigned* dst = ws + r * pitch + k;
        const unsigned* from = wg + static_cast<size_t>(r) * K + k;
        if (wstep == 4) {
          cp_async16(dst, k < K ? from : wg, k < K ? 16 : 0);   // zeros past K
        } else if (k < K) {
          cp_async4(dst, from, true);
        } else {
          *dst = 0u;
        }
      }
    }
    float* ab = reinterpret_cast<float*>(smem + L.ab_off[l]);
    for (int i = tid; i < own_ch; i += kStageThreads) {
      cp_async4(ab + i, p.a[l] + group * own_ch + i, true);
      cp_async4(ab + own_ch + i, p.b[l] + group * own_ch + i, true);
    }
    cp_async_commit();
    int* tab = reinterpret_cast<int*>(smem + L.tab_off[l]);
    for (int k = tid; k < K; k += kStageThreads) {
      const int tap = k / cw, i = tap / p.kw;
      tab[k] = (i * win + tap - i * p.kw) * cw + k - tap * cw;
    }
    win = win - p.kw + 1 + 2 * p.pad;
  }
  const int n_inter = p.n_layers > 2 ? 2 : p.n_layers - 1;
  for (int i = tid; i < n_inter * L.inter_words; i += kStageThreads) {
    smem[L.inter_off[0] + i] = ~0u;
  }
  // Every CTA's buffers are initialised before any peer writes into them.
  cluster.sync();

  int hin = p.hp;
  win = p.wp;
  for (int l = 0; l < p.n_layers; ++l) {
    ConvStep c;
    c.last = l + 1 == p.n_layers;
    c.src = smem + (l == 0 ? L.x_off : L.inter_off[(l - 1) & 1]);
    c.dst = smem + (c.last ? L.out_off : L.inter_off[l & 1]);
    c.cw = p.cw[l];
    c.K = p.kh * p.kw * c.cw;
    c.pitch = L.pitch[l];
    c.win = win;
    c.ow = win - p.kw + 1;
    c.inv_ow = 1.f / c.ow;
    const int oh = hin - p.kh + 1;
    c.npix = oh * c.ow;
    c.dw = p.d_words[l];
    c.nxt_w = c.ow + 2 * p.pad;
    c.k_bits = p.k_bits[l];
    c.pad = p.pad;
    c.S = S;
    c.C = channel_groups(S, c.dw);
    c.group = rank % c.C;
    c.own_w = c.dw / c.C;
    c.ws = smem + L.w_off[l];
    c.ab = reinterpret_cast<const float*>(smem + L.ab_off[l]);
    c.tab = reinterpret_cast<const int*>(smem + L.tab_off[l]);
    int* pw = reinterpret_cast<int*>(smem + L.pw_off[l]);
    c.pw = pw;
    // This conv's filters (and, for the first, the map) have landed; count
    // P(w) of each channel, a warp a row.
    cp_async_wait_upto<kStageMaxLayers - 1>(p.n_layers - 1 - l);
    __syncthreads();
    for (int r = warp; r < 32 * c.own_w; r += kStageWarps) {
      int s = 0;
      for (int k = lane; k < c.K; k += 32) s += __popc(c.ws[r * c.pitch + k]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) pw[r] = s;
    }
    if (!c.last && l >= 2) {
      // A reused buffer: lay this map's all-ones border down again (the
      // previous map had other widths). Peers write only interior cells.
      const int nxt_h = oh + 2 * p.pad;
      for (int i = tid; i < nxt_h * c.nxt_w * c.dw; i += kStageThreads) {
        const int cell = i / c.dw, y = cell / c.nxt_w, x = cell % c.nxt_w;
        if (y < p.pad || y >= oh + p.pad || x < p.pad || x >= c.ow + p.pad) c.dst[i] = ~0u;
      }
    }
    __syncthreads();  // P(w) is readable

    // Units of 32 channels x 16 pixels; this CTA takes the pixel chunks
    // of its part.
    const int parts = S / c.C, part = rank / c.C;
    const int chunks = ((c.npix + 15) / 16 - part + parts - 1) / parts;
    for (int u = warp; u < c.own_w * chunks; u += kStageWarps) {
      conv_unit(c, u % c.own_w, (part + (u / c.own_w) * parts) * 16, cluster);
    }
    if (!c.last || parts > 1) {
      cluster.sync();   // the next map, or the parts' words of the last conv
                        // in every output buffer, is complete
    } else {
      __syncthreads();  // the last conv's words are in the output buffer
    }
    if (c.last) {
      // The channel group's parts split the writes.
      const unsigned* mine = c.dst;
      const int own_w = c.own_w, ow = c.ow, dw = c.dw;
      unsigned* og = out + c.group * own_w;
      if (p.pool) {
        const int ph = oh / 2, pwd = ow / 2;
        for (int i = tid + part * kStageThreads; i < ph * pwd * own_w;
             i += kStageThreads * parts) {
          const int wl = i % own_w, cell = i / own_w, y = cell / pwd, x = cell % pwd;
          const unsigned* q = mine + ((2 * y) * ow + 2 * x) * own_w + wl;
          og[((static_cast<size_t>(img) * ph + y) * pwd + x) * dw + wl] =
              q[0] | q[own_w] | q[ow * own_w] | q[(ow + 1) * own_w];
        }
      } else {
        for (int i = tid + part * kStageThreads; i < c.npix * own_w;
             i += kStageThreads * parts) {
          const int wl = i % own_w, cell = i / own_w;
          og[(static_cast<size_t>(img) * c.npix + cell) * dw + wl] = mine[i];
        }
      }
    }
    hin = oh + 2 * p.pad;
    win = c.nxt_w;
  }
}

StageParams make_params(const void* x, const void* const* w, const void* const* a,
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
  p.vec_x = cw[0] % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  for (int l = 0; l < n_layers && l < kStageMaxLayers; ++l) {
    const bool vec = (kh * kw * cw[l]) % 4 == 0 &&
                     (w == nullptr || reinterpret_cast<uintptr_t>(w[l]) % 16 == 0);
    p.vec_w |= (vec ? 1 : 0) << l;
  }
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
  const StageParams p = make_params(nullptr, nullptr, nullptr, nullptr, d_words, cw,
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

// x: the unpadded map [N, hp - 2 pad, wp - 2 pad, cw[0]]; hp, wp the
// padded sizes.
extern "C" int repro_megakernel_conv_stage(
    const void* x, void* out, const void* const* w, const void* const* a,
    const void* const* b, const int* d_words, const int* cw,
    const int* k_bits, int n_layers, int n_images, int hp, int wp, int kh,
    int kw, int pad, int pool, int cluster, void* stream) {
  using namespace repro_torch;
  if (n_layers < 1 || n_layers > kStageMaxLayers) return cudaErrorInvalidValue;
  const StageParams p = make_params(x, w, a, b, d_words, cw, k_bits, n_layers,
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
