// The backward's tile kernel and what it shares with its entry points:
// the stash and workspace layouts, the transposed weights, bwd_tile_kernel
// and its launch (launch_tiles). fused_mlp_bwd.cu instantiates it at H =
// 128 to 512 beside the dW leg and the entry points; fused_mlp_bwd_wide.cu
// at H = 640 to 1024 (2-CTA pairs), so that nvcc compiles the two halves
// in parallel. fused_mlp_bwd.cu describes the whole backward.

#pragma once

#include <limits.h>

#include "fused_field.cuh"

namespace {

constexpr int HEAD_LD = 16;      // rgb / alpha cotangent rows, padded to one product step
constexpr int DB_GROUP = 64;     // bias partial rows per first-level reduction
constexpr int REDUCE_THREADS = 256;
constexpr int TRANSPOSE_THREADS = 256;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

size_t round_up(size_t x, size_t m) { return (x + m - 1) / m * m; }

// The stash: row-major bf16 arrays of n_pad rows each (element offsets).
//   pe      [pxp + pdp]   X of layer1 (xyz part), of the skips and of dir
//   act[i]  [H], i < L    x_0 = layer1's output, x_i = trunk layer i-1's
//                         ReLU output; x_{L-1} is the trunk output
//   feat    [H]           ReLU(fc_feat(trunk output))
//   h       [H/2]         the dir layer's ReLU output
//   dy[g]   [H], g <= L   output cotangent of product g (layer1, trunk, feat)
//   dy_dir  [H/2]         of the dir layer
//   dy_a    [HEAD_LD]     of the alpha head (column 0; the rest are zeros)
//   dy_rgb  [HEAD_LD]     of the rgb head (columns 0-2)
struct Stash {
  size_t pe, act, feat, h, dy, dy_dir, dy_a, dy_rgb, end;
};

__host__ __device__ Stash stash_layout(const Desc& d, long long n_pad) {
  const size_t n = (size_t)n_pad, H = d.hidden, L = d.num_layers;
  Stash s;
  s.pe = 0;
  s.act = s.pe + n * (d.pxp + d.pdp);
  s.feat = s.act + n * H * L;
  s.h = s.feat + n * H;
  s.dy = s.h + n * (H / 2);
  s.dy_dir = s.dy + n * H * (L + 1);
  s.dy_a = s.dy_dir + n * (H / 2);
  s.dy_rgb = s.dy_a + n * HEAD_LD;
  s.end = s.dy_rgb + n * HEAD_LD;
  return s;
}

// wt[(j H + n) H + k] = W_g[k][n] for g = L + 1 - j (j = 0: dir, 1: feat,
// 2..L: trunk layers L - 2 down to 0), n < H (the x part of the product's
// input), k < N_g (zeros past it): row block j is the K-major B operand of
// the dX chain's product j.
__global__ void __launch_bounds__(TRANSPOSE_THREADS)
wt_transpose_kernel(const Desc d, const bf16* __restrict__ W, bf16* __restrict__ wt) {
  const int H = d.hidden;
  const long long total = (long long)(d.num_layers + 1) * H * H;
  for (long long e = (long long)blockIdx.x * TRANSPOSE_THREADS + threadIdx.x; e < total;
       e += (long long)gridDim.x * TRANSPOSE_THREADS) {
    const int k = (int)(e % H), n = (int)((e / H) % H), j = (int)(e / ((long long)H * H));
    const int g = d.num_layers + 1 - j;
    wt[e] = k < gemm_n(d, g) ? W[d.w_off[g] + (size_t)k * gemm_k(d, g) + n]
                             : __float2bfloat16(0.f);
  }
}

// Tensor maps of the tile kernel: the forward's products, then the
// transposed copy wt, (L + 1) H rows of H columns, read in boxes of
// slab_box_rows(H) rows; then the stash regions the activation tile goes
// to by TMA stores, boxes of 64 rows x 64 columns (one 128 B swizzled atom
// of the tile each): act and feat ((L + 1) n_pad rows of H; feat follows
// act[L - 1]), dy ((L + 1) n_pad rows of H) and dy_dir (n_pad rows of H/2).
struct BwdMaps {
  FieldMaps fwd;
  CUtensorMap wt;
  CUtensorMap act, dy, dy_dir;
};

// The tile kernel's arguments, in the parameter space: read there when
// used rather than held in registers.
struct BwdArgs {
  const float* origins;
  const float* dirs;
  const float* z;
  const float* grad;  // (4, n_pts) f32
  const bf16* W;
  const float* B;
  bf16* stash;
  Stash st;
  uint32_t* bits;  // ReLU masks of products 1..L (mask_words)
  float* dbpart;   // one row of nb_ld per warpgroup of 64 points
  long long n_pts, n_pad, n_tiles;
  int samples, nb_ld;
};

// A consumer warpgroup's columns of an H-wide product: all of them, or its
// half under split_n, its quarter in a pair (fused_field.cuh).
__host__ __device__ constexpr int wg_cols(int H) {
  return split_n(H) ? H / (2 * cluster_ctas(H)) : H;
}
// Mask words a thread keeps per product: one per 8 chunks of 8 columns.
__host__ __device__ constexpr int mask_wpt(int H) { return (wg_cols(H) + 63) / 64; }

// The ReLU masks of forward product g's output (g = 1..L), as the recompute
// epilogue stores them: per (g, tile, warpgroup u of the tile's 2, or 4 in
// a pair), mask_wpt(H) words per thread, word w of thread t at w *
// WG_THREADS + t, bit k for its accumulator k. A dX epilogue reads them
// back with loads issued before its product, so the mask costs 4
// registers, not the 64 that its bf16 values would (the kernel has 168 a
// thread).
__host__ __device__ __forceinline__ size_t mask_words(int H, long long n_tiles, int g,
                                                      long long tile, int u, int t) {
  return (((size_t)g * n_tiles + tile) * 2 * cluster_ctas(H) + u) * WG_THREADS * mask_wpt(H) + t;
}

// Per-warp column partials the tile kernel keeps in shared memory: 4 warps
// x (wg_cols(H) + 4) floats per warpgroup (the dir epilogue's 4 extra: rgb,
// alpha). In a pair with one PE tile they lie in the PE arena (field_layout).
__host__ __device__ __forceinline__ int part_ld(int H) { return wg_cols(H) + 4; }
int part_bytes(int H) { return 2 * 4 * part_ld(H) * (int)sizeof(float); }

// One step of colsum8: lanes that differ in `bit` swap halves of their
// first 2h partials and each keeps the sum of the half it holds.
template <int h, int bit>
__device__ __forceinline__ void colsum_halve(float (&cs)[8], int lane) {
  const bool up = lane & bit;
#pragma unroll
  for (int k = 0; k < h; ++k) {
    const float send = up ? cs[k] : cs[k + h];
    const float keep = up ? cs[k + h] : cs[k];
    cs[k] = keep + __shfl_xor_sync(0xffffffffu, send, bit);
  }
}

// The column sums of 4 fragment chunks n0..n0+3 over the warp's 16 rows:
// cs[2i + j] is the thread's partial (rows r, r + 8) of column
// 8 (n0 + i) + 2q + j. Lanes of equal q sum them in one fixed order,
// halving what each holds per step (lane bits 4, 3, 2: 7 shuffles for 8
// columns), and each lane stores the one column sum it is left with into
// the warp's row of `part`, for the chunks below CHUNKS (a last group of
// fewer than 4 passes zeros for the rest).
template <int CHUNKS>
__device__ __forceinline__ void colsum8(float (&cs)[8], float* part, int n0, int q, int lane) {
  colsum_halve<4, 16>(cs, lane);
  colsum_halve<2, 8>(cs, lane);
  colsum_halve<1, 4>(cs, lane);
  const int m = ((lane >> 4) & 1) * 4 + ((lane >> 3) & 1) * 2 + ((lane >> 2) & 1);
  if (n0 + 4 <= CHUNKS || n0 + (m >> 1) < CHUNKS)
    part[8 * (n0 + (m >> 1)) + 2 * q + (m & 1)] = cs[0];
}

// A warpgroup's bias partial of n columns: its 4 warps' rows of `part`
// summed in order, into dst[0, n). After a warpgroup barrier.
__device__ __forceinline__ void flush_colsum(const float* part, int ld, int n, float* dst,
                                             int t) {
  for (int c = t; c < n; c += WG_THREADS)
    dst[c] = part[c] + part[ld + c] + part[2 * ld + c] + part[3 * ld + c];
}

// Chunks j and j + 1 of a fragment, y = {row r's j, row r + 8's j, row
// r's j + 1, row r + 8's j + 1} (bf16 pairs), into the warpgroup's A tile:
// one stmatrix at this lane's address for chunk pair j (stm_addr), or in a
// pair element by element into both CTAs' tiles (the tile's base act, the
// columns from col = c0 + 8 j + 2q; the peer's at `peer`).
template <bool PAIR>
__device__ __forceinline__ void put_pair(const uint32_t (&y)[4], uint32_t sm,
                                         unsigned char* act, int r, int col, uint32_t peer) {
  if constexpr (PAIR) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      *reinterpret_cast<uint32_t*>(act + swz(r, col + 8 * h)) = y[2 * h];
      *reinterpret_cast<uint32_t*>(act + swz(r + 8, col + 8 * h)) = y[2 * h + 1];
      st_peer(peer + swz(r, col + 8 * h), y[2 * h]);
      st_peer(peer + swz(r + 8, col + 8 * h), y[2 * h + 1]);
    }
  } else {
    stmatrix_x4(sm, y);
  }
}

// This lane's stmatrix address of chunk pair j in the A tile at `act`: the
// row (lane % 8, + 8 for lanes 8-15 and 24-31) of its matrix among the
// warp's 16 (r is the fragment's first row), chunk j or (lanes 16-31) j + 1.
__device__ __forceinline__ uint32_t stm_addr(uint32_t act, int r, int lane, int j) {
  return act + swz(r - (lane >> 2) + ((lane >> 3) & 1) * 8 + (lane & 7), 8 * (j + (lane >> 4)));
}

// The recompute's epilogue of an N = 2R-column product (rows r, r + 8 of
// the fragment): relu?(acc + bias), bias from shared memory, as bf16 into
// the warpgroup's A tile (put_pair), from which the kernel sends it to the
// stash; where `bits` is given, whether each bf16 value is > 0 (the ReLU
// mask the dX chain applies) as R bits, bit k for acc[k], in R/32 words,
// word w at bits[w * WG_THREADS] (a warp's stores of a word are
// contiguous; the last group of R/4 chunks not a multiple of 8 fills part
// of its word). Tested on the f32 value: bf16(v) > 0 exactly where v >
// 2^-134 (round to nearest even takes 2^-134, half the least bf16, and
// below to zero; negatives and NaN fail both), which spares unpacking the
// bf16 pair. In groups of 8 chunks, as epilogue() (fused_field.cuh).
template <int R, bool PAIR>
__device__ __forceinline__ void recompute_epilogue(const float (&acc)[R], const float* bias,
                                                   bool relu, unsigned char* act, int r, int q,
                                                   int lane, uint32_t* bits, int c0,
                                                   uint32_t peer) {
  constexpr int CHUNKS = R / 4;  // of 8 columns, an even number
  const uint32_t act_a = smem_u32(act);
#pragma unroll
  for (int n0 = 0; n0 < CHUNKS; n0 += 8) {
    uint32_t mb = 0;  // this group's word of mask bits
#pragma unroll
    for (int j = n0; j < n0 + 8 && j < CHUNKS; j += 2) {
      uint32_t y[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = j + h, col = 8 * n + 2 * q;
        const float2 b = *reinterpret_cast<const float2*>(bias + col);
        float v[4] = {acc[4 * n] + b.x, acc[4 * n + 1] + b.y, acc[4 * n + 2] + b.x,
                      acc[4 * n + 3] + b.y};
        if (relu) {
#pragma unroll
          for (int i = 0; i < 4; ++i) v[i] = fmaxf(v[i], 0.f);
        }
        y[2 * h] = pack_bf16(v[0], v[1]);
        y[2 * h + 1] = pack_bf16(v[2], v[3]);
        constexpr float half_least = 0x1p-134f;
        mb |= ((uint32_t)(v[0] > half_least) | (uint32_t)(v[1] > half_least) << 1 |
               (uint32_t)(v[2] > half_least) << 2 | (uint32_t)(v[3] > half_least) << 3)
              << (4 * (n - n0));
      }
      put_pair<PAIR>(y, stm_addr(act_a, r, lane, j), act, r, c0 + 8 * j + 2 * q, peer);
    }
    if (bits != nullptr) bits[n0 / 8 * WG_THREADS] = mb;
    asm volatile("" ::: "memory");
  }
}

// The epilogue of a dX product of N = 2R columns (rows r, r + 8 of the
// fragment): v = acc (+ bf16(dalpha) wa[col] for the trunk output), zeroed
// where bit k of mw is clear (masked: the forward's bf16 output of that
// product was not > 0; layer1 has no ReLU); bf16(v) in place into the
// warpgroup's A tile (put_pair), from which the kernel sends it to the
// stash's dY rows; v's column sums over the warp's 16 rows into `part`.
template <int R, bool PAIR = false>
__device__ __forceinline__ void dx_epilogue(const float (&acc)[R], unsigned char* act, int r,
                                            int q, int lane, bool masked,
                                            const uint32_t (&mw)[(R + 31) / 32], const bf16* wa,
                                            float a0, float a1, float* part, int c0 = 0,
                                            uint32_t peer = 0) {
  const uint32_t act_a = smem_u32(act);
#pragma unroll
  for (int n0 = 0; n0 < R / 4; n0 += 4) {
    float cs[8];
#pragma unroll
    for (int j = n0; j < n0 + 4; j += 2) {
      uint32_t y[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = j + h, col = 8 * n + 2 * q;
        float v[4] = {acc[4 * n], acc[4 * n + 1], acc[4 * n + 2], acc[4 * n + 3]};
        if (wa != nullptr) {
          const float2 w = bf16x2_at(wa + col);
          v[0] += a0 * w.x;
          v[1] += a0 * w.y;
          v[2] += a1 * w.x;
          v[3] += a1 * w.y;
        }
        if (masked) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (!((mw[n / 8] >> (4 * (n % 8) + i)) & 1u)) v[i] = 0.f;
        }
        y[2 * h] = pack_bf16(v[0], v[1]);
        y[2 * h + 1] = pack_bf16(v[2], v[3]);
        cs[2 * (n - n0)] = v[0] + v[2];
        cs[2 * (n - n0) + 1] = v[1] + v[3];
      }
      put_pair<PAIR>(y, stm_addr(act_a, r, lane, j), act, r, c0 + 8 * j + 2 * q, peer);
    }
    colsum8<R / 4>(cs, part, n0, q, lane);
  }
}

// One thread's mask words of forward product g (mask_words), loaded ahead
// of the dX product that needs them.
template <int W>
__device__ __forceinline__ void load_mask(uint32_t (&mw)[W], const uint32_t* p) {
#pragma unroll
  for (int w = 0; w < W; ++w) mw[w] = __ldcg(p + w * WG_THREADS);
}

// The backward's tile kernel (see the top of the file): field_body's
// producer, ring and forward recompute, then the heads and the dX chain.
// Rows past n_pts read the point 0 and a zero cotangent, so the stash's
// tail rows hold finite activations and zero cotangents, as the dW
// products over n_pad rows need. Under split_n (H > 256) it runs
// field_body's wide design: a 64-point tile shared by both consumer
// warpgroups, each taking half the columns of every product, the dX
// chain's included, with a barrier over both before an epilogue writes in
// place; the rgb head's dot products are summed across them through the
// exchange buffer, and warpgroup 0 alone writes the heads' cotangents and
// bias sums. At H > 512 (pair_n) the tile is shared by a pair of CTAs as
// in field_body: each warpgroup takes a quarter of the columns, its
// epilogues (the dir layer's cotangent too) write both CTAs' tiles, the
// pair barrier stands where the split design's 256-thread barrier does,
// and warpgroup 0 of CTA 0 writes what warpgroup 0 did.
template <int H>
__global__ void __launch_bounds__(FIELD_THREADS, 1)
bwd_tile_kernel(const __grid_constant__ BwdMaps maps, const Desc desc, const FieldLayout lay,
                const BwdArgs a) {
  constexpr bool SPLIT = split_n(H);
  constexpr bool PAIR = pair_n(H);
  constexpr int SK = slab_k(H);
  constexpr int ROWS = tile_rows(H);
  constexpr int NW = wg_cols(H);  // a warpgroup's columns of an H-wide product
  constexpr int ND = NW / 2;      // of the dir product
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bar_off);
  uint64_t* empty = full + MAX_STAGES;
  const PeCol* tab = reinterpret_cast<const PeCol*>(smem + lay.tab_off);
  const Desc& d = field_setup(smem, desc, lay, true);
  const int tid = threadIdx.x;
  const int L = d.num_layers;
  const int wg = tid / WG_THREADS;
  const int rank = PAIR ? (int)cluster_rank() : 0;
  const long long first = PAIR ? cluster_index() : blockIdx.x;
  const long long stride = PAIR ? cluster_count() : gridDim.x;

  if (wg == 2) {
    // Producer: the forward's products, then the dX chain's on wt (the
    // trunk output's brings the alpha head for its rank-1 term).
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (tid == 2 * WG_THREADS) {
      Producer prod{0, 0};
      for (long long t = first; t < a.n_tiles; t += stride) {
        for (int g = 0; g < L + 2; ++g) {
          uint32_t head_bytes;
          int head_at;
          const bf16* head = product_head(d, a.W, g, &head_bytes, &head_at);
          const int N = gemm_n(d, g), rows = cta_rows(H, N);
          prod.product<SK>(smem, lay, full, empty, &maps.fwd.w[g], rank * rows, gemm_k(d, g), N,
                           rows, a.B + d.b_off[g], head, head_bytes, head_at);
        }
        constexpr int rows = cta_rows(H, H);
        for (int j = 0; j <= L; ++j)
          prod.product<SK>(smem, lay, full, empty, &maps.wt, j * H + rank * rows,
                           j == 0 ? H / 2 : H, H, rows, nullptr,
                           j == 1 ? a.W + d.wa_off : nullptr, 2 * H, alpha_off(H));
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
    const int t = tid % WG_THREADS, warp = t / 32, lane = t % 32;
    const int r = warp * 16 + lane / 4, q = lane % 4;  // fragment rows r, r + 8
    const int tile_row = SPLIT ? 0 : wg * 64;         // the warpgroup's first row of a tile
    const int u = rank * 2 + wg;  // SPLIT: the warpgroup's part of the tile's columns
    const int col0 = SPLIT ? u * NW : 0, cd0 = SPLIT ? u * ND : 0;  // its first columns
    // their rows of this CTA's slabs (2 SK bytes a row)
    const uint32_t b_w = SPLIT ? wg * NW * SK * 2 : 0;
    const uint32_t b_d = SPLIT ? wg * ND * SK * 2 : 0;
    unsigned char* act = smem + lay.act_off + (SPLIT ? 0 : wg * (H / 64) * ATOM_BYTES);
    unsigned char* pe = smem + lay.pe_off + (SPLIT ? 0 : wg * lay.pe_blocks * ATOM_BYTES);
    // its output columns: PAIR passes the tile and col0 to the epilogues
    unsigned char* act_w = PAIR ? act : act + col0 / 64 * ATOM_BYTES;
    const int c_w = PAIR ? col0 : 0;
    float* part = reinterpret_cast<float*>(smem + lay.extra_off) + wg * 4 * part_ld(H);
    const uint32_t act_a = smem_u32(act), pe_a = smem_u32(pe);
    const uint32_t act_p = PAIR ? peer_addr(act_a, rank ^ 1) : 0;  // the peer CTA's tile
    Ring ring{full, empty, smem, lay.slot_bytes, lay.slab_bytes, lay.stages, 0, 0};
    TileSync<H> tsync = tile_sync<H>(smem, lay, rank, wg);
    // The column partials share the PE arena (field_layout): the next
    // tile's PE is built only once every warpgroup has read them.
    const bool part_in_pe = lay.extra_off == lay.pe_off;
    // The stash's act, feat, dy and dy_dir rows leave from the activation
    // tile itself by TMA stores, a 64 x 64 box per 128 B swizzled atom (the
    // maps' swizzle undoes the tile's, so the stash stays row-major): one
    // thread issues them, this warpgroup's first (or the CTA's, where the
    // warpgroups share the tile; in a pair each CTA sends its half of the
    // atoms), once the epilogue's writes are fenced and met at the
    // barrier (writes_done); it waits for their reads before the barrier
    // after the next product (products_done), past which an epilogue writes
    // the tile again.
    const bool storer = SPLIT ? tid == 0 : t == 0;
    auto store = [&](const CUtensorMap* map, int atoms, long long row) {
      if (!storer) return;
      const int share = PAIR ? (atoms + 1) / 2 : atoms;
      for (int i = rank * share; i < atoms && i < (rank + 1) * share; ++i)
        tma_store_2d(map, act + i * ATOM_BYTES, 64 * i, (int)row);
      bulk_commit();
    };
    auto products_done = [&] {
      if (storer) bulk_wait_read();
      tsync.products_done();
    };

    const int chunks = lay.pe_cols / 8;
    const int pt = SPLIT ? tid : t;  // the PE builder's thread
    PeBuild<true, true, SPLIT ? 4 : 2> pb;  // the first tile's PE, then each next tile's
    pb.start(a.origins, a.dirs, a.z, a.n_pts, a.samples, first * ROWS + tile_row, 0, pt);
    pb.stash_row(a.stash + a.st.pe, lay.pe_cols, first * ROWS + tile_row, pt);
    pb.finish(tab, chunks, pe, pt);

    for (long long tile = first; tile < a.n_tiles; tile += stride) {
      const long long row0 = tile * ROWS + tile_row;
      const long long next = tile + stride;
      const int pe_base = pb.base;  // this tile's first PE column
      fence_proxy_async();  // this tile's PE, built by every thread, to the products
      tile_barrier<SPLIT>(wg);
      // With two PE slots the next tile's PE is built in the other one, a
      // chunk per slab of the forward's products; with one, after the dX
      // chain. Either way the builder's registers are free for the dX
      // chain's epilogues.
      const bool ahead = lay.pe_slots == 2 && next < a.n_tiles;
      auto begin_next = [&] {
        const long long next0 = next * ROWS + tile_row;
        pb.start(a.origins, a.dirs, a.z, a.n_pts, a.samples, next0,
                 lay.pe_slots == 2 ? lay.pe_cols - pe_base : 0, pt);
        pb.stash_row(a.stash + a.st.pe, lay.pe_cols, next0, pt);
      };
      if (ahead) begin_next();
      auto work = [&] {
        if (ahead) pb.step(tab, chunks, pe, pt);
      };
      auto no_work = [] {};

      // ---- the forward, as field_body<H, true>, stashing every output
      // (and the ReLU masks of products 1..L; feat's rows follow act's) ----
      float acc[NW / 2];
#pragma unroll
      for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;
      for (int g = 0; g <= L; ++g) {  // layer1, the trunk, feat
        const bool skip = g > 0 && g < L && ((d.skip_mask >> (g - 1)) & 1);
        const int slot = layer_product<SK>(acc, ring, act_a, g == 0 ? 0 : H, pe_a, pe_base,
                                           g == 0 || skip ? d.pxp : 0, lane, work, b_w);
        products_done();  // every warp's products have read the tile
        recompute_epilogue<NW / 2, PAIR>(
            acc, reinterpret_cast<const float*>(ring.params(slot)) + col0, g > 0, act_w, r, q,
            lane, g > 0 ? a.bits + mask_words(H, a.n_tiles, g, tile, u, t) : nullptr, c_w, act_p);
        ring.release(slot, lane);
        tsync.writes_done();
        store(&maps.act, H / 64, g * a.n_pad + row0);
      }

      // dir on [feat | PE(dir)] -> H/2, then the heads in registers.
      float acc_d[ND / 2];
#pragma unroll
      for (int i = 0; i < ND / 2; ++i) acc_d[i] = 0.f;
      int slot = layer_product<SK>(acc_d, ring, act_a, H, pe_a, pe_base + d.pxp, d.pdp, lane,
                                   work, b_d);
      products_done();
      if (ahead) pb.finish(tab, chunks, pe, pt);
      const float* bd = reinterpret_cast<const float*>(ring.params(slot)) + cd0;
      const bf16* wr = reinterpret_cast<const bf16*>(ring.params(slot) + rgb_off(H)) + cd0;
      bf16* const h_out = a.stash + a.st.h + row0 * (H / 2) + cd0;
      float c0[3] = {0.f, 0.f, 0.f}, c1[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int n = 0; n < ND / 8; ++n) {
        if (n % 8 == 0) asm volatile("" ::: "memory");  // as in epilogue()
        const int col = 8 * n + 2 * q;
        const float2 b = *reinterpret_cast<const float2*>(bd + col);
        const uint32_t lo = pack_bf16(fmaxf(acc_d[4 * n] + b.x, 0.f),
                                      fmaxf(acc_d[4 * n + 1] + b.y, 0.f));
        const uint32_t hi = pack_bf16(fmaxf(acc_d[4 * n + 2] + b.x, 0.f),
                                      fmaxf(acc_d[4 * n + 3] + b.y, 0.f));
        *reinterpret_cast<uint32_t*>(h_out + r * (H / 2) + col) = lo;
        *reinterpret_cast<uint32_t*>(h_out + (r + 8) * (H / 2) + col) = hi;
        const float2 h0 = bf16x2_at(reinterpret_cast<const bf16*>(&lo));
        const float2 h1 = bf16x2_at(reinterpret_cast<const bf16*>(&hi));
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float2 w = bf16x2_at(wr + c * (H / 2) + col);
          c0[c] += h0.x * w.x + h0.y * w.y;
          c1[c] += h1.x * w.x + h1.y * w.y;
        }
      }
      // The rgb head's sums of rows r, r + 8: the quad's, or under SPLIT
      // every warpgroup's part (in a pair, written to both CTAs), in the
      // order of u (every thread then holds the same sums).
      float sr0[3], sr1[3];
      if constexpr (SPLIT) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float p0 = quad_sum(c0[c]), p1 = quad_sum(c1[c]);
          if (q == 0) tsync.put(c, r, p0, p1);
        }
        tsync.exchanged();
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          sr0[c] = tsync.sum(c, r);
          sr1[c] = tsync.sum(c, r + 8);
        }
      } else {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          sr0[c] = quad_sum(c0[c]);
          sr1[c] = quad_sum(c1[c]);
        }
      }
      // rgb, its cotangent through the sigmoid, and alpha's, rows r, r + 8
      // (every lane of a quad holds them); tail rows take a zero cotangent.
      const long long g0 = row0 + r, g1 = g0 + 8;
      float dr0[3], dr1[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float br = a.B[d.br_off + c];
        const float rgb0 = 1.f / (1.f + expf(-(sr0[c] + br)));
        const float rgb1 = 1.f / (1.f + expf(-(sr1[c] + br)));
        dr0[c] = (g0 < a.n_pts ? a.grad[c * a.n_pts + g0] : 0.f) * rgb0 * (1.f - rgb0);
        dr1[c] = (g1 < a.n_pts ? a.grad[c * a.n_pts + g1] : 0.f) * rgb1 * (1.f - rgb1);
      }
      const float da0 = g0 < a.n_pts ? a.grad[3 * a.n_pts + g0] : 0.f;
      const float da1 = g1 < a.n_pts ? a.grad[3 * a.n_pts + g1] : 0.f;
      const bool writer = !SPLIT || u == 0;  // who writes a shared tile's heads
      if (writer) {
        // dy_rgb, dy_a: lane q writes columns 4q..4q+3 of both rows.
        const uint2 zero = make_uint2(0u, 0u);
        bf16* const yr = a.stash + a.st.dy_rgb + (size_t)row0 * HEAD_LD + 4 * q;
        bf16* const ya = a.stash + a.st.dy_a + (size_t)row0 * HEAD_LD + 4 * q;
        *reinterpret_cast<uint2*>(yr + r * HEAD_LD) =
            q == 0 ? make_uint2(pack_bf16(dr0[0], dr0[1]), pack_bf16(dr0[2], 0.f)) : zero;
        *reinterpret_cast<uint2*>(yr + (r + 8) * HEAD_LD) =
            q == 0 ? make_uint2(pack_bf16(dr1[0], dr1[1]), pack_bf16(dr1[2], 0.f)) : zero;
        *reinterpret_cast<uint2*>(ya + r * HEAD_LD) =
            q == 0 ? make_uint2(pack_bf16(da0, 0.f), 0u) : zero;
        *reinterpret_cast<uint2*>(ya + (r + 8) * HEAD_LD) =
            q == 0 ? make_uint2(pack_bf16(da1, 0.f), 0u) : zero;
      }
      // The dir layer's output cotangent dh = sum_c bf16(drgb_c) Wr[c, :],
      // masked by h > 0: the A tile of the first dX product (feat has been
      // sent to the stash; in a pair, to both CTAs' tiles), and from it the
      // stash's dy_dir.
      {
        float rb0[3], rb1[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          rb0[c] = bf16_round(dr0[c]);
          rb1[c] = bf16_round(dr1[c]);
        }
        float* const my_part = part + warp * part_ld(H);
#pragma unroll
        for (int n0 = 0; n0 < ND / 8; n0 += 4) {
          float cs[8];
#pragma unroll
          for (int n = n0; n < n0 + 4; ++n) {
            if (n >= ND / 8) {  // past the last chunk (ND / 8 not a multiple of 4)
              cs[2 * (n - n0)] = cs[2 * (n - n0) + 1] = 0.f;
              continue;
            }
            const int col = 8 * n + 2 * q;
            const float2 b = *reinterpret_cast<const float2*>(bd + col);
            const float2 h0 = __bfloat1622float2(__floats2bfloat162_rn(
                fmaxf(acc_d[4 * n] + b.x, 0.f), fmaxf(acc_d[4 * n + 1] + b.y, 0.f)));
            const float2 h1 = __bfloat1622float2(__floats2bfloat162_rn(
                fmaxf(acc_d[4 * n + 2] + b.x, 0.f), fmaxf(acc_d[4 * n + 3] + b.y, 0.f)));
            float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              const float2 w = bf16x2_at(wr + c * (H / 2) + col);
              v[0] += rb0[c] * w.x;
              v[1] += rb0[c] * w.y;
              v[2] += rb1[c] * w.x;
              v[3] += rb1[c] * w.y;
            }
            if (!(h0.x > 0.f)) v[0] = 0.f;
            if (!(h0.y > 0.f)) v[1] = 0.f;
            if (!(h1.x > 0.f)) v[2] = 0.f;
            if (!(h1.y > 0.f)) v[3] = 0.f;
            const uint32_t lo = pack_bf16(v[0], v[1]), hi = pack_bf16(v[2], v[3]);
            *reinterpret_cast<uint32_t*>(act + swz(r, cd0 + col)) = lo;
            *reinterpret_cast<uint32_t*>(act + swz(r + 8, cd0 + col)) = hi;
            if constexpr (PAIR) {
              st_peer(act_p + swz(r, cd0 + col), lo);
              st_peer(act_p + swz(r + 8, cd0 + col), hi);
            }
            cs[2 * (n - n0)] = v[0] + v[2];
            cs[2 * (n - n0) + 1] = v[1] + v[3];
          }
          colsum8<ND / 8>(cs, my_part, n0, q, lane);
        }
        // The heads' bias sums: rows r, r + 8, then the warp's row groups.
        float hs[4] = {dr0[0] + dr1[0], dr0[1] + dr1[1], dr0[2] + dr1[2], da0 + da1};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
#pragma unroll
          for (int bit = 4; bit <= 16; bit *= 2) hs[k] += __shfl_xor_sync(0xffffffffu, hs[k], bit);
        }
        if (lane == 0) {
#pragma unroll
          for (int k = 0; k < 4; ++k) my_part[ND + k] = hs[k];
        }
      }
      ring.release(slot, lane);
      tsync.writes_done();
      store(&maps.dy_dir, H / 128, row0);
      float* const db = a.dbpart + (row0 / 64) * a.nb_ld;  // one row per 64 points
      flush_colsum(part, part_ld(H), ND, db + d.b_off[L + 1] + cd0, t);
      if (writer && t < 4) {
        const int c = ND + t;
        db[t < 3 ? d.br_off + t : d.ba_off] =
            part[c] + part[part_ld(H) + c] + part[2 * part_ld(H) + c] + part[3 * part_ld(H) + c];
      }
      const float a0 = bf16_round(da0), a1 = bf16_round(da1);

      // ---- the dX chain: product j gives the output cotangent of forward
      // product g = L - j (feat, the trunk output, ..., layer1) ----
      // A fresh accumulator: layer_product pins acc's registers on entry, so
      // without this the trunk's sums would stay live (and spill) across
      // the dir product and the heads.
#pragma unroll
      for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;
      for (int j = 0; j <= L; ++j) {
        const int g = L - j;
        uint32_t mw[mask_wpt(H)] = {};
        if (g > 0) load_mask(mw, a.bits + mask_words(H, a.n_tiles, g, tile, u, t));
        slot = layer_product<SK>(acc, ring, act_a, j == 0 ? H / 2 : H, 0, 0, 0, lane, no_work,
                                 b_w);
        products_done();
        const bf16* wa =
            j == 1 ? reinterpret_cast<const bf16*>(ring.params(slot) + alpha_off(H)) + col0
                   : nullptr;
        dx_epilogue<NW / 2, PAIR>(acc, act_w, r, q, lane, g > 0, mw, wa, a0, a1,
                                  part + warp * part_ld(H), c_w, act_p);
        ring.release(slot, lane);
        tsync.writes_done();
        store(&maps.dy, H / 64, g * a.n_pad + row0);
        flush_colsum(part, part_ld(H), NW, db + d.b_off[g] + col0, t);
      }
      // With one PE slot, the next tile's PE now (the dir product, the
      // last to read this tile's, is done: barriers followed it), once the
      // column partials that share its arena are read.
      if (!ahead && next < a.n_tiles) {
        if (part_in_pe) tile_barrier<SPLIT>(wg);
        begin_next();
        pb.finish(tab, chunks, pe, pt);
      }
    }
    if (storer) bulk_wait();  // the stash's last rows are written before the CTA leaves
  }
  if constexpr (PAIR) cluster_sync_all();  // no CTA leaves while its peer may reach into it
}

// ---- the workspace: the stash, then the dW leg's partials ----

constexpr int DW_RANGES = 24;        // point ranges, at most (partials per dW element)
constexpr int DW_MIN_RANGE = 2048;   // points per range, at least (short inputs)

// Points per dW range for n_pad points (a multiple of 64): about n_pad /
// DW_RANGES in whole 64-point stages, at least DW_MIN_RANGE. Fixed by the
// shape alone, so the partials, and dW's bits, are the same on every card.
int dw_range_pts(long long n_pad) {
  const long long r = (long long)round_up((size_t)((n_pad + DW_RANGES - 1) / DW_RANGES), SLAB_K);
  return (int)(r > DW_MIN_RANGE ? r : DW_MIN_RANGE);
}

// Workspace layout (bytes), every region on a 256 B boundary.
struct Workspace {
  long long n_pad;
  int tiles, db_rows, range_pts, ranges, groups;
  int n_weights, n_biases, tw_ld, nb_ld;
  size_t partial, dbpart, dbtmp, wt, bits, total;
};

Workspace workspace_layout(const Desc& d, long long n_pts) {
  Workspace w;
  w.n_pad = (long long)round_up((size_t)n_pts, 128);
  w.tiles = (int)(w.n_pad / tile_rows(d.hidden));
  w.db_rows = (int)(w.n_pad / 64);  // one per 64 points
  w.range_pts = dw_range_pts(w.n_pad);
  w.ranges = (int)((w.n_pad + w.range_pts - 1) / w.range_pts);
  w.groups = (w.db_rows + DB_GROUP - 1) / DB_GROUP;
  w.n_weights = d.wr_off + 3 * (d.hidden / 2);
  w.n_biases = d.br_off + 3;
  w.tw_ld = (int)round_up(w.n_weights, 64);
  w.nb_ld = (int)round_up(w.n_biases, 64);
  const size_t stash = round_up(stash_layout(d, w.n_pad).end * sizeof(bf16), 256);
  w.partial = stash;
  w.dbpart = w.partial + (size_t)w.ranges * w.tw_ld * sizeof(float);
  w.dbtmp = w.dbpart + (size_t)w.db_rows * w.nb_ld * sizeof(float);
  w.wt = w.dbtmp + (size_t)w.groups * w.nb_ld * sizeof(float);
  w.bits = w.wt + round_up((size_t)(d.num_layers + 1) * d.hidden * d.hidden * sizeof(bf16), 256);
  w.total = w.bits + round_up(
      mask_words(d.hidden, w.tiles, d.num_layers + 1, 0, 0, 0) * sizeof(uint32_t), 256);
  return w;
}

// The transpose and the tile kernel on stream s. Every check (alignment,
// tensor maps, the shared-memory plan: a descriptor that leaves the ring
// fewer than 2 slots is refused with cudaErrorInvalidValue) comes before
// the first launch.
template <int H>
int launch_tiles(const Desc& d, const Workspace& ws, const float* o, const float* dirs,
                 const float* z, long long n_pts, int samples, const float* grad,
                 const bf16* W, const float* B, unsigned char* base, cudaStream_t s) {
  int sms = 0, smem_limit = 0;
  BwdMaps maps;
  int rc = field_prepare(d, W, B, d.num_layers + 2, &sms, &smem_limit, &maps.fwd);
  if (rc != 0) return rc;
  bf16* wt = reinterpret_cast<bf16*>(base + ws.wt);
  rc = encode_slab_map(&maps.wt, wt, H, (d.num_layers + 1) * H,
                       slab_box_rows(cta_rows(H, H)), slab_k(H));
  if (rc != 0) return rc;
  // The stash's maps (TMA coordinates are 32-bit: (L + 1) n_pad rows).
  const long long rows = (long long)(d.num_layers + 1) * ws.n_pad;
  if (rows > INT_MAX) return (int)cudaErrorInvalidValue;
  const Stash st = stash_layout(d, ws.n_pad);
  const bf16* stash = reinterpret_cast<const bf16*>(base);
  rc = encode_slab_map(&maps.act, stash + st.act, H, (int)rows, 64);
  if (rc == 0) rc = encode_slab_map(&maps.dy, stash + st.dy, H, (int)rows, 64);
  if (rc == 0) rc = encode_slab_map(&maps.dy_dir, stash + st.dy_dir, H / 2, (int)ws.n_pad, 64);
  if (rc != 0) return rc;
  FieldLayout lay;
  rc = field_layout(d, true, smem_limit, &lay, part_bytes(H));
  if (rc != 0) return rc;

  const long long wt_elems = (long long)(d.num_layers + 1) * H * H;
  wt_transpose_kernel<<<(unsigned)((wt_elems + TRANSPOSE_THREADS - 1) / TRANSPOSE_THREADS),
                        TRANSPOSE_THREADS, 0, s>>>(d, W, wt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  BwdArgs args;
  args.origins = o;
  args.dirs = dirs;
  args.z = z;
  args.grad = grad;
  args.W = W;
  args.B = B;
  args.stash = reinterpret_cast<bf16*>(base);
  args.st = st;
  args.bits = reinterpret_cast<uint32_t*>(base + ws.bits);
  args.dbpart = reinterpret_cast<float*>(base + ws.dbpart);
  args.n_pts = n_pts;
  args.n_pad = ws.n_pad;
  args.n_tiles = ws.tiles;
  args.samples = samples;
  args.nb_ld = ws.nb_ld;
  return ring_launch(bwd_tile_kernel<H>, cluster_ctas(H), ws.tiles, sms, lay.bytes, s, maps, d,
                     lay, args);
}

}  // namespace
