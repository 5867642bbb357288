// Fused FlexibleNeRF MLP backward, straight from rays, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel nerfmeshes_tpu/ops/pallas/fused_mlp.py:397
// (_bwd_kernel, launched by _fused_mlp_bwd, pallas_call :607). From the rays
// o, d, z and the channels-first cotangent g (4, N) of the forward's
// [rgb, sigma], it recomputes the PE and the forward, back-propagates g
// through the rgb sigmoid, the dir layer, the alpha and feat heads, the trunk
// with its PE skip and layer1, and returns f32 grads of every weight and bias
// in the packed layout (fused_mlp_common.cuh). The padding columns' grads
// are computed and discarded by the caller. Rays get no grad: the samples are
// detached upstream, as in the TPU kernel.
//
// Numerics are _bwd_kernel's: activations stashed in bf16, ReLU masks taken
// from the bf16 stash, every product on bf16 operands (cotangents included)
// with f32 accumulation, bias grads summed in f32 from the f32 cotangent,
// sigmoid' from the recomputed rgb.
//
// What bounds it on an H100: the work is ~3x the forward's (the recomputed
// forward, the dX products and the dW products, ~3.5 MFLOP per point at
// lego width), but the dW products contract over all points, and the TPU
// kernel's way of doing that, accumulating dW in VMEM across a sequential
// grid, has no counterpart: blocks run in parallel and in no order, and dW
// (2.4 MB in f32) fits no block's 227 KB of shared memory. So the products
// that make dY and those that contract it meet in device memory: a bf16
// stash, ~10 KB per point at lego width, written once and read back once.
//
// Design, four kernels, no float atomics, so two launches on the same inputs
// give bitwise equal grads:
//   (a) wt_transpose_kernel: a bf16 copy of the x part (first H columns) of
//       every matrix the dX chain multiplies by, transposed, so that the dX
//       products read K-major slabs through the same tensor maps and
//       descriptors as the forward (~1.2 MB at lego width).
//   (b) bwd_tile_kernel, the forward's machinery (fused_field.cuh: one
//       persistent CTA per SM, a producer streaming weight slabs by TMA into
//       a ring, two consumer warpgroups of 64 points running wgmma) on
//       128-point tiles (64-point tiles at H > 256, each product split in N
//       across the two consumer warpgroups, as the forward's: see
//       fused_field.cuh): it recomputes the forward, each epilogue also
//       storing its bf16 activation from the registers into the stash; the
//       rgb and alpha heads' cotangents and the dir layer's in the dir
//       product's epilogue, in registers; then the dX chain, L + 1 wgmma
//       products on the activation tile, each epilogue writing bf16(dY) to
//       the stash and in place as the next product's A tile, with each
//       bias's f32 column sum over the warpgroup's 64 rows. 3.9 GB of stash
//       at 2048 x 192.
//   (c) dw_kernel, dW = dY^T X for every weight matrix: ~1.2 MFLOP per point
//       against the ~10 KB of stash it reads, ~120 FLOP/B, under the ~295
//       FLOP/B at which bf16 tensor cores rather than HBM set the pace. So
//       it is built to read the stash about once with many bytes in flight:
//       a CTA per (128 x 256 block of a matrix, range of points), a producer
//       thread streaming 48 KB stages (64 points of dY's and X's rows) by
//       TMA straight from the row-major stash into a ring of 4, and two
//       consumer warpgroups contracting each stage with wgmma on MN-major
//       operands (the points are the stash's rows). The two row blocks of a
//       matrix over the same points run side by side and share X through
//       L2; at most DW_RANGES ranges, so the f32 partials stay ~58 MB at
//       lego width (~221 MB at 8x512, whose matrices of 384 or 512 columns
//       are jobs of 256 columns and the rest).
//   (d) reduce_rows_kernel: the partials summed in a fixed order (ranges for
//       dW; warpgroup rows in two levels for the biases).
// The stash costs device-memory traffic (~20 KB per point written and read)
// that a fused design would keep on chip: later work.

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
// slab_box_rows(H) rows.
struct BwdMaps {
  FieldMaps fwd;
  CUtensorMap wt;
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
// half under split_n (fused_field.cuh).
__host__ __device__ constexpr int wg_cols(int H) { return split_n(H) ? H / 2 : H; }

// The ReLU masks of forward product g's output (g = 1..L), as the recompute
// epilogue stores them: per (g, tile, warpgroup), wg_cols(H)/64 words per
// thread, word w of thread t at w * WG_THREADS + t, bit k for its
// accumulator k. A dX epilogue reads them back with loads issued before its
// product, so the mask costs 4 registers, not the 64 that its bf16 values
// would (the kernel has 168 a thread).
__host__ __device__ __forceinline__ size_t mask_words(int H, long long n_tiles, int g,
                                                      long long tile, int wg, int t) {
  return (((size_t)g * n_tiles + tile) * 2 + wg) * WG_THREADS * (wg_cols(H) / 64) + t;
}

// Per-warp column partials the tile kernel keeps in shared memory: 4 warps
// x (wg_cols(H) + 4) floats per warpgroup (the dir epilogue's 4 extra: rgb,
// alpha).
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
// the warp's row of `part`.
__device__ __forceinline__ void colsum8(float (&cs)[8], float* part, int n0, int q, int lane) {
  colsum_halve<4, 16>(cs, lane);
  colsum_halve<2, 8>(cs, lane);
  colsum_halve<1, 4>(cs, lane);
  const int m = ((lane >> 4) & 1) * 4 + ((lane >> 3) & 1) * 2 + ((lane >> 2) & 1);
  part[8 * (n0 + (m >> 1)) + 2 * q + (m & 1)] = cs[0];
}

// A warpgroup's bias partial of n columns: its 4 warps' rows of `part`
// summed in order, into dst[0, n). After a warpgroup barrier.
__device__ __forceinline__ void flush_colsum(const float* part, int ld, int n, float* dst,
                                             int t) {
  for (int c = t; c < n; c += WG_THREADS)
    dst[c] = part[c] + part[ld + c] + part[2 * ld + c] + part[3 * ld + c];
}

// The epilogue of a dX product of N = 2R columns (rows r, r + 8 of the
// fragment): v = acc (+ bf16(dalpha) wa[col] for the trunk output), zeroed
// where bit k of mw is clear (masked: the forward's bf16 output of that
// product was not > 0; layer1 has no ReLU); bf16(v) to the stash's dY rows
// (`ld` elements apart) and in place into the warpgroup's A tile; v's
// column sums over the warp's 16 rows into `part`.
template <int R>
__device__ __forceinline__ void dx_epilogue(const float (&acc)[R], unsigned char* act, int r,
                                            int q, int lane, bool masked,
                                            const uint32_t (&mw)[R / 32], const bf16* wa,
                                            float a0, float a1, bf16* dy, float* part,
                                            int ld = 2 * R) {
#pragma unroll
  for (int n0 = 0; n0 < R / 4; n0 += 4) {
    float cs[8];
#pragma unroll
    for (int n = n0; n < n0 + 4; ++n) {
      const int col = 8 * n + 2 * q;
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
      const uint32_t lo = pack_bf16(v[0], v[1]), hi = pack_bf16(v[2], v[3]);
      *reinterpret_cast<uint32_t*>(act + swz(r, col)) = lo;
      *reinterpret_cast<uint32_t*>(act + swz(r + 8, col)) = hi;
      *reinterpret_cast<uint32_t*>(dy + r * ld + col) = lo;
      *reinterpret_cast<uint32_t*>(dy + (r + 8) * ld + col) = hi;
      cs[2 * (n - n0)] = v[0] + v[2];
      cs[2 * (n - n0) + 1] = v[1] + v[3];
    }
    colsum8(cs, part, n0, q, lane);
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
// bias sums.
template <int H>
__global__ void __launch_bounds__(FIELD_THREADS, 1)
bwd_tile_kernel(const __grid_constant__ BwdMaps maps, const Desc desc, const FieldLayout lay,
                const BwdArgs a) {
  constexpr bool SPLIT = split_n(H);
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

  if (wg == 2) {
    // Producer: the forward's products, then the dX chain's on wt (the
    // trunk output's brings the alpha head for its rank-1 term).
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (tid == 2 * WG_THREADS) {
      Producer prod{0, 0};
      for (long long t = blockIdx.x; t < a.n_tiles; t += gridDim.x) {
        for (int g = 0; g < L + 2; ++g) {
          uint32_t head_bytes;
          int head_at;
          const bf16* head = product_head(d, a.W, g, &head_bytes, &head_at);
          prod.product(smem, lay, full, empty, &maps.fwd.w[g], 0, gemm_k(d, g), gemm_n(d, g),
                       a.B + d.b_off[g], head, head_bytes, head_at);
        }
        for (int j = 0; j <= L; ++j)
          prod.product(smem, lay, full, empty, &maps.wt, j * H, j == 0 ? H / 2 : H, H, nullptr,
                       j == 1 ? a.W + d.wa_off : nullptr, 2 * H, alpha_off(H));
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
    const int t = tid % WG_THREADS, warp = t / 32, lane = t % 32;
    const int r = warp * 16 + lane / 4, q = lane % 4;  // fragment rows r, r + 8
    const int tile_row = SPLIT ? 0 : wg * 64;         // the warpgroup's first row of a tile
    const int col0 = SPLIT ? wg * NW : 0, cd0 = SPLIT ? wg * ND : 0;  // its first columns
    const uint32_t b_w = col0 * 128, b_d = cd0 * 128;  // their slab rows (128 B a row)
    unsigned char* act = smem + lay.act_off + (SPLIT ? 0 : wg * (H / 64) * ATOM_BYTES);
    unsigned char* pe = smem + lay.pe_off + (SPLIT ? 0 : wg * lay.pe_blocks * ATOM_BYTES);
    unsigned char* act_w = act + col0 / 64 * ATOM_BYTES;  // its output columns
    float* part = reinterpret_cast<float*>(smem + lay.extra_off) + wg * 4 * part_ld(H);
    float* xch = reinterpret_cast<float*>(smem + lay.xch_off);  // SPLIT: [wg][rgb][64]
    const uint32_t act_a = smem_u32(act), pe_a = smem_u32(pe);
    Ring ring{full, empty, smem, lay.slot_bytes, lay.slab_bytes, lay.stages, 0, 0};

    const int chunks = lay.pe_cols / 8;
    const int pt = SPLIT ? tid : t;  // the PE builder's thread
    PeBuild<true, true, SPLIT ? 4 : 2> pb;  // the first tile's PE, then each next tile's
    pb.start(a.origins, a.dirs, a.z, a.n_pts, a.samples,
             (long long)blockIdx.x * ROWS + tile_row, 0, pt);
    pb.stash_row(a.stash + a.st.pe, lay.pe_cols, (long long)blockIdx.x * ROWS + tile_row, pt);
    pb.finish(tab, chunks, pe, pt);

    for (long long tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
      const long long row0 = tile * ROWS + tile_row;
      const long long next = tile + gridDim.x;
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
      // (and the ReLU masks of products 1..L) ----
      float acc[NW / 2];
#pragma unroll
      for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;
      float unused0 = 0.f, unused1 = 0.f;
      for (int g = 0; g <= L; ++g) {  // layer1, the trunk, feat
        const bool skip = g > 0 && g < L && ((d.skip_mask >> (g - 1)) & 1);
        const int slot = layer_product(acc, ring, act_a, g == 0 ? 0 : H, pe_a, pe_base,
                                       g == 0 || skip ? d.pxp : 0, lane, work, b_w);
        tile_barrier<SPLIT>(wg);  // every warp's products have read the tile
        bf16* const out = a.stash + (g < L ? a.st.act + (size_t)g * a.n_pad * H : a.st.feat) +
                          row0 * H + col0;
        epilogue<NW / 2, true>(acc, reinterpret_cast<const float*>(ring.params(slot)) + col0,
                               g > 0, act_w, r, q, nullptr, unused0, unused1, out,
                               g > 0 ? a.bits + mask_words(H, a.n_tiles, g, tile, wg, t)
                                     : nullptr,
                               H);
        ring.release(slot, lane);
        fence_proxy_async();
        tile_barrier<SPLIT>(wg);
      }

      // dir on [feat | PE(dir)] -> H/2, then the heads in registers.
      float acc_d[ND / 2];
#pragma unroll
      for (int i = 0; i < ND / 2; ++i) acc_d[i] = 0.f;
      int slot = layer_product(acc_d, ring, act_a, H, pe_a, pe_base + d.pxp, d.pdp, lane, work,
                               b_d);
      tile_barrier<SPLIT>(wg);
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
      // both warpgroups' parts, warpgroup 0's first (every thread of both
      // then holds the same sums).
      float sr0[3], sr1[3];
      if constexpr (SPLIT) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float p0 = quad_sum(c0[c]), p1 = quad_sum(c1[c]);
          if (q == 0) {
            xch[(wg * 4 + c) * 64 + r] = p0;
            xch[(wg * 4 + c) * 64 + r + 8] = p1;
          }
        }
        tile_barrier<SPLIT>(wg);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          sr0[c] = xch[c * 64 + r] + xch[(4 + c) * 64 + r];
          sr1[c] = xch[c * 64 + r + 8] + xch[(4 + c) * 64 + r + 8];
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
      if (!SPLIT || wg == 0) {
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
      // masked by h > 0: to the stash, and as the A tile of the first dX
      // product (feat is stashed already).
      {
        float rb0[3], rb1[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          rb0[c] = bf16_round(dr0[c]);
          rb1[c] = bf16_round(dr1[c]);
        }
        bf16* const dh_out = a.stash + a.st.dy_dir + row0 * (H / 2) + cd0;
        float* const my_part = part + warp * part_ld(H);
#pragma unroll
        for (int n0 = 0; n0 < ND / 8; n0 += 4) {
          float cs[8];
#pragma unroll
          for (int n = n0; n < n0 + 4; ++n) {
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
            *reinterpret_cast<uint32_t*>(dh_out + r * (H / 2) + col) = lo;
            *reinterpret_cast<uint32_t*>(dh_out + (r + 8) * (H / 2) + col) = hi;
            cs[2 * (n - n0)] = v[0] + v[2];
            cs[2 * (n - n0) + 1] = v[1] + v[3];
          }
          colsum8(cs, my_part, n0, q, lane);
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
      fence_proxy_async();
      tile_barrier<SPLIT>(wg);
      float* const db = a.dbpart + (row0 / 64) * a.nb_ld;  // one row per 64 points
      flush_colsum(part, part_ld(H), ND, db + d.b_off[L + 1] + cd0, t);
      if ((!SPLIT || wg == 0) && t < 4) {
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
        uint32_t mw[NW / 64] = {};
        if (g > 0) load_mask(mw, a.bits + mask_words(H, a.n_tiles, g, tile, wg, t));
        slot = layer_product(acc, ring, act_a, j == 0 ? H / 2 : H, 0, 0, 0, lane, no_work, b_w);
        tile_barrier<SPLIT>(wg);
        const bf16* wa =
            j == 1 ? reinterpret_cast<const bf16*>(ring.params(slot) + alpha_off(H)) + col0
                   : nullptr;
        dx_epilogue(acc, act_w, r, q, lane, g > 0, mw, wa, a0, a1,
                    a.stash + a.st.dy + ((size_t)g * a.n_pad + row0) * H + col0,
                    part + warp * part_ld(H), H);
        ring.release(slot, lane);
        fence_proxy_async();
        tile_barrier<SPLIT>(wg);
        flush_colsum(part, part_ld(H), NW, db + d.b_off[g] + col0, t);
      }
      // With one PE slot, the next tile's PE now (the dir product, the
      // last to read this tile's, is done: barriers followed it).
      if (!ahead && next < a.n_tiles) {
        begin_next();
        pb.finish(tab, chunks, pe, pt);
      }
    }
  }
}

// ---- (c) the dW leg: dW = dY^T X, contracted over points ----
//
// Both operands come straight from the row-major stash (points x features),
// so the contraction axis, the points, is each operand's outer dimension:
// A = dY^T (M = dW rows) and B = X (N = dW columns) are MN-major in shared
// memory, a box of 64 points x 64 features per TMA load, 128 B swizzled,
// and wgmma reads them through its transpose immediates (sw128_mn_desc,
// wgmma_bf16_mn). A work unit is one 128 x 256 block of a dW matrix (job)
// over one range of points: two 64-row atoms of dY (one per consumer
// warpgroup, each an m64n256 f32 accumulator) and four 64-column atoms of
// X per 64-point stage. Columns or rows past a map's width arrive as TMA's
// zeros (the heads' 16-column cotangents, the narrower PE jobs) and rows
// or columns past the job's are computed and never written.

// Jobs of a descriptor, at most: at H = 512 and 14 layers with a skip at
// every trunk layer, 2 column blocks for each of the 13 trunk products, feat,
// dir's feat part and the alpha head, 1 for layer1, the 12 skips' PE parts,
// dir's PE part and the rgb head: 47.
constexpr int MAX_JOBS = 56;
constexpr int DW_A_ATOMS = 2;   // dW rows per unit: 64 per consumer warpgroup
constexpr int DW_B_ATOMS = 4;   // dW columns per unit: 256
constexpr int DW_STAGE_BYTES = (DW_A_ATOMS + DW_B_ATOMS) * ATOM_BYTES;  // 48 KB, 64 points
constexpr int DW_STAGES = 4;
constexpr int DW_SMEM = DW_STAGES * DW_STAGE_BYTES + 2 * DW_STAGES * (int)sizeof(uint64_t);
constexpr int DW_RANGES = 24;        // point ranges, at most (partials per dW element)
constexpr int DW_MIN_RANGE = 2048;   // points per range, at least (short inputs)

// The stash regions the dW products read, one tensor map each (box 64 x 64).
enum DwMap { MAP_PE, MAP_ACT, MAP_H, MAP_DY, MAP_DY_DIR, MAP_DY_A, MAP_DY_RGB, N_MAPS };

// One dW = dY^T X product, or one column block of it ([x | PE] inputs):
// dY's columns [a_col, a_col + m) and X's [b_col, b_col + n) of the rows
// from a_row / b_row of their maps (the region's first point).
struct DwJob {
  int a_map, a_row, a_col, b_map, b_row, b_col;
  int m, m_real, n;         // dW rows computed / kept, columns
  int w_off, ldw, col_off;  // where dW lies in the packed weights
  int m_blocks, unit0;      // 128-row blocks; the job's first unit
};

// The dW kernel's arguments, in the parameter space. Unit u of job j
// (unit0 <= u < the next job's unit0) is its 128-row block (u - unit0) %
// m_blocks over point range (u - unit0) / m_blocks: the two blocks of a
// matrix over the same points are neighbours in launch order, so they run
// side by side and the X slabs they share come from L2.
struct DwArgs {
  CUtensorMap maps[N_MAPS];
  DwJob job[MAX_JOBS];
  int count, range_pts;
  long long n_pad;  // points, a multiple of 64
  float* partial;   // one row of part_ld per point range
  long long part_ld;
};
static_assert(sizeof(DwArgs) <= 4096, "dw_kernel's parameters");

// dW partials: one CTA per unit, a producer thread streaming the unit's
// stages by TMA into a ring of DW_STAGES, two consumer warpgroups each
// accumulating its 64 x 256 block in registers over the range's points in
// order (the same sums on every launch, whichever SM runs the unit), then
// writing the job's rows and columns of it to the range's partial row.
__global__ void __launch_bounds__(FIELD_THREADS, 1) dw_kernel(const __grid_constant__ DwArgs a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + DW_STAGES * DW_STAGE_BYTES);
  uint64_t* empty = full + DW_STAGES;
  const int tid = threadIdx.x, wg = tid / WG_THREADS;
  int j = 0;
  while (j + 1 < a.count && (int)blockIdx.x >= a.job[j + 1].unit0) ++j;
  const DwJob& jb = a.job[j];
  const int local = (int)blockIdx.x - jb.unit0;
  const int mb = local % jb.m_blocks;
  const long long p0 = (long long)(local / jb.m_blocks) * a.range_pts;
  const long long p1 = p0 + a.range_pts < a.n_pad ? p0 + a.range_pts : a.n_pad;
  const int slabs = (int)((p1 - p0) / SLAB_K);
  if (tid == 0) {
    for (int s = 0; s < DW_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * WG_THREADS / 32);  // every consumer warp releases
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (tid == 2 * WG_THREADS) {
      const CUtensorMap* am = &a.maps[jb.a_map];
      const CUtensorMap* bm = &a.maps[jb.b_map];
      const int a_col = jb.a_col + mb * DW_A_ATOMS * 64;
      int stage = 0;
      uint32_t phase = 0;
      for (int s = 0; s < slabs; ++s) {
        const int pt = (int)(p0 + (long long)s * SLAB_K);
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_arrive_expect_tx(&full[stage], DW_STAGE_BYTES);
        unsigned char* dst = smem + stage * DW_STAGE_BYTES;
#pragma unroll
        for (int i = 0; i < DW_A_ATOMS; ++i)
          tma_load_2d(dst + i * ATOM_BYTES, am, a_col + 64 * i, jb.a_row + pt, &full[stage]);
#pragma unroll
        for (int i = 0; i < DW_B_ATOMS; ++i)
          tma_load_2d(dst + (DW_A_ATOMS + i) * ATOM_BYTES, bm, jb.b_col + 64 * i, jb.b_row + pt,
                      &full[stage]);
        if (++stage == DW_STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
    const int t = tid % WG_THREADS, warp = t / 32, lane = t % 32;
    Ring ring{full, empty, smem, DW_STAGE_BYTES, DW_STAGE_BYTES, DW_STAGES, 0, 0};
    const uint32_t base = smem_u32(smem);
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    int prev = -1;
    fence_regs(acc);
    wgmma_fence();
    for (int s = 0; s < slabs; ++s) {
      mbar_wait(&ring.full[ring.stage], ring.phase);
      const uint32_t st = base + ring.stage * DW_STAGE_BYTES;
#pragma unroll
      for (int k = 0; k < SLAB_K / 16; ++k)
        wgmma_bf16_mn(acc, sw128_mn_desc(st + wg * ATOM_BYTES + 2048 * k),
                      sw128_mn_desc(st + DW_A_ATOMS * ATOM_BYTES + 2048 * k), s + k);
      wgmma_commit();
      if (prev >= 0) {
        wgmma_wait<1>();  // the previous stage's products are done: release it
        ring.release(prev, lane);
      }
      prev = ring.stage;
      ring.advance();
    }
    wgmma_wait<0>();
    fence_regs(acc);

    // acc[4n + 2i + c] is dW row 16 warp + lane / 4 + 8 i of this
    // warpgroup's 64, column 8 n + 2 (lane % 4) + c.
    const int row0 = mb * DW_A_ATOMS * 64 + wg * 64 + warp * 16 + lane / 4;
    float* const out = a.partial + (size_t)(p0 / a.range_pts) * a.part_ld + jb.w_off + jb.col_off;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      if (row >= jb.m_real) continue;
      float* const dst = out + (size_t)row * jb.ldw;
#pragma unroll
      for (int n = 0; n < 32; ++n) {
        const int col = 8 * n + 2 * (lane % 4);
        if (col < jb.n)
          *reinterpret_cast<float2*>(dst + col) = make_float2(acc[4 * n + 2 * i],
                                                              acc[4 * n + 2 * i + 1]);
      }
    }
  }
}

// out[g][c] = sum of in[r][c] over rows r of group g (group rows each), in
// row order: a fixed-order reduction, the same bits on every launch.
__global__ void __launch_bounds__(REDUCE_THREADS)
reduce_rows_kernel(const float* __restrict__ in, long long ld_in, int rows, int cols,
                   int group, float* __restrict__ out, long long ld_out) {
  const int c = blockIdx.x * REDUCE_THREADS + threadIdx.x;
  if (c >= cols) return;
  const int r0 = blockIdx.y * group;
  const int r1 = r0 + group < rows ? r0 + group : rows;
  float s = 0.f;
  for (int r = r0; r < r1; ++r) s += in[(size_t)r * ld_in + c];
  out[(size_t)blockIdx.y * ld_out + c] = s;
}

int reduce_rows(const float* in, long long ld_in, int rows, int cols, int group,
                float* out, long long ld_out, cudaStream_t s) {
  const dim3 grid((cols + REDUCE_THREADS - 1) / REDUCE_THREADS,
                  (rows + group - 1) / group);
  reduce_rows_kernel<<<grid, REDUCE_THREADS, 0, s>>>(in, ld_in, rows, cols, group, out,
                                                     ld_out);
  return (int)cudaGetLastError();
}

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

// Appends a job, as one job per 256-column block of its X (a unit's width),
// whose units follow the `units` before it; returns the total, or -1 past
// MAX_JOBS.
int add_job(DwArgs* a, int units, int ranges, DwJob jb) {
  if (units < 0) return units;
  for (int c = 0; c < jb.n; c += DW_B_ATOMS * 64) {
    if (a->count == MAX_JOBS) return -1;
    DwJob blk = jb;
    blk.b_col += c;
    blk.col_off += c;
    blk.n = jb.n - c < DW_B_ATOMS * 64 ? jb.n - c : DW_B_ATOMS * 64;
    blk.m_blocks = (jb.m + DW_A_ATOMS * 64 - 1) / (DW_A_ATOMS * 64);
    blk.unit0 = units;
    a->job[a->count++] = blk;
    units += blk.m_blocks * ranges;
  }
  return units;
}

// Every weight matrix of the packed layout as dW = dY^T X jobs over the
// stash's maps (encode_dw_maps); returns the number of units (-1: too many
// jobs).
int dw_jobs(const Desc& d, int n, int ranges, DwArgs* a) {
  const int H = d.hidden, L = d.num_layers, pxp = d.pxp, pdp = d.pdp;
  int u = 0;
  u = add_job(a, u, ranges, {MAP_DY, 0, 0, MAP_PE, 0, 0, H, H, pxp, d.w_off[0], pxp, 0});
  for (int i = 0; i < L - 1; ++i) {
    const bool skip = (d.skip_mask >> i) & 1;
    const int ldw = H + (skip ? pxp : 0);
    u = add_job(a, u, ranges,
                {MAP_DY, (1 + i) * n, 0, MAP_ACT, i * n, 0, H, H, H, d.w_off[1 + i], ldw, 0});
    if (skip)
      u = add_job(a, u, ranges,
                  {MAP_DY, (1 + i) * n, 0, MAP_PE, 0, 0, H, H, pxp, d.w_off[1 + i], ldw, H});
  }
  u = add_job(a, u, ranges,  // feat
              {MAP_DY, L * n, 0, MAP_ACT, (L - 1) * n, 0, H, H, H, d.w_off[L], H, 0});
  u = add_job(a, u, ranges,  // dir: the feat part (feat follows act[L - 1]), then PE(dir)
              {MAP_DY_DIR, 0, 0, MAP_ACT, L * n, 0, H / 2, H / 2, H, d.w_off[L + 1], H + pdp, 0});
  u = add_job(a, u, ranges,
              {MAP_DY_DIR, 0, 0, MAP_PE, 0, pxp, H / 2, H / 2, pdp, d.w_off[L + 1], H + pdp, H});
  u = add_job(a, u, ranges,  // the heads: 1 and 3 of their 16 cotangent columns
              {MAP_DY_A, 0, 0, MAP_ACT, (L - 1) * n, 0, HEAD_LD, 1, H, d.wa_off, H, 0});
  return add_job(a, u, ranges, {MAP_DY_RGB, 0, 0, MAP_H, 0, 0, HEAD_LD, 3, H / 2, d.wr_off, H / 2, 0});
}

// One tensor map per stash region the dW products read, box 64 x 64.
int encode_dw_maps(const Desc& d, const bf16* stash, int n, CUtensorMap* maps) {
  const Stash st = stash_layout(d, n);
  const int H = d.hidden, L = d.num_layers;
  const struct {
    size_t off;
    int cols, rows;
  } region[N_MAPS] = {{st.pe, d.pxp + d.pdp, n}, {st.act, H, (L + 1) * n}, {st.h, H / 2, n},
                      {st.dy, H, (L + 1) * n},   {st.dy_dir, H / 2, n},     {st.dy_a, HEAD_LD, n},
                      {st.dy_rgb, HEAD_LD, n}};
  for (int i = 0; i < N_MAPS; ++i) {
    const int rc = encode_slab_map(&maps[i], stash + region[i].off, region[i].cols,
                                   region[i].rows, SLAB_K);
    if (rc != 0) return rc;
  }
  return 0;
}

// dw_kernel over `units` units, then its partials summed over the point
// ranges in order into out (rows of `cols`, contiguous).
int launch_dw(const DwArgs& a, int units, int ranges, int cols, float* out, cudaStream_t s) {
  dw_kernel<<<units, FIELD_THREADS, DW_SMEM, s>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return reduce_rows(a.partial, a.part_ld, ranges, cols, ranges, out, 0, s);
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
  rc = encode_slab_map(&maps.wt, wt, H, (d.num_layers + 1) * H, slab_box_rows(H));
  if (rc != 0) return rc;
  FieldLayout lay;
  rc = field_layout(d, true, smem_limit, &lay, part_bytes(H));
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(bwd_tile_kernel<H>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, lay.bytes);
  if (err != cudaSuccess) return (int)err;

  const long long wt_elems = (long long)(d.num_layers + 1) * H * H;
  wt_transpose_kernel<<<(unsigned)((wt_elems + TRANSPOSE_THREADS - 1) / TRANSPOSE_THREADS),
                        TRANSPOSE_THREADS, 0, s>>>(d, W, wt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  BwdArgs args;
  args.origins = o;
  args.dirs = dirs;
  args.z = z;
  args.grad = grad;
  args.W = W;
  args.B = B;
  args.stash = reinterpret_cast<bf16*>(base);
  args.st = stash_layout(d, ws.n_pad);
  args.bits = reinterpret_cast<uint32_t*>(base + ws.bits);
  args.dbpart = reinterpret_cast<float*>(base + ws.dbpart);
  args.n_pts = n_pts;
  args.n_pad = ws.n_pad;
  args.n_tiles = ws.tiles;
  args.samples = samples;
  args.nb_ld = ws.nb_ld;
  const unsigned grid = (unsigned)(ws.tiles < sms ? ws.tiles : sms);
  bwd_tile_kernel<H><<<grid, FIELD_THREADS, lay.bytes, s>>>(maps, d, lay, args);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of device workspace nm_fused_mlp_bwd needs for n_pts points.
extern "C" int nm_fused_mlp_bwd_workspace(const int* desc_i, int n_desc_i,
                                          const float* freqs, int n_freqs,
                                          long long n_pts, long long* bytes) {
  Desc d;
  const int err = parse_desc(desc_i, n_desc_i, freqs, n_freqs, &d);
  if (err != 0) return err;
  if (n_pts <= 0) return (int)cudaErrorInvalidValue;
  *bytes = (long long)workspace_layout(d, n_pts).total;
  return 0;
}

// grad: the (4, n_rays * samples) f32 cotangent of the forward's channels-first
// output. dW / dB: f32 grads of the packed weights / biases (every element is
// written). workspace: device memory of nm_fused_mlp_bwd_workspace's size.
// Returns a cudaError_t code; 0 on success.
extern "C" int nm_fused_mlp_bwd(const float* origins, const float* dirs, const float* z,
                                long long n_rays, int samples, const float* grad,
                                const void* weights, const float* biases,
                                const int* desc_i, int n_desc_i, const float* freqs,
                                int n_freqs, void* workspace, long long workspace_bytes,
                                float* dW, float* dB, void* stream) {
  Desc d;
  int err = parse_desc(desc_i, n_desc_i, freqs, n_freqs, &d);
  if (err != 0) return err;
  if (samples <= 0 || n_rays <= 0) return (int)cudaErrorInvalidValue;
  const long long n_pts = n_rays * samples;
  const Workspace ws = workspace_layout(d, n_pts);
  if (workspace_bytes < (long long)ws.total) return (int)cudaErrorInvalidValue;
  const bf16* W = static_cast<const bf16*>(weights);
  unsigned char* base = static_cast<unsigned char*>(workspace);
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  // The dW leg's maps, jobs and shared memory first: every check before
  // the first launch.
  if ((long long)(d.num_layers + 1) * ws.n_pad > INT_MAX) return (int)cudaErrorInvalidValue;
  DwArgs dw = {};
  err = encode_dw_maps(d, reinterpret_cast<const bf16*>(base), (int)ws.n_pad, dw.maps);
  if (err != 0) return err;
  const int units = dw_jobs(d, (int)ws.n_pad, ws.ranges, &dw);
  if (units < 0) return (int)cudaErrorInvalidValue;
  dw.range_pts = ws.range_pts;
  dw.n_pad = ws.n_pad;
  dw.partial = reinterpret_cast<float*>(base + ws.partial);
  dw.part_ld = ws.tw_ld;
  err = (int)cudaFuncSetAttribute(dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  DW_SMEM);
  if (err != 0) return err;

  switch (d.hidden) {
    case 128:
      err = launch_tiles<128>(d, ws, origins, dirs, z, n_pts, samples, grad, W, biases, base, s);
      break;
    case 256:
      err = launch_tiles<256>(d, ws, origins, dirs, z, n_pts, samples, grad, W, biases, base, s);
      break;
    case 384:
      err = launch_tiles<384>(d, ws, origins, dirs, z, n_pts, samples, grad, W, biases, base, s);
      break;
    case 512:
      err = launch_tiles<512>(d, ws, origins, dirs, z, n_pts, samples, grad, W, biases, base, s);
      break;
    default:
      err = (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  err = launch_dw(dw, units, ws.ranges, ws.n_weights, dW, s);
  if (err != 0) return err;

  float* dbpart = reinterpret_cast<float*>(base + ws.dbpart);
  float* dbtmp = reinterpret_cast<float*>(base + ws.dbtmp);
  err = reduce_rows(dbpart, ws.nb_ld, ws.db_rows, ws.n_biases, DB_GROUP, dbtmp, ws.nb_ld, s);
  if (err != 0) return err;
  return reduce_rows(dbtmp, ws.nb_ld, ws.groups, ws.n_biases, ws.groups, dB, 0, s);
}

// The dW leg alone on one product, for its tests: out (m, n) f32 = dy^T x
// over n_pts points, dy (n_pts, ldy) and x (n_pts, ldx) row-major bf16 on
// 16 B aligned bases (ldy, ldx multiples of 8; m <= ldy, n <= ldx), through
// dw_kernel (one job per 256 columns) and the reduction over its point
// ranges, as the backward runs them. partial: scratch of partial_floats f32, at least
// DW_RANGES x round_up(m n, 64). Returns a cudaError_t code; 0 on success.
extern "C" int nm_dw_product(const void* dy, int ldy, int m, const void* x, int ldx, int n,
                             long long n_pts, float* partial, long long partial_floats,
                             float* out, void* stream) {
  if (m <= 0 || n <= 0 || m > ldy || n > ldx || ldy % 8 != 0 ||
      ldx % 8 != 0 || n_pts <= 0 || n_pts > INT_MAX - SLAB_K)
    return (int)cudaErrorInvalidValue;
  const long long n_pad = (long long)round_up((size_t)n_pts, SLAB_K);
  DwArgs a = {};
  a.range_pts = dw_range_pts(n_pad);
  a.n_pad = n_pad;
  a.partial = partial;
  a.part_ld = (long long)round_up((size_t)m * n, 64);
  const int ranges = (int)((n_pad + a.range_pts - 1) / a.range_pts);
  if (partial_floats < ranges * a.part_ld) return (int)cudaErrorInvalidValue;
  // Rows past n_pts (up to n_pad) arrive as TMA's zeros.
  int err = encode_slab_map(&a.maps[0], static_cast<const bf16*>(dy), ldy, (int)n_pts, SLAB_K);
  if (err == 0)
    err = encode_slab_map(&a.maps[1], static_cast<const bf16*>(x), ldx, (int)n_pts, SLAB_K);
  if (err == 0)
    err = (int)cudaFuncSetAttribute(dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    DW_SMEM);
  if (err != 0) return err;
  const int units = add_job(&a, 0, ranges, {0, 0, 0, 1, 0, 0, m, m, n, 0, n, 0});
  if (units < 0) return (int)cudaErrorInvalidValue;
  return launch_dw(a, units, ranges, m * n, out, static_cast<cudaStream_t>(stream));
}
