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
// What bounds it on an H100: the work is ~2x the forward's (dX and dW
// products beside the recomputed forward, ~3.5 MFLOP per point at lego
// width), but the dW products contract over all points, and the TPU kernel's
// way of doing that, accumulating dW in VMEM across a sequential grid, has no
// counterpart: blocks run in parallel and in no order, dW (2.4 MB in f32)
// does not fit a block's 227 KB of shared memory, and a 64-point tile's bf16
// stash (~338 KB at lego width) does not either.
//
// Design (right first, not fast), three kernels, no float atomics, so two
// launches on the same inputs give bitwise equal grads:
//   (a) bwd_tile_kernel, one block of 4 warps per 64-point tile: rebuilds the
//       PE and runs the forward as fused_mlp_fwd.cu does, writing each
//       layer's bf16 input to a stash in device memory; then runs the
//       backward chain (dX products by wmma against the weights, read from
//       L2), writing each layer's bf16 output cotangent dY to the stash and
//       each bias's f32 column sum over the tile to a per-tile partial.
//       ~10 KB of stash per point at lego width (3.9 GB at 2048 x 192).
//   (b) dw_partial_kernel: dW = dY^T X over points as split-K wmma products,
//       one block per 64x64 tile of a weight matrix and per chunk of
//       CHUNK_PTS points, each writing its own f32 partial.
//   (c) reduce_rows_kernel: the partials summed in a fixed order (chunks for
//       dW; tiles in two levels for the biases).
// The stash costs device-memory traffic (~20 KB per point written and read)
// that a fused design would keep on chip; making it fast is later work.

#include "fused_mlp_common.cuh"

namespace {

constexpr int HEAD_LD = 16;      // rgb / alpha cotangent rows, padded to one product step
constexpr int CHUNK_PTS = 4096;  // points per dW partial
constexpr int DB_GROUP = 64;     // tiles per first-level bias reduction
constexpr int DW_TILE = 64;      // dW tile edge per block (2 x 2 warps of 32 x 32)
constexpr int MAX_JOBS = 2 * MAX_GEMMS + 2;
constexpr int REDUCE_THREADS = 256;

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

// Copies a BM x width bf16 tile (width a multiple of 8) from shared memory to
// BM rows of a global array, 16 bytes per thread and step.
__device__ void store_tile(const bf16* __restrict__ s, int lds, int width,
                           bf16* __restrict__ g, int ldg) {
  const int vecs = width / 8;
  for (int e = threadIdx.x; e < BM * vecs; e += THREADS) {
    const int r = e / vecs, c = (e % vecs) * 8;
    *reinterpret_cast<uint4*>(g + (size_t)r * ldg + c) =
        *reinterpret_cast<const uint4*>(s + r * lds + c);
  }
}

// The backward of one layer for the block's tile:
//   v[p, n] = sum_k dy[p, k] W[k, n]          (bf16 operands, f32 sum)
//   v += bf16(add_a[p]) * add_w[n]             (when add_w: the alpha head)
//   v = mask[p, n] > 0 ? v : 0                 (when mask: a ReLU's output)
// W is the layer's (out, in) matrix, row-major with ld ldw: K = out rows and
// the first N columns (the x part of its input). Writes bf16(v) to `out`
// (shared) and `gout` (the stash), and each column's f32 sum over the BM
// points to colsum[n], in a fixed order. K a multiple of 16, N of 32.
__device__ void gemm_dx(const bf16* __restrict__ dy, int lddy, int K,
                        const bf16* __restrict__ w, int ldw, int N,
                        const float* __restrict__ add_a, int add_lda,
                        const bf16* __restrict__ add_w,
                        const bf16* __restrict__ mask, int ldm,
                        bf16* __restrict__ out, int ldo, bf16* __restrict__ gout,
                        int ldgo, float* __restrict__ colsum,
                        float* __restrict__ scratch) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int n0 = warp * 32; n0 < N; n0 += WARPS * 32) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BM / 16][2];
#pragma unroll
    for (int m = 0; m < BM / 16; ++m) {
      wmma::fill_fragment(acc[m][0], 0.f);
      wmma::fill_fragment(acc[m][1], 0.f);
    }
    for (int k0 = 0; k0 < K; k0 += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b0, b1;
      wmma::load_matrix_sync(b0, w + (size_t)k0 * ldw + n0, ldw);
      wmma::load_matrix_sync(b1, w + (size_t)k0 * ldw + n0 + 16, ldw);
#pragma unroll
      for (int m = 0; m < BM / 16; ++m) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
        wmma::load_matrix_sync(af, dy + m * 16 * lddy + k0, lddy);
        wmma::mma_sync(acc[m][0], af, b0, acc[m][0]);
        wmma::mma_sync(acc[m][1], af, b1, acc[m][1]);
      }
    }
    float cs0 = 0.f, cs1 = 0.f;  // lanes 0-15: columns n0 + lane, n0 + 16 + lane
#pragma unroll
    for (int m = 0; m < BM / 16; ++m) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::store_matrix_sync(scratch, acc[m][j], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int p = m * 16 + (e >> 4);
          const int col = n0 + 16 * j + (e & 15);
          float v = scratch[e];
          if (add_w != nullptr)
            v += bf16_round(add_a[p * add_lda]) * __bfloat162float(add_w[col]);
          if (mask != nullptr && !(__bfloat162float(mask[(size_t)p * ldm + col]) > 0.f))
            v = 0.f;
          scratch[e] = v;
          const bf16 b = __float2bfloat16(v);
          out[p * ldo + col] = b;
          gout[(size_t)p * ldgo + col] = b;
        }
        __syncwarp();
        if (lane < 16) {
          float s = 0.f;
          for (int r = 0; r < 16; ++r) s += scratch[r * 16 + lane];
          if (j == 0)
            cs0 += s;
          else
            cs1 += s;
        }
        __syncwarp();
      }
    }
    if (lane < 16) {
      colsum[n0 + lane] = cs0;
      colsum[n0 + 16 + lane] = cs1;
    }
  }
}

template <int H>
__global__ void __launch_bounds__(THREADS)
bwd_tile_kernel(const Desc desc, const float* __restrict__ origins,
                const float* __restrict__ dirs, const float* __restrict__ z,
                long long n_pts, int samples, const float* __restrict__ grad,
                const bf16* __restrict__ W, const float* __restrict__ B,
                bf16* __restrict__ stash, long long n_pad,
                float* __restrict__ dbpart, int nb_ld) {
  constexpr int ALD = H + 8;  // row stride 16 B off a 128 B multiple
  constexpr int HH = H / 2;
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x;
  const int pxp = desc.pxp, pdp = desc.pdp;
  const int pw = pxp + pdp;
  const int peld = pw + 8;
  bf16* act0 = reinterpret_cast<bf16*>(smem);
  bf16* act1 = act0 + BM * ALD;
  bf16* pe = act1 + BM * ALD;
  float* scratch = reinterpret_cast<float*>(pe + BM * peld);
  float* pts = scratch + WARPS * 256;  // [BM][6]: xyz, dir
  float* gh = pts + BM * 6;            // [BM][4]: cotangents of rgb pre-sigmoid, alpha
  float* wscratch = scratch + (tid >> 5) * 256;
  Desc& d = *reinterpret_cast<Desc*>(gh + BM * 4);
  if (tid == 0) d = desc;
  __syncthreads();

  const int L = d.num_layers;
  const long long base = (long long)blockIdx.x * BM;
  const Stash st = stash_layout(d, n_pad);
  bf16* const s_pe = stash + st.pe + (size_t)base * pw;
  bf16* const s_feat = stash + st.feat + (size_t)base * H;
  bf16* const s_h = stash + st.h + (size_t)base * HH;
  bf16* const s_dy_dir = stash + st.dy_dir + (size_t)base * HH;
  bf16* const s_dy_a = stash + st.dy_a + (size_t)base * HEAD_LD;
  bf16* const s_dy_rgb = stash + st.dy_rgb + (size_t)base * HEAD_LD;
  auto s_act = [&](int i) { return stash + st.act + ((size_t)i * n_pad + base) * H; };
  auto s_dy = [&](int g) { return stash + st.dy + ((size_t)g * n_pad + base) * H; };
  float* const db = dbpart + (size_t)blockIdx.x * nb_ld;

  // ---- forward, as fused_mlp_fwd.cu, stashing every layer's input ----
  load_tile_inputs(d, origins, dirs, z, n_pts, samples, base, pts, pe, peld);
  store_tile(pe, peld, pw, s_pe, pw);

  gemm_bias_act(pe, peld, pxp, nullptr, 0, 0, W + d.w_off[0], B + d.b_off[0], H,
                act0, ALD, false, wscratch);
  __syncthreads();
  store_tile(act0, ALD, H, s_act(0), H);

  bf16* cur = act0;
  bf16* nxt = act1;
  for (int i = 0; i < L - 1; ++i) {
    const bool skip = (d.skip_mask >> i) & 1;
    gemm_bias_act(cur, ALD, H, pe, peld, skip ? pxp : 0, W + d.w_off[1 + i],
                  B + d.b_off[1 + i], H, nxt, ALD, true, wscratch);
    __syncthreads();
    store_tile(nxt, ALD, H, s_act(i + 1), H);
    bf16* t = cur;
    cur = nxt;
    nxt = t;
  }
  // cur: trunk output. feat head into nxt, dir layer on [feat | PE(dir)] into cur.
  gemm_bias_act(cur, ALD, H, nullptr, 0, 0, W + d.w_off[L], B + d.b_off[L], H, nxt,
                ALD, true, wscratch);
  __syncthreads();
  store_tile(nxt, ALD, H, s_feat, H);
  gemm_bias_act(nxt, ALD, H, pe + pxp, peld, pdp, W + d.w_off[L + 1],
                B + d.b_off[L + 1], HH, cur, ALD, true, wscratch);
  __syncthreads();
  store_tile(cur, ALD, HH, s_h, HH);

  // ---- heads: the cotangent through the rgb sigmoid, and alpha's ----
  for (int e = tid; e < BM * 4; e += THREADS) {
    const int p = e >> 2, c = e & 3;
    const long long g = base + p;
    float v = g < n_pts ? grad[(size_t)c * n_pts + g] : 0.f;
    if (c < 3) {
      const bf16* h = cur + p * ALD;
      const bf16* wr = W + d.wr_off + c * HH;
      float s = 0.f;
      for (int k = 0; k < HH; ++k) s += __bfloat162float(h[k]) * __bfloat162float(wr[k]);
      const float rgb = 1.f / (1.f + expf(-(s + B[d.br_off + c])));
      v = v * rgb * (1.f - rgb);
    }
    gh[e] = v;
  }
  __syncthreads();
  for (int e = tid; e < BM * HEAD_LD; e += THREADS) {
    const int p = e / HEAD_LD, c = e % HEAD_LD;
    s_dy_rgb[e] = __float2bfloat16(c < 3 ? gh[p * 4 + c] : 0.f);
    s_dy_a[e] = __float2bfloat16(c == 0 ? gh[p * 4 + 3] : 0.f);
  }
  if (tid < 4) {
    float s = 0.f;
    for (int p = 0; p < BM; ++p) s += gh[p * 4 + tid];
    db[tid < 3 ? d.br_off + tid : d.ba_off] = s;
  }

  // dir layer's output cotangent dh = (drgb @ Wr) * (h > 0), into nxt (feat
  // is stashed already).
  for (int o = tid; o < HH; o += THREADS) {
    float cs = 0.f;
    for (int p = 0; p < BM; ++p) {
      float v = 0.f;
#pragma unroll
      for (int c = 0; c < 3; ++c)
        v += bf16_round(gh[p * 4 + c]) * __bfloat162float(W[d.wr_off + c * HH + o]);
      if (!(__bfloat162float(cur[p * ALD + o]) > 0.f)) v = 0.f;
      const bf16 b = __float2bfloat16(v);
      nxt[p * ALD + o] = b;
      s_dy_dir[(size_t)p * HH + o] = b;
      cs += v;
    }
    db[d.b_off[L + 1] + o] = cs;
  }
  __syncthreads();

  // feat head: df = (dh @ Wd[:, :H]) * (feat > 0), into cur.
  gemm_dx(nxt, ALD, HH, W + d.w_off[L + 1], H + pdp, H, nullptr, 0, nullptr, s_feat,
          H, cur, ALD, s_dy(L), H, db + d.b_off[L], wscratch);
  __syncthreads();
  // trunk output: dx = df @ Wf + bf16(dalpha) Wa, masked where the trunk
  // output is a ReLU's (L >= 2), into nxt.
  gemm_dx(cur, ALD, H, W + d.w_off[L], H, H, gh + 3, 4, W + d.wa_off,
          L >= 2 ? s_act(L - 1) : nullptr, H, nxt, ALD, s_dy(L - 1), H,
          db + d.b_off[L - 1], wscratch);
  __syncthreads();
  // trunk layers backwards: product 1 + i's cotangent -> product i's.
  cur = nxt;
  nxt = (cur == act0) ? act1 : act0;
  for (int i = L - 2; i >= 0; --i) {
    const int ldw = H + (((d.skip_mask >> i) & 1) ? pxp : 0);
    gemm_dx(cur, ALD, H, W + d.w_off[1 + i], ldw, H, nullptr, 0, nullptr,
            i > 0 ? s_act(i) : nullptr, H, nxt, ALD, s_dy(i), H, db + d.b_off[i],
            wscratch);
    __syncthreads();
    bf16* t = cur;
    cur = nxt;
    nxt = t;
  }
}

// One dW = dY^T X product, or one column block of it ([x | PE] inputs).
struct DwJob {
  long long dy_off, x_off;  // element offsets in the stash
  int ldy, m, m_real;       // dY row stride, rows of dW computed / kept
  int ldx, n;               // X row stride, columns of this block
  int w_off, ldw, col_off;  // where dW lies in the packed weights
  int tiles_n, tile_start;  // DW_TILE tiles along n; first tile's index
};

struct DwJobs {
  int count, tiles;
  DwJob job[MAX_JOBS];
};

__global__ void __launch_bounds__(THREADS)
dw_partial_kernel(const DwJobs jobs, const bf16* __restrict__ stash, long long n_pad,
                  float* __restrict__ partial, long long part_ld) {
  __shared__ __align__(32) float scratch[WARPS][256];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int j = 0;
  while (j + 1 < jobs.count && (int)blockIdx.x >= jobs.job[j + 1].tile_start) ++j;
  const DwJob& jb = jobs.job[j];
  const int t = (int)blockIdx.x - jb.tile_start;
  const int m0 = (t / jb.tiles_n) * DW_TILE + (warp >> 1) * 32;
  const int n0 = (t % jb.tiles_n) * DW_TILE + (warp & 1) * 32;
  const bool mv1 = m0 + 16 < jb.m, nv1 = n0 + 16 < jb.n;
  if (m0 >= jb.m || n0 >= jb.n) return;  // warp-uniform; no block barrier below

  const bf16* dy = stash + jb.dy_off;
  const bf16* x = stash + jb.x_off;
  const long long p0 = (long long)blockIdx.y * CHUNK_PTS;
  const long long p1 = p0 + CHUNK_PTS < n_pad ? p0 + CHUNK_PTS : n_pad;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    wmma::fill_fragment(acc[a][0], 0.f);
    wmma::fill_fragment(acc[a][1], 0.f);
  }
  for (long long p = p0; p < p1; p += 16) {
    // dY^T as a col-major (m, points) A operand; X as a row-major (points, n) B.
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a0, a1;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b0, b1;
    wmma::load_matrix_sync(a0, dy + (size_t)p * jb.ldy + m0, jb.ldy);
    wmma::load_matrix_sync(b0, x + (size_t)p * jb.ldx + n0, jb.ldx);
    if (mv1) wmma::load_matrix_sync(a1, dy + (size_t)p * jb.ldy + m0 + 16, jb.ldy);
    if (nv1) wmma::load_matrix_sync(b1, x + (size_t)p * jb.ldx + n0 + 16, jb.ldx);
    wmma::mma_sync(acc[0][0], a0, b0, acc[0][0]);
    if (nv1) wmma::mma_sync(acc[0][1], a0, b1, acc[0][1]);
    if (mv1) wmma::mma_sync(acc[1][0], a1, b0, acc[1][0]);
    if (mv1 && nv1) wmma::mma_sync(acc[1][1], a1, b1, acc[1][1]);
  }

  float* out = partial + (size_t)blockIdx.y * part_ld + jb.w_off + jb.col_off;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      if ((a == 1 && !mv1) || (b == 1 && !nv1)) continue;
      wmma::store_matrix_sync(scratch[warp], acc[a][b], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int row = m0 + 16 * a + (e >> 4);
        if (row < jb.m_real)
          out[(size_t)row * jb.ldw + n0 + 16 * b + (e & 15)] = scratch[warp][e];
      }
      __syncwarp();
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

// Workspace layout (bytes), every region on a 256 B boundary.
struct Workspace {
  long long n_pad;
  int tiles, chunks, groups;
  int n_weights, n_biases, tw_ld, nb_ld;
  size_t partial, dbpart, dbtmp, total;
};

Workspace workspace_layout(const Desc& d, long long n_pts) {
  Workspace w;
  w.n_pad = (long long)round_up((size_t)n_pts, BM);
  w.tiles = (int)(w.n_pad / BM);
  w.chunks = (int)((w.n_pad + CHUNK_PTS - 1) / CHUNK_PTS);
  w.groups = (w.tiles + DB_GROUP - 1) / DB_GROUP;
  w.n_weights = d.wr_off + 3 * (d.hidden / 2);
  w.n_biases = d.br_off + 3;
  w.tw_ld = (int)round_up(w.n_weights, 64);
  w.nb_ld = (int)round_up(w.n_biases, 64);
  const size_t stash = round_up(stash_layout(d, w.n_pad).end * sizeof(bf16), 256);
  w.partial = stash;
  w.dbpart = w.partial + (size_t)w.chunks * w.tw_ld * sizeof(float);
  w.dbtmp = w.dbpart + (size_t)w.tiles * w.nb_ld * sizeof(float);
  w.total = w.dbtmp + (size_t)w.groups * w.nb_ld * sizeof(float);
  return w;
}

void add_job(DwJobs* jobs, size_t dy_off, int ldy, int m, int m_real, size_t x_off,
             int ldx, int n, int w_off, int ldw, int col_off) {
  DwJob& jb = jobs->job[jobs->count++];
  jb.dy_off = (long long)dy_off;
  jb.x_off = (long long)x_off;
  jb.ldy = ldy;
  jb.m = m;
  jb.m_real = m_real;
  jb.ldx = ldx;
  jb.n = n;
  jb.w_off = w_off;
  jb.ldw = ldw;
  jb.col_off = col_off;
  jb.tiles_n = (n + DW_TILE - 1) / DW_TILE;
  jb.tile_start = jobs->tiles;
  jobs->tiles += ((m + DW_TILE - 1) / DW_TILE) * jb.tiles_n;
}

// Every weight matrix of the packed layout as dW = dY^T X jobs over the stash.
DwJobs dw_jobs(const Desc& d, long long n_pad) {
  const Stash st = stash_layout(d, n_pad);
  const size_t n = (size_t)n_pad;
  const int H = d.hidden, L = d.num_layers, pxp = d.pxp, pdp = d.pdp;
  const int pw = pxp + pdp;
  auto act = [&](int i) { return st.act + (size_t)i * n * H; };
  auto dy = [&](int g) { return st.dy + (size_t)g * n * H; };
  DwJobs jobs = {};
  add_job(&jobs, dy(0), H, H, H, st.pe, pw, pxp, d.w_off[0], pxp, 0);  // layer1
  for (int i = 0; i < L - 1; ++i) {
    const bool skip = (d.skip_mask >> i) & 1;
    const int ldw = H + (skip ? pxp : 0);
    add_job(&jobs, dy(1 + i), H, H, H, act(i), H, H, d.w_off[1 + i], ldw, 0);
    if (skip) add_job(&jobs, dy(1 + i), H, H, H, st.pe, pw, pxp, d.w_off[1 + i], ldw, H);
  }
  add_job(&jobs, dy(L), H, H, H, act(L - 1), H, H, d.w_off[L], H, 0);  // feat
  add_job(&jobs, st.dy_dir, H / 2, H / 2, H / 2, st.feat, H, H, d.w_off[L + 1], H + pdp,
          0);  // dir, feat part
  add_job(&jobs, st.dy_dir, H / 2, H / 2, H / 2, st.pe + pxp, pw, pdp, d.w_off[L + 1],
          H + pdp, H);  // dir, PE(dir) part
  add_job(&jobs, st.dy_a, HEAD_LD, HEAD_LD, 1, act(L - 1), H, H, d.wa_off, H, 0);
  add_job(&jobs, st.dy_rgb, HEAD_LD, HEAD_LD, 3, st.h, H / 2, H / 2, d.wr_off, H / 2, 0);
  return jobs;
}

template <int H>
size_t tile_smem_bytes(const Desc& d) {
  const size_t peld = d.pxp + d.pdp + 8;
  return 2 * BM * (H + 8) * sizeof(bf16) + BM * peld * sizeof(bf16) +
         (WARPS * 256 + BM * 6 + BM * 4) * sizeof(float) + sizeof(Desc);
}

template <int H>
int launch_tiles(const Desc& d, const Workspace& ws, const float* o, const float* dirs,
                 const float* z, long long n_pts, int samples, const float* grad,
                 const bf16* W, const float* B, unsigned char* base, cudaStream_t s) {
  const size_t smem = tile_smem_bytes<H>(d);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_tile_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  bwd_tile_kernel<H><<<(unsigned)ws.tiles, THREADS, smem, s>>>(
      d, o, dirs, z, n_pts, samples, grad, W, B, reinterpret_cast<bf16*>(base),
      ws.n_pad, reinterpret_cast<float*>(base + ws.dbpart), ws.nb_ld);
  return (int)cudaGetLastError();
}

int reduce_rows(const float* in, long long ld_in, int rows, int cols, int group,
                float* out, long long ld_out, cudaStream_t s) {
  const dim3 grid((cols + REDUCE_THREADS - 1) / REDUCE_THREADS,
                  (rows + group - 1) / group);
  reduce_rows_kernel<<<grid, REDUCE_THREADS, 0, s>>>(in, ld_in, rows, cols, group, out,
                                                     ld_out);
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

  err = d.hidden == 128
            ? launch_tiles<128>(d, ws, origins, dirs, z, n_pts, samples, grad, W, biases,
                                base, s)
            : launch_tiles<256>(d, ws, origins, dirs, z, n_pts, samples, grad, W, biases,
                                base, s);
  if (err != 0) return err;

  const DwJobs jobs = dw_jobs(d, ws.n_pad);
  float* partial = reinterpret_cast<float*>(base + ws.partial);
  dw_partial_kernel<<<dim3(jobs.tiles, ws.chunks), THREADS, 0, s>>>(
      jobs, reinterpret_cast<const bf16*>(base), ws.n_pad, partial, ws.tw_ld);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  err = reduce_rows(partial, ws.tw_ld, ws.chunks, ws.n_weights, ws.chunks, dW, 0, s);
  if (err != 0) return err;

  float* dbpart = reinterpret_cast<float*>(base + ws.dbpart);
  float* dbtmp = reinterpret_cast<float*>(base + ws.dbtmp);
  err = reduce_rows(dbpart, ws.nb_ld, ws.tiles, ws.n_biases, DB_GROUP, dbtmp, ws.nb_ld, s);
  if (err != 0) return err;
  return reduce_rows(dbtmp, ws.nb_ld, ws.groups, ws.n_biases, ws.groups, dB, 0, s);
}
