// The FlexibleNeRF field layer at a time, for Hopper (sm_90a): the route
// for every model the fused kernels do not take (ops/kernels/fused_mlp.py:
// field_route: hidden widths from 512 on, where this route beat the fused
// plans in turns on an H100; more than 24 bands, more than 14 layers, or
// a 128-384-wide field whose fused plans refuse it), which JAX still runs
// through its Pallas kernels: forward, sigma-only and backward, replacing
// nerfmeshes_tpu/ops/pallas/fused_mlp.py's _fwd_kernel (:387), _sigma_kernel
// (:675) and _bwd_kernel (:397) at those shapes. Same contract as the fused
// entry points (fused_mlp_fwd.cu, fused_sigma.cu, fused_mlp_bwd.cu), the same
// packed weights and descriptor, the same numerics: bf16 operands, f32
// sums, f32 bias, ReLU and sigmoid, an activation rounded to bf16 as the
// next product's operand.
//
// What bounds it on an H100: each product moves its bf16 activations
// through device memory, 2H^2 FLOPs a point against ~4H bytes, H/2 FLOP per
// byte; from H ~ 600 on that is above the card's ~295 FLOP/B, so the
// tensor cores can still set the pace (512 FLOP/B at 1024, 1024 at 2048),
// where the fused design's 64 x H activation tile no longer fits a block.
//
// Design, six kernels of its own beside the fused backward's range
// reduction (dw_leg.cuh:reduce_rows_kernel):
//   (1) layer_pe_kernel: PE(xyz) and PE(dir) of a slab of points into bf16
//       row-major arrays, a thread per point taking both values of each
//       argument from one range reduction, PE(dir) once per ray, the rows
//       staged in shared memory and stored 16 B a lane, with the fused
//       kernels' PE arithmetic (fused_field.cuh:PeBuild): on equal points
//       the same bits.
//   (2) layer_product_kernel<NN, BN, FULL>: Y = epilogue(A W^T + b), A
//       the K-concatenation of one or two bf16 row-major arrays ([x |
//       PE(xyz)] at skips, [feat | PE(dir)] at dir), W the packed (N, K)
//       matrix (NN 0), or for the backward's dX chain A W with W's (K, N) x
//       part read untransposed (NN 1). Output tiles of 128 rows x BN
//       columns, BN chosen per product from n (product_bn: 256, 192, 128 or
//       64, so that 576- or 64-column products compute no empty columns).
//       Persistent: one CTA per SM walks tiles blockIdx.x, + gridDim.x, ...
//       in row blocks with N fastest, so a row block's column tiles run side
//       by side and share its A panel through L2 (W, at most 8 MB, stays
//       there). Warp-specialised: a producer thread streams 64-column
//       K-slabs of A (one 128-row box) and W (one BN-row box, or BN / 64
//       MN-major 64 x 64 boxes) by TMA into a ring of slots (product_plan:
//       3 at BN 256, up to 8), running ahead across tile boundaries, so the
//       ring never drains between tiles; two consumer warpgroups (64 rows
//       each) run wgmma m64nBNk16 on them, a wgmma.fence, the slab's four
//       products and a commit per slab, nothing else between (no branch or
//       register write inside a group, which would make ptxas serialise
//       them). The epilogue runs in registers, + bias, then ReLU or the
//       backward's mask (zero where the forward's bf16 output is not > 0),
//       the feat dX's rank-1 alpha term, the f32 column sums over the tile's
//       rows in a fixed order with `colsum` (the bias grads); its bf16
//       values go by stmatrix into the warpgroup's half of a staging tile
//       (128 B swizzled, 64 x 64 atoms) and leave by TMA stores that drain
//       under the next tile's products, while the producer has already
//       filled the ring for it. The mask tile arrives by TMA into the same
//       staging tile with the tile's last K-slab (once the previous tile's
//       stores have read it: out_free) and is read back by ldmatrix in the
//       accumulators' layout. The forward's products run a lean
//       instantiation (FULL false: bias and ReLU only, half the code of the
//       whole epilogue's, which did not stay in the instruction cache from
//       one tile's epilogue to the next: 8-13% faster on an H100). The
//       choice of this cooperative shape over a ping-pong of two
//       warpgroups on separate tiles: a 64-row tile per warpgroup would
//       load each W slab once per 64 rows instead of 128 (1.67x the bytes
//       from L2 per product) and split the column sums' per-128-row order.
//       A 2-CTA cluster sharing each W slab by TMA multicast, timed on an
//       H100, gave nothing: the slabs' traffic from L2 does not bound it.
//       Each output element takes the same K-slabs in the same order
//       through k16 steps as the one-tile-per-CTA design before it, and the
//       epilogue the same arithmetic: the same bits.
//   (3) layer_heads_kernel<MODE>: the alpha (H -> 1) and rgb (H/2 -> 3,
//       sigmoid) heads, a warp per point, dot products in a fixed order:
//       the forward's (4, N) or (N, 4) output, or sigma's (N,). For the
//       backward, layer_heads_bwd_kernel<CH>: the heads' cotangents (rgb
//       through the sigmoid, alpha), the dir layer's cotangent dy_dir
//       (through the rgb weights and the ReLU mask) and their f32
//       bias-grad partials per 64 points. It moves h in and dy_dir out, 4
//       bytes a column a point against 6 f32 operations: bytes bound, so it
//       reads each h row once, 16 bytes a lane, keeps it in registers for
//       the three rgb dots and dy_dir, stores dy_dir 16 bytes a lane, and
//       sums the partials in registers and shared memory.
//   (4) bias_grads_kernel: every bias grad of a backward slab in one
//       launch. Each dX product writes its column sums per 128 points into
//       a region of its own, the heads their partials into theirs, so no
//       product waits on a reduction; the launch spreads row groups of
//       every segment over the card (a block per 64 rows x 128 columns),
//       and the last block of a column chunk adds the groups in order.
//   (5) layer_dw_kernel<BN>: dW = dY^T X of a weight matrix over a slab,
//       persistent on dw_leg.cuh's operands and products, its units in
//       point-range order, whole waves at 256 columns and the last wave in
//       128- or 64-column pieces (section (5)).
// Points go through in slabs whose activations (every layer's, for the
// backward) fit the workspace the caller sizes (ops/kernels/field_layers.py
// plans them under a bound); each slab's weight grads come from (5), one
// launch per weight matrix, added to the running grads by the unit itself
// at one point range, else by the fixed-order reduction of dw_leg.cuh, the
// bias grads by (4): no float
// atomics, so two calls give the same bits. Sigma runs the forward's PE,
// trunk and alpha head kernels with the forward's arguments: bit for bit
// its channel 3.
//
// Bands and per-product offsets of any count reach it through the
// descriptor and frequency arrays on the host (each product's K is read off
// its offsets); the PE column table goes to the workspace once per call.

#include <cstring>
#include <vector>

#include "dw_leg.cuh"

namespace {

constexpr int LP_ROWS = 128;      // points per product tile: 64 per consumer warpgroup
constexpr int LP_MAX_COLS = 256;  // output columns per product tile, at most (wgmma's N)
constexpr int LP_MAX_STAGES = 8;
constexpr int LP_A_BYTES = LP_ROWS * SLAB_K * (int)sizeof(bf16);  // 16 KB
// the ring's full and empty barriers, then the staging tile's out_free
constexpr int LP_BAR_BYTES = (2 * LP_MAX_STAGES + 1) * (int)sizeof(uint64_t);
constexpr int PE_THREADS = 128;
constexpr int PE_MAX_PTS = 128;            // points per PE block, at most
constexpr int PE_SMEM_AIM = 96 * 1024;     // a PE block's shared memory, at most where it can
constexpr int HEAD_ROWS = 64;  // points per heads block
constexpr int HEAD_THREADS = 256;
constexpr int HEAD_WARPS = HEAD_THREADS / 32;
// The bias-grad reduction's units: BIAS_GROUP partial rows x BIAS_COLS
// columns (32 lanes x 4) a block of BIAS_LANES row lanes; its launch's
// most segments (bias vectors) in the parameter space.
constexpr int BIAS_THREADS = 256;
constexpr int BIAS_LANES = BIAS_THREADS / 32;
constexpr int BIAS_COLS = 128;
constexpr int BIAS_GROUP = 64;
constexpr int MAX_BIAS_SEGS = 32;
// dW units (128 x 256 blocks over a point range) a weight matrix's point
// ranges aim at, two waves of the H100's 132 SMs, with at most DW_RANGES
// ranges (ranges_for): the split of the points the route had before its
// dW kernel was persistent, kept so that each weight's sum over the points
// keeps its order, and its bits; the kernel fills the card's SMs itself
// (section (5)).
constexpr int DW_UNITS = 264;
// The dW leg's narrowest piece of a unit in its last wave (section (5)).
constexpr int DW_MIN_PIECE = 64;

enum Kind { KIND_FWD = 0, KIND_SIGMA = 1, KIND_BWD = 2 };
enum HeadMode { HEAD_FWD = 0, HEAD_SIGMA = 1 };
enum Counter {
  CNT_PE, CNT_PRODUCT, CNT_HEADS, CNT_DW, CNT_REDUCE, CNT_BIAS, CNT_HEADS_BWD, N_COUNTERS
};

// ---------------------------------------------------------------- (1) PE --

struct PeArgs {
  const float* src;  // rays' origins (fwd) or points
  const float* dirs;
  const float* z;
  long long row0, m;  // the slab's first point and its points
  int samples, fwd, pxp, pdp;
  int lx, ld, inc_x, inc_d;  // bands and raw coordinates of PE(xyz), PE(dir)
  int pts;           // points a block (pe_points)
  const PeCol* tab;  // what each column computes (fused_field.cuh:pe_col)
  bf16* pe_x;        // (m, pxp)
  bf16* pe_d;        // (m, pdp), fwd only
};

// One row of PE into `row` (bf16, shared memory) from its coordinates v:
// the raw coordinates and the zero padding by the row's first thread
// (sub 0), then of the 3 L (component, band) arguments every subs-th from
// sub on, each argument's sin and cos from one range reduction (sincosf:
// the same bits as sinf and cosf apart, whose reduction it shares) into
// its sin column (s0 + j) and cos column (s0 + 3 L + j). PeBuild::step's
// arithmetic: arg = coordinate * f as one f32 product, bf16 round to
// nearest even.
__device__ __forceinline__ void pe_row(bf16* row, const PeCol* tab, float v0, float v1, float v2,
                                       int L, int inc, int width, int sub, int subs) {
  const int s0 = inc ? 3 : 0;
  if (sub == 0) {
    if (inc) {
      row[0] = __float2bfloat16_rn(v0);
      row[1] = __float2bfloat16_rn(v1);
      row[2] = __float2bfloat16_rn(v2);
    }
    for (int c = s0 + 6 * L; c < width; ++c) row[c] = __float2bfloat16_rn(0.f);
  }
  for (int j = sub; j < 3 * L; j += subs) {
    const float v = j < L ? v0 : (j < 2 * L ? v1 : v2);
    float sn, cs;
    sincosf(__fmul_rn(v, tab[s0 + j].f), &sn, &cs);
    row[s0 + j] = __float2bfloat16_rn(sn);
    row[s0 + 3 * L + j] = __float2bfloat16_rn(cs);
  }
}

// PE(xyz) and, for the forward, PE(dir) of `pts` points a block: the
// column table in shared memory; PE_THREADS / pts threads a point, each
// taking every (PE_THREADS / pts)-th of its arguments (one thread a point
// at pts = 128); PE(dir) once per ray of the block's points, not per
// sample; the rows staged in shared memory (rows an odd number of 32-bit
// words apart: the threads' 2-byte stores of one column fall in distinct
// banks), then stored as the block's contiguous run of rows, 16 B a lane
// on consecutive addresses. Bytes bound: each point reads z (its ray's o
// and d shared) and writes (pxp + pdp) bf16.
__global__ void __launch_bounds__(PE_THREADS) layer_pe_kernel(const PeArgs a) {
  extern __shared__ __align__(16) unsigned char pe_smem[];
  const int cols = a.pxp + (a.fwd ? a.pdp : 0);
  const int xs = a.pxp / 2 + 1, ds = a.pdp / 2 + 1;  // row strides, 32-bit words
  PeCol* tab = reinterpret_cast<PeCol*>(pe_smem);
  uint32_t* xt = reinterpret_cast<uint32_t*>(pe_smem + (cols * (int)sizeof(PeCol) + 15) / 16 * 16);
  uint32_t* dt = xt + a.pts * xs;
  const int tid = threadIdx.x;
  for (int i = tid; i < cols; i += PE_THREADS) tab[i] = a.tab[i];
  const long long b0 = (long long)blockIdx.x * a.pts;
  const int rows = (int)(a.m - b0 < a.pts ? a.m - b0 : a.pts);
  const int p = tid % a.pts, sub = tid / a.pts, subs = PE_THREADS / a.pts;
  const long long g0 = a.row0 + b0;  // the block's first point of the call
  // its rays: the block's first point's to its last point's
  const long long ray0 = a.fwd ? g0 / a.samples : 0;
  const int rays = a.fwd ? (int)((g0 + rows - 1) / a.samples - ray0 + 1) : 0;
  float x0 = 0.f, x1 = 0.f, x2 = 0.f;
  if (p < rows) {
    const long long g = g0 + p;
    if (a.fwd) {  // o + d*z of the point's ray, unfused, as PeBuild::start
      const long long ray = g / a.samples;
      const float zt = a.z[g];
      x0 = __fadd_rn(a.src[3 * ray], __fmul_rn(a.dirs[3 * ray], zt));
      x1 = __fadd_rn(a.src[3 * ray + 1], __fmul_rn(a.dirs[3 * ray + 1], zt));
      x2 = __fadd_rn(a.src[3 * ray + 2], __fmul_rn(a.dirs[3 * ray + 2], zt));
    } else {
      x0 = a.src[3 * g];
      x1 = a.src[3 * g + 1];
      x2 = a.src[3 * g + 2];
    }
  }
  __syncthreads();  // the table
  if (p < rows)
    pe_row(reinterpret_cast<bf16*>(xt + p * xs), tab, x0, x1, x2, a.lx, a.inc_x, a.pxp, sub,
           subs);
  if (p < rays) {
    const long long ray = ray0 + p;
    pe_row(reinterpret_cast<bf16*>(dt + p * ds), tab + a.pxp, a.dirs[3 * ray],
           a.dirs[3 * ray + 1], a.dirs[3 * ray + 2], a.ld, a.inc_d, a.pdp, sub, subs);
  }
  __syncthreads();
  const int xch = a.pxp / 8;  // 16 B chunks a row
  uint4* gx = reinterpret_cast<uint4*>(a.pe_x + b0 * a.pxp);
  for (int i = tid; i < rows * xch; i += PE_THREADS) {
    const uint32_t* w = xt + (i / xch) * xs + 4 * (i % xch);
    gx[i] = make_uint4(w[0], w[1], w[2], w[3]);
  }
  if (!a.fwd) return;
  const int dch = a.pdp / 8;
  uint4* gd = reinterpret_cast<uint4*>(a.pe_d + b0 * a.pdp);
  for (int i = tid; i < rows * dch; i += PE_THREADS) {
    const int r = i / dch;
    const uint32_t* w = dt + (int)((g0 + r) / a.samples - ray0) * ds + 4 * (i % dch);
    gd[i] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// A PE launch's points a block and shared bytes: PE_MAX_PTS points, halved
// (down to 1) while the table and the staged rows pass PE_SMEM_AIM.
int pe_points(int pxp, int pdp, bool fwd, size_t* smem) {
  const size_t tab = round_up((size_t)(pxp + pdp) * sizeof(PeCol), 16);
  const size_t row = 4 * ((size_t)(pxp / 2 + 1) + (fwd ? pdp / 2 + 1 : 0));
  int pts = PE_MAX_PTS;
  while (pts > 1 && tab + pts * row > (size_t)PE_SMEM_AIM) pts /= 2;
  *smem = tab + pts * row;
  return pts;
}

// ----------------------------------------------------------- (2) product --

// D(64 x N, f32) (+)= A(64 x 16) B(16 x N), bf16, N = 64, 128, 192 or 256:
// A K-major in shared memory (sw128_desc), B K-major (TB 0, sw128_desc) or
// MN-major (TB 1, sw128_mn_desc, wgmma's transpose immediate); D's fragment
// as wgmma_bf16's (fused_field.cuh): d[4j + 2i + e] is row 16 warp + lane/4
// + 8i, column 8j + 2(lane % 4) + e.
template <int TB>
__device__ __forceinline__ void wgmma_tb(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_tb(float (&d)[64], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_tb(float (&d)[96], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
      "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, %99;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
        "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
        "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
        "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(a), "l"(b), "r"(acc), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_tb(float (&d)[128], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
      "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
      "%124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, %131;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
        "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
        "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
        "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]),
        "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]),
        "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]),
        "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
        "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
        "+f"(d[127])
      : "l"(a), "l"(b), "r"(acc), "n"(TB));
}

// Shared-memory plan of a product launch (mirrored in Python by
// ops/kernels/field_layers.py:product_plan; keep the two alike): the ring
// of `stages` slots, each a 64-column K-slab of A (128 rows) and of B (bn
// rows or columns), from byte 0; the output staging tile (128 x bn bf16, a
// half of 64 rows per consumer warpgroup, each half bn / 64 swizzled atoms
// of 64 rows x 64 columns) at out_off; the consumer warps' column-sum
// partials (8 x bn f32) at part_off; the barriers at bar_off.
struct ProductPlan {
  int bn, stages, col_tiles;
  int out_off, part_off, bar_off, bytes;
};

__host__ __device__ constexpr int lp_stage_bytes(int bn) { return LP_A_BYTES + bn * SLAB_K * 2; }

// The tile width for n output columns: of 256, 192, 128 and 64 (wgmma's N,
// in whole 64-column atoms), the one with the least tiles x (width + 64):
// the columns computed, each tile charged a 64-column share of its A
// panel's loads and its epilogue; a tie to the wider.
int product_bn(int n) {
  int best = 0;
  long long cost = 0;
  for (int bn = LP_MAX_COLS; bn >= 64; bn -= 64) {
    const long long c = (long long)((n + bn - 1) / bn) * (bn + 64);
    if (best == 0 || c < cost) {
      best = bn;
      cost = c;
    }
  }
  return best;
}

// cudaErrorInvalidValue where fewer than 2 ring slots fit `smem_limit`.
int product_plan(int n, int smem_limit, ProductPlan* out) {
  ProductPlan p = {};
  p.bn = product_bn(n);
  p.col_tiles = (n + p.bn - 1) / p.bn;
  const int stage = lp_stage_bytes(p.bn), out_bytes = LP_ROWS * p.bn * 2,
            part_bytes = 8 * p.bn * (int)sizeof(float);
  const int stages = (smem_limit - out_bytes - part_bytes - LP_BAR_BYTES) / stage;
  if (stages < 2) return (int)cudaErrorInvalidValue;
  p.stages = stages < LP_MAX_STAGES ? stages : LP_MAX_STAGES;
  p.out_off = p.stages * stage;
  p.part_off = p.out_off + out_bytes;
  p.bar_off = p.part_off + part_bytes;
  p.bytes = p.bar_off + LP_BAR_BYTES;
  *out = p;
  return 0;
}

// A product's arguments, in the parameter space.
struct ProductArgs {
  CUtensorMap a1, a2;  // A's parts, (m, k1) and (m, k2), boxes 64 x 128
  CUtensorMap b;       // W: (N, K) boxes 64 x bn (NN 0); its x part (K, n) boxes 64 x 64 (NN 1)
  CUtensorMap out;     // Y (m, n), boxes 64 x 64 (TMA stores from the staging tile)
  CUtensorMap mask;    // (m, n), boxes 64 x 64 (TMA loads into the staging tile)
  ProductPlan plan;
  int k1, k2, n;       // K = k1 + k2 (k1 a multiple of 64 where k2 > 0), output columns
  long long m;         // rows (points)
  long long tiles;     // 128-row blocks x plan.col_tiles
  const float* bias;   // n floats, or none
  int relu;
  int has_mask;        // zero where mask <= 0
  const bf16* r1_a;    // the rank-1 term r1_a[row * 16] * r1_w[col], or none
  const bf16* r1_w;
  float* colsum;       // (row blocks, n): column sums of the tile's rows, or none
};

__device__ __forceinline__ float2 unpack_bf16(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

// Y = epilogue(A B + bias) over every 128 x BN tile: see the top of the
// file. A persistent CTA walks tiles blockIdx.x, + gridDim.x, ... (N
// fastest: a row block's column tiles side by side, sharing its A panel
// through L2); its producer runs ahead across tiles. FULL compiles the
// whole epilogue (the mask, the rank-1 term, the column sums); without it
// only the forward's bias and ReLU, whose shorter code stays in the
// instruction cache.
template <bool NN, int BN, bool FULL>
__global__ void __launch_bounds__(FIELD_THREADS, 1)
    layer_product_kernel(const __grid_constant__ ProductArgs a) {
  constexpr int STAGE_BYTES = lp_stage_bytes(BN);
  constexpr int ATOMS = BN / 64;
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* staging = smem + a.plan.out_off;
  float* part = reinterpret_cast<float*>(smem + a.plan.part_off);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + a.plan.bar_off);
  uint64_t* empty = full + LP_MAX_STAGES;
  uint64_t* out_free = empty + LP_MAX_STAGES;  // the staging tile's stores have read it
  const int tid = threadIdx.x, wg = tid / WG_THREADS;
  const int stages = a.plan.stages, ct = a.plan.col_tiles;
  const int slabs = (a.k1 + a.k2 + SLAB_K - 1) / SLAB_K;
  const bool has_mask = FULL && a.has_mask;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * WG_THREADS / 32);  // every consumer warp releases
    }
    mbar_init(out_free, 2);  // each consumer warpgroup's storing thread
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (tid == 2 * WG_THREADS) {
      int stage = 0;
      uint32_t phase = 0, free_phase = 0;
      for (long long u = blockIdx.x; u < a.tiles; u += gridDim.x) {
        const int m0 = (int)(u / ct) * LP_ROWS, n0 = (int)(u % ct) * BN;
        for (int s = 0; s < slabs; ++s) {
          const int k0 = s * SLAB_K;
          // the backward's mask rides with the tile's last slab, into the
          // staging tile once the previous tile's stores have read it
          const bool mask = has_mask && s == slabs - 1;
          mbar_wait(&empty[stage], phase ^ 1);
          if (mask) {
            mbar_wait(out_free, free_phase);
            free_phase ^= 1;
          }
          mbar_arrive_expect_tx(&full[stage], STAGE_BYTES + (mask ? LP_ROWS * BN * 2 : 0));
          unsigned char* dst = smem + stage * STAGE_BYTES;
          if (k0 < a.k1)
            tma_load_2d(dst, &a.a1, k0, m0, &full[stage]);
          else
            tma_load_2d(dst, &a.a2, k0 - a.k1, m0, &full[stage]);
          if constexpr (NN) {
#pragma unroll
            for (int i = 0; i < ATOMS; ++i)
              tma_load_2d(dst + LP_A_BYTES + i * ATOM_BYTES, &a.b, n0 + 64 * i, k0, &full[stage]);
          } else {
            tma_load_2d(dst + LP_A_BYTES, &a.b, k0, n0, &full[stage]);
          }
          if (mask) {
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int i = 0; i < ATOMS; ++i)
                tma_load_2d(staging + (h * ATOMS + i) * ATOM_BYTES, &a.mask, n0 + 64 * i,
                            m0 + 64 * h, &full[stage]);
          }
          if (++stage == stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
  const int t = tid % WG_THREADS, warp = t / 32, lane = t % 32, q = lane % 4;
  const bool storer = t == 0;  // issues the warpgroup's stores
  Ring ring{full, empty, smem, STAGE_BYTES, STAGE_BYTES, stages, 0, 0};
  const uint32_t base = smem_u32(smem);
  unsigned char* half = staging + wg * ATOMS * ATOM_BYTES;  // this warpgroup's 64 rows
  // ldmatrix / stmatrix: this lane's row and column offset in a 16 x 16 block
  const int mrow = warp * 16 + (lane >> 3 & 1) * 8 + (lane & 7), mcol = (lane >> 4) * 8;
  float* wpart = part + (wg * 4 + warp) * BN;
  const int free_at = slabs > 1 ? 1 : 0;  // the slab before which out_free is signalled
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (long long u = blockIdx.x; u < a.tiles; u += gridDim.x) {
    const long long rb = u / ct;
    const long long m0 = rb * LP_ROWS;
    const int n0 = (int)(u % ct) * BN;
    // The mainloop: a wgmma.fence, the slab's four k16 products and a
    // commit per slab, the previous slab released once its products are
    // done; no branch or register write inside a slab's group.
    int prev = -1;
    for (int s = 0; s < slabs; ++s) {
      if (has_mask && s == free_at && storer) {
        bulk_wait_read();
        mbar_arrive(out_free);
      }
      mbar_wait(&ring.full[ring.stage], ring.phase);
      const uint32_t st = base + ring.stage * STAGE_BYTES;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < SLAB_K / 16; ++k) {
        const uint64_t ad = sw128_desc(st + wg * ATOM_BYTES + 32 * k);
        const uint64_t bd = NN ? sw128_mn_desc(st + LP_A_BYTES + 2048 * k)
                               : sw128_desc(st + LP_A_BYTES + 32 * k);
        wgmma_tb<NN ? 1 : 0>(acc, ad, bd, s + k);
      }
      wgmma_commit();
      if (prev >= 0) {
        wgmma_wait<1>();  // the previous slab's products are done: release it
        fence_regs(acc);
        ring.release(prev, lane);
      }
      prev = ring.stage;
      ring.advance();
    }
    wgmma_wait<0>();
    fence_regs(acc);
    ring.release(prev, lane);

    // The epilogue, in registers, into this warpgroup's half of the staging
    // tile (the mask's values read from it where the mask came with the last
    // slab), then its TMA stores, which run under the next tile's products.
    // acc[4j + 2i + e] is row r0 + 8i, column n0 + 8j + 2q + e.
    const long long r0 = m0 + wg * 64 + warp * 16 + lane / 4;
    const bool in0 = r0 < a.m, in1 = r0 + 8 < a.m;
    float a0 = 0.f, a1 = 0.f;  // the rank-1 term's row values
    if (FULL && a.r1_a != nullptr) {
      if (in0) a0 = __bfloat162float(a.r1_a[r0 * HEAD_LD]);
      if (in1) a1 = __bfloat162float(a.r1_a[(r0 + 8) * HEAD_LD]);
    }
    if (!has_mask) {  // the previous tile's stores have read the half
      if (storer) bulk_wait_read();
      wg_barrier(wg);
    }
    const uint32_t half_u32 = smem_u32(half);
#pragma unroll
    for (int j0 = 0; j0 < BN / 8; j0 += 2) {
      const uint32_t addr = half_u32 + swz(mrow, 8 * j0 + mcol);
      uint32_t mk[4] = {0u, 0u, 0u, 0u}, y[4];
      if (has_mask) ldmatrix_x4(addr, mk);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = j0 + h;
        const int c = n0 + 8 * j + 2 * q;
        const bool live = c < a.n;  // n is a multiple of 64: c and c + 1 alike
        float v[4] = {acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]};
        if (a.bias != nullptr && live) {
          const float2 b = *reinterpret_cast<const float2*>(a.bias + c);
          v[0] += b.x;
          v[1] += b.y;
          v[2] += b.x;
          v[3] += b.y;
        }
        if (FULL && a.r1_a != nullptr && live) {
          const float2 w = bf16x2_at(a.r1_w + c);
          v[0] += a0 * w.x;
          v[1] += a0 * w.y;
          v[2] += a1 * w.x;
          v[3] += a1 * w.y;
        }
        if (a.relu) {
#pragma unroll
          for (int i = 0; i < 4; ++i) v[i] = fmaxf(v[i], 0.f);
        }
        if (has_mask) {
          const float2 k0 = unpack_bf16(mk[2 * h]), k1 = unpack_bf16(mk[2 * h + 1]);
          if (!(k0.x > 0.f)) v[0] = 0.f;
          if (!(k0.y > 0.f)) v[1] = 0.f;
          if (!(k1.x > 0.f)) v[2] = 0.f;
          if (!(k1.y > 0.f)) v[3] = 0.f;
        }
        y[2 * h] = pack_bf16(v[0], v[1]);
        y[2 * h + 1] = pack_bf16(v[2], v[3]);
        if (FULL && a.colsum != nullptr) {
          // the two rows, then the warp's 8 row pairs of this column (lanes
          // of equal q) by a butterfly: every lane ends with the same sum
          float s0 = (in0 ? v[0] : 0.f) + (in1 ? v[2] : 0.f);
          float s1 = (in0 ? v[1] : 0.f) + (in1 ? v[3] : 0.f);
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) {
            s0 += __shfl_xor_sync(0xffffffffu, s0, o);
            s1 += __shfl_xor_sync(0xffffffffu, s1, o);
          }
          if (lane < 4) *reinterpret_cast<float2*>(wpart + 8 * j + 2 * q) = make_float2(s0, s1);
        }
      }
      stmatrix_x4(addr, y);
    }
    fence_proxy_async();  // the staging writes, before the TMA's reads
    wg_barrier(wg);
    if (storer && m0 + wg * 64 < a.m) {
      for (int i = 0; i < ATOMS && n0 + 64 * i < a.n; ++i)
        tma_store_2d(&a.out, half + i * ATOM_BYTES, n0 + 64 * i, (int)(m0 + wg * 64));
      bulk_commit();
    }
    if (FULL && a.colsum != nullptr) {
      asm volatile("bar.sync 3, %0;" ::"n"(2 * WG_THREADS) : "memory");
      for (int c = t + wg * WG_THREADS; c < BN && n0 + c < a.n; c += 2 * WG_THREADS) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < 8; ++w) s += part[w * BN + c];  // the tile's rows in order
        a.colsum[(size_t)rb * a.n + n0 + c] = s;
      }
      asm volatile("bar.sync 3, %0;" ::"n"(2 * WG_THREADS) : "memory");  // partials read
    }
  }
  if (storer) bulk_wait();
}

// ------------------------------------------------------------- (3) heads --

struct HeadArgs {
  const bf16* x;  // the trunk's output (m, H)
  const bf16* h;  // the dir layer's output (m, H/2)
  const bf16* wa;  // (H)
  const bf16* wr;  // (3, H/2)
  const float* ba;
  const float* br;
  int H;
  long long m, row0, n_total;
  float* out;  // fwd: (4, n_total) or (n_total, 4); sigma: (n_total)
  int channels_first;
  const float* grad;  // bwd: (4, n_total)
  bf16* dy_rgb;       // bwd: (m, HEAD_LD), columns 0-2
  bf16* dy_a;         // bwd: (m, HEAD_LD), column 0
  bf16* dy_dir;       // bwd: (m, H/2)
  float* part;        // bwd: a row per block: [H/2 dir | alpha | rgb]
  int ld_part;
};

// x . w over n bf16 (a multiple of 8), 8 a lane per step, then summed
// across the warp by a butterfly: the same bits in every lane and on every
// launch.
__device__ __forceinline__ float warp_dot(const bf16* x, const bf16* w, int n, int lane) {
  float s = 0.f;
  for (int k = 8 * lane; k < n; k += 256) {
    const uint4 xv = *reinterpret_cast<const uint4*>(x + k);
    const uint4 wv = *reinterpret_cast<const uint4*>(w + k);
    const bf16* xs = reinterpret_cast<const bf16*>(&xv);
    const bf16* ws = reinterpret_cast<const bf16*>(&wv);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      s = __fmaf_rn(__bfloat162float(xs[e]), __bfloat162float(ws[e]), s);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// The forward's and sigma's heads, a warp per point.
template <int MODE>
__global__ void __launch_bounds__(HEAD_THREADS) layer_heads_kernel(const HeadArgs a) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long b0 = (long long)blockIdx.x * HEAD_ROWS;
  const int H2 = a.H / 2;
  for (int i = warp; i < HEAD_ROWS; i += HEAD_WARPS) {
    const long long r = b0 + i, g = a.row0 + r;
    if (r >= a.m) continue;
    const float alpha = warp_dot(a.x + r * a.H, a.wa, a.H, lane) + a.ba[0];
    if constexpr (MODE == HEAD_SIGMA) {
      if (lane == 0) a.out[g] = alpha;
      continue;
    }
    float rgb[3];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      rgb[c] = 1.f / (1.f + expf(-(warp_dot(a.h + r * H2, a.wr + c * H2, H2, lane) + a.br[c])));
    if (lane != 0) continue;
    const float v[4] = {rgb[0], rgb[1], rgb[2], alpha};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (a.channels_first)
        a.out[c * a.n_total + g] = v[c];
      else
        a.out[g * 4 + c] = v[c];
    }
  }
}

// The lane's CH 16-byte chunks of h columns [w0, w0 + 256 CH) of row r:
// chunk j at column w0 + 8 (lane + 32 j), warp_dot's chunks; zeros past H/2.
template <int CH>
__device__ __forceinline__ void load_h_window(uint4 (&v)[CH], const bf16* row, int w0, int H2,
                                              int lane) {
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const int k = w0 + 8 * (lane + 32 * j);
    v[j] = k < H2 ? __ldg(reinterpret_cast<const uint4*>(row + k)) : make_uint4(0u, 0u, 0u, 0u);
  }
}

// The three rgb dots' lane partials over those chunks, warp_dot's order:
// chunk by chunk, 8 fmas each.
template <int CH>
__device__ __forceinline__ void dot_window(float (&s)[3], const uint4 (&v)[CH], const bf16* swr,
                                           int w0, int H2, int lane) {
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const int k = w0 + 8 * (lane + 32 * j);
    if (k >= H2) continue;
    const bf16* xs = reinterpret_cast<const bf16*>(&v[j]);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const uint4 wv = *reinterpret_cast<const uint4*>(swr + c * H2 + k);
      const bf16* ws = reinterpret_cast<const bf16*>(&wv);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        s[c] = __fmaf_rn(__bfloat162float(xs[e]), __bfloat162float(ws[e]), s[c]);
    }
  }
}

// A point's cotangents from its rgb dots (summed over the warp by
// warp_dot's butterfly: the same bits in every lane): d[0..2] through the
// sigmoid, d[3] the grad's alpha channel; lane 0 stores them in sd and the
// padded dy_rgb and dy_a rows.
__device__ __forceinline__ void head_cotangents(float (&d)[4], float (&s)[3], const HeadArgs& a,
                                                long long r, float (&sd)[4], int lane) {
  const long long g = a.row0 + r;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s[c] += __shfl_xor_sync(0xffffffffu, s[c], o);
    const float rgb = 1.f / (1.f + expf(-(s[c] + a.br[c])));
    d[c] = a.grad[c * a.n_total + g] * rgb * (1.f - rgb);
  }
  d[3] = a.grad[3 * a.n_total + g];
  if (lane != 0) return;
#pragma unroll
  for (int c = 0; c < 4; ++c) sd[c] = d[c];
  uint4* rgb_row = reinterpret_cast<uint4*>(a.dy_rgb + r * HEAD_LD);
  uint4* a_row = reinterpret_cast<uint4*>(a.dy_a + r * HEAD_LD);
  rgb_row[0] = make_uint4(pack_bf16(d[0], d[1]), pack_bf16(d[2], 0.f), 0u, 0u);
  rgb_row[1] = make_uint4(0u, 0u, 0u, 0u);
  a_row[0] = make_uint4(pack_bf16(d[3], 0.f), 0u, 0u, 0u);
  a_row[1] = make_uint4(0u, 0u, 0u, 0u);
}

// The backward's heads over HEAD_ROWS points a block, in one pass over h:
// each warp takes HEAD_ROWS / HEAD_WARPS consecutive points, each lane CH
// 16-byte chunks of a point's h row (warp_dot's chunks, the next point's
// loaded under this one's arithmetic); the three rgb dots come from those
// registers (dot_window, head_cotangents), and so does dy_dir = (bf16(drgb)
// wr) masked by h > 0, stored 16 bytes a lane, its f32 values summed per
// column over the warp's points in order, then over the warps in order: the
// block's row of dir bias-grad partials, and of [alpha, r, g, b] over its
// points in order. The rgb weights sit in shared memory. Past a window of
// 256 CH columns (H/2 > 1024) a first pass takes the dots window by window
// and the second reads h again. The dots sum in warp_dot's order and each
// dy_dir element adds its three terms in a fixed order, so dy_dir, and
// every dW taken from it, has the bits of a warp_dot per channel whatever
// the block's shape.
template <int CH>
__global__ void __launch_bounds__(HEAD_THREADS) layer_heads_bwd_kernel(const HeadArgs a) {
  constexpr int WIN = 256 * CH;
  constexpr int PTS = HEAD_ROWS / HEAD_WARPS;
  extern __shared__ __align__(16) unsigned char head_smem[];
  __shared__ float sd[HEAD_ROWS][4];  // drgb, dalpha of the block's points
  const int H2 = a.H / 2;
  const int nwin = (H2 + WIN - 1) / WIN, win = H2 < WIN ? H2 : WIN;
  bf16* swr = reinterpret_cast<bf16*>(head_smem);                          // (3, H/2)
  float* wsum = reinterpret_cast<float*>(head_smem + 6 * (size_t)H2);      // (HEAD_WARPS, win)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long b0 = (long long)blockIdx.x * HEAD_ROWS;
  const int rows = (int)(a.m - b0 < HEAD_ROWS ? a.m - b0 : HEAD_ROWS);
  const int i0 = warp * PTS;
  const int pts = rows - i0 < 0 ? 0 : (rows - i0 < PTS ? rows - i0 : PTS);
  for (int i = threadIdx.x; i < 3 * H2 / 8; i += HEAD_THREADS)
    reinterpret_cast<uint4*>(swr)[i] = reinterpret_cast<const uint4*>(a.wr)[i];
  __syncthreads();
  if (nwin > 1) {  // the dots first, window by window
    for (int t = 0; t < pts; ++t) {
      const long long r = b0 + i0 + t;
      float s[3] = {0.f, 0.f, 0.f}, d[4];
      for (int w = 0; w < nwin; ++w) {
        uint4 v[CH];
        load_h_window(v, a.h + r * H2, w * WIN, H2, lane);
        dot_window(s, v, swr, w * WIN, H2, lane);
      }
      head_cotangents(d, s, a, r, sd[i0 + t], lane);
    }
    __syncwarp();
  }
  float* const prow = a.part + (size_t)blockIdx.x * a.ld_part;
  for (int w = 0; w < nwin; ++w) {
    const int w0 = w * WIN;
    float p[CH * 8];
#pragma unroll
    for (int e = 0; e < CH * 8; ++e) p[e] = 0.f;
    uint4 next[CH];
    if (pts > 0) load_h_window(next, a.h + (b0 + i0) * H2, w0, H2, lane);
    for (int t = 0; t < pts; ++t) {
      const long long r = b0 + i0 + t;
      uint4 v[CH];
#pragma unroll
      for (int j = 0; j < CH; ++j) v[j] = next[j];
      if (t + 1 < pts) load_h_window(next, a.h + (r + 1) * H2, w0, H2, lane);
      float d[4];
      if (nwin == 1) {
        float s[3] = {0.f, 0.f, 0.f};
        dot_window(s, v, swr, 0, H2, lane);
        head_cotangents(d, s, a, r, sd[i0 + t], lane);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) d[c] = sd[i0 + t][c];
      }
      const float d0 = bf16_round(d[0]), d1 = bf16_round(d[1]), d2 = bf16_round(d[2]);
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const int k = w0 + 8 * (lane + 32 * j);
        if (k >= H2) continue;
        const bf16* xs = reinterpret_cast<const bf16*>(&v[j]);
        const uint4 w0v = *reinterpret_cast<const uint4*>(swr + k);
        const uint4 w1v = *reinterpret_cast<const uint4*>(swr + H2 + k);
        const uint4 w2v = *reinterpret_cast<const uint4*>(swr + 2 * H2 + k);
        const bf16* ws0 = reinterpret_cast<const bf16*>(&w0v);
        const bf16* ws1 = reinterpret_cast<const bf16*>(&w1v);
        const bf16* ws2 = reinterpret_cast<const bf16*>(&w2v);
        float o[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float val = __fadd_rn(__fadd_rn(__fmul_rn(d0, __bfloat162float(ws0[e])),
                                          __fmul_rn(d1, __bfloat162float(ws1[e]))),
                                __fmul_rn(d2, __bfloat162float(ws2[e])));
          if (!(__bfloat162float(xs[e]) > 0.f)) val = 0.f;
          o[e] = val;
          p[8 * j + e] += val;
        }
        *reinterpret_cast<uint4*>(a.dy_dir + r * H2 + k) =
            make_uint4(pack_bf16(o[0], o[1]), pack_bf16(o[2], o[3]), pack_bf16(o[4], o[5]),
                       pack_bf16(o[6], o[7]));
      }
    }
    // the warps' column sums, then the block's: the warps in order
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int k = 8 * (lane + 32 * j);
      if (w0 + k >= H2) continue;
      float4* dst = reinterpret_cast<float4*>(wsum + warp * win + k);
      dst[0] = make_float4(p[8 * j], p[8 * j + 1], p[8 * j + 2], p[8 * j + 3]);
      dst[1] = make_float4(p[8 * j + 4], p[8 * j + 5], p[8 * j + 6], p[8 * j + 7]);
    }
    __syncthreads();
    for (int k = threadIdx.x; k < win && w0 + k < H2; k += HEAD_THREADS) {
      float s = 0.f;
#pragma unroll
      for (int v = 0; v < HEAD_WARPS; ++v) s += wsum[v * win + k];
      prow[w0 + k] = s;
    }
    __syncthreads();  // wsum read, sd written
  }
  if (threadIdx.x < 4) {  // [alpha, r, g, b], as the biases lie from ba_off
    const int c = threadIdx.x == 0 ? 3 : threadIdx.x - 1;
    float s = 0.f;
    for (int i = 0; i < rows; ++i) s += sd[i][c];
    prow[H2 + threadIdx.x] = s;
  }
}

// Its h columns a lane holds (CH chunks of 8) and shared memory: the rgb
// weights and every warp's column sums of a window.
int heads_bwd_chunks(int H) { return H / 2 <= 256 ? 1 : (H / 2 <= 512 ? 2 : 4); }

size_t heads_bwd_smem(int H) {
  const int H2 = H / 2, win = 256 * heads_bwd_chunks(H);
  return 6 * (size_t)H2 + HEAD_WARPS * (size_t)(H2 < win ? H2 : win) * sizeof(float);
}

template <int CH>
int launch_heads_bwd_ch(const HeadArgs& ha, cudaStream_t s) {
  const size_t smem = heads_bwd_smem(ha.H);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(reinterpret_cast<const void*>(layer_heads_bwd_kernel<CH>),
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  layer_heads_bwd_kernel<CH><<<(unsigned)((ha.m + HEAD_ROWS - 1) / HEAD_ROWS), HEAD_THREADS,
                               smem, s>>>(ha);
  return (int)cudaGetLastError();
}

int launch_heads_bwd(const HeadArgs& ha, cudaStream_t s, int* launches) {
  launches[CNT_HEADS_BWD] += 1;
  switch (heads_bwd_chunks(ha.H)) {
    case 1:
      return launch_heads_bwd_ch<1>(ha, s);
    case 2:
      return launch_heads_bwd_ch<2>(ha, s);
    default:
      return launch_heads_bwd_ch<4>(ha, s);
  }
}

// -------------------------------------------------------- (4) bias grads --
//
// Every bias grad of a backward slab, from the column partials its kernels
// wrote into regions of their own (each dX product's per 128 points, the
// heads' per HEAD_ROWS), in one launch spread over the card. A segment is
// one bias vector's partials; a unit (block) sums BIAS_GROUP rows of one
// segment over BIAS_COLS columns, float4 loads, eight row lanes each over
// every eighth row in order, then the lanes in order, into the segment's
// level-1 row of that group; the last unit of a column chunk to finish (an
// integer counter per chunk, reset by that unit) adds the groups in order
// to the running grads. No float atomics: the same sums in the same order
// on every launch, whichever unit ends last.
struct BiasSeg {
  const float* src;  // (rows, cols) partials, rows ld floats apart
  float* dst;        // cols grads, added to
  float* level1;     // (groups, cols)
  unsigned* count;   // one per column chunk, 0 between launches
  long long ld;
  int rows, cols, groups, chunks, unit0;
};

struct BiasArgs {
  BiasSeg seg[MAX_BIAS_SEGS];
  int count;
};

__global__ void __launch_bounds__(BIAS_THREADS)
    bias_grads_kernel(const __grid_constant__ BiasArgs a) {
  __shared__ float4 lanes[BIAS_LANES][BIAS_COLS / 4];
  __shared__ int last;
  int s = 0;
  while (s + 1 < a.count && (int)blockIdx.x >= a.seg[s + 1].unit0) ++s;
  const BiasSeg& sg = a.seg[s];
  const int local = (int)blockIdx.x - sg.unit0;
  const int chunk = local / sg.groups, group = local % sg.groups;
  const int q = threadIdx.x % 32, lane = threadIdx.x / 32;
  const int c4 = chunk * BIAS_COLS + 4 * q;
  const int r1 = (group + 1) * BIAS_GROUP < sg.rows ? (group + 1) * BIAS_GROUP : sg.rows;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (c4 < sg.cols) {
#pragma unroll 8
    for (int r = group * BIAS_GROUP + lane; r < r1; r += BIAS_LANES) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(sg.src + (size_t)r * sg.ld + c4));
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
  }
  lanes[lane][q] = acc;
  __syncthreads();
  const int t = threadIdx.x, col = chunk * BIAS_COLS + t;
  if (t < BIAS_COLS && col < sg.cols) {
    const float* lf = reinterpret_cast<const float*>(&lanes[0][0]);
    float v = 0.f;
#pragma unroll
    for (int l = 0; l < BIAS_LANES; ++l) v += lf[l * BIAS_COLS + t];
    sg.level1[(size_t)group * sg.cols + col] = v;
  }
  __threadfence();  // the group's row, before the count that publishes it
  __syncthreads();
  if (t == 0) last = atomicAdd(&sg.count[chunk], 1u) == (unsigned)(sg.groups - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (t < BIAS_COLS && col < sg.cols) {
    float v = sg.dst[col];
    for (int g = 0; g < sg.groups; ++g) v += __ldcg(sg.level1 + (size_t)g * sg.cols + col);
    sg.dst[col] = v;
  }
  if (t == 0) sg.count[chunk] = 0u;
}

// One bias vector's partials to reduce: src (rows, cols), row stride ld,
// added to dst.
struct BiasSpec {
  const float* src;
  long long ld;
  int rows, cols;
  float* dst;
};

int bias_groups(long long rows) { return (int)((rows + BIAS_GROUP - 1) / BIAS_GROUP); }
int bias_chunks(long long cols) { return (int)((cols + BIAS_COLS - 1) / BIAS_COLS); }

// bias_grads_kernel over n segments, MAX_BIAS_SEGS a launch: level-1 rows
// from `level1` and counters from `count` (zero), segment after segment.
int launch_bias(const BiasSpec* segs, int n, float* level1, unsigned* count, cudaStream_t s,
                int* launches) {
  for (int first = 0; first < n; first += MAX_BIAS_SEGS) {
    BiasArgs a;
    memset(&a, 0, sizeof(a));
    int units = 0;
    for (int i = first; i < n && i < first + MAX_BIAS_SEGS; ++i) {
      const BiasSpec& b = segs[i];
      BiasSeg& g = a.seg[a.count++];
      g.src = b.src;
      g.dst = b.dst;
      g.ld = b.ld;
      g.rows = b.rows;
      g.cols = b.cols;
      g.groups = bias_groups(b.rows);
      g.chunks = bias_chunks(b.cols);
      g.level1 = level1;
      g.count = count;
      g.unit0 = units;
      level1 += (size_t)g.groups * g.cols;
      count += g.chunks;
      units += g.groups * g.chunks;
    }
    bias_grads_kernel<<<units, BIAS_THREADS, 0, s>>>(a);
    launches[CNT_BIAS] += 1;
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// ---------------------------------------------------------------- (5) dW --
//
// dW = dY^T X of one weight matrix (with the heads' for dir's) over a slab
// of points, added to the running grads. dw_leg.cuh's operands, jobs and
// products (a unit: one 128 x 256 block of a job over one point range, two
// consumer warpgroups of f32 accumulators on MN-major 128 B swizzled TMA
// boxes of 64 points), the point ranges of ranges_for, laid out for the
// card:
//   - whole waves, then a wide last one: the units that fill whole waves
//     of the card's SMs run 256 columns a CTA; the units left over (the
//     last wave, part full, where dw_kernel left SMs idle: at 1024 wide
//     its third wave held 24 units on 132 SMs) run as 128- or 64-column
//     pieces, as many as the SMs take, in a second launch. Columns are
//     independent sums: each dW element adds the same products in the same
//     order (m64nNk16 per 16 points, the range's points in order) whatever
//     a piece's width, so dW keeps the bits of the fused backward's
//     dw_kernel on the same ranges. Persistent: a CTA per SM (at most one
//     a unit or piece) walks them blockIdx.x, + gridDim.x, ...; its
//     producer thread runs the ring across units, so a unit's partial
//     stores drain under the next unit's first loads.
//   - raster: units go range by range, within a range job by job, row
//     block by row block, and a wave's units start together: the units of
//     a range read each 64-point slab of dY and X at about the same time,
//     from device memory about once and from L2 to the rest (dw_kernel's
//     order put a column block's units of every range first). Splitting
//     one unit's points across CTAs instead (stream-K, with an exact f32
//     carry to keep the bits) was measured 1.8x slower on an H100: its
//     units start at scattered times and read their slabs from device
//     memory each.
//   - loads: only the 64-row and 64-column boxes a unit's job reaches (a
//     head's 16 cotangent columns, a PE job's columns); the rest of the
//     slot is never read into a kept row or column.
//   - at one range a unit adds its block to the running grads itself (no
//     partials, no reduction launch).
// What bounds it on an H100: 2 x rows x cols FLOP a point against (rows +
// cols) bf16 read, at H >= 512 over the card's ~295 FLOP/B: the tensor
// cores. Ranges are added to the running grads in order by
// reduce_rows_kernel: two calls give the same bits.
struct LayerDwArgs {
  CUtensorMap maps[N_MAPS];
  DwJob job[MAX_JOBS];  // unit0: the job's first unit within a range
  int count, per_range;  // jobs; units a range
  int range_pts;         // points a range (a multiple of 64; the last range shorter)
  int range_step;        // range r reads from point r x range_step (range_pts; 0: timing only)
  int pieces;            // column pieces a unit (256 / BN)
  long long n_pad, first, items;  // units first, first + 1, ... x pieces
  float* partial;  // ranges > 1: a row of part_ld floats a range
  long long part_ld;
  float* out;  // one range: the running grads, each unit's block added in place
};
static_assert(sizeof(LayerDwArgs) <= 32764, "layer_dw_kernel's parameters");

// D(64 x N, f32) (+)= A(64 x 16) B(16 x N), bf16, N = 128 or 64, A and B
// MN-major in shared memory: fused_field.cuh's wgmma_bf16_mn (N = 256) at
// the narrower widths of the dW leg's last wave (section (5)).
__device__ __forceinline__ void wgmma_bf16_mn(float (&d)[64], uint64_t a, uint64_t b,
                                              int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_bf16_mn(float (&d)[32], uint64_t a, uint64_t b,
                                              int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

// Item i of a launch: unit first + i / pieces, its columns [c0, c0 + BN)
// of the job's 256-column block (none past the block's columns: skipped).
struct DwItem {
  int job, mb, c0, range;
  long long p0;
  int slabs;
};

template <int BN>
__device__ __forceinline__ DwItem dw_item(const LayerDwArgs& a, long long i) {
  DwItem w;
  const long long u = a.first + i / a.pieces;
  w.c0 = (int)(i % a.pieces) * BN;
  w.range = (int)(u / a.per_range);
  const int local = (int)(u % a.per_range);
  int j = 0;
  while (j + 1 < a.count && local >= a.job[j + 1].unit0) ++j;
  w.job = j;
  w.mb = local - a.job[j].unit0;
  const long long first = (long long)w.range * a.range_pts;
  const long long len = a.n_pad - first < a.range_pts ? a.n_pad - first : a.range_pts;
  w.p0 = (long long)w.range * a.range_step;
  w.slabs = w.c0 < a.job[j].n ? (int)(len / SLAB_K) : 0;
  return w;
}

template <int BN>
__global__ void __launch_bounds__(FIELD_THREADS, 1)
    layer_dw_kernel(const __grid_constant__ LayerDwArgs a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + DW_STAGES * DW_STAGE_BYTES);
  uint64_t* empty = full + DW_STAGES;
  const int tid = threadIdx.x, wg = tid / WG_THREADS;
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
    if (tid != 2 * WG_THREADS) return;
    int stage = 0;
    uint32_t phase = 0;
    for (long long i = blockIdx.x; i < a.items; i += gridDim.x) {
      const DwItem w = dw_item<BN>(a, i);
      const DwJob& jb = a.job[w.job];
      const CUtensorMap* am = &a.maps[jb.a_map];
      const CUtensorMap* bm = &a.maps[jb.b_map];
      const int a_col = jb.a_col + w.mb * DW_A_ATOMS * 64;
      const int rows = jb.m - w.mb * DW_A_ATOMS * 64;
      const int na = rows >= DW_A_ATOMS * 64 ? DW_A_ATOMS : (rows + 63) / 64;
      const int cols = jb.n - w.c0 < BN ? jb.n - w.c0 : BN;
      const int nb = (cols + 63) / 64;
      for (int s = 0; s < w.slabs; ++s) {
        const int pt = (int)(w.p0 + (long long)s * SLAB_K);
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_arrive_expect_tx(&full[stage], (na + nb) * ATOM_BYTES);
        unsigned char* dst = smem + stage * DW_STAGE_BYTES;
        for (int k = 0; k < na; ++k)
          tma_load_2d(dst + k * ATOM_BYTES, am, a_col + 64 * k, jb.a_row + pt, &full[stage]);
        for (int k = 0; k < nb; ++k)
          tma_load_2d(dst + (DW_A_ATOMS + k) * ATOM_BYTES, bm, jb.b_col + w.c0 + 64 * k,
                      jb.b_row + pt, &full[stage]);
        if (++stage == DW_STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
  const int t = tid % WG_THREADS, warp = t / 32, lane = t % 32;
  Ring ring{full, empty, smem, DW_STAGE_BYTES, DW_STAGE_BYTES, DW_STAGES, 0, 0};
  const uint32_t base = smem_u32(smem);
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (long long i = blockIdx.x; i < a.items; i += gridDim.x) {
    const DwItem w = dw_item<BN>(a, i);
    if (w.slabs == 0) continue;  // a piece past its block's columns
    const DwJob& jb = a.job[w.job];
    // The mainloop: a slab's four k16 products and a commit, the previous
    // slab released once its products are done; the unit's first product
    // overwrites the accumulators (scale-d 0).
    int prev = -1;
    fence_regs(acc);
    wgmma_fence();
    for (int s = 0; s < w.slabs; ++s) {
      mbar_wait(&ring.full[ring.stage], ring.phase);
      const uint32_t st = base + ring.stage * DW_STAGE_BYTES;
#pragma unroll
      for (int k = 0; k < SLAB_K / 16; ++k)
        wgmma_bf16_mn(acc, sw128_mn_desc(st + wg * ATOM_BYTES + 2048 * k),
                      sw128_mn_desc(st + DW_A_ATOMS * ATOM_BYTES + 2048 * k), s + k);
      wgmma_commit();
      if (prev >= 0) {
        wgmma_wait<1>();
        ring.release(prev, lane);
      }
      prev = ring.stage;
      ring.advance();
    }
    wgmma_wait<0>();
    fence_regs(acc);
    ring.release(prev, lane);

    // acc[4n + 2r + c] is dW row 16 warp + lane / 4 + 8 r of this
    // warpgroup's 64, column c0 + 8 n + 2 (lane % 4) + c: into the range's
    // partial row, or (one range) added to the running grads.
    const int row0 = w.mb * DW_A_ATOMS * 64 + wg * 64 + warp * 16 + lane / 4;
    const bool direct = a.out != nullptr;
    float* const out = (direct ? a.out : a.partial + (size_t)w.range * a.part_ld) + jb.w_off +
                       jb.col_off + w.c0;
    const int cols = jb.n - w.c0;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= jb.m_real) continue;
      float* const dst = out + (size_t)row * jb.ldw;
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
        const int col = 8 * n + 2 * (lane % 4);
        if (col >= cols) continue;
        float2 v = make_float2(acc[4 * n + 2 * r], acc[4 * n + 2 * r + 1]);
        if (direct) {  // reduce_rows_kernel's sum at one range: the grads, then the range's
          const float2 o = *reinterpret_cast<const float2*>(dst + col);
          v = make_float2(o.x + v.x, o.y + v.y);
        }
        *reinterpret_cast<float2*>(dst + col) = v;
      }
    }
  }
}

// ------------------------------------------------------------------ host --

// The descriptor (fused_mlp_common.cuh's layout) of any depth, width and
// band count; product g's K is read off its offsets.
struct LDesc {
  int L, H, lx, ld, inc_x, inc_d, pxp, pdp;
  long long wa_off, ba_off, wr_off, br_off;
  std::vector<long long> w_off, b_off, k;
  std::vector<PeCol> tab;  // the pxp + pdp PE columns
  long long n(int g) const { return g == L + 1 ? H / 2 : H; }
};

// What PE column c computes: fused_field.cuh's pe_col for the forward, at
// any band count.
PeCol host_pe_col(const LDesc& d, const float* freqs, int c) {
  const bool dir = c >= d.pxp;
  int j = dir ? c - d.pxp : c;
  const int L = dir ? d.ld : d.lx, inc = dir ? d.inc_d : d.inc_x;
  if (dir && j >= d.pdp) return {0.f, 0};
  const int part = dir ? 16 : 0;
  if (inc) {
    if (j < 3) return {0.f, 1 | j << 2 | part};
    j -= 3;
  }
  const int kind = j < 3 * L ? 2 : 3;
  if (kind == 3) j -= 3 * L;
  if (j >= 3 * L) return {0.f, 0};
  return {freqs[(dir ? d.lx : 0) + j % L], kind | (j / L) << 2 | part};
}

// Returns a cudaError_t code; 0 when the descriptor is one the route takes.
int parse_layers(const int* di, int n_di, const float* freqs, int n_freqs, LDesc* out) {
  if (n_di < N_DESC_FIXED) return (int)cudaErrorInvalidValue;
  LDesc d;
  d.L = di[0];
  d.H = di[1];
  d.lx = di[3];
  d.ld = di[4];
  d.inc_x = di[5];
  d.inc_d = di[6];
  d.pxp = di[7];
  d.pdp = di[8];
  d.wa_off = di[9];
  d.ba_off = di[10];
  d.wr_off = di[11];
  d.br_off = di[12];
  const int G = d.L + 2;
  if (d.L < 1 || n_di != N_DESC_FIXED + 2 * G || d.H < 128 || d.H % 128 != 0 || d.lx < 1 ||
      d.ld < 1 || n_freqs != d.lx + d.ld || d.pxp % 16 != 0 || d.pdp % 16 != 0 ||
      d.pxp < 6 * d.lx + 3 * (d.inc_x != 0) || d.pdp < 6 * d.ld + 3 * (d.inc_d != 0) ||
      d.wa_off % 8 != 0 || d.wr_off % 8 != 0 || d.wr_off != d.wa_off + d.H ||
      d.br_off != d.ba_off + 1)
    return (int)cudaErrorInvalidValue;
  for (int g = 0; g < G; ++g) {
    d.w_off.push_back(di[N_DESC_FIXED + g]);
    d.b_off.push_back(di[N_DESC_FIXED + G + g]);
  }
  for (int g = 0; g < G; ++g) {
    const long long next = g + 1 < G ? d.w_off[g + 1] : d.wa_off;
    const long long span = next - d.w_off[g];
    if (d.w_off[g] % 8 != 0 || d.b_off[g] % 2 != 0 || span <= 0 || span % d.n(g) != 0)
      return (int)cudaErrorInvalidValue;
    const long long k = span / d.n(g);
    const bool ok = g == 0       ? k == d.pxp
                    : g < d.L    ? k == d.H || k == d.H + d.pxp
                    : g == d.L   ? k == d.H
                                 : k == d.H + d.pdp;
    if (!ok) return (int)cudaErrorInvalidValue;
    d.k.push_back(k);
  }
  for (int c = 0; c < d.pxp + d.pdp; ++c) d.tab.push_back(host_pe_col(d, freqs, c));
  *out = d;
  return 0;
}

long long blocks(long long x, long long b) { return (x + b - 1) / b; }

// dW units of one point range of an m x n job (a 128-row block of each
// 256-column block).
long long job_units(long long m, long long n) {
  return blocks(m, DW_A_ATOMS * 64) * blocks(n, DW_B_ATOMS * 64);
}

int ranges_for(long long units_per_range) {
  const long long r = (DW_UNITS + units_per_range - 1) / units_per_range;
  return (int)(r < 1 ? 1 : (r > DW_RANGES ? DW_RANGES : r));
}

// The backward's dW launches, one per weight matrix (the dir launch also
// takes the heads, whose weights follow dir's): where the grads lie in the
// packed weights, how many, and the point ranges they are split into.
struct DwGroup {
  long long base, cols;
  int ranges;
};

std::vector<DwGroup> dw_groups(const LDesc& d) {
  const long long H = d.H;
  std::vector<DwGroup> out;
  out.push_back({d.w_off[0], H * d.pxp, ranges_for(job_units(H, d.pxp))});
  for (int g = 1; g <= d.L; ++g) {
    const bool skip = d.k[g] > H;
    out.push_back({d.w_off[g], H * d.k[g],
                   ranges_for(job_units(H, H) + (skip ? job_units(H, d.pxp) : 0))});
  }
  out.push_back({d.w_off[d.L + 1], d.wr_off + 3 * (H / 2) - d.w_off[d.L + 1],
                 ranges_for(job_units(H / 2, H) + job_units(H / 2, d.pdp) +
                            job_units(HEAD_LD, H) + job_units(HEAD_LD, H / 2))});
  return out;
}

// Workspace layout (bytes), every region on a 256 B boundary. Mirrored in
// Python by nerfmeshes_tpu_torch/ops/kernels/field_layers.py:workspace_bytes,
// which plans the slab: keep the two alike.
struct LLayout {
  long long slab;
  size_t tab, pe_x, pe_d, buf0, buf1, h, act, feat, dy_rgb, dy_a, dy_dir, dy0, dy1;
  size_t colsum, hpart, bpart, bcount, dwpart, total;
  int hpart_ld;
};

LLayout layers_layout(const LDesc& d, int kind, long long slab) {
  LLayout w = {};
  size_t off = 0;
  auto take = [&off](size_t bytes) {
    const size_t at = off;
    off += round_up(bytes, 256);
    return at;
  };
  const size_t P = (size_t)slab, H = d.H, e = sizeof(bf16);
  w.slab = slab;
  w.tab = take((d.pxp + d.pdp) * sizeof(PeCol));
  w.pe_x = take(P * d.pxp * e);
  if (kind != KIND_SIGMA) w.pe_d = take(P * d.pdp * e);
  if (kind != KIND_BWD) {
    w.buf0 = take(P * H * e);
    w.buf1 = take(P * H * e);
    if (kind == KIND_FWD) w.h = take(P * (H / 2) * e);
  } else {
    w.act = take(d.L * P * H * e);
    w.feat = take(P * H * e);
    w.h = take(P * (H / 2) * e);
    w.dy_rgb = take(P * HEAD_LD * e);
    w.dy_a = take(P * HEAD_LD * e);
    w.dy_dir = take(P * (H / 2) * e);
    w.dy0 = take(P * H * e);
    w.dy1 = take(P * H * e);
    // every dX product's column sums (L + 1 regions), the heads' partials,
    // then the bias-grad reduction's level-1 rows and counters (launch_bias,
    // for the slab's segments: the products', the heads' dir and 4 columns)
    w.colsum = take((d.L + 1) * (P / LP_ROWS) * H * sizeof(float));
    w.hpart_ld = (int)(H / 2 + 4);
    w.hpart = take(P / HEAD_ROWS * w.hpart_ld * sizeof(float));
    const long long mt = slab / LP_ROWS, hb = slab / HEAD_ROWS;
    w.bpart = take(((size_t)(d.L + 1) * bias_groups(mt) * H +
                    (size_t)bias_groups(hb) * (H / 2 + 4)) * sizeof(float));
    w.bcount = take(((size_t)(d.L + 1) * bias_chunks(H) + bias_chunks(H / 2) + bias_chunks(4)) *
                    sizeof(unsigned));
    size_t floats = 0;
    for (const DwGroup& g : dw_groups(d)) {
      const size_t f = (size_t)g.ranges * round_up((size_t)g.cols, 64);
      floats = f > floats ? f : floats;
    }
    w.dwpart = take(floats * sizeof(float));
  }
  w.total = off;
  return w;
}

// The card a call runs on: its SMs and the shared memory a block may opt in to.
struct Card {
  int sms, smem_limit;
};

int query_card(Card* c) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&c->sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&c->smem_limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (int)err;
}

// Every product instantiation may take the card's whole shared memory (a
// launch asks for its plan's bytes).
template <bool NN, bool FULL>
int product_attributes(int smem_limit) {
  const void* kernels[4] = {reinterpret_cast<const void*>(layer_product_kernel<NN, 64, FULL>),
                            reinterpret_cast<const void*>(layer_product_kernel<NN, 128, FULL>),
                            reinterpret_cast<const void*>(layer_product_kernel<NN, 192, FULL>),
                            reinterpret_cast<const void*>(layer_product_kernel<NN, 256, FULL>)};
  for (const void* k : kernels) {
    const cudaError_t err =
        cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_limit);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// ... every instantiation a launch may pick (launch_product).
int product_attributes(int smem_limit) {
  int rc = product_attributes<false, false>(smem_limit);
  if (rc == 0) rc = product_attributes<false, true>(smem_limit);
  if (rc == 0) rc = product_attributes<true, true>(smem_limit);
  return rc;
}

// The map of a product's W as the kernel reads it: NN 0, (n, K) in boxes
// of 64 K-columns x product_bn(n) rows; NN 1, W's x part (K = n_g rows of
// ld elements, n columns) in boxes of 64 columns x 64 K rows.
int encode_w_map(CUtensorMap* map, const bf16* W, bool nn, int K, int n, long long ld) {
  return nn ? encode_slab_map(map, W, n, K, SLAB_K, SLAB_K, ld)
            : encode_slab_map(map, W, K, n, product_bn(n), SLAB_K, ld);
}

// A product's epilogue: + bias (n floats, or none), ReLU, zero where mask
// (m, n) is not > 0 (or none), the rank-1 term r1_a[row * 16] r1_w[col]
// (or none), bf16 into out (m, n), and with colsum its column sums per 128
// rows.
struct Epilogue {
  const float* bias;
  int relu;
  const bf16* mask;
  bf16* out;
  float* colsum;
  const bf16* r1_a;
  const bf16* r1_w;
};

Epilogue epilogue_args(const float* bias, int relu, const bf16* mask, bf16* out,
                       float* colsum = nullptr, const bf16* r1_a = nullptr,
                       const bf16* r1_w = nullptr) {
  return {bias, relu, mask, out, colsum, r1_a, r1_w};
}

// A persistent launch: a CTA per SM (the plan's shared memory holds one),
// at most one per tile.
template <bool NN, int BN, bool FULL>
int launch_bn(const ProductArgs& pa, int sms, cudaStream_t s) {
  const unsigned grid = (unsigned)(pa.tiles < sms ? pa.tiles : sms);
  layer_product_kernel<NN, BN, FULL><<<grid, FIELD_THREADS, pa.plan.bytes, s>>>(pa);
  return (int)cudaGetLastError();
}

template <bool NN, bool FULL>
int launch_plan(const ProductArgs& pa, int sms, cudaStream_t s) {
  switch (pa.plan.bn) {
    case 64:
      return launch_bn<NN, 64, FULL>(pa, sms, s);
    case 128:
      return launch_bn<NN, 128, FULL>(pa, sms, s);
    case 192:
      return launch_bn<NN, 192, FULL>(pa, sms, s);
    default:
      return launch_bn<NN, 256, FULL>(pa, sms, s);
  }
}

// One product launch on the stream: A = [a1 (m, k1) | a2 (m, k2)] row-major
// arrays, b the weight map (encode_w_map), persistent CTAs (launch_bn).
template <bool NN>
int launch_product(const Epilogue& e, const bf16* a1, int k1, const bf16* a2, int k2,
                   long long m, int n, const CUtensorMap& b, const Card& card, cudaStream_t s,
                   int* launches) {
  ProductArgs pa;
  memset(&pa, 0, sizeof(pa));
  int rc = product_plan(n, card.smem_limit, &pa.plan);
  if (rc == 0) rc = encode_slab_map(&pa.a1, a1, k1, (int)m, LP_ROWS);
  if (rc == 0 && k2 > 0) rc = encode_slab_map(&pa.a2, a2, k2, (int)m, LP_ROWS);
  if (rc == 0) rc = encode_slab_map(&pa.out, e.out, n, (int)m, 64);
  if (rc == 0 && e.mask != nullptr) rc = encode_slab_map(&pa.mask, e.mask, n, (int)m, 64);
  if (rc != 0) return rc;
  if (k2 == 0) pa.a2 = pa.a1;
  pa.b = b;
  pa.k1 = k1;
  pa.k2 = k2;
  pa.n = n;
  pa.m = m;
  pa.tiles = blocks(m, LP_ROWS) * pa.plan.col_tiles;
  pa.bias = e.bias;
  pa.relu = e.relu;
  pa.has_mask = e.mask != nullptr;
  pa.r1_a = e.r1_a;
  pa.r1_w = e.r1_w;
  pa.colsum = e.colsum;
  // the forward's bias and ReLU alone on the lean instantiation
  if (NN || e.mask != nullptr || e.colsum != nullptr || e.r1_a != nullptr)
    rc = launch_plan<NN, true>(pa, card.sms, s);
  else
    rc = launch_plan<false, false>(pa, card.sms, s);
  launches[CNT_PRODUCT] += 1;
  return rc;
}

// One dW launch over a slab of m points: jobs over `maps` (row-major bf16
// arrays of m rows, ld elements apart, 0: cols), their grads added to
// out[0, cols) (the group's part of the packed dW): layer_dw_kernel over
// the group's point ranges, the units of whole waves of the card's SMs at
// 256 columns, then the rest in pieces of 128 or 64 columns (dw_pieces),
// and past one range reduce_rows_kernel over its partials. `variant`, for
// timing probes only: DW_FUSED launches the fused backward's dw_kernel on
// its job-major units instead (a CTA a unit), DW_SAME_POINTS has every
// range read the first range's points (wrong grads: a probe of what the
// leg's bytes cost), DW_PLAIN runs every unit at 256 columns. info, where
// given: the point ranges, the units, the kernel launches, the last
// wave's pieces a unit.
enum DwVariant { DW_ROUTE = 0, DW_FUSED = 1, DW_SAME_POINTS = 2, DW_PLAIN = 3 };

struct DwMapSpec {
  const bf16* base;
  int cols;
  long long ld = 0;
};

// Column pieces a unit of the last wave takes: the most of 1, 2 and 4
// (256, 128, 64 columns) whose pieces the SMs hold at once.
int dw_pieces(long long left, int sms) {
  int pieces = 1;
  while (pieces * DW_MIN_PIECE < DW_B_ATOMS * 64 && left * pieces * 2 <= sms) pieces *= 2;
  return pieces;
}

template <int BN>
int launch_dw_items(LayerDwArgs& a, long long first, long long units, int sms, cudaStream_t s) {
  a.first = first;
  a.pieces = DW_B_ATOMS * 64 / BN;
  a.items = units * a.pieces;
  const unsigned grid = (unsigned)(a.items < sms ? a.items : sms);
  layer_dw_kernel<BN><<<grid, FIELD_THREADS, DW_SMEM, s>>>(a);
  return (int)cudaGetLastError();
}

int launch_layer_dw(const DwGroup& grp, const DwMapSpec* maps, int n_maps, const DwJob* jobs,
                    int n_jobs, long long m, float* partial, float* out, int sms,
                    cudaStream_t s, int* launches, int variant = DW_ROUTE, int* info = nullptr) {
  if (n_maps > N_MAPS) return (int)cudaErrorInvalidValue;
  LayerDwArgs a;
  memset(&a, 0, sizeof(a));
  for (int i = 0; i < n_maps; ++i) {
    const int rc = encode_slab_map(&a.maps[i], maps[i].base, maps[i].cols, (int)m, SLAB_K,
                                   SLAB_K, maps[i].ld);
    if (rc != 0) return rc;
  }
  const long long n_pad = (long long)round_up((size_t)m, SLAB_K);
  a.range_pts = (int)round_up((size_t)blocks(n_pad, grp.ranges), SLAB_K);
  a.part_ld = (long long)round_up((size_t)grp.cols, 64);
  const int ranges = (int)blocks(n_pad, a.range_pts);
  if (variant == DW_FUSED) {
    DwArgs b;
    memset(&b, 0, sizeof(b));
    memcpy(b.maps, a.maps, sizeof(b.maps));
    b.range_pts = a.range_pts;
    b.n_pad = n_pad;
    b.partial = partial;
    b.part_ld = a.part_ld;
    int u = 0;
    for (int j = 0; j < n_jobs; ++j) u = add_job(&b, u, ranges, jobs[j]);
    if (u < 0) return (int)cudaErrorInvalidValue;
    if (info != nullptr) info[0] = ranges, info[1] = u, info[2] = 1, info[3] = 1;
    launches[CNT_DW] += 1;
    launches[CNT_REDUCE] += 1;
    return launch_dw(b, u, ranges, (int)grp.cols, out, s, 1);
  }
  for (int j = 0; j < n_jobs; ++j) {  // each job's 256-column blocks, a range's units in turn
    for (int c = 0; c < jobs[j].n; c += DW_B_ATOMS * 64) {
      if (a.count == MAX_JOBS) return (int)cudaErrorInvalidValue;
      DwJob blk = jobs[j];
      blk.b_col += c;
      blk.col_off += c;
      blk.n = jobs[j].n - c < DW_B_ATOMS * 64 ? jobs[j].n - c : DW_B_ATOMS * 64;
      blk.m_blocks = (int)blocks(blk.m, DW_A_ATOMS * 64);
      blk.unit0 = a.per_range;
      a.job[a.count++] = blk;
      a.per_range += blk.m_blocks;
    }
  }
  a.range_step = variant == DW_SAME_POINTS ? 0 : a.range_pts;
  a.n_pad = n_pad;
  a.partial = partial;
  a.out = ranges == 1 ? out : nullptr;
  const long long units = (long long)a.per_range * ranges;
  // whole waves at 256 columns; the last wave's units in pieces
  const long long whole = variant == DW_PLAIN ? units : units / sms * sms;
  const int pieces = units > whole ? dw_pieces(units - whole, sms) : 1;
  int err = 0, kernels = 0;
  if (whole > 0) {
    err = launch_dw_items<DW_B_ATOMS * 64>(a, 0, whole, sms, s);
    ++kernels;
  }
  if (err == 0 && units > whole) {
    err = pieces == 4   ? launch_dw_items<64>(a, whole, units - whole, sms, s)
          : pieces == 2 ? launch_dw_items<128>(a, whole, units - whole, sms, s)
                        : launch_dw_items<256>(a, whole, units - whole, sms, s);
    ++kernels;
  }
  launches[CNT_DW] += kernels;
  if (info != nullptr) info[0] = ranges, info[1] = (int)units, info[2] = kernels, info[3] = pieces;
  if (err != 0 || ranges == 1) return err;
  launches[CNT_REDUCE] += 1;
  return reduce_rows(partial, a.part_ld, ranges, (int)grp.cols, ranges, out, 0, s, 1);
}

// The dW kernels may take DW_SMEM bytes of shared memory.
int dw_attributes() {
  const void* kernels[4] = {reinterpret_cast<const void*>(layer_dw_kernel<64>),
                            reinterpret_cast<const void*>(layer_dw_kernel<128>),
                            reinterpret_cast<const void*>(layer_dw_kernel<256>),
                            reinterpret_cast<const void*>(dw_kernel)};
  for (const void* k : kernels) {
    const cudaError_t err =
        cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, DW_SMEM);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

int launch_pe(const LDesc& d, const PeCol* tab, const float* src, const float* dirs,
              const float* z, long long row0, long long m, int samples, bool fwd, bf16* pe_x,
              bf16* pe_d, cudaStream_t s, int* launches) {
  size_t smem = 0;
  const int pts = pe_points(d.pxp, d.pdp, fwd, &smem);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        layer_pe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const PeArgs a = {src,  dirs, z,       row0,    m,       samples, fwd ? 1 : 0, d.pxp, d.pdp,
                    d.lx, d.ld, d.inc_x, d.inc_d, pts,     tab,     pe_x,        pe_d};
  layer_pe_kernel<<<(unsigned)blocks(m, pts), PE_THREADS, smem, s>>>(a);
  launches[CNT_PE] += 1;
  return (int)cudaGetLastError();
}

// Every check before the first launch: the card, the weights' maps (as
// (N, K) for the forward products, and for the backward the x parts as
// (K, H)), the kernels' shared memory, the PE table copied to the workspace.
int prepare(const LDesc& d, int kind, const bf16* W, const float* B, unsigned char* ws,
            const LLayout& lay, std::vector<CUtensorMap>* nt, std::vector<CUtensorMap>* nn,
            Card* card, cudaStream_t s) {
  if (reinterpret_cast<uintptr_t>(W) % 16 != 0 || reinterpret_cast<uintptr_t>(B) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(ws) % 256 != 0)
    return (int)cudaErrorInvalidValue;
  int rc = query_card(card);
  if (rc != 0) return rc;
  const int G = d.L + 2;
  nt->resize(G);
  nn->resize(G);
  for (int g = 0; g < G; ++g) {
    ProductPlan plan;
    rc = product_plan((int)d.n(g), card->smem_limit, &plan);
    if (rc == 0)
      rc = encode_w_map(&(*nt)[g], W + d.w_off[g], false, (int)d.k[g], (int)d.n(g), 0);
    if (rc == 0 && kind == KIND_BWD && g > 0)
      rc = encode_w_map(&(*nn)[g], W + d.w_off[g], true, (int)d.n(g), d.H, d.k[g]);
    if (rc != 0) return rc;
  }
  rc = product_attributes(card->smem_limit);
  if (rc != 0) return rc;
  cudaError_t err = kind == KIND_BWD ? (cudaError_t)dw_attributes() : cudaSuccess;
  if (err == cudaSuccess && kind == KIND_BWD)  // the bias reduction's counters start at 0
    err = cudaMemsetAsync(ws + lay.bcount, 0, lay.dwpart - lay.bcount, s);
  if (err == cudaSuccess)  // pageable source: staged at once, no wait on the device
    err = cudaMemcpyAsync(ws + lay.tab, d.tab.data(), d.tab.size() * sizeof(PeCol),
                          cudaMemcpyHostToDevice, s);
  return (int)err;
}

}  // namespace

// Bytes of workspace nm_field_layers needs for `kind` (0 forward, 1 sigma,
// 2 backward) in slabs of `slab` points (a positive multiple of 128).
extern "C" int nm_field_layers_workspace(int kind, const int* desc_i, int n_desc_i,
                                         const float* freqs, int n_freqs, long long slab,
                                         long long* bytes) {
  LDesc d;
  const int err = parse_layers(desc_i, n_desc_i, freqs, n_freqs, &d);
  if (err != 0) return err;
  if (kind < KIND_FWD || kind > KIND_BWD || slab <= 0 || slab % LP_ROWS != 0)
    return (int)cudaErrorInvalidValue;
  *bytes = (long long)layers_layout(d, kind, slab).total;
  return 0;
}

// The field layer at a time, in slabs of `slab` points.
//   kind 0, the forward: src/dirs (n_rays, 3), z (n_rays, samples) f32 ->
//     out (4, N) channels-first or (N, 4), N = n_rays * samples.
//   kind 1, sigma: src (n_rays, 3) points (samples 1) -> out (N,) raw sigma.
//   kind 2, the backward: the forward's rays and grad, its (4, N) f32
//     cotangent -> dW, dB (the packed layout; zeroed by the caller: the
//     grads are added to them).
// workspace: nm_field_layers_workspace's bytes for this kind and slab.
// launches[7] gets each kernel's launches added: PE, product, the forward's
// and sigma's heads, dW, the dW partials' reductions, the bias-grad
// reductions, the backward's heads. Returns a cudaError_t code; 0 on
// success.
extern "C" int nm_field_layers(int kind, const float* src, const float* dirs, const float* z,
                               long long n_rays, int samples, const float* grad,
                               const void* weights, const float* biases, const int* desc_i,
                               int n_desc_i, const float* freqs, int n_freqs, void* workspace,
                               long long workspace_bytes, long long slab, float* out,
                               int channels_first, float* dW, float* dB, int* launches,
                               void* stream) {
  LDesc d;
  int err = parse_layers(desc_i, n_desc_i, freqs, n_freqs, &d);
  if (err != 0) return err;
  if (kind < KIND_FWD || kind > KIND_BWD || slab <= 0 || slab % LP_ROWS != 0 ||
      slab / LP_ROWS > 65535 || n_rays < 0 || samples <= 0 ||
      (kind == KIND_SIGMA && samples != 1) || n_rays * samples > (long long)INT_MAX)
    return (int)cudaErrorInvalidValue;
  const LLayout lay = layers_layout(d, kind, slab);
  if (workspace_bytes < (long long)lay.total) return (int)cudaErrorInvalidValue;
  const long long n_pts = n_rays * samples;
  if (n_pts == 0) return 0;
  const bf16* W = static_cast<const bf16*>(weights);
  unsigned char* ws = static_cast<unsigned char*>(workspace);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  std::vector<CUtensorMap> nt, nn;
  Card card;
  err = prepare(d, kind, W, biases, ws, lay, &nt, &nn, &card, s);
  if (err != 0) return err;

  const int L = d.L, H = d.H;
  auto at = [ws](size_t off) { return reinterpret_cast<bf16*>(ws + off); };
  const PeCol* tab = reinterpret_cast<const PeCol*>(ws + lay.tab);
  bf16 *pe_x = at(lay.pe_x), *pe_d = at(lay.pe_d);
  const bool fwd_pe = kind != KIND_SIGMA;
  const bf16* wa = W + d.wa_off;
  const bf16* wr = W + d.wr_off;
  const std::vector<DwGroup> groups = dw_groups(d);
  float* dwpart = reinterpret_cast<float*>(ws + lay.dwpart);
  float* colsum = reinterpret_cast<float*>(ws + lay.colsum);
  float* hpart = reinterpret_cast<float*>(ws + lay.hpart);
  float* bpart = reinterpret_cast<float*>(ws + lay.bpart);
  unsigned* bcount = reinterpret_cast<unsigned*>(ws + lay.bcount);
  // dX product j's column sums (j = 0 dir's, then the feat and trunk
  // products' down to layer1's): their own region each
  auto colsum_of = [&](int j) { return colsum + (size_t)j * (slab / LP_ROWS) * H; };

  for (long long row0 = 0; row0 < n_pts; row0 += slab) {
    const long long m = n_pts - row0 < slab ? n_pts - row0 : slab;
    err = launch_pe(d, tab, src, dirs, z, row0, m, samples, fwd_pe, pe_x, pe_d, s, launches);
    if (err != 0) return err;
    // The forward's products: layer1, the trunk, feat, dir. The backward
    // keeps every output (act[g], feat, h); the others two buffers in turn.
    auto act = [&](int g) { return at(lay.act) + (size_t)g * slab * H; };
    bf16* x = kind == KIND_BWD ? act(0) : at(lay.buf0);
    err = launch_product<false>(epilogue_args(biases + d.b_off[0], 0, nullptr, x), pe_x, d.pxp,
                                nullptr, 0, m, H, nt[0], card, s, launches);
    for (int g = 1; g < L && err == 0; ++g) {
      bf16* y = kind == KIND_BWD ? act(g) : (x == at(lay.buf0) ? at(lay.buf1) : at(lay.buf0));
      const bool skip = d.k[g] > H;
      err = launch_product<false>(epilogue_args(biases + d.b_off[g], 1, nullptr, y), x, H,
                                  pe_x, skip ? d.pxp : 0, m, H, nt[g], card, s, launches);
      x = y;
    }
    if (err != 0) return err;
    const bf16* trunk = x;
    HeadArgs ha = {trunk, nullptr, wa, wr, biases + d.ba_off, biases + d.br_off, H, m, row0,
                   n_pts, out, channels_first, grad, nullptr, nullptr, nullptr, nullptr, 0};
    const unsigned head_blocks = (unsigned)blocks(m, HEAD_ROWS);
    if (kind == KIND_SIGMA) {
      layer_heads_kernel<HEAD_SIGMA><<<head_blocks, HEAD_THREADS, 0, s>>>(ha);
      launches[CNT_HEADS] += 1;
      err = (int)cudaGetLastError();
      if (err != 0) return err;
      continue;
    }
    bf16* feat = kind == KIND_BWD ? at(lay.feat) : (x == at(lay.buf0) ? at(lay.buf1) : at(lay.buf0));
    bf16* h = at(lay.h);
    err = launch_product<false>(epilogue_args(biases + d.b_off[L], 1, nullptr, feat), trunk, H,
                                nullptr, 0, m, H, nt[L], card, s, launches);
    if (err == 0)
      err = launch_product<false>(epilogue_args(biases + d.b_off[L + 1], 1, nullptr, h), feat,
                                  H, pe_d, d.pdp, m, H / 2, nt[L + 1], card, s, launches);
    if (err != 0) return err;
    ha.h = h;
    if (kind == KIND_FWD) {
      layer_heads_kernel<HEAD_FWD><<<head_blocks, HEAD_THREADS, 0, s>>>(ha);
      launches[CNT_HEADS] += 1;
      err = (int)cudaGetLastError();
      if (err != 0) return err;
      continue;
    }

    // The backward: the heads' and the dir layer's cotangents and their
    // bias-grad partials, then dW of dir and the heads.
    bf16 *dy_rgb = at(lay.dy_rgb), *dy_a = at(lay.dy_a), *dy_dir = at(lay.dy_dir);
    ha.dy_rgb = dy_rgb;
    ha.dy_a = dy_a;
    ha.dy_dir = dy_dir;
    ha.part = hpart;
    ha.ld_part = lay.hpart_ld;
    err = launch_heads_bwd(ha, s, launches);
    if (err != 0) return err;
    const long long dir0 = d.w_off[L + 1];
    {
      const DwMapSpec maps[7] = {{dy_dir, H / 2}, {feat, H},   {pe_d, d.pdp}, {dy_a, HEAD_LD},
                                 {trunk, H},      {dy_rgb, HEAD_LD}, {h, H / 2}};
      const int ldir = H + d.pdp;
      const DwJob jobs[4] = {
          {0, 0, 0, 1, 0, 0, H / 2, H / 2, H, 0, ldir, 0},
          {0, 0, 0, 2, 0, 0, H / 2, H / 2, d.pdp, 0, ldir, H},
          {3, 0, 0, 4, 0, 0, HEAD_LD, 1, H, (int)(d.wa_off - dir0), H, 0},
          {5, 0, 0, 6, 0, 0, HEAD_LD, 3, H / 2, (int)(d.wr_off - dir0), H / 2, 0}};
      err = launch_layer_dw(groups[L + 1], maps, 7, jobs, 4, m, dwpart, dW + dir0, card.sms, s,
                            launches);
      if (err != 0) return err;
    }
    // The dX chain: dy[g - 1] = (dy[g] W_g's x part) masked by the forward's
    // output of product g - 1 (layer1 has no ReLU), from dir's down to
    // layer1's; each product's bias grads are its output's column sums,
    // each into its own region, each weight matrix's dW follows its
    // cotangent.
    bf16* dy = at(lay.dy0);
    err = launch_product<true>(epilogue_args(nullptr, 0, feat, dy, colsum_of(0)), dy_dir, H / 2,
                               nullptr, 0, m, H, nn[L + 1], card, s, launches);
    for (int g = L; g >= 1 && err == 0; --g) {
      const bool skip = d.k[g] > H;
      const bf16* xin = act(g - 1);  // product g's input: [act[g - 1] | PE(xyz)]
      const DwMapSpec maps[3] = {{dy, H}, {xin, H}, {pe_x, d.pxp}};
      const DwJob jobs[2] = {{0, 0, 0, 1, 0, 0, H, H, H, 0, (int)d.k[g], 0},
                             {0, 0, 0, 2, 0, 0, H, H, d.pxp, 0, (int)d.k[g], H}};
      err = launch_layer_dw(groups[g], maps, 3, jobs, skip ? 2 : 1, m, dwpart, dW + d.w_off[g],
                            card.sms, s, launches);
      if (err != 0) return err;
      bf16* next = dy == at(lay.dy0) ? at(lay.dy1) : at(lay.dy0);
      const bf16* mask = g - 1 > 0 ? act(g - 1) : nullptr;
      err = launch_product<true>(
          epilogue_args(nullptr, 0, mask, next, colsum_of(L + 1 - g), g == L ? dy_a : nullptr,
                        g == L ? wa : nullptr),
          dy, H, nullptr, 0, m, H, nn[g], card, s, launches);
      dy = next;
    }
    if (err != 0) return err;
    const DwMapSpec maps[2] = {{dy, H}, {pe_x, d.pxp}};
    const DwJob job = {0, 0, 0, 1, 0, 0, H, H, d.pxp, 0, d.pxp, 0};
    err = launch_layer_dw(groups[0], maps, 2, &job, 1, m, dwpart, dW + d.w_off[0], card.sms, s,
                          launches);
    if (err != 0) return err;
    // Every bias grad of the slab in one reduction: the L + 1 products'
    // column sums, the heads' dir and [alpha, r, g, b] partials.
    const int mt = (int)blocks(m, LP_ROWS), hb = (int)blocks(m, HEAD_ROWS);
    std::vector<BiasSpec> segs;
    segs.push_back({colsum_of(0), H, mt, H, dB + d.b_off[L]});
    for (int g = L; g >= 1; --g)
      segs.push_back({colsum_of(L + 1 - g), H, mt, H, dB + d.b_off[g - 1]});
    segs.push_back({hpart, lay.hpart_ld, hb, H / 2, dB + d.b_off[L + 1]});
    segs.push_back({hpart + H / 2, lay.hpart_ld, hb, 4, dB + d.ba_off});
    err = launch_bias(segs.data(), (int)segs.size(), bpart, bcount, s, launches);
    if (err != 0) return err;
  }
  return 0;
}

// The PE kernel alone, for its checks: PE(xyz) (n, pxp) and, with dirs,
// PE(dir) (n, pdp) bf16 of the rays (o, d, z) (samples > 0) or, without
// dirs, of the points src (samples 1). table: device memory of
// (pxp + pdp) * 8 bytes. Returns a cudaError_t code; 0 on success.
extern "C" int nm_field_layers_pe(const float* src, const float* dirs, const float* z,
                                  long long n_rays, int samples, const int* desc_i,
                                  int n_desc_i, const float* freqs, int n_freqs, void* table,
                                  void* pe_x, void* pe_d, void* stream) {
  LDesc d;
  const int err = parse_layers(desc_i, n_desc_i, freqs, n_freqs, &d);
  if (err != 0) return err;
  if (n_rays < 0 || samples <= 0) return (int)cudaErrorInvalidValue;
  const long long n = n_rays * samples;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = cudaMemcpyAsync(table, d.tab.data(), d.tab.size() * sizeof(PeCol),
                                        cudaMemcpyHostToDevice, s);
  if (e != cudaSuccess) return (int)e;
  int launches[N_COUNTERS] = {};
  return launch_pe(d, static_cast<const PeCol*>(table), src, dirs, z, 0, n, samples,
                   dirs != nullptr, static_cast<bf16*>(pe_x), static_cast<bf16*>(pe_d), s,
                   launches);
}

// The product kernel's plan for n output columns on the current card
// (product_plan): out[4] = tile columns, ring stages, column tiles, shared
// bytes. Returns a cudaError_t code; 0 on success.
extern "C" int nm_field_layers_product_plan(int n, int* out) {
  if (n <= 0 || n % 64 != 0) return (int)cudaErrorInvalidValue;
  Card card;
  ProductPlan p;
  int rc = query_card(&card);
  if (rc == 0) rc = product_plan(n, card.smem_limit, &p);
  if (rc != 0) return rc;
  out[0] = p.bn;
  out[1] = p.stages;
  out[2] = p.col_tiles;
  out[3] = p.bytes;
  return 0;
}

// The product kernel alone, for its checks: out (m, n) bf16 =
// epilogue([a1 | a2] B + bias), a1 (m, k1), a2 (m, k2) row-major bf16 (k1 a
// multiple of 64 where k2 > 0); B = w^T, w (n, k1 + k2) row-major (nn 0),
// or B = w[:, :n], w (k1 + k2, ldw) row-major (nn 1); relu, or zero where
// mask (m, n) is not > 0; with colsum, its (ceil(m / 128), n) f32 column
// sums per 128 rows. n a multiple of 64. Returns a cudaError_t code.
extern "C" int nm_field_layers_product(const void* a1, int k1, const void* a2, int k2,
                                       long long m, const void* w, long long ldw, int n, int nn,
                                       const float* bias, int relu, const void* mask, void* out,
                                       float* colsum, void* stream) {
  if (m <= 0 || m > INT_MAX || k1 <= 0 || k1 % 8 != 0 || k2 < 0 || k2 % 8 != 0 ||
      (k2 > 0 && k1 % SLAB_K != 0) || n <= 0 || n % 64 != 0 || ldw % 8 != 0)
    return (int)cudaErrorInvalidValue;
  Card card;
  int rc = query_card(&card);
  if (rc == 0) rc = product_attributes(card.smem_limit);
  if (rc != 0) return rc;
  const bf16* W = static_cast<const bf16*>(w);
  CUtensorMap b;
  rc = encode_w_map(&b, W, nn != 0, k1 + k2, n, ldw);
  if (rc != 0) return rc;
  const Epilogue e = epilogue_args(bias, relu, static_cast<const bf16*>(mask),
                                   static_cast<bf16*>(out), colsum);
  int launches[N_COUNTERS] = {};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* A1 = static_cast<const bf16*>(a1);
  const bf16* A2 = static_cast<const bf16*>(a2);
  return nn ? launch_product<true>(e, A1, k1, A2, k2, m, n, b, card, s, launches)
            : launch_product<false>(e, A1, k1, A2, k2, m, n, b, card, s, launches);
}

// The backward's heads kernel alone, for its checks: h (m, H/2) bf16, the
// (4, m) f32 cotangent, the rgb head's weights wr (3, H/2) bf16 and biases
// br (3) -> dy_rgb, dy_a (m, 16) bf16, dy_dir (m, H/2) bf16 and part
// (ceil(m / 64), H/2 + 4) f32: per 64 points the column sums of dy_dir's
// f32 values and of [dalpha, dr, dg, db]. Returns a cudaError_t code.
extern "C" int nm_field_layers_heads_bwd(const void* h, const float* grad, long long m, int H,
                                         const void* wr, const float* br, void* dy_rgb,
                                         void* dy_a, void* dy_dir, float* part, void* stream) {
  const void* ptrs[5] = {h, wr, dy_rgb, dy_a, dy_dir};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return (int)cudaErrorInvalidValue;
  if (m <= 0 || H < 128 || H % 128 != 0) return (int)cudaErrorInvalidValue;
  HeadArgs ha = {nullptr, static_cast<const bf16*>(h), nullptr, static_cast<const bf16*>(wr),
                 nullptr, br, H, m, 0, m, nullptr, 0, grad, static_cast<bf16*>(dy_rgb),
                 static_cast<bf16*>(dy_a), static_cast<bf16*>(dy_dir), part, H / 2 + 4};
  int launches[N_COUNTERS] = {};
  return launch_heads_bwd(ha, static_cast<cudaStream_t>(stream), &launches[0]);
}

// The bias-grad reduction alone, for its checks: dst[i][c] += the sum over
// r of src[i][r * ld[i] + c], r < rows[i], c < cols[i], for n segments
// (host arrays of device pointers and sizes; cols and ld multiples of 4,
// src 16-byte aligned). scratch: device memory of the level-1 rows and
// counters, sum over segments of ceil(rows / 64) * cols floats, then of
// ceil(cols / 128) 32-bit counters, which must hold zeros (and hold zeros
// again after the launch). Returns a cudaError_t code.
extern "C" int nm_field_layers_bias(int n, const long long* src, const long long* ld,
                                    const int* rows, const int* cols, const long long* dst,
                                    void* scratch, long long scratch_bytes, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  std::vector<BiasSpec> segs;
  size_t floats = 0, counters = 0;
  for (int i = 0; i < n; ++i) {
    if (rows[i] <= 0 || cols[i] <= 0 || cols[i] % 4 != 0 || ld[i] < cols[i] || ld[i] % 4 != 0 ||
        src[i] % 16 != 0)
      return (int)cudaErrorInvalidValue;
    segs.push_back({reinterpret_cast<const float*>(src[i]), ld[i], rows[i], cols[i],
                    reinterpret_cast<float*>(dst[i])});
    floats += (size_t)bias_groups(rows[i]) * cols[i];
    counters += bias_chunks(cols[i]);
  }
  if (scratch_bytes < (long long)((floats + counters) * 4)) return (int)cudaErrorInvalidValue;
  float* level1 = static_cast<float*>(scratch);
  int launches[N_COUNTERS] = {};
  return launch_bias(segs.data(), n, level1, reinterpret_cast<unsigned*>(level1 + floats),
                     static_cast<cudaStream_t>(stream), launches);
}

// The dW leg alone, for its checks and timing: out[0, out_cols) f32 += the
// grads of n_jobs products dY^T X over m points, as the route launches
// them (launch_layer_dw). maps: n_maps bf16 row-major arrays of m rows
// (device addresses, 16 B aligned; columns; row pitches in elements, a
// multiple of 8). jobs: 10 ints each, a_map, a_col, b_map, b_col, rows
// computed, rows kept, columns, w_off, ldw, col_off: the (rows, columns)
// grads of dY's columns [a_col, a_col + rows) of map a_map against X's
// [b_col, b_col + columns) of map b_map, at out[w_off + col_off + row *
// ldw + col]. ranges: the point ranges (0: ranges_for's). variant:
// DwVariant. partial: scratch of partial_floats floats, the ranges x
// round_up(out_cols, 64) partials (unused at one range). info[4] gets the
// ranges, units, kernel launches and the last wave's pieces a unit.
// Returns a cudaError_t code.
extern "C" int nm_field_layers_dw(int n_maps, const long long* bases, const int* cols,
                                  const long long* lds, long long m, int n_jobs, const int* jobs,
                                  long long out_cols, int ranges, int variant, float* out,
                                  float* partial, long long partial_floats, int* info,
                                  void* stream) {
  if (n_maps <= 0 || n_maps > N_MAPS || m <= 0 || m > INT_MAX - SLAB_K || n_jobs <= 0 ||
      n_jobs > MAX_JOBS || out_cols <= 0 || ranges < 0 || variant < DW_ROUTE ||
      variant > DW_PLAIN)
    return (int)cudaErrorInvalidValue;
  std::vector<DwMapSpec> maps;
  for (int i = 0; i < n_maps; ++i) {
    if (bases[i] % 16 != 0 || cols[i] <= 0 || lds[i] < cols[i] || lds[i] % 8 != 0)
      return (int)cudaErrorInvalidValue;
    maps.push_back({reinterpret_cast<const bf16*>(bases[i]), cols[i], lds[i]});
  }
  std::vector<DwJob> js;
  long long per_range = 0;
  for (int j = 0; j < n_jobs; ++j) {
    const int* v = jobs + 10 * j;
    if (v[0] < 0 || v[0] >= n_maps || v[2] < 0 || v[2] >= n_maps || v[1] < 0 || v[3] < 0 ||
        v[5] <= 0 || v[4] < v[5] || v[6] <= 0 || v[6] % 2 != 0 || v[7] < 0 || v[8] < v[6] ||
        v[9] < 0 || (long long)v[7] + v[9] + (long long)(v[5] - 1) * v[8] + v[6] > out_cols)
      return (int)cudaErrorInvalidValue;
    js.push_back({v[0], 0, v[1], v[2], 0, v[3], v[4], v[5], v[6], v[7], v[8], v[9], 0, 0});
    per_range += job_units(v[4], v[6]);
  }
  Card card;
  int rc = query_card(&card);
  if (rc == 0) rc = dw_attributes();
  if (rc != 0) return rc;
  const DwGroup grp = {0, out_cols, ranges > 0 ? ranges : ranges_for(per_range)};
  const long long n_pad = (long long)round_up((size_t)m, SLAB_K);
  const long long range_pts = (long long)round_up((size_t)blocks(n_pad, grp.ranges), SLAB_K);
  const long long used = blocks(n_pad, range_pts);
  if ((used > 1 || variant == DW_FUSED) &&
      partial_floats < used * (long long)round_up((size_t)out_cols, 64))
    return (int)cudaErrorInvalidValue;
  int launches[N_COUNTERS] = {};
  return launch_layer_dw(grp, maps.data(), n_maps, js.data(), n_jobs, m, partial, out,
                         card.sms, static_cast<cudaStream_t>(stream), launches, variant, info);
}
