// The FlexibleNeRF field layer at a time, for Hopper (sm_90a): the route
// for every model the fused kernels' shared-memory plans refuse (hidden
// widths past 1024, more than 128 PE columns at 512 and 1024 wide, more
// than 24 bands, more than 14 layers), which JAX still runs through its
// Pallas kernels: forward, sigma-only and backward, replacing
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
// Design, three kernels of its own beside the backward's dW leg and
// reductions (dw_leg.cuh):
//   (1) layer_pe_kernel: PE(xyz) and PE(dir) of a slab of points into bf16
//       row-major arrays, each 8-column chunk by one thread, with the fused
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
//       the forward's (4, N) or (N, 4) output, sigma's (N,), or for the
//       backward the heads' cotangents (rgb through the sigmoid, alpha),
//       the dir layer's cotangent (through the rgb weights and the ReLU
//       mask) and their f32 bias-grad partials per 64 points.
// Points go through in slabs whose activations (every layer's, for the
// backward) fit the workspace the caller sizes (ops/kernels/field_layers.py
// plans them under a bound); each slab's weight grads come from dw_kernel,
// one launch per weight matrix, and are added to the running grads by the
// fixed-order reduction, as are the bias grads: no float atomics, so two
// calls give the same bits. Sigma runs the forward's PE, trunk and alpha
// head kernels with the forward's arguments: bit for bit its channel 3.
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
constexpr int PE_THREADS = 256;
constexpr int HEAD_ROWS = 64;  // points per heads block
constexpr int HEAD_THREADS = 256;
// dW units (dw_kernel blocks) a weight matrix's launch aims at: two waves of
// the H100's 132 SMs; its point ranges follow (at most DW_RANGES).
constexpr int DW_UNITS = 264;

enum Kind { KIND_FWD = 0, KIND_SIGMA = 1, KIND_BWD = 2 };
enum HeadMode { HEAD_FWD = 0, HEAD_SIGMA = 1, HEAD_BWD = 2 };
enum Counter { CNT_PE, CNT_PRODUCT, CNT_HEADS, CNT_DW, CNT_REDUCE, N_COUNTERS };

// ---------------------------------------------------------------- (1) PE --

struct PeArgs {
  const float* src;  // rays' origins (fwd) or points
  const float* dirs;
  const float* z;
  long long row0, m;  // the slab's first point and its points
  int samples, fwd, pxp, pdp;
  const PeCol* tab;  // what each column computes (fused_field.cuh:pe_col)
  bf16* pe_x;        // (m, pxp)
  bf16* pe_d;        // (m, pdp), fwd only
};

__global__ void __launch_bounds__(PE_THREADS) layer_pe_kernel(const PeArgs a) {
  const int chunks = (a.pxp + (a.fwd ? a.pdp : 0)) / 8;
  const long long i = (long long)blockIdx.x * PE_THREADS + threadIdx.x;
  const long long r = i / chunks;
  if (r >= a.m) return;
  const int ch = (int)(i % chunks);
  const long long g = a.row0 + r;
  float x0, x1, x2, v0 = 0.f, v1 = 0.f, v2 = 0.f;
  if (a.fwd) {  // o + d*z of the point's ray, unfused, as PeBuild::start
    const long long ray = g / a.samples;
    const float zt = a.z[g];
    v0 = a.dirs[3 * ray];
    v1 = a.dirs[3 * ray + 1];
    v2 = a.dirs[3 * ray + 2];
    x0 = __fadd_rn(a.src[3 * ray], __fmul_rn(v0, zt));
    x1 = __fadd_rn(a.src[3 * ray + 1], __fmul_rn(v1, zt));
    x2 = __fadd_rn(a.src[3 * ray + 2], __fmul_rn(v2, zt));
  } else {
    x0 = a.src[3 * g];
    x1 = a.src[3 * g + 1];
    x2 = a.src[3 * g + 2];
  }
  uint32_t w[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {  // PeBuild::step's arithmetic, two columns at a time
    float e[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const PeCol col = a.tab[8 * ch + 2 * p + h];
      const int comp = (col.code >> 2) & 3, kind = col.code & 3;
      const bool dir = col.code & 16;
      const float x = comp == 0 ? (dir ? v0 : x0)
                                : (comp == 1 ? (dir ? v1 : x1) : (dir ? v2 : x2));
      if (kind == 2)
        e[h] = sinf(x * col.f);
      else if (kind == 3)
        e[h] = cosf(x * col.f);
      else
        e[h] = kind == 1 ? x : 0.f;
    }
    w[p] = pack_bf16(e[0], e[1]);
  }
  const int c = 8 * ch;
  bf16* dst = c < a.pxp ? a.pe_x + r * a.pxp + c : a.pe_d + r * a.pdp + (c - a.pxp);
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
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

// TMA store of the box at (c0 = column, c1 = row) of `map` from src, in
// the issuing thread's bulk group.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], [%3];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(smem_u32(src))
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// The issuing thread's bulk stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
// ... and written global memory.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// Four 8 x 8 bf16 matrices between the mma fragment and shared memory: lane
// l gives the address of row l % 8 of matrix l / 8; register i holds row
// lane / 4, columns 2 (lane % 4) and + 1 of matrix i.
__device__ __forceinline__ void stmatrix_x4(uint32_t addr, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};" ::"r"(addr),
               "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

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

template <int MODE>
__global__ void __launch_bounds__(HEAD_THREADS) layer_heads_kernel(const HeadArgs a) {
  __shared__ float sd[HEAD_ROWS][4];  // bwd: drgb, dalpha of the block's points
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long b0 = (long long)blockIdx.x * HEAD_ROWS;
  const int H2 = a.H / 2;
  for (int i = warp; i < HEAD_ROWS; i += HEAD_THREADS / 32) {
    const long long r = b0 + i, g = a.row0 + r;
    if (r >= a.m) {
      if (MODE == HEAD_BWD && lane == 0) sd[i][0] = sd[i][1] = sd[i][2] = sd[i][3] = 0.f;
      continue;
    }
    float alpha = 0.f;
    if constexpr (MODE != HEAD_BWD) alpha = warp_dot(a.x + r * a.H, a.wa, a.H, lane) + a.ba[0];
    if constexpr (MODE == HEAD_SIGMA) {
      if (lane == 0) a.out[g] = alpha;
      continue;
    }
    float rgb[3];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      rgb[c] = 1.f / (1.f + expf(-(warp_dot(a.h + r * H2, a.wr + c * H2, H2, lane) + a.br[c])));
    if (lane != 0) continue;
    if constexpr (MODE == HEAD_FWD) {
      const float v[4] = {rgb[0], rgb[1], rgb[2], alpha};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (a.channels_first)
          a.out[c * a.n_total + g] = v[c];
        else
          a.out[g * 4 + c] = v[c];
      }
    } else {
      float d[4];
#pragma unroll
      for (int c = 0; c < 3; ++c) d[c] = a.grad[c * a.n_total + g] * rgb[c] * (1.f - rgb[c]);
      d[3] = a.grad[3 * a.n_total + g];
#pragma unroll
      for (int c = 0; c < 4; ++c) sd[i][c] = d[c];
      uint4* rgb_row = reinterpret_cast<uint4*>(a.dy_rgb + r * HEAD_LD);
      uint4* a_row = reinterpret_cast<uint4*>(a.dy_a + r * HEAD_LD);
      rgb_row[0] = make_uint4(pack_bf16(d[0], d[1]), pack_bf16(d[2], 0.f), 0u, 0u);
      rgb_row[1] = make_uint4(0u, 0u, 0u, 0u);
      a_row[0] = make_uint4(pack_bf16(d[3], 0.f), 0u, 0u, 0u);
      a_row[1] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  if constexpr (MODE == HEAD_BWD) {
    __syncthreads();
    const int rows = (int)(a.m - b0 < HEAD_ROWS ? a.m - b0 : HEAD_ROWS);
    float* prow = a.part + (size_t)blockIdx.x * a.ld_part;
    // dh = (bf16(drgb) wr) masked by h > 0: the dir layer's cotangent, and
    // its column sums over the block's points in order
    for (int k = threadIdx.x; k < H2; k += HEAD_THREADS) {
      const float w0 = __bfloat162float(a.wr[k]), w1 = __bfloat162float(a.wr[H2 + k]),
                  w2 = __bfloat162float(a.wr[2 * H2 + k]);
      float s = 0.f;
      for (int i = 0; i < rows; ++i) {
        const long long r = b0 + i;
        float v = __fadd_rn(__fadd_rn(__fmul_rn(bf16_round(sd[i][0]), w0),
                                      __fmul_rn(bf16_round(sd[i][1]), w1)),
                            __fmul_rn(bf16_round(sd[i][2]), w2));
        if (!(__bfloat162float(a.h[r * H2 + k]) > 0.f)) v = 0.f;
        a.dy_dir[r * H2 + k] = __float2bfloat16(v);
        s += v;
      }
      prow[k] = s;
    }
    if (threadIdx.x < 4) {  // [alpha, r, g, b], as the biases lie from ba_off
      const int c = threadIdx.x == 0 ? 3 : threadIdx.x - 1;
      float s = 0.f;
      for (int i = 0; i < rows; ++i) s += sd[i][c];
      prow[H2 + threadIdx.x] = s;
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

int ranges_for(long long units_per_range) {
  const long long r = (DW_UNITS + units_per_range - 1) / units_per_range;
  return (int)(r < 1 ? 1 : (r > DW_RANGES ? DW_RANGES : r));
}

long long blocks(long long x, long long b) { return (x + b - 1) / b; }

// dW units of one point range of an m x n job (add_job's blocks).
long long job_units(long long m, long long n) {
  return blocks(m, DW_A_ATOMS * 64) * blocks(n, DW_B_ATOMS * 64);
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
  size_t colsum, hpart, dwpart, total;
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
    w.colsum = take(P / LP_ROWS * H * sizeof(float));
    w.hpart_ld = (int)(H / 2 + 4);
    w.hpart = take(P / HEAD_ROWS * w.hpart_ld * sizeof(float));
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
// arrays of m rows), their grads added to out[0, cols) (the group's part
// of the packed dW) through the point ranges' partials.
struct DwMapSpec {
  const bf16* base;
  int cols;
};

int launch_group(const DwGroup& grp, const DwMapSpec* maps, int n_maps, const DwJob* jobs,
                 int n_jobs, long long m, float* partial, float* out, cudaStream_t s,
                 int* launches) {
  DwArgs a;
  memset(&a, 0, sizeof(a));
  for (int i = 0; i < n_maps; ++i) {
    const int rc = encode_slab_map(&a.maps[i], maps[i].base, maps[i].cols, (int)m, SLAB_K);
    if (rc != 0) return rc;
  }
  const long long n_pad = (long long)round_up((size_t)m, SLAB_K);
  a.range_pts = (int)round_up((size_t)blocks(n_pad, grp.ranges), SLAB_K);
  a.n_pad = n_pad;
  a.partial = partial;
  a.part_ld = (long long)round_up((size_t)grp.cols, 64);
  const int ranges = (int)blocks(n_pad, a.range_pts);
  int units = 0;
  for (int j = 0; j < n_jobs; ++j) units = add_job(&a, units, ranges, jobs[j]);
  if (units < 0) return (int)cudaErrorInvalidValue;
  launches[CNT_DW] += 1;
  launches[CNT_REDUCE] += 1;
  return launch_dw(a, units, ranges, (int)grp.cols, out, s, 1);
}

int launch_pe(const LDesc& d, const PeCol* tab, const float* src, const float* dirs,
              const float* z, long long row0, long long m, int samples, bool fwd, bf16* pe_x,
              bf16* pe_d, cudaStream_t s, int* launches) {
  const PeArgs a = {src, dirs, z, row0, m, samples, fwd ? 1 : 0, d.pxp, d.pdp, tab, pe_x, pe_d};
  const long long threads = m * ((d.pxp + (fwd ? d.pdp : 0)) / 8);
  layer_pe_kernel<<<(unsigned)blocks(threads, PE_THREADS), PE_THREADS, 0, s>>>(a);
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
  cudaError_t err = cudaSuccess;
  if (kind == KIND_BWD)
    err = cudaFuncSetAttribute(dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DW_SMEM);
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
// launches[5] gets each kernel's launches added: PE, product, heads, dW,
// reductions. Returns a cudaError_t code; 0 on success.
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
    // bias grads, then dW of dir and the heads.
    bf16 *dy_rgb = at(lay.dy_rgb), *dy_a = at(lay.dy_a), *dy_dir = at(lay.dy_dir);
    ha.dy_rgb = dy_rgb;
    ha.dy_a = dy_a;
    ha.dy_dir = dy_dir;
    ha.part = hpart;
    ha.ld_part = lay.hpart_ld;
    layer_heads_kernel<HEAD_BWD><<<head_blocks, HEAD_THREADS, 0, s>>>(ha);
    launches[CNT_HEADS] += 1;
    err = (int)cudaGetLastError();
    if (err == 0)
      err = reduce_rows(hpart, lay.hpart_ld, (int)head_blocks, H / 2, (int)head_blocks,
                        dB + d.b_off[L + 1], 0, s, 1);
    if (err == 0)
      err = reduce_rows(hpart + H / 2, lay.hpart_ld, (int)head_blocks, 4, (int)head_blocks,
                        dB + d.ba_off, 0, s, 1);
    launches[CNT_REDUCE] += 2;
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
      err = launch_group(groups[L + 1], maps, 7, jobs, 4, m, dwpart, dW + dir0, s, launches);
      if (err != 0) return err;
    }
    // The dX chain: dy[g - 1] = (dy[g] W_g's x part) masked by the forward's
    // output of product g - 1 (layer1 has no ReLU), from dir's down to
    // layer1's; each product's bias grads are its output's column sums,
    // each weight matrix's dW follows its cotangent.
    const int mt = (int)blocks(m, LP_ROWS);
    bf16* dy = at(lay.dy0);
    err = launch_product<true>(epilogue_args(nullptr, 0, feat, dy, colsum), dy_dir, H / 2,
                               nullptr, 0, m, H, nn[L + 1], card, s, launches);
    if (err == 0)
      err = reduce_rows(colsum, H, mt, H, mt, dB + d.b_off[L], 0, s, 1);
    launches[CNT_REDUCE] += 1;
    for (int g = L; g >= 1 && err == 0; --g) {
      const bool skip = d.k[g] > H;
      const bf16* xin = act(g - 1);  // product g's input: [act[g - 1] | PE(xyz)]
      const DwMapSpec maps[3] = {{dy, H}, {xin, H}, {pe_x, d.pxp}};
      const DwJob jobs[2] = {{0, 0, 0, 1, 0, 0, H, H, H, 0, (int)d.k[g], 0},
                             {0, 0, 0, 2, 0, 0, H, H, d.pxp, 0, (int)d.k[g], H}};
      err = launch_group(groups[g], maps, 3, jobs, skip ? 2 : 1, m, dwpart, dW + d.w_off[g], s,
                         launches);
      if (err != 0) return err;
      bf16* next = dy == at(lay.dy0) ? at(lay.dy1) : at(lay.dy0);
      const bf16* mask = g - 1 > 0 ? act(g - 1) : nullptr;
      err = launch_product<true>(
          epilogue_args(nullptr, 0, mask, next, colsum, g == L ? dy_a : nullptr,
                        g == L ? wa : nullptr),
          dy, H, nullptr, 0, m, H, nn[g], card, s, launches);
      if (err == 0) err = reduce_rows(colsum, H, mt, H, mt, dB + d.b_off[g - 1], 0, s, 1);
      launches[CNT_REDUCE] += 1;
      dy = next;
    }
    if (err != 0) return err;
    const DwMapSpec maps[2] = {{dy, H}, {pe_x, d.pxp}};
    const DwJob job = {0, 0, 0, 1, 0, 0, H, H, d.pxp, 0, d.pxp, 0};
    err = launch_group(groups[0], maps, 2, &job, 1, m, dwpart, dW + d.w_off[0], s, launches);
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
