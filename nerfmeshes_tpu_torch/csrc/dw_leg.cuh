// The backward's dW leg, dW = dY^T X contracted over points, and the
// fixed-order row reductions: dw_kernel (TMA-staged MN-major operands,
// wgmma), reduce_rows_kernel and their launches. The fused backward
// (fused_mlp_bwd.cu) runs them over its stash; fused_mlp_bwd.cu describes
// the leg's design. The layer route (field_layers.cu) runs its own
// persistent layer_dw_kernel on these jobs, operands and products over
// each slab of points' activations, and reduce_rows_kernel to add a
// slab's point ranges to the running grads.
//
// Everything here has internal linkage: each .cu file gets its own copy.

#pragma once

#include "fused_mlp_bwd.cuh"

namespace {

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

// Jobs of a descriptor, at most: at H = 1024 and 14 layers with a skip at
// every trunk layer, 4 column blocks for each of the 13 trunk products, feat,
// dir's feat part and the alpha head, 2 for the rgb head, 1 for layer1, the
// 12 skips' PE parts and dir's PE part (PE at most 160 columns): 80. The
// arguments then pass the 4 KB of the old parameter limit (32,764 B since
// CUDA 12.1).
constexpr int MAX_JOBS = 80;
constexpr int DW_A_ATOMS = 2;   // dW rows per unit: 64 per consumer warpgroup
constexpr int DW_B_ATOMS = 4;   // dW columns per unit: 256
constexpr int DW_STAGE_BYTES = (DW_A_ATOMS + DW_B_ATOMS) * ATOM_BYTES;  // 48 KB, 64 points
constexpr int DW_STAGES = 4;
constexpr int DW_SMEM = DW_STAGES * DW_STAGE_BYTES + 2 * DW_STAGES * (int)sizeof(uint64_t);

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
static_assert(sizeof(DwArgs) <= 32764, "dw_kernel's parameters");

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
// row order: a fixed-order reduction, the same bits on every launch. With
// `accumulate` the sum starts from out[g][c] instead of 0 (the layer
// route's running grads, csrc/field_layers.cu).
__global__ void __launch_bounds__(REDUCE_THREADS)
reduce_rows_kernel(const float* __restrict__ in, long long ld_in, int rows, int cols,
                   int group, float* __restrict__ out, long long ld_out, int accumulate) {
  const int c = blockIdx.x * REDUCE_THREADS + threadIdx.x;
  if (c >= cols) return;
  const int r0 = blockIdx.y * group;
  const int r1 = r0 + group < rows ? r0 + group : rows;
  float s = accumulate ? out[(size_t)blockIdx.y * ld_out + c] : 0.f;
  for (int r = r0; r < r1; ++r) s += in[(size_t)r * ld_in + c];
  out[(size_t)blockIdx.y * ld_out + c] = s;
}

int reduce_rows(const float* in, long long ld_in, int rows, int cols, int group,
                float* out, long long ld_out, cudaStream_t s, int accumulate = 0) {
  const dim3 grid((cols + REDUCE_THREADS - 1) / REDUCE_THREADS,
                  (rows + group - 1) / group);
  reduce_rows_kernel<<<grid, REDUCE_THREADS, 0, s>>>(in, ld_in, rows, cols, group, out,
                                                     ld_out, accumulate);
  return (int)cudaGetLastError();
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

// dw_kernel over `units` units, then its partials summed over the point
// ranges in order into out (rows of `cols`, contiguous), or with
// `accumulate` added to what out holds.
int launch_dw(const DwArgs& a, int units, int ranges, int cols, float* out, cudaStream_t s,
              int accumulate = 0) {
  dw_kernel<<<units, FIELD_THREADS, DW_SMEM, s>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return reduce_rows(a.partial, a.part_ld, ranges, cols, ranges, out, 0, s, accumulate);
}

}  // namespace
