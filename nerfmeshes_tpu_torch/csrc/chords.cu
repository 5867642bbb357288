// Ray/AABB slab test and first-K chord compaction, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel nerfmeshes_tpu/ops/pallas/chords.py:98
// (_chords_kernel, launched by compact_chords, :244-327). For every ray r it
// slab-tests all V voxel boxes, in the op order of the JAX sampler's
// _slab_test (nerfmeshes_tpu/buff/tree.py:429-454), and keeps the first K
// valid chords in voxel-index order:
//   lo[r, k], hi[r, k]  entry and exit t of the k-th valid chord (f32)
//   ids[r, k]           its voxel index (int32; JAX carries ids as f32 only
//                       for its MXU one-hot contraction)
//   n_hit[r]            every valid chord of the ray, those past K included
// Slots past the ray's valid chords hold big / big / 0, big = 2 * (1e8 + 1)
// in f32, the sampler's empty-slot sentinel.
//
// What bounds it: ~36 FP32 operations per (ray, active voxel) test against
// 12 bytes written per output slot, so at the train shape (2048 rays x 4096
// voxels x K 64) the tests take ~0.3 G operations and the outputs ~1.6 MB:
// the FP32 pipes, not device memory, set the pace. The test cannot fuse a
// multiply into an add and keep its bits, so every operation is one issue
// slot: issue, not the FMA rate, is the ceiling.
//
// Design. The TPU kernel tiles 128 rays on the lanes, scans V in 1024-row
// chunks, ranks chords with a log-step sublane cumsum and sums each chord
// into its rank row of a (K, 128) VMEM scratch through predicated one-hot
// products. Here:
// - Persistent CTAs (one per SM at V = 4096; more where the table is small,
//   as occupancy allows) stage the voxel table ONCE each: the boxes copied
//   raw by cp.async into shared memory while the active flags load, then
//   a compaction (ballot + popc) to the list of ACTIVE boxes in index
//   order. Inactive voxels are never tested. The list is padded to a
//   multiple of 32 with a NaN box, which no test accepts.
// - A tile of RT = 16 rays at a time, sorted by octant (the sign of inv per
//   axis, which picks each axis's entry and exit planes). The CTA's warps
//   split the active list into contiguous runs of 32-box groups; lane l
//   holds box 32 g + l of GP groups of its warp's run in registers and
//   tests them against the tile's rays, octant by octant, through a body
//   specialised by octant: a ray's parameters are uniform over the warp
//   (two broadcast 16-byte loads), and a test does no load and no select,
//   its GP tests independent chains.
// - Where every staged box has lo <= hi on each axis (checked while
//   staging), the x-y pair and z conditions reduce to tmin <= tmax: three
//   comparisons fewer a test, the same verdict (count_ray).
// - Count pass: one ballot mask per (ray, group). Prefix pass: one warp per
//   ray sums popc over the groups in voxel order (a warp scan): each group's
//   first rank, and n_hit. Write pass: one thread per (ray, group) whose
//   first rank is below K redoes the tests of the group's set bits and
//   writes each chord at its rank; the empty slots get big / big / 0. Voxel
//   order gives first-K-by-index order by construction; no atomics, so two
//   launches give the same bits. A ray never spans two CTAs.
// - A table past one stage (CV_MAX voxels) is scanned in chunks per tile,
//   the ranks carried across chunks; such a CTA restages per tile.
//
// Bitwise agreement with the plain version (compact_chords_plain): IEEE
// division for 1 / d and (lo - o) * inv with round-to-nearest intrinsics
// that nvcc never fuses, entry and exit picked by the sign of inv, and PTX
// max.NaN / min.NaN, which propagate NaN as jnp.maximum and torch.maximum
// do (fmaxf / fminf return the non-NaN operand). An axis-aligned ray has
// inv = +-inf and (lo - o) * inf is NaN where lo == o; such a test fails
// its comparisons on both sides.

#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int RT = 16;  // rays per tile
constexpr int GP = 4;   // 32-box groups a lane holds in registers at a time
constexpr int SMEM_LIMIT = 232448;  // shared memory a block may use on sm_90
const float BIG = static_cast<float>(2.0 * (1e8 + 1.0));
const unsigned FULL = 0xffffffffu;

// Shared-memory plan for a stage of cv voxels (a multiple of 32), in bytes:
//   raw    (cv + 1) x 24 B  the stage's boxes as they lie in device memory,
//                           then one NaN box
//   list   cv x 4 B         indices (into raw) of the active boxes in order,
//                           padded with the NaN box to a multiple of 32
//   union  max(cv, 8 RT cv / 32): the stage's active flags (bytes), then
//          masks RT x cv/32 u32 and gbase RT x cv/32 i32 (first ranks)
//   rays   RT x 8 f32 {o xyz, inv x}, {inv y, inv z, near, far} in octant
//          order; their tile index, each tile ray's place in that order,
//          the ranks so far, the 9 octant bounds (16 i32)
//   warp   WARPS i32 of compaction counts
__host__ __device__ constexpr int list_offset(int cv) { return (24 * (cv + 1) + 15) / 16 * 16; }
__host__ __device__ constexpr int union_offset(int cv) { return list_offset(cv) + 4 * cv; }
__host__ __device__ constexpr int rays_offset(int cv) {
  return union_offset(cv) + (cv > RT * cv / 4 ? cv : RT * cv / 4);
}
__host__ __device__ constexpr int warp_offset(int cv) { return rays_offset(cv) + RT * 44 + 64; }
__host__ __device__ constexpr int smem_bytes(int cv) { return warp_offset(cv) + WARPS * 4; }
constexpr int CV_MAX = (SMEM_LIMIT - smem_bytes(0)) / 32 / 32 * 32;  // 7232
static_assert(smem_bytes(CV_MAX) <= SMEM_LIMIT, "stage plan over the shared-memory limit");
static_assert(CV_MAX >= 4096, "a capacity-4096 tree must stage in one chunk");

// The shared-memory regions of a stage of cv voxels.
struct Smem {
  float* raw;
  int* list;
  unsigned char* act;
  unsigned* masks;
  int* gbase;
  float4* rays;  // 2 per ray, in octant order
  int* sidx;     // tile index of the ray at each place in octant order
  int* spos;     // place in octant order of each tile ray
  int* rank;     // chords of each tile ray in the chunks scanned so far
  int* obound;   // rays of octant o at places obound[o] .. obound[o + 1] - 1
  int* wcnt;
  __device__ Smem(unsigned char* base, int cv)
      : raw(reinterpret_cast<float*>(base)),
        list(reinterpret_cast<int*>(base + list_offset(cv))),
        act(base + union_offset(cv)),
        masks(reinterpret_cast<unsigned*>(base + union_offset(cv))),
        gbase(reinterpret_cast<int*>(base + union_offset(cv) + RT * cv / 8)),
        rays(reinterpret_cast<float4*>(base + rays_offset(cv))),
        sidx(reinterpret_cast<int*>(base + rays_offset(cv) + RT * 32)),
        spos(reinterpret_cast<int*>(base + rays_offset(cv) + RT * 36)),
        rank(reinterpret_cast<int*>(base + rays_offset(cv) + RT * 40)),
        obound(reinterpret_cast<int*>(base + rays_offset(cv) + RT * 44)),
        wcnt(reinterpret_cast<int*>(base + warp_offset(cv))) {}
};

__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(d), "l"(src), "n"(BYTES)
               : "memory");
}

// The slab test's tail on the per-axis entry and exit values: the x-y pair,
// then z, then near / far (the JAX sampler's order).
__device__ __forceinline__ bool accept(const float (&tvmin)[3], const float (&tvmax)[3],
                                       float t_near, float t_far, float& tmin, float& tmax) {
  bool valid = (tvmin[0] <= tvmax[1]) & (tvmin[1] <= tvmax[0]);
  tmin = max_nan(tvmin[0], tvmin[1]);
  tmax = min_nan(tvmax[0], tvmax[1]);
  valid = valid & (tmin <= tvmax[2]) & (tvmin[2] <= tmax);
  tmin = max_nan(tmin, tvmin[2]);
  tmax = min_nan(tmax, tvmax[2]);
  return valid & (tmin >= t_near) & (tmax <= t_far);
}

// Count pass of one ray against the GP groups a warp holds: lane l has box
// 32 g + l of each in lo / hi. OCT is the ray's octant: where bit a is set,
// inv[a] < 0 and the hi plane is the entry on axis a. ray0 = {o xyz, inv x},
// ray1 = {inv y, inv z, near, far}. The GP tests are independent chains,
// with no branch between them; lane 0 stores the masks of the ng groups in
// the run.
//
// ORDERED: every staged box has lo <= hi on each axis. Then each axis's
// entry is at most its exit wherever neither is NaN (rounding is
// monotone), so the x-y pair and z conditions of accept() together equal
// tmin <= tmax, with tmin and tmax NaN wherever any of the six values is
// NaN (max.NaN / min.NaN); the same verdict and values in three fewer
// comparisons.
template <int OCT, bool ORDERED>
__device__ __forceinline__ void count_ray(const float (&lo)[GP][3], const float (&hi)[GP][3],
                                          float4 ray0, float4 ray1, int ng, unsigned* mrow,
                                          int lane) {
  const float o[3] = {ray0.x, ray0.y, ray0.z}, inv[3] = {ray0.w, ray1.x, ray1.y};
  bool ok[GP];
#pragma unroll
  for (int i = 0; i < GP; ++i) {
    float tvmin[3], tvmax[3], tmin, tmax;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const bool neg = (OCT >> a) & 1;
      tvmin[a] = __fmul_rn(__fsub_rn(neg ? hi[i][a] : lo[i][a], o[a]), inv[a]);
      tvmax[a] = __fmul_rn(__fsub_rn(neg ? lo[i][a] : hi[i][a], o[a]), inv[a]);
    }
    if (ORDERED) {
      tmin = max_nan(max_nan(tvmin[0], tvmin[1]), tvmin[2]);
      tmax = min_nan(min_nan(tvmax[0], tvmax[1]), tvmax[2]);
      ok[i] = (tmin <= tmax) & (tmin >= ray1.z) & (tmax <= ray1.w);
    } else {
      ok[i] = accept(tvmin, tvmax, ray1.z, ray1.w, tmin, tmax);
    }
  }
  unsigned mine = 0;
#pragma unroll
  for (int i = 0; i < GP; ++i) {
    const unsigned m = __ballot_sync(FULL, ok[i]);
    mine = lane == i ? m : mine;
  }
  if (lane < ng) mrow[lane] = mine;
}

// The count pass over the tile's rays of octant OCT (places k0 .. k1 - 1).
template <int OCT, bool ORDERED>
__device__ __forceinline__ void count_octant(const float (&lo)[GP][3], const float (&hi)[GP][3],
                                             const Smem& sm, int k0, int k1, int gs, int gp,
                                             int ng, int lane) {
  for (int k = k0; k < k1; ++k) {
    count_ray<OCT, ORDERED>(lo, hi, sm.rays[2 * k], sm.rays[2 * k + 1], ng,
                            sm.masks + sm.sidx[k] * gs + gp, lane);
  }
}

// The count pass over every octant of the tile's rays.
template <bool ORDERED>
__device__ __forceinline__ void count_tile(const float (&lo)[GP][3], const float (&hi)[GP][3],
                                           const Smem& sm, int gs, int gp, int ng, int lane) {
  const int* ob = sm.obound;
  count_octant<0, ORDERED>(lo, hi, sm, ob[0], ob[1], gs, gp, ng, lane);
  count_octant<1, ORDERED>(lo, hi, sm, ob[1], ob[2], gs, gp, ng, lane);
  count_octant<2, ORDERED>(lo, hi, sm, ob[2], ob[3], gs, gp, ng, lane);
  count_octant<3, ORDERED>(lo, hi, sm, ob[3], ob[4], gs, gp, ng, lane);
  count_octant<4, ORDERED>(lo, hi, sm, ob[4], ob[5], gs, gp, ng, lane);
  count_octant<5, ORDERED>(lo, hi, sm, ob[5], ob[6], gs, gp, ng, lane);
  count_octant<6, ORDERED>(lo, hi, sm, ob[6], ob[7], gs, gp, ng, lane);
  count_octant<7, ORDERED>(lo, hi, sm, ob[7], ob[8], gs, gp, ng, lane);
}

// The slab test of box (lo xyz, hi xyz) at b against ray (ray0, ray1) of
// octant oct, entry and exit picked per axis by the sign of inv (the write
// pass's form; the same values as count_ray's).
__device__ __forceinline__ bool slab(const float* b, float4 ray0, float4 ray1, int oct,
                                     float& tmin, float& tmax) {
  const float o[3] = {ray0.x, ray0.y, ray0.z}, inv[3] = {ray0.w, ray1.x, ray1.y};
  float tvmin[3], tvmax[3];
  for (int a = 0; a < 3; ++a) {
    const float tl = __fmul_rn(__fsub_rn(b[a], o[a]), inv[a]);
    const float th = __fmul_rn(__fsub_rn(b[3 + a], o[a]), inv[a]);
    const bool neg = (oct >> a) & 1;
    tvmin[a] = neg ? th : tl;
    tvmax[a] = neg ? tl : th;
  }
  return accept(tvmin, tvmax, ray1.z, ray1.w, tmin, tmax);
}

// Warp 0 loads rays ray0 .. ray0 + RT - 1 (o, 1 / d, near, far) into the
// ray rows in octant order, with the octant bounds. Rays past R are left
// out of every octant, so they are never tested.
__device__ void load_rays(int ray0, int R, const float* __restrict__ origins, int o_stride,
                          const float* __restrict__ dirs, const float* __restrict__ near_p,
                          int near_stride, float near_val, const float* __restrict__ far_p,
                          int far_stride, float far_val, const Smem& sm) {
  if (threadIdx.x >= 32) return;
  const int t = threadIdx.x, ray = ray0 + t;
  const bool live = t < RT && ray < R;
  float o[3] = {0.f, 0.f, 0.f}, inv[3] = {0.f, 0.f, 0.f}, t_near = 0.f, t_far = 0.f;
  int oct = 8;  // no octant
  if (live) {
    oct = 0;
    for (int a = 0; a < 3; ++a) {
      o[a] = origins[(long long)ray * o_stride + a];
      inv[a] = __fdiv_rn(1.0f, dirs[(long long)ray * 3 + a]);
      oct |= (inv[a] < 0.f) << a;
    }
    t_near = near_p ? near_p[(long long)ray * near_stride] : near_val;
    t_far = far_p ? far_p[(long long)ray * far_stride] : far_val;
  }
  int base = 0, pos = 0;
  for (int q = 0; q < 8; ++q) {
    const unsigned m = __ballot_sync(FULL, oct == q);
    if (oct == q) pos = base + __popc(m & ((1u << t) - 1u));
    if (t == q) sm.obound[q] = base;
    base += __popc(m);
  }
  if (t == 8) sm.obound[8] = base;
  if (live) {
    sm.rays[2 * pos] = make_float4(o[0], o[1], o[2], inv[0]);
    sm.rays[2 * pos + 1] = make_float4(inv[1], inv[2], t_near, t_far);
    sm.sidx[pos] = t;
    sm.spos[t] = pos;
  }
  if (t < RT) sm.rank[t] = 0;
}

// Stage voxels [c0, c0 + n) (n <= cv): the boxes copied raw by cp.async
// while the active flags load, then the list of active boxes in index order,
// padded to a multiple of 32 with the NaN box after them. Returns the
// active count, and sets `ordered` to whether every active box has lo <= hi
// on each axis (the same in every thread).
__device__ int stage(const float* __restrict__ voxels, const unsigned char* __restrict__ active,
                     int c0, int n, const Smem& sm, bool& ordered) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // the previous stage's boxes and the union are no longer read
  // 24 n bytes from voxels + 6 c0 (c0 is a multiple of 32, so the source is
  // as aligned as the table): 16-byte copies where it is 16-byte aligned,
  // then the tail by 4 bytes.
  const float* src = voxels + (long long)c0 * 6;
  const int nf = n * 6;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int i = threadIdx.x; i < nf / 4; i += THREADS) cp_async<16>(sm.raw + 4 * i, src + 4 * i);
    done = nf / 4 * 4;
  }
  for (int i = done + threadIdx.x; i < nf; i += THREADS) cp_async<4>(sm.raw + i, src + i);
  for (int i = threadIdx.x; i < n; i += THREADS) sm.act[i] = __ldg(active + c0 + i);
  if (threadIdx.x < 6) sm.raw[nf + threadIdx.x] = __int_as_float(0x7fc00000);  // the NaN box
  __syncthreads();

  // Each warp lists a contiguous run of 32-voxel groups: count, prefix over
  // the warps, then place.
  const int ng = (n + 31) / 32;
  const int g0 = warp * ng / WARPS, g1 = (warp + 1) * ng / WARPS;
  int count = 0;
  for (int g = g0; g < g1; ++g) {
    const int j = g * 32 + lane;
    count += __popc(__ballot_sync(FULL, j < n && sm.act[j] != 0));
  }
  if (lane == 0) sm.wcnt[warp] = count;
  __syncthreads();
  int pos = 0, total = 0;
  for (int w = 0; w < WARPS; ++w) {
    const int c = sm.wcnt[w];
    pos += w < warp ? c : 0;
    total += c;
  }
  const unsigned below = (1u << lane) - 1u;
  for (int g = g0; g < g1; ++g) {
    const int j = g * 32 + lane;
    const bool a = j < n && sm.act[j] != 0;
    const unsigned m = __ballot_sync(FULL, a);
    if (a) sm.list[pos + __popc(m & below)] = j;
    pos += __popc(m);
  }
  for (int p = total + threadIdx.x; p < (total + 31) / 32 * 32; p += THREADS) sm.list[p] = n;
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();  // boxes and list complete
  bool mine = true;
  for (int p = threadIdx.x; p < total; p += THREADS) {
    const float* b = sm.raw + 6 * sm.list[p];
    mine = mine & (b[0] <= b[3]) & (b[1] <= b[4]) & (b[2] <= b[5]);
  }
  ordered = __syncthreads_and(mine) != 0;  // also: the union is free
  return total;
}

__global__ void __launch_bounds__(THREADS, 1)
chords_kernel(const float* __restrict__ voxels, const unsigned char* __restrict__ active, int V,
              const float* __restrict__ origins, int o_stride, const float* __restrict__ dirs,
              int R, const float* __restrict__ near_p, int near_stride, float near_val,
              const float* __restrict__ far_p, int far_stride, float far_val, int K, int cv,
              float* __restrict__ lo_out, float* __restrict__ hi_out, int* __restrict__ ids_out,
              int* __restrict__ n_hit_out, float big) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem sm(smem, cv);
  const int gs = cv / 32;  // group stride of the mask and base rows
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nchunks = (V + cv - 1) / cv;
  const int ntiles = (R + RT - 1) / RT;
  int A = 0;             // active boxes staged
  bool ordered = false;  // every staged box has lo <= hi on each axis

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int ray0 = tile * RT;
    const int nr = min(RT, R - ray0);
    const bool first = tile == blockIdx.x;
    if (!first) __syncthreads();  // the previous tile no longer reads the ray rows
    load_rays(ray0, R, origins, o_stride, dirs, near_p, near_stride, near_val, far_p, far_stride,
              far_val, sm);
    if (first && nchunks == 1) {
      A = stage(voxels, active, 0, V, sm, ordered);  // its barriers publish the rays too
    } else if (nchunks <= 1) {
      __syncthreads();
    }

    for (int c = 0; c < nchunks; ++c) {
      const int c0 = c * cv;
      if (nchunks > 1) A = stage(voxels, active, c0, min(cv, V - c0), sm, ordered);
      const int G = (A + 31) / 32;
      const int g0 = warp * G / WARPS, g1 = (warp + 1) * G / WARPS;

      // Count pass: GP groups of the warp's run at a time in registers,
      // against the tile's rays, octant by octant.
      for (int gp = g0; gp < g1; gp += GP) {
        const int ng = min(GP, g1 - gp);
        float lo[GP][3], hi[GP][3];
#pragma unroll
        for (int i = 0; i < GP; ++i) {  // groups past the run repeat its last (not stored)
          const float* b = sm.raw + 6 * sm.list[min(gp + i, g1 - 1) * 32 + lane];
          const float2 x = *reinterpret_cast<const float2*>(b);
          const float2 y = *reinterpret_cast<const float2*>(b + 2);
          const float2 z = *reinterpret_cast<const float2*>(b + 4);
          lo[i][0] = x.x, lo[i][1] = x.y, lo[i][2] = y.x;
          hi[i][0] = y.y, hi[i][1] = z.x, hi[i][2] = z.y;
        }
        if (ordered) {
          count_tile<true>(lo, hi, sm, gs, gp, ng, lane);
        } else {
          count_tile<false>(lo, hi, sm, gs, gp, ng, lane);
        }
      }
      __syncthreads();

      // Prefix pass: per ray, each group's first rank in voxel order.
      const int per = (G + 31) / 32;
      for (int q = warp; q < nr; q += WARPS) {
        const int l0 = min(lane * per, G), l1 = min(l0 + per, G);
        int cnt = 0;
        for (int g = l0; g < l1; ++g) cnt += __popc(sm.masks[q * gs + g]);
        int incl = cnt;
        for (int s = 1; s < 32; s <<= 1) {
          const int up = __shfl_up_sync(FULL, incl, s);
          if (lane >= s) incl += up;
        }
        int base = sm.rank[q] + incl - cnt;
        for (int g = l0; g < l1; ++g) {
          sm.gbase[q * gs + g] = base;
          base += __popc(sm.masks[q * gs + g]);
        }
        const int total = __shfl_sync(FULL, incl, 31);
        __syncwarp();
        if (lane == 0) sm.rank[q] += total;
      }
      __syncthreads();

      // Write pass: one thread per (ray, group) with chords below rank K;
      // thread t takes ray (t / 64) mod RT and groups t mod 64, + 64, ...
      for (int pr = threadIdx.x; pr < RT * 64 * ((G + 63) / 64); pr += THREADS) {
        const int r = (pr >> 6) % RT, g = (pr & 63) + 64 * (pr / (RT * 64));
        if (r >= nr || g >= G) continue;
        unsigned m = sm.masks[r * gs + g];
        int slot = sm.gbase[r * gs + g];
        if (m == 0u || slot >= K) continue;
        const int k = sm.spos[r];
        const float4 ray0v = sm.rays[2 * k], ray1v = sm.rays[2 * k + 1];
        const int oct = (ray0v.w < 0.f) | (ray1v.x < 0.f) << 1 | (ray1v.y < 0.f) << 2;
        const long long row = (long long)(ray0 + r) * K;
        for (; m != 0u && slot < K; m &= m - 1u, ++slot) {
          const int j = sm.list[g * 32 + __ffs(m) - 1];
          float tmin, tmax;
          slab(sm.raw + 6 * j, ray0v, ray1v, oct, tmin, tmax);
          lo_out[row + slot] = tmin;
          hi_out[row + slot] = tmax;
          ids_out[row + slot] = c0 + j;
        }
      }
    }

    // Empty slots and n_hit (the last prefix pass's ranks are final).
    for (int q = warp; q < nr; q += WARPS) {
      const int n = sm.rank[q];
      const long long row = (long long)(ray0 + q) * K;
      for (int s = min(n, K) + lane; s < K; s += 32) {
        lo_out[row + s] = big;
        hi_out[row + s] = big;
        ids_out[row + s] = 0;
      }
      if (lane == 0) n_hit_out[ray0 + q] = n;
    }
  }
}

// The launch geometry of the current device: its SM count, and the CTAs an
// SM holds at a stage of cv voxels. Read once per device (the occupancy
// again only when cv changes), with the kernel's shared-memory limit raised
// to the largest stage's then, so a call does no attribute query of its own.
cudaError_t geometry(int cv, int& sms, int& per_sm) {
  struct Device {
    int sms = 0, cv = -1, per_sm = 0;
  };
  constexpr int DEVICES = 64;
  static std::mutex lock;
  static Device cache[DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= DEVICES) return cudaErrorInvalidDevice;
  const std::lock_guard<std::mutex> guard(lock);
  Device& d = cache[dev];
  if (d.sms == 0) {
    int n = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(chords_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem_bytes(CV_MAX));
    if (err != cudaSuccess) return err;
    d.sms = n;
  }
  if (d.cv != cv) {
    int n = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, chords_kernel, THREADS,
                                                        smem_bytes(cv));
    if (err != cudaSuccess) return err;
    d.cv = cv;
    d.per_sm = n;
  }
  sms = d.sms;
  per_sm = d.per_sm;
  return cudaSuccess;
}

}  // namespace

// voxels (V, 2, 3) f32 and active (V,) bool, contiguous; origins (R, 3) f32
// with o_stride 3, or one (3,) origin with o_stride 0; dirs (R, 3) f32.
// near / far: a device pointer read at ray * stride (stride 0: one value for
// all rays), or, where the pointer is null, the value passed. Outputs lo, hi
// (R, K) f32, ids (R, K) int32 and n_hit (R,) int32, allocated by the
// caller. Launches on `stream` and returns a cudaError_t code; 0 on success.
extern "C" int nm_compact_chords(const float* voxels, const unsigned char* active, int V,
                                 const float* origins, int o_stride, const float* dirs, int R,
                                 const float* near_p, int near_stride, float near_val,
                                 const float* far_p, int far_stride, float far_val, int K,
                                 float* lo, float* hi, int* ids, int* n_hit, void* stream) {
  if (R < 0 || V < 0 || K < 1) return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  // The stage: the whole table where it fits, else CV_MAX-voxel chunks.
  const int cv = V > CV_MAX ? CV_MAX : (V + 31) / 32 * 32 + (V == 0 ? 32 : 0);
  int sms = 0, per_sm = 0;
  const cudaError_t err = geometry(cv, sms, per_sm);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidValue;
  const int tiles = (R + RT - 1) / RT;
  const int grid = tiles < sms * per_sm ? tiles : sms * per_sm;
  chords_kernel<<<grid, THREADS, smem_bytes(cv), static_cast<cudaStream_t>(stream)>>>(
      voxels, active, V, origins, o_stride, dirs, R, near_p, near_stride, near_val, far_p,
      far_stride, far_val, K, cv, lo, hi, ids, n_hit, BIG);
  return (int)cudaGetLastError();
}
