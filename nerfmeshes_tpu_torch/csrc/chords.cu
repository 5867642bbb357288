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
// What bounds it: ~35 FP32 operations per (ray, voxel) test against 12
// bytes written per output slot, so at the train shape (2048 rays x 4096
// voxels x K 64) the tests take ~0.3 G operations and the outputs ~1.6 MB:
// the FP32 pipes, not device memory, set the pace, and at a few microseconds
// of work the launch itself is a large part of the time.
//
// Design: the TPU kernel tiles 128 rays on the lanes, scans V in 1024-row
// chunks, ranks chords with a log-step sublane cumsum and sums each chord
// into its rank row of a (K, 128) VMEM scratch through predicated one-hot
// products, then transposes (K, R). None of that is needed here. One warp
// owns one ray (WARPS rays per block); the block stages CHUNK voxel boxes
// at a time in shared memory as structure-of-arrays rows (conflict-free
// reads); lane j tests voxel c + j, __ballot_sync gives the warp's valid
// mask, __popc(mask & lanes below) the lane's rank among the 32, and a
// running base in a register makes it the ray's global rank. A lane whose
// rank is below K writes its chord straight into slot `rank` of the ray's
// (R, K) output row, so voxel order gives first-K-by-index order by
// construction. The scan covers all V even once K chords are kept, because
// n_hit counts the dropped ones. No atomics: two launches give the same bits.
//
// Bitwise agreement with the plain version (compact_chords_plain): IEEE
// division for 1 / d and (lo - o) * inv with round-to-nearest intrinsics
// that nvcc never fuses, and a max / min that propagate NaN as
// jnp.maximum and torch.maximum do (fmaxf / fminf return the non-NaN
// operand). An axis-aligned ray has inv = +-inf and (lo - o) * inf is NaN
// where lo == o; such a test fails its comparisons on both sides.

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;  // rays per block, one warp each
constexpr int THREADS = WARPS * 32;
constexpr int CHUNK = 1024;  // voxel boxes staged in shared memory at a time
const float BIG = static_cast<float>(2.0 * (1e8 + 1.0));

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : (a > b ? a : b);
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : (a < b ? a : b);
}

__global__ void __launch_bounds__(THREADS)
chords_kernel(const float* __restrict__ voxels, const unsigned char* __restrict__ active, int V,
              const float* __restrict__ origins, int o_stride, const float* __restrict__ dirs,
              int R, const float* __restrict__ near_p, int near_stride, float near_val,
              const float* __restrict__ far_p, int far_stride, float far_val, int K,
              float* __restrict__ lo_out, float* __restrict__ hi_out, int* __restrict__ ids_out,
              int* __restrict__ n_hit_out, float big) {
  // box[a * CHUNK + v]: coordinate a (lo x y z, hi x y z) of staged voxel v.
  __shared__ float box[6 * CHUNK];
  __shared__ unsigned char act[CHUNK];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ray = blockIdx.x * WARPS + warp;
  const bool live = ray < R;  // uniform over the warp

  float o[3] = {0.f, 0.f, 0.f}, inv[3] = {0.f, 0.f, 0.f};
  bool neg[3] = {false, false, false};
  float t_near = 0.f, t_far = 0.f;
  if (live) {
    for (int a = 0; a < 3; ++a) {
      o[a] = origins[(long long)ray * o_stride + a];
      inv[a] = __fdiv_rn(1.0f, dirs[(long long)ray * 3 + a]);
      neg[a] = inv[a] < 0.f;
    }
    t_near = near_p ? near_p[(long long)ray * near_stride] : near_val;
    t_far = far_p ? far_p[(long long)ray * far_stride] : far_val;
  }

  const unsigned below = (1u << lane) - 1u;
  const long long row = (long long)ray * K;
  int base = 0;  // valid chords of this ray in the voxels scanned so far
  for (int c0 = 0; c0 < V; c0 += CHUNK) {
    const int n = min(CHUNK, V - c0);
    __syncthreads();  // the previous chunk is no longer read
    for (int i = threadIdx.x; i < n * 6; i += THREADS) {
      box[(i % 6) * CHUNK + i / 6] = voxels[(long long)c0 * 6 + i];
    }
    for (int i = threadIdx.x; i < n; i += THREADS) act[i] = active[c0 + i];
    __syncthreads();
    if (!live) continue;

    for (int j0 = 0; j0 < n; j0 += 32) {
      const int j = j0 + lane;
      bool valid = false;
      float tmin = 0.f, tmax = 0.f;
      if (j < n) {
        float tvmin[3], tvmax[3];
        for (int a = 0; a < 3; ++a) {
          const float tl = __fmul_rn(__fsub_rn(box[a * CHUNK + j], o[a]), inv[a]);
          const float th = __fmul_rn(__fsub_rn(box[(3 + a) * CHUNK + j], o[a]), inv[a]);
          tvmin[a] = neg[a] ? th : tl;
          tvmax[a] = neg[a] ? tl : th;
        }
        // x-y pair, then z (the JAX sampler's order).
        valid = (tvmin[0] <= tvmax[1]) & (tvmin[1] <= tvmax[0]);
        tmin = max_nan(tvmin[0], tvmin[1]);
        tmax = min_nan(tvmax[0], tvmax[1]);
        valid = valid & (tmin <= tvmax[2]) & (tvmin[2] <= tmax);
        tmin = max_nan(tmin, tvmin[2]);
        tmax = min_nan(tmax, tvmax[2]);
        valid = valid & (tmin >= t_near) & (tmax <= t_far) & (act[j] != 0);
      }
      const unsigned mask = __ballot_sync(0xffffffffu, valid);
      if (valid) {
        const int slot = base + __popc(mask & below);
        if (slot < K) {
          lo_out[row + slot] = tmin;
          hi_out[row + slot] = tmax;
          ids_out[row + slot] = c0 + j;
        }
      }
      base += __popc(mask);
    }
  }
  if (!live) return;
  for (int s = min(base, K) + lane; s < K; s += 32) {
    lo_out[row + s] = big;
    hi_out[row + s] = big;
    ids_out[row + s] = 0;
  }
  if (lane == 0) n_hit_out[ray] = base;
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
  const unsigned blocks = (unsigned)((R + WARPS - 1) / WARPS);
  chords_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      voxels, active, V, origins, o_stride, dirs, R, near_p, near_stride, near_val, far_p,
      far_stride, far_val, K, lo, hi, ids, n_hit, BIG);
  return (int)cudaGetLastError();
}
