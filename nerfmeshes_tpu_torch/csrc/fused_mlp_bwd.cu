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
//       across the two consumer warpgroups, and at H > 512 across a pair of
//       CTAs as well, as the forward's: see fused_field.cuh): it recomputes
//       the forward, the rgb and alpha heads' cotangents and the dir
//       layer's in the dir product's epilogue, in registers; then the dX
//       chain, L + 1 wgmma products on the activation tile, each epilogue
//       writing bf16(dY) in place as the next product's A tile, with each
//       bias's f32 column sum over the warpgroup's 64 rows. Every epilogue
//       writes its tile by stmatrix (four 8 x 8 matrices a lane's address:
//       a quarter of the shared stores, and 4 swizzled offsets a thread to
//       keep rather than 8, which at H = 256 had spilled), and one thread
//       sends the tile to the stash by TMA stores (act, feat, dy, dy_dir:
//       95% of its bytes at lego width), which drain under the next
//       product: the stash's bytes leave in 8 KB boxes instead of 4-byte
//       stores from the fragments, 8 rows a warp instruction, that had
//       held the kernel at 22% of its bound. 3.9 GB of stash at 2048 x 192
//       (15.4 GB at 8x1024).
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
//       lego width (~221 MB at 8x512, ~870 MB at 8x1024, whose matrices of
//       384 to 1024 columns are jobs of 256 columns and the rest).
//   (d) reduce_rows_kernel: the partials summed in a fixed order (ranges for
//       dW; warpgroup rows in two levels for the biases).
// The stash costs device-memory traffic (~20 KB per point written and read)
// that a fused design would keep on chip: later work.
//
// Files: (a), (b) and the workspace layout are fused_mlp_bwd.cuh's; (c)
// and (d) are dw_leg.cuh's, which the layer route (field_layers.cu) runs
// too; this file instantiates the tile kernel at H = 128 to 512 and holds
// the dW jobs over the stash and the entry points; fused_mlp_bwd_wide.cu
// instantiates it at 640 to 1024, so that nvcc builds the two halves at
// once.
#include "dw_leg.cuh"

namespace {

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

}  // namespace

// The transpose and the tile kernel at H = 640 to 1024 (fused_mlp_bwd_wide.cu).
extern "C" int nm_fused_mlp_bwd_tiles_wide(const float* origins, const float* dirs,
                                           const float* z, long long n_pts, int samples,
                                           const float* grad, const void* weights,
                                           const float* biases, const int* desc_i,
                                           int n_desc_i, const float* freqs, int n_freqs,
                                           void* workspace, void* stream);

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
    default:  // 640 to 1024: fused_mlp_bwd_wide.cu
      err = nm_fused_mlp_bwd_tiles_wide(origins, dirs, z, n_pts, samples, grad, weights, biases,
                                        desc_i, n_desc_i, freqs, n_freqs, workspace, stream);
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
