// Sigma-only FlexibleNeRF field at points, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel nerfmeshes_tpu/ops/pallas/fused_mlp.py:675
// (_sigma_kernel, launched by fused_sigma_from_packed). Per point p it
// computes the raw density the full forward's fourth channel holds:
//   x = layer1(PE(p));  x = relu(trunk_i(x [, PE(p)]));  sigma = alpha(x)
// and writes sigma (before any ReLU) as one f32 per point. The feat, dir and
// rgb products are never run: density does not depend on the view direction
// (the alpha head hangs off the trunk), so mesh extraction's res^3 grid
// evaluation skips ~18% of the forward's FLOPs and three quarters of its
// output bytes.
//
// What bounds it on an H100: ~0.98 MFLOP per point at lego width against 16
// bytes of input and output per point, so the tensor cores set the pace
// (wgmma only), then the trunk's weights read from L2 once per 128-point
// tile.
//
// Design: the forward kernel's (fused_field.cuh), stopped after the alpha
// head: the same persistent CTAs, TMA weight ring, wgmma products, register
// epilogues and PE builders (at H = 128 and 256 the register design, its
// activations in registers), and the very same trunk and alpha head code,
// so on equal points the two kernels give the same sigma bit for bit. Its PE
// tiles hold PE(xyz) only. It reads the same packed weights and descriptor
// as the forward kernel (the TPU kernel's separate sigma weight list and its
// (8, N) input with zero direction rows are TPU layouts, not carried over):
// points are (N, 3) f32, the output (N,) f32. H = 128 to 1024 in steps of
// 128, as the forward kernel, with the same tiles, CTA pairs and head-sum
// order.

#include "fused_field.cuh"

namespace {

template <int H>
__global__ void __launch_bounds__(FIELD_THREADS, 1) fused_sigma_kernel(FIELD_KERNEL_PARAMS) {
  field_body<H, false>(FIELD_KERNEL_ARGS);
}

}  // namespace

// points (n_pts, 3) f32, out (n_pts,) f32; weights, biases, desc_i, freqs:
// the forward kernel's (parse_desc in fused_mlp_common.cuh).
// Returns a cudaError_t code; 0 on success.
extern "C" int nm_fused_sigma(const float* points, long long n_pts, const void* weights,
                              const float* biases, const int* desc_i, int n_desc_i,
                              const float* freqs, int n_freqs, float* out, void* stream) {
  Desc d;
  const int err = parse_desc(desc_i, n_desc_i, freqs, n_freqs, &d);
  if (err != 0) return err;
  if (n_pts < 0) return (int)cudaErrorInvalidValue;
  if (n_pts == 0) return 0;
  const bf16* W = static_cast<const bf16*>(weights);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d.hidden) {
    case 128:
      return field_launch<128, false>(fused_sigma_kernel<128>, d, points, nullptr, nullptr,
                                      n_pts, 1, W, biases, out, 0, s);
    case 256:
      return field_launch<256, false>(fused_sigma_kernel<256>, d, points, nullptr, nullptr,
                                      n_pts, 1, W, biases, out, 0, s);
    case 384:
      return field_launch<384, false>(fused_sigma_kernel<384>, d, points, nullptr, nullptr,
                                      n_pts, 1, W, biases, out, 0, s);
    case 512:
      return field_launch<512, false>(fused_sigma_kernel<512>, d, points, nullptr, nullptr,
                                      n_pts, 1, W, biases, out, 0, s);
    case 640:
      return field_launch<640, false>(fused_sigma_kernel<640>, d, points, nullptr, nullptr,
                                      n_pts, 1, W, biases, out, 0, s);
    case 768:
      return field_launch<768, false>(fused_sigma_kernel<768>, d, points, nullptr, nullptr,
                                      n_pts, 1, W, biases, out, 0, s);
    case 896:
      return field_launch<896, false>(fused_sigma_kernel<896>, d, points, nullptr, nullptr,
                                      n_pts, 1, W, biases, out, 0, s);
    case 1024:
      return field_launch<1024, false>(fused_sigma_kernel<1024>, d, points, nullptr, nullptr,
                                       n_pts, 1, W, biases, out, 0, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
