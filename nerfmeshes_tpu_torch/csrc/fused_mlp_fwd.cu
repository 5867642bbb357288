// Fused FlexibleNeRF MLP forward, straight from rays, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel nerfmeshes_tpu/ops/pallas/fused_mlp.py:387
// (_fwd_kernel, launched by _fused_mlp_fwd). Per point it computes
//   points = o + d*z, PE(xyz), PE(dir)        (built in shared memory)
//   x = layer1(PE(xyz))                        (no activation)
//   x = relu(trunk_i(x [, PE(xyz)]))           (PE skip where skip_mask says)
//   sigma = alpha(x);  feat = relu(fc_feat(x))
//   h = relu(dir([feat, PE(dir)]));  rgb = sigmoid(fc_rgb(h))
// and writes [rgb, sigma] per point, channels-first (4, N) or (N, 4).
// No points, PE or activation tensor ever exists in device memory.
//
// What bounds it on an H100: ~1.19 MFLOP per point at lego width against
// ~44 bytes of input and output per point, so the tensor cores set the
// pace, and only wgmma reaches their rate. Next come the weights (1.19 MB
// of bf16, far above a CTA's 227 KB of shared memory), read from L2 once
// per tile: ~9.3 KB per point at 128-point tiles.
//
// Design: fused_field.cuh's persistent kernel (one CTA per SM, a producer
// thread streaming K-slabs of every product's weights by TMA into a ring of
// shared-memory slots, two consumer warpgroups of 64 points running
// wgmma.mma_async on them with the sums in registers, epilogues and the
// alpha and rgb heads in registers). At H = 128 and 256 the activations
// stay in registers as the next product's A operand and the producer
// warpgroup's other warps build the PE (field_body_regs); from 384 on
// 64-point tiles in shared memory whose products the two consumer
// warpgroups split in N, from 640 on split across a 2-CTA cluster as well,
// launched as clusters (field_body_split). The sigma kernel
// (fused_sigma.cu) runs the same code up to the alpha head. Instantiated at
// H = 128 to 1024 in steps of 128.

#include "fused_field.cuh"

namespace {

template <int H>
__global__ void __launch_bounds__(FIELD_THREADS, 1) fused_mlp_fwd_kernel(FIELD_KERNEL_PARAMS) {
  field_body<H, true>(FIELD_KERNEL_ARGS);
}

}  // namespace

// desc_i, freqs: as parse_desc (fused_mlp_common.cuh) reads them.
// Returns a cudaError_t code; 0 on success.
extern "C" int nm_fused_mlp_fwd(const float* origins, const float* dirs,
                                const float* z, long long n_rays, int samples,
                                const void* weights, const float* biases,
                                const int* desc_i, int n_desc_i, const float* freqs,
                                int n_freqs, float* out, int channels_first,
                                void* stream) {
  Desc d;
  const int err = parse_desc(desc_i, n_desc_i, freqs, n_freqs, &d);
  if (err != 0) return err;
  if (samples <= 0 || n_rays < 0) return (int)cudaErrorInvalidValue;

  const long long n_pts = n_rays * samples;
  if (n_pts == 0) return 0;
  const bf16* W = static_cast<const bf16*>(weights);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d.hidden) {
    case 128:
      return field_launch<128, true>(fused_mlp_fwd_kernel<128>, d, origins, dirs, z, n_pts,
                                     samples, W, biases, out, channels_first, s);
    case 256:
      return field_launch<256, true>(fused_mlp_fwd_kernel<256>, d, origins, dirs, z, n_pts,
                                     samples, W, biases, out, channels_first, s);
    case 384:
      return field_launch<384, true>(fused_mlp_fwd_kernel<384>, d, origins, dirs, z, n_pts,
                                     samples, W, biases, out, channels_first, s);
    case 512:
      return field_launch<512, true>(fused_mlp_fwd_kernel<512>, d, origins, dirs, z, n_pts,
                                     samples, W, biases, out, channels_first, s);
    case 640:
      return field_launch<640, true>(fused_mlp_fwd_kernel<640>, d, origins, dirs, z, n_pts,
                                     samples, W, biases, out, channels_first, s);
    case 768:
      return field_launch<768, true>(fused_mlp_fwd_kernel<768>, d, origins, dirs, z, n_pts,
                                     samples, W, biases, out, channels_first, s);
    case 896:
      return field_launch<896, true>(fused_mlp_fwd_kernel<896>, d, origins, dirs, z, n_pts,
                                     samples, W, biases, out, channels_first, s);
    case 1024:
      return field_launch<1024, true>(fused_mlp_fwd_kernel<1024>, d, origins, dirs, z, n_pts,
                                      samples, W, biases, out, channels_first, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* nm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
