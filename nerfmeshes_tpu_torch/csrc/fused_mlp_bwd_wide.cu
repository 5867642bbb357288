// The backward's tile kernel at H = 640, 768, 896 and 1024, where each
// 64-point tile is split across a 2-CTA cluster (fused_field.cuh): its own
// translation unit, so that nvcc compiles these four instantiations beside
// fused_mlp_bwd.cu's four rather than after them. nm_fused_mlp_bwd calls it
// between its checks and the dW leg; the kernel and its launch are
// fused_mlp_bwd.cuh's.

#include "fused_mlp_bwd.cuh"

// The transpose and the tile kernel on `stream` for the descriptor's
// width, with nm_fused_mlp_bwd's arguments (its workspace already checked).
// Returns a cudaError_t code; 0 on success.
extern "C" int nm_fused_mlp_bwd_tiles_wide(const float* origins, const float* dirs,
                                           const float* z, long long n_pts, int samples,
                                           const float* grad, const void* weights,
                                           const float* biases, const int* desc_i,
                                           int n_desc_i, const float* freqs, int n_freqs,
                                           void* workspace, void* stream) {
  Desc d;
  const int err = parse_desc(desc_i, n_desc_i, freqs, n_freqs, &d);
  if (err != 0) return err;
  const Workspace ws = workspace_layout(d, n_pts);
  const bf16* W = static_cast<const bf16*>(weights);
  unsigned char* base = static_cast<unsigned char*>(workspace);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d.hidden) {
    case 640:
      return launch_tiles<640>(d, ws, origins, dirs, z, n_pts, samples, grad, W, biases, base, s);
    case 768:
      return launch_tiles<768>(d, ws, origins, dirs, z, n_pts, samples, grad, W, biases, base, s);
    case 896:
      return launch_tiles<896>(d, ws, origins, dirs, z, n_pts, samples, grad, W, biases, base, s);
    case 1024:
      return launch_tiles<1024>(d, ws, origins, dirs, z, n_pts, samples, grad, W, biases, base,
                                s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
