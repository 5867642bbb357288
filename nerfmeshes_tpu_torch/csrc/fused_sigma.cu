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
// What bounds it: ~0.98 MFLOP per point at lego width against 16 bytes of
// input and output per point, so the tensor cores set the pace. Like the
// forward kernel it streams each layer's weights from L2 once per 64-point
// tile (they do not fit shared memory).
//
// Design: the forward kernel's, minus its heads. One block of 4 warps per
// tile of BM = 64 points; the points, their PE(xyz) and two activation tiles
// live in shared memory as bf16; the PE(xyz) tile, the trunk and the alpha
// head are the forward kernel's own code (pe_tile / trunk_forward /
// alpha_head in fused_mlp_common.cuh), so on equal points the two kernels
// give the same sigma bit for bit. It reads the same packed weights and descriptor as the
// forward kernel (the TPU kernel's separate sigma weight list and its
// (8, N) input with zero direction rows are TPU layouts, not carried over):
// points are (N, 3) f32, the output (N,) f32.

#include "fused_mlp_common.cuh"

namespace {

template <int H>
__global__ void __launch_bounds__(THREADS)
fused_sigma_kernel(const Desc desc, const float* __restrict__ points, long long n_pts,
                   const bf16* __restrict__ W, const float* __restrict__ B,
                   float* __restrict__ out) {
  constexpr int ALD = H + 8;
  // Regions start on 128 B multiples, as in the forward kernel.
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x;
  const int pxp = desc.pxp;
  const int peld = pxp + 8;  // row stride 16 B off a 32 B multiple
  bf16* act0 = reinterpret_cast<bf16*>(smem);
  bf16* act1 = act0 + BM * ALD;
  bf16* pe = act1 + BM * ALD;
  float* scratch = reinterpret_cast<float*>(pe + BM * peld);
  float* pts = scratch + WARPS * 256;  // [BM][3]
  float* wscratch = scratch + (tid >> 5) * 256;
  Desc& d = *reinterpret_cast<Desc*>(pts + BM * 3);
  if (tid == 0) d = desc;

  const long long base = (long long)blockIdx.x * BM;
  for (int i = tid; i < BM * 3; i += THREADS) {
    const long long g = base * 3 + i;
    pts[i] = g < n_pts * 3 ? points[g] : 0.f;  // points past n_pts read zeros
  }
  __syncthreads();
  pe_tile(pts, 3, d.inc_x, d.lx, d.fx, pxp, pe, peld);
  __syncthreads();

  const bf16* x = trunk_forward<H>(d, pe, peld, act0, act1, W, B, wscratch);
  for (int p = tid; p < BM; p += THREADS) {
    const long long g = base + p;
    if (g < n_pts) out[g] = alpha_head<H>(d, x + p * ALD, W, B);
  }
}

template <int H>
size_t smem_bytes(const Desc& d) {
  return 2 * BM * (H + 8) * sizeof(bf16) + BM * (d.pxp + 8) * sizeof(bf16) +
         (WARPS * 256 + BM * 3) * sizeof(float) + sizeof(Desc);
}

template <int H>
int launch(const Desc& d, const float* points, long long n_pts, const bf16* W,
           const float* B, float* out, cudaStream_t stream) {
  const size_t smem = smem_bytes<H>(d);
  cudaError_t err = cudaFuncSetAttribute(
      fused_sigma_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (n_pts + BM - 1) / BM;
  fused_sigma_kernel<H><<<(unsigned)blocks, THREADS, smem, stream>>>(d, points, n_pts, W, B,
                                                                      out);
  return (int)cudaGetLastError();
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
      return launch<128>(d, points, n_pts, W, biases, out, s);
    case 256:
      return launch<256>(d, points, n_pts, W, biases, out, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
