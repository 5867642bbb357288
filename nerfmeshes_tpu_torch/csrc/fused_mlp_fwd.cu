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
// What bounds it: ~1.2 MFLOP per point (lego width) against ~44 bytes of
// input and output per point, so the tensor cores set the pace, not device
// memory. The next limit is the weights (1.19 MB in bf16, far above the
// 227 KB of shared memory a block may hold): each block streams every
// layer's weights from L2 once per tile of BM points, ~18.6 KB per point
// at BM = 64.
//
// Design (simple first): one block of 4 warps per tile of BM = 64 points.
// The PE tile and two activation tiles (ping-pong) live in shared memory as
// bf16. Each warp owns 32-column slices of a layer's output and runs
// nvcuda::wmma bf16 16x16x16 products with f32 accumulation over the K
// dimension, loading its weight fragments straight from global memory
// (L2-resident after the first tiles). Bias, ReLU and sigmoid run in f32; an
// activation is rounded to bf16 only as the next product's operand, as in
// the TPU kernel. The tiny alpha (H -> 1) and rgb (H/2 -> 3) heads run as
// scalar dot products. PE widths are padded to multiples of 16 with zero
// weight columns. The sine arguments reach thousands of radians (2^9 *
// |6| at L_xyz = 10): sinf/cosf with full range reduction, never __sinf or
// --use_fast_math.
//
// Descriptor, tile inputs and the per-layer product: fused_mlp_common.cuh.

#include "fused_mlp_common.cuh"

namespace {

template <int H>
__global__ void __launch_bounds__(THREADS)
fused_mlp_fwd_kernel(const Desc desc, const float* __restrict__ origins,
                     const float* __restrict__ dirs, const float* __restrict__ z,
                     long long n_pts, int samples, const bf16* __restrict__ W,
                     const float* __restrict__ B, float* __restrict__ out,
                     int channels_first) {
  constexpr int ALD = H + 8;  // row stride 16 B off a 128 B multiple
  // Only dynamic shared memory, so its base is the window's (aligned) base;
  // every region below starts on a 128 B multiple (BM * 2 B = 128 B).
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x;
  const int pxp = desc.pxp, pdp = desc.pdp;
  const int peld = pxp + pdp + 8;  // row stride 16 B off a 32 B multiple
  bf16* act0 = reinterpret_cast<bf16*>(smem);
  bf16* act1 = act0 + BM * ALD;
  bf16* pe = act1 + BM * ALD;
  float* scratch = reinterpret_cast<float*>(pe + BM * peld);
  float* pts = scratch + WARPS * 256;  // [BM][6]: xyz, dir
  float* alpha = pts + BM * 6;         // [BM]
  float* wscratch = scratch + (tid >> 5) * 256;
  // Shared copy of the descriptor: its arrays are indexed at run time.
  Desc& d = *reinterpret_cast<Desc*>(alpha + BM);
  if (tid == 0) d = desc;
  __syncthreads();

  const long long base = (long long)blockIdx.x * BM;

  // Points o + d*z, their ray's direction, and the PE tile.
  load_tile_inputs(d, origins, dirs, z, n_pts, samples, base, pts, pe, peld);

  // layer1 + trunk.
  bf16* cur = trunk_forward<H>(d, pe, peld, act0, act1, W, B, wscratch);
  bf16* nxt = cur == act0 ? act1 : act0;

  // alpha head (raw sigma) off the trunk output, then the feat head.
  const int L = d.num_layers;
  for (int p = tid; p < BM; p += THREADS) alpha[p] = alpha_head<H>(d, cur + p * ALD, W, B);
  gemm_bias_act(cur, ALD, H, nullptr, 0, 0, W + d.w_off[L], B + d.b_off[L], H, nxt,
                ALD, true, wscratch);
  __syncthreads();

  // dir layer on [feat | PE(dir)] -> H/2, into the trunk buffer.
  gemm_bias_act(nxt, ALD, H, pe + pxp, peld, pdp, W + d.w_off[L + 1],
                B + d.b_off[L + 1], H / 2, cur, ALD, true, wscratch);
  __syncthreads();

  // rgb head + output.
  for (int e = tid; e < BM * 4; e += THREADS) {
    const int p = e >> 2, c = e & 3;
    const long long g = base + p;
    if (g >= n_pts) continue;
    float v;
    if (c < 3) {
      const bf16* h = cur + p * ALD;
      const bf16* wr = W + d.wr_off + c * (H / 2);
      float s = 0.f;
      for (int k = 0; k < H / 2; ++k) s += __bfloat162float(h[k]) * __bfloat162float(wr[k]);
      v = 1.f / (1.f + expf(-(s + B[d.br_off + c])));
    } else {
      v = alpha[p];
    }
    if (channels_first)
      out[(long long)c * n_pts + g] = v;
    else
      out[g * 4 + c] = v;
  }
}

template <int H>
size_t smem_bytes(const Desc& d) {
  const size_t peld = d.pxp + d.pdp + 8;
  return 2 * BM * (H + 8) * sizeof(bf16) + BM * peld * sizeof(bf16) +
         (WARPS * 256 + BM * 6 + BM) * sizeof(float) + sizeof(Desc);
}

template <int H>
int launch(const Desc& d, const float* o, const float* dirs, const float* z,
           long long n_pts, int samples, const bf16* W, const float* B, float* out,
           int channels_first, cudaStream_t stream) {
  const size_t smem = smem_bytes<H>(d);
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_fwd_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (n_pts + BM - 1) / BM;
  fused_mlp_fwd_kernel<H><<<(unsigned)blocks, THREADS, smem, stream>>>(
      d, o, dirs, z, n_pts, samples, W, B, out, channels_first);
  return (int)cudaGetLastError();
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
      return launch<128>(d, origins, dirs, z, n_pts, samples, W, biases, out,
                         channels_first, s);
    case 256:
      return launch<256>(d, origins, dirs, z, n_pts, samples, W, biases, out,
                         channels_first, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* nm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
