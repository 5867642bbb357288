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
// Weight layout (packed in nerfmeshes_tpu_torch/ops/kernels/fused_mlp.py):
// one flat bf16 buffer holding, per product, the torch-layout matrix
// (out, in_padded) row-major, i.e. the col-major (K, N) B operand; one flat
// f32 buffer of biases; offsets of each in the descriptor.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64;  // points per block
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_L = 24;       // PE bands per encoding
constexpr int MAX_GEMMS = 16;   // layer1 + trunk + feat + dir
constexpr int N_DESC_FIXED = 13;

struct Desc {
  int num_layers, hidden, skip_mask;
  int lx, ld, inc_x, inc_d, pxp, pdp;
  int wa_off, ba_off, wr_off, br_off;
  int w_off[MAX_GEMMS], b_off[MAX_GEMMS];
  float fx[MAX_L], fd[MAX_L];
};

__device__ __forceinline__ float pe_value(const float* c, int j, int inc, int L,
                                          const float* f) {
  if (inc) {
    if (j < 3) return c[j];
    j -= 3;
  }
  if (j < 3 * L) return sinf(c[j / L] * f[j % L]);
  j -= 3 * L;
  if (j < 3 * L) return cosf(c[j / L] * f[j % L]);
  return 0.f;  // padding lanes
}

// out[BM, N] = act([a1 | a2] @ W^T + bias), W is (N, k1 + k2) row-major.
// k1, k2 and N are multiples of 16 (N of 32); lda*, ldo multiples of 8.
__device__ void gemm_bias_act(const bf16* __restrict__ a1, int lda1, int k1,
                              const bf16* __restrict__ a2, int lda2, int k2,
                              const bf16* __restrict__ w,
                              const float* __restrict__ bias, int N,
                              bf16* __restrict__ out, int ldo, bool relu,
                              float* __restrict__ scratch) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int K = k1 + k2;
  for (int n0 = warp * 32; n0 < N; n0 += WARPS * 32) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BM / 16][2];
#pragma unroll
    for (int m = 0; m < BM / 16; ++m) {
      wmma::fill_fragment(acc[m][0], 0.f);
      wmma::fill_fragment(acc[m][1], 0.f);
    }
    for (int k0 = 0; k0 < K; k0 += 16) {
      const bf16* a;
      int lda;
      if (k0 < k1) {
        a = a1 + k0;
        lda = lda1;
      } else {
        a = a2 + (k0 - k1);
        lda = lda2;
      }
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b0, b1;
      wmma::load_matrix_sync(b0, w + (size_t)n0 * K + k0, K);
      wmma::load_matrix_sync(b1, w + (size_t)(n0 + 16) * K + k0, K);
#pragma unroll
      for (int m = 0; m < BM / 16; ++m) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
        wmma::load_matrix_sync(af, a + m * 16 * lda, lda);
        wmma::mma_sync(acc[m][0], af, b0, acc[m][0]);
        wmma::mma_sync(acc[m][1], af, b1, acc[m][1]);
      }
    }
    // Epilogue through a per-warp 16x16 f32 scratch tile: the accumulator's
    // register layout is opaque under wmma.
#pragma unroll
    for (int m = 0; m < BM / 16; ++m) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::store_matrix_sync(scratch, acc[m][j], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int r = e >> 4, c = e & 15;
          const int col = n0 + 16 * j + c;
          float v = scratch[e] + bias[col];
          if (relu) v = fmaxf(v, 0.f);
          out[(m * 16 + r) * ldo + col] = __float2bfloat16(v);
        }
        __syncwarp();
      }
    }
  }
}

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

  // Points o + d*z and their ray's direction; the ragged tail reads zeros.
  for (int i = tid; i < BM; i += THREADS) {
    const long long g = base + i;
    float v[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (g < n_pts) {
      const long long r = g / samples;
      const float t = z[g];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float dc = dirs[3 * r + c];
        // Unfused multiply and add: the same rounding as the plain version.
        v[c] = __fadd_rn(origins[3 * r + c], __fmul_rn(dc, t));
        v[3 + c] = dc;
      }
    }
#pragma unroll
    for (int c = 0; c < 6; ++c) pts[i * 6 + c] = v[c];
  }
  __syncthreads();

  // PE tile: [pe_x padded to pxp | pe_d padded to pdp] per point, bf16.
  for (int e = tid; e < BM * pxp; e += THREADS) {
    const int i = e / pxp, j = e % pxp;
    pe[i * peld + j] = __float2bfloat16(pe_value(pts + i * 6, j, d.inc_x, d.lx, d.fx));
  }
  for (int e = tid; e < BM * pdp; e += THREADS) {
    const int i = e / pdp, j = e % pdp;
    pe[i * peld + pxp + j] =
        __float2bfloat16(pe_value(pts + i * 6 + 3, j, d.inc_d, d.ld, d.fd));
  }
  __syncthreads();

  // layer1: PE(xyz) -> hidden, no activation.
  gemm_bias_act(pe, peld, pxp, nullptr, 0, 0, W + d.w_off[0], B + d.b_off[0], H,
                act0, ALD, false, wscratch);
  __syncthreads();

  bf16* cur = act0;
  bf16* nxt = act1;
  for (int i = 0; i < d.num_layers - 1; ++i) {
    const bool skip = (d.skip_mask >> i) & 1;
    gemm_bias_act(cur, ALD, H, pe, peld, skip ? pxp : 0, W + d.w_off[1 + i],
                  B + d.b_off[1 + i], H, nxt, ALD, true, wscratch);
    __syncthreads();
    bf16* t = cur;
    cur = nxt;
    nxt = t;
  }

  // alpha head (raw sigma) off the trunk output, then the feat head.
  const int L = d.num_layers;
  for (int p = tid; p < BM; p += THREADS) {
    const bf16* x = cur + p * ALD;
    const bf16* wa = W + d.wa_off;
    float s = 0.f;
    for (int k = 0; k < H; ++k) s += __bfloat162float(x[k]) * __bfloat162float(wa[k]);
    alpha[p] = s + B[d.ba_off];
  }
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

// desc_i: [num_layers, hidden, skip_mask, lx, ld, inc_x, inc_d, pxp, pdp,
//          wa_off, ba_off, wr_off, br_off, w_off[num_layers + 2],
//          b_off[num_layers + 2]]
// freqs:  [fx[lx], fd[ld]]
// Returns a cudaError_t code; 0 on success.
extern "C" int nm_fused_mlp_fwd(const float* origins, const float* dirs,
                                const float* z, long long n_rays, int samples,
                                const void* weights, const float* biases,
                                const int* desc_i, int n_desc_i, const float* freqs,
                                int n_freqs, float* out, int channels_first,
                                void* stream) {
  Desc d = {};
  if (n_desc_i < N_DESC_FIXED) return (int)cudaErrorInvalidValue;
  d.num_layers = desc_i[0];
  d.hidden = desc_i[1];
  d.skip_mask = desc_i[2];
  d.lx = desc_i[3];
  d.ld = desc_i[4];
  d.inc_x = desc_i[5];
  d.inc_d = desc_i[6];
  d.pxp = desc_i[7];
  d.pdp = desc_i[8];
  d.wa_off = desc_i[9];
  d.ba_off = desc_i[10];
  d.wr_off = desc_i[11];
  d.br_off = desc_i[12];
  const int n_gemms = d.num_layers + 2;
  if (d.num_layers < 1 || n_gemms > MAX_GEMMS ||
      n_desc_i != N_DESC_FIXED + 2 * n_gemms || d.lx < 0 || d.lx > MAX_L ||
      d.ld < 0 || d.ld > MAX_L || n_freqs != d.lx + d.ld || d.pxp % 16 != 0 ||
      d.pdp % 16 != 0 || d.pxp <= 0 || d.pdp <= 0 || samples <= 0 || n_rays < 0)
    return (int)cudaErrorInvalidValue;
  for (int g = 0; g < n_gemms; ++g) {
    d.w_off[g] = desc_i[N_DESC_FIXED + g];
    d.b_off[g] = desc_i[N_DESC_FIXED + n_gemms + g];
    if (d.w_off[g] % 16 != 0) return (int)cudaErrorInvalidValue;  // 32 B aligned
  }
  for (int l = 0; l < d.lx; ++l) d.fx[l] = freqs[l];
  for (int l = 0; l < d.ld; ++l) d.fd[l] = freqs[d.lx + l];

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
