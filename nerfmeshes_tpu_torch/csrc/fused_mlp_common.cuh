// Shared by the fused FlexibleNeRF MLP kernels (fused_mlp_fwd.cu,
// fused_mlp_bwd.cu and fused_sigma.cu): the descriptor of a packed model, the
// tile of points and positional encoding a block builds in shared memory, the
// bias + ReLU product every kernel runs for every layer's forward, and the
// trunk and alpha head the forward and sigma kernels share.
//
// Weight layout (packed in nerfmeshes_tpu_torch/ops/kernels/fused_mlp.py):
// one flat bf16 buffer holding, per product (layer1, trunk 0..L-2, feat,
// dir), the torch-layout matrix (out, in_padded) row-major, i.e. the
// col-major (K, N) B operand, then the alpha row and the rgb matrix; one
// flat f32 buffer of biases in the same order; offsets of each in the
// descriptor.
//
// Everything here has internal linkage: each .cu file gets its own copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

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

// desc_i: [num_layers, hidden, skip_mask, lx, ld, inc_x, inc_d, pxp, pdp,
//          wa_off, ba_off, wr_off, br_off, w_off[num_layers + 2],
//          b_off[num_layers + 2]]
// freqs:  [fx[lx], fd[ld]]
// Returns a cudaError_t code; 0 when the descriptor is one the kernels take.
int parse_desc(const int* desc_i, int n_desc_i, const float* freqs, int n_freqs,
               Desc* out) {
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
      d.pdp % 16 != 0 || d.pxp <= 0 || d.pdp <= 0 ||
      (d.hidden != 128 && d.hidden != 256))
    return (int)cudaErrorInvalidValue;
  for (int g = 0; g < n_gemms; ++g) {
    d.w_off[g] = desc_i[N_DESC_FIXED + g];
    d.b_off[g] = desc_i[N_DESC_FIXED + n_gemms + g];
    if (d.w_off[g] % 16 != 0) return (int)cudaErrorInvalidValue;  // 32 B aligned
  }
  for (int l = 0; l < d.lx; ++l) d.fx[l] = freqs[l];
  for (int l = 0; l < d.ld; ++l) d.fd[l] = freqs[d.lx + l];
  *out = d;
  return 0;
}

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

// One encoding of the tile's BM points: pe[i * peld + j] = PE(c_i)[j] in bf16
// for j < width (lanes past the encoding read 0), c_i the 3 floats at
// c + i * stride. Every PE tile of every kernel is built here, so the
// kernels round PE alike. No barrier.
__device__ __forceinline__ void pe_tile(const float* c, int stride, int inc, int L,
                                        const float* f, int width, bf16* pe, int peld) {
  for (int e = threadIdx.x; e < BM * width; e += THREADS) {
    const int i = e / width, j = e % width;
    pe[i * peld + j] = __float2bfloat16(pe_value(c + i * stride, j, inc, L, f));
  }
}

// The block's tile of BM points: pts[BM][6] = (o + d*z, d) and the PE tile
// pe[BM][peld] = [PE(xyz) padded to pxp | PE(dir) padded to pdp], bf16.
// Points past n_pts read zeros. Ends with a block barrier.
__device__ void load_tile_inputs(const Desc& d, const float* __restrict__ origins,
                                 const float* __restrict__ dirs,
                                 const float* __restrict__ z, long long n_pts,
                                 int samples, long long base, float* pts, bf16* pe,
                                 int peld) {
  const int tid = threadIdx.x;
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

  pe_tile(pts, 6, d.inc_x, d.lx, d.fx, d.pxp, pe, peld);
  pe_tile(pts + 3, 6, d.inc_d, d.ld, d.fd, d.pdp, pe + d.pxp, peld);
  __syncthreads();
}

// out[BM, N] = act([a1 | a2] @ W^T + bias), W is (N, k1 + k2) row-major.
// k1, k2 and N are multiples of 16 (N of 32); lda*, ldo multiples of 8.
// Each warp owns 32-column slices of the output and loads its weight
// fragments straight from global memory (L2-resident after the first tiles).
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

// layer1 (no activation) then the ReLU trunk, PE(xyz) skips where skip_mask
// says, on a tile whose PE(xyz) occupies columns [0, pxp) of pe. Ping-pongs
// between act0 and act1 and returns the one holding the trunk output. Ends
// with a block barrier. The forward and the sigma kernel both run this, so
// their trunks are one arithmetic.
template <int H>
__device__ __forceinline__ bf16* trunk_forward(const Desc& d, const bf16* pe, int peld,
                                               bf16* act0, bf16* act1,
                                               const bf16* __restrict__ W,
                                               const float* __restrict__ B,
                                               float* wscratch) {
  constexpr int ALD = H + 8;
  gemm_bias_act(pe, peld, d.pxp, nullptr, 0, 0, W + d.w_off[0], B + d.b_off[0], H,
                act0, ALD, false, wscratch);
  __syncthreads();
  bf16* cur = act0;
  bf16* nxt = act1;
  for (int i = 0; i < d.num_layers - 1; ++i) {
    const bool skip = (d.skip_mask >> i) & 1;
    gemm_bias_act(cur, ALD, H, pe, peld, skip ? d.pxp : 0, W + d.w_off[1 + i],
                  B + d.b_off[1 + i], H, nxt, ALD, true, wscratch);
    __syncthreads();
    bf16* t = cur;
    cur = nxt;
    nxt = t;
  }
  return cur;
}

// Raw sigma (the alpha head, no activation) off one trunk output row x.
template <int H>
__device__ __forceinline__ float alpha_head(const Desc& d, const bf16* x,
                                            const bf16* __restrict__ W,
                                            const float* __restrict__ B) {
  const bf16* wa = W + d.wa_off;
  float s = 0.f;
  for (int k = 0; k < H; ++k) s += __bfloat162float(x[k]) * __bfloat162float(wa[k]);
  return s + B[d.ba_off];
}

}  // namespace
