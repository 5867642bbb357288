// Shared by the fused FlexibleNeRF MLP kernels, which replace the Pallas TPU
// kernels of nerfmeshes_tpu/ops/pallas/fused_mlp.py: the forward
// (fused_mlp_fwd.cu, _fwd_kernel :387), the sigma-only field (fused_sigma.cu,
// _sigma_kernel :675) and the backward (fused_mlp_bwd.cu, _bwd_kernel :397).
// All three are bound on the H100 by the tensor cores (~1.2 MFLOP per point
// forward at lego width, 3x that backward, against tens of bytes of I/O),
// then by the weights read from L2 once per tile of points. The forward and
// sigma kernels answer with wgmma on TMA-staged weight slabs, 128-point
// tiles and persistent CTAs (fused_field.cuh). The backward's tile kernel
// still runs the first design, which lives here: a 64-point tile of points
// and PE in shared memory and a bias + ReLU product on nvcuda::wmma with
// weight fragments read from L2 (load_tile_inputs, pe_tile, gemm_bias_act).
// Every kernel computes PE through pe_value and reads the same descriptor.
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

constexpr int BM = 64;  // points per block (backward tile kernel)
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

// PE value j of the point (p0, p1, p2): [p if inc, sin(p_c * f_l) for c, l,
// cos(p_c * f_l) for c, l, zeros past the encoding]. Every kernel's PE is
// this arithmetic, so the kernels round PE alike.
__device__ __forceinline__ float pe_value(float p0, float p1, float p2, int j, int inc, int L,
                                          const float* f) {
  if (inc) {
    if (j < 3) return j == 0 ? p0 : (j == 1 ? p1 : p2);
    j -= 3;
  }
  const bool is_sin = j < 3 * L;
  if (!is_sin) j -= 3 * L;
  if (j >= 3 * L) return 0.f;  // padding lanes
  const int c = j / L;
  const float x = (c == 0 ? p0 : (c == 1 ? p1 : p2)) * f[j % L];
  return is_sin ? sinf(x) : cosf(x);
}

// One encoding of the tile's BM points: pe[i * peld + j] = PE(c_i)[j] in bf16
// for j < width (lanes past the encoding read 0), c_i the 3 floats at
// c + i * stride. No barrier.
__device__ __forceinline__ void pe_tile(const float* c, int stride, int inc, int L,
                                        const float* f, int width, bf16* pe, int peld) {
  for (int e = threadIdx.x; e < BM * width; e += THREADS) {
    const int i = e / width, j = e % width;
    const float* p = c + i * stride;
    pe[i * peld + j] = __float2bfloat16(pe_value(p[0], p[1], p[2], j, inc, L, f));
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

}  // namespace
