// Shared by the fused FlexibleNeRF MLP kernels, which replace the Pallas TPU
// kernels of nerfmeshes_tpu/ops/pallas/fused_mlp.py: the forward
// (fused_mlp_fwd.cu, _fwd_kernel :387), the sigma-only field (fused_sigma.cu,
// _sigma_kernel :675) and the backward (fused_mlp_bwd.cu, _bwd_kernel :397).
// The forward and the sigma kernel are bound on the H100 by the tensor cores
// (~1.2 MFLOP per point at lego width against tens of bytes of I/O), then
// by the weights read from L2 once per tile of points; the backward by its
// stash's device-memory traffic. All of them run wgmma on TMA-staged
// shared memory (fused_field.cuh). Every kernel reads the same descriptor.
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

namespace {

typedef __nv_bfloat16 bf16;

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
      d.hidden % 128 != 0 || d.hidden < 128 || d.hidden > 1024)
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

}  // namespace
