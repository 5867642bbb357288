"""Torch ops: device milliseconds a view of every kernel that PyTorch
launches (sampling, compositing, the maps' gathers): every kernel of the
trace but those built from the program's csrc/. Moves render_rays_per_s."""

from harness.readers import other_kernels_ms

# The program's own kernels (nerfmeshes_tpu_torch/csrc), by function name.
CSRC_KERNELS = ("fused_mlp_fwd_kernel", "fused_sigma_kernel", "wt_transpose_kernel",
                "bwd_tile_kernel", "dw_kernel", "reduce_rows_kernel", "chords_kernel",
                "layer_pe_kernel", "layer_product_kernel", "layer_heads_kernel",
                "layer_heads_bwd_kernel", "bias_grads_kernel", "layer_dw_kernel")


def read(ctx):
    return other_kernels_ms(ctx, CSRC_KERNELS)
