"""Torch ops: device milliseconds a train step of every kernel that
PyTorch launches (ray batch, sampling, compositing, loss, optimizer):
every kernel of the trace but those built from the program's csrc/.
Moves train_rays_per_s."""

from harness.readers import other_kernels_ms

# The program's own kernels (nerfmeshes_tpu_torch/csrc), by function name.
CSRC_KERNELS = ("fused_mlp_fwd_kernel", "fused_sigma_kernel", "wt_transpose_kernel",
                "bwd_tile_kernel", "dw_kernel", "reduce_rows_kernel", "chords_kernel",
                "layer_pe_kernel", "layer_product_kernel", "layer_heads_kernel",
                "layer_heads_bwd_kernel", "bias_grads_kernel", "layer_dw_kernel")


def read(ctx):
    return other_kernels_ms(ctx, CSRC_KERNELS)
