"""Field backward: percent of the bf16 peak (989 TFLOP/s) that the fused
backward's kernels reach: the dX and dW products the algorithm needs,
2x the forward's operations (no recompute, no stash), over the device
time of the transpose, tile, dW and reduction kernels. Moves
train_rays_per_s."""

from harness.readers import roofline

KERNELS = ("wt_transpose_kernel", "bwd_tile_kernel", "dw_kernel", "reduce_rows_kernel")


def read(ctx):
    return roofline(ctx, KERNELS, 2.0 * ctx.forward_flops)
