"""Field forward: percent of the bf16 peak (989 TFLOP/s) that the fused
forward kernel reaches in training: the forward operations of a step's
points (2 per weight of every product, coarse and fine fields) over its
device time. Moves train_rays_per_s."""

from harness.readers import roofline

KERNELS = ("fused_mlp_fwd_kernel",)


def read(ctx):
    return roofline(ctx, KERNELS, ctx.forward_flops)
