"""Field forward: percent of the bf16 peak (989 TFLOP/s) that the fused
forward kernel reaches in rendering: the forward operations of a view's
pixels (the padding of its last chunk not counted: it is the
implementation's, not the work's) over its device time. Moves
render_rays_per_s."""

from harness.readers import roofline

KERNELS = ("fused_mlp_fwd_kernel",)


def read(ctx):
    return roofline(ctx, KERNELS, ctx.forward_flops)
