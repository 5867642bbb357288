"""Device, the whole view: percent of the bf16 peak (989 TFLOP/s, the
card's power limit printed beside it) that rendering reaches: the
forward operations of every pixel of every view of the window (padding
not counted) over the window's time. Moves render_rays_per_s."""

from harness.readers import mfu


def read(ctx):
    return mfu(ctx)
