"""Device, the whole step: percent of the bf16 peak (989 TFLOP/s, the
card's power limit printed beside it) that training reaches: 3x the
forward operations of every ray of every step of the window (forward,
dX, dW; no recompute) over the window's time. Moves train_rays_per_s."""

from harness.readers import mfu


def read(ctx):
    return mfu(ctx)
