"""Device: percent of the traced stretch of rendering in which no kernel,
copy or fill ran on the card (one minus the union of their intervals).
Moves render_rays_per_s."""

from harness.readers import idle_percent


def read(ctx):
    return idle_percent(ctx)
