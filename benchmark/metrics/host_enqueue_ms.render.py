"""Host loop: the calling thread's CPU milliseconds a view inside
NeRFSystem.query_rays, before the rgb map's fetch, over the views outside
the traced stretch: the host's own work, not its waits for the card.
Moves render_rays_per_s."""

from harness.readers import enqueue_ms


def read(ctx):
    return enqueue_ms(ctx)
