"""Host loop: the calling thread's CPU milliseconds a train step inside
the program's train function (steps_per_call steps), over the calls
outside the traced stretch: the host's own work, not the time it waits
for the card when the launch queue is full. Moves train_rays_per_s."""

from harness.readers import enqueue_ms


def read(ctx):
    return enqueue_ms(ctx)
