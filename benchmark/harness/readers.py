"""What a per-layer metric's reader (metrics/<name>.py) is given, and the
arithmetic the readers share. A reader that finds nothing to read
returns None, and the metric is left out of the run's line."""

from __future__ import annotations

from dataclasses import dataclass, field

from harness import devtrace
from harness.flops import PEAK_BF16_FLOPS


@dataclass
class TraceContext:
    stretch: devtrace.Stretch  # the device trace of a steady stretch of the window
    units: int  # train steps or views inside the stretch
    forward_flops: float  # the algorithm's forward operations a unit (its rays; no padding)
    window_s: float  # the window outside the traced stretch, on the host clock
    window_model_flops: float  # the model operations of the units outside the stretch
    enqueue_s: list = field(default_factory=list)  # the calling thread's CPU seconds a unit
    host_wall_s: list = field(default_factory=list)  # host seconds a unit until the call returned
    host_spans: list = field(default_factory=list)  # (label, start, end) on the host's clock
    launches: dict = field(default_factory=dict)  # the program's launch counters over the stretch


def device_seconds(ctx: TraceContext, names) -> float:
    """Kernel time in the stretch of the kernels named (by function name)."""
    return sum(op.dur for op in ctx.stretch.kernels() if devtrace.matches(op.name, names))


def per_unit_ms(ctx: TraceContext, seconds: float):
    if ctx.units <= 0:
        return None
    return seconds / ctx.units * 1e3


def roofline(ctx: TraceContext, names, flops_per_unit: float):
    """Percent of the bf16 peak that the named kernels reach on the
    algorithm's operations: ops / peak / kernel time. None without those
    kernels in the trace."""
    secs = device_seconds(ctx, names)
    if secs <= 0.0 or ctx.units <= 0:
        return None
    return 100.0 * flops_per_unit * ctx.units / PEAK_BF16_FLOPS / secs


def other_kernels_ms(ctx: TraceContext, excluded) -> float | None:
    """Device ms a unit of every kernel not named in `excluded`."""
    kernels = ctx.stretch.kernels()
    if not kernels:
        return None
    secs = sum(op.dur for op in kernels if not devtrace.matches(op.name, excluded))
    return per_unit_ms(ctx, secs)


def idle_percent(ctx: TraceContext):
    """Percent of the stretch in which no device op ran."""
    if not ctx.stretch.ops or ctx.stretch.seconds <= 0.0:
        return None
    busy = devtrace.union_seconds((op.start, op.start + op.dur) for op in ctx.stretch.ops)
    return 100.0 * (1.0 - busy / ctx.stretch.seconds)


def mfu(ctx: TraceContext):
    """Percent of the bf16 peak that the window's model operations reach
    over the window's time."""
    if ctx.window_s <= 0.0 or ctx.window_model_flops <= 0.0:
        return None
    return 100.0 * ctx.window_model_flops / ctx.window_s / PEAK_BF16_FLOPS


def enqueue_ms(ctx: TraceContext):
    """The calling thread's CPU milliseconds a unit inside the program's
    call, outside the traced stretch: the host's own work, not its
    waits for the device."""
    if not ctx.enqueue_s:
        return None
    return 1e3 * sum(ctx.enqueue_s) / len(ctx.enqueue_s)
