"""What the kinds of cell share: the outcome of a run, the device's
synchronisation and peak, the traced stretch inside the window, and the
statistics of the end-to-end metrics."""

from __future__ import annotations

import gc
import statistics
import time
from dataclasses import dataclass, field

import torch

from harness import devtrace

# The stretch of the window that a --trace 1 run traces: from this share
# of the window on, for this many seconds (whole calls or views).
TRACE_FROM = 0.3
TRACE_SECONDS = 2.0


@dataclass
class Outcome:
    end_to_end: dict  # metric name -> value
    attempted: int
    failed: int
    memory_peak: int
    checks: list  # (name, value, limit or None)
    trace: object = None  # readers.TraceContext of a traced run
    notes: list = field(default_factory=list)  # lines for standard error
    setup: dict = field(default_factory=dict)  # SetupLegs.summary()


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


class SetupLegs:
    """The legs of set-up in seconds, and whether this run built the
    program's kernel library (a checkout's first run does; its set-up is
    then not a warm one)."""

    def __init__(self, process_age):
        self.legs = {"imports": process_age()}  # process start until the kind of cell runs
        self.at = now()
        self.built = False

    def mark(self, leg: str) -> None:
        t = now()
        self.legs[leg] = t - self.at
        self.at = t

    def summary(self) -> dict:
        return {"built": self.built, "legs_s": dict(self.legs)}

    def note(self) -> str:
        legs = " ".join(f"{k} {v:.4f}" for k, v in self.legs.items())
        return f"set-up legs (s): {legs}; kernel library built in this run: {self.built}"


class TracedStretch:
    """Decides, at each unit's boundary, whether the traced stretch starts
    or ends there; a no-op without --trace 1."""

    def __init__(self, enabled: bool, device, start: float, seconds: float):
        self.enabled = enabled and torch.device(device).type == "cuda"
        self.device = device
        self.begin_at = start + TRACE_FROM * seconds
        self.length = min(TRACE_SECONDS, 0.25 * seconds)
        self.profiler = None
        self.stretch = None
        self.units = 0
        self.host_start = self.host_stop = None
        self.launches_before: dict = {}
        self.launches: dict = {}
        self.began = 0.0
        self.spent = 0.0  # host seconds from the profiler's start to the trace's reduction

    @property
    def active(self) -> bool:
        return self.profiler is not None

    def boundary(self, now: float, launch_counts) -> None:
        if not self.enabled or self.stretch is not None:
            return
        if self.profiler is None and now >= self.begin_at:
            self.began = time.perf_counter()
            self.profiler = devtrace.Profiler(self.device)
            self.launches_before = launch_counts()
            self.profiler.start()
            self.host_start = self.profiler.host_start
        elif self.profiler is not None and now >= self.host_start + self.length and self.units:
            self.finish(launch_counts)

    def count(self, units: int) -> None:
        if self.profiler is not None:
            self.units += units

    def finish(self, launch_counts) -> None:
        if self.profiler is None:
            return
        self.stretch = self.profiler.stop()
        self.host_stop = self.profiler.host_stop
        after = launch_counts()
        self.launches = {k: after[k] - self.launches_before.get(k, 0) for k in after}
        self.profiler = None
        self.spent = time.perf_counter() - self.began


def overhead_note(traced: TracedStretch, units: int, window_s: float, unit: str) -> list:
    """The traced stretch's rate beside the rest of the window's: what
    tracing costs while it is on."""
    if traced.stretch is None or window_s <= traced.spent:
        return []
    inside = traced.units / (traced.host_stop - traced.host_start)
    outside = (units - traced.units) / (window_s - traced.spent)
    return [f"tracing: {inside:.4f} {unit}/s inside the traced stretch, {outside:.4f} outside; "
            f"the trace took {traced.spent:.4f} s of the window"]


def percentile(values: list, q: float) -> float:
    """The q-th percentile (0-100) of all values, statistics.quantiles'
    inclusive method."""
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[int(q) - 1]


def now() -> float:
    return time.perf_counter()


def thread_cpu() -> float:
    """CPU seconds of the calling thread: what it computed, not what it
    slept through while it waited for the device."""
    return time.thread_time()
