"""The device trace of a steady stretch of the window, and its reduction.

torch.profiler records CUDA activity only (no CPU operators, stacks or
shapes), so that it slows the host it measures as little as it can. The
stretch starts and ends at a synchronisation. A marker kernel
(torch.cuda._sleep's `spin_kernel`), launched at a known host time right
after the start, places the trace on the host's clock, so that idle gaps
can be named by the host span they fall in.
"""

from __future__ import annotations

import json
import re
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARKER = "spin_kernel"


@dataclass
class DeviceOp:
    name: str
    cat: str
    start: float  # seconds, on the trace's clock
    dur: float  # seconds


@dataclass
class Stretch:
    """What the trace of one stretch holds."""

    ops: list = field(default_factory=list)  # DeviceOp, the marker left out
    t0: float = 0.0  # the stretch on the trace's clock
    t1: float = 0.0
    host_offset: float | None = None  # trace clock - host perf_counter
    runtime: list = field(default_factory=list)  # seconds of each CUDA runtime call on the host

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def kernels(self) -> list:
        return [op for op in self.ops if op.cat == "kernel"]


def kernel_id(name: str) -> str:
    """The function's name in a demangled kernel name: 'void ns::f<3>(int)'
    -> 'f'."""
    head = name.replace("(anonymous namespace)", "anonymous").split("(", 1)[0]
    head = re.sub(r"<.*", "", head).strip()
    return head.split()[-1].split("::")[-1] if head else name


def matches(name: str, names) -> bool:
    return kernel_id(name) in names


def union_seconds(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def idle_gaps(ops, t0: float, t1: float) -> list:
    """(start, end) of every stretch of [t0, t1] in which no device op ran."""
    gaps, at = [], t0
    for s, e in sorted((op.start, op.start + op.dur) for op in ops):
        if s > at:
            gaps.append((at, min(s, t1)))
        at = max(at, e)
    if at < t1:
        gaps.append((at, t1))
    return [(s, e) for s, e in gaps if e > s]


class Profiler:
    """Traces one stretch: start() and stop() around it, on a card."""

    def __init__(self, device):
        import torch

        self.torch = torch
        self.device = device
        self.prof = None
        self.host_start = 0.0
        self.host_stop = 0.0

    def start(self) -> None:
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize(self.device)
        self.prof = profile(activities=[ProfilerActivity.CUDA], record_shapes=False,
                            with_stack=False, profile_memory=False, with_flops=False)
        self.prof.__enter__()
        torch.cuda.synchronize(self.device)
        self.host_start = time.perf_counter()
        torch.cuda._sleep(1000)

    def stop(self) -> Stretch:
        torch = self.torch
        torch.cuda.synchronize(self.device)
        self.host_stop = time.perf_counter()
        self.prof.__exit__(None, None, None)
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            self.prof.export_chrome_trace(str(path))
            events = json.loads(path.read_text()).get("traceEvents", [])
        self.prof = None
        return reduce_events(events, self.host_start, self.host_stop)


def reduce_events(events: list, host_start: float, host_stop: float) -> Stretch:
    """The device ops of a chrome trace (ts and dur in microseconds), the
    stretch's bounds on the trace's clock, and the host clock's offset."""
    ops, marker, runtime = [], None, []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime", "cuda_driver"):
            runtime.append(float(e.get("dur", 0)) * 1e-6)
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        op = DeviceOp(e["name"], e["cat"], float(e["ts"]) * 1e-6, float(e.get("dur", 0)) * 1e-6)
        if op.cat == "kernel" and kernel_id(op.name) == MARKER and marker is None:
            marker = op
            continue
        ops.append(op)
    if marker is not None:
        offset = marker.start - host_start
        t0, t1 = marker.start, host_stop + offset
        ops = [op for op in ops if op.start >= t0]
    else:
        offset = None
        t0 = min((op.start for op in ops), default=0.0)
        t1 = max((op.start + op.dur for op in ops), default=0.0)
    return Stretch(ops=ops, t0=t0, t1=t1, host_offset=offset, runtime=runtime)


def breakdown(stretch: Stretch, host_spans: list, top: int = 10) -> dict:
    """The `breakdown` of a traced run: the device ops that took most time
    (by kernel name), and the longest idle gaps named by the host span
    that was open when each began ("host" where none was)."""
    by_name: dict = {}
    for op in stretch.ops:
        key = op.name if op.cat == "kernel" else op.cat
        by_name[key] = by_name.get(key, 0.0) + op.dur
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle_gaps(stretch.ops, stretch.t0, stretch.t1), key=lambda g: g[0] - g[1])
    named = []
    for s, e in gaps[:top]:
        label = "host"
        if stretch.host_offset is not None:
            at = s - stretch.host_offset
            for span_label, h0, h1 in host_spans:
                if h0 <= at < h1:
                    label = span_label
                    break
        named.append([label, e - s])
    return {"device_ops": [[name[:160], secs] for name, secs in device_ops],
            "idle_gaps": named}
