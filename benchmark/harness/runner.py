"""One run of one cell: the kind of cell drives the program, the checks
decide `correct`, the readers give the per-layer metrics, and the result
is one JSON line."""

from __future__ import annotations

import importlib
import json
import math
import os
import sys

from harness import spec

BANNED = ("jax", "jaxlib", "flax", "nerfmeshes_tpu")


def process_age() -> float:
    """Seconds since this process started: /proc's start time against the
    uptime clock (10 ms ticks)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def banned_modules(modules=None) -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's, flax's
    or the JAX package's (nerfmeshes_tpu_torch is not nerfmeshes_tpu)."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".", 1)[0] in BANNED})


def run_outcome(cell: spec.Cell, seed: int, seconds: float, trace: bool, device="cuda",
                fault: str | None = None):
    """The Outcome of one run of `cell`, by its kind (harness/kind_<kind>.py)."""
    kind = importlib.import_module(f"harness.kind_{cell.kind}")
    return kind.run(cell, seed, seconds, trace, device, process_age, fault=fault)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device="cuda",
             fault: str | None = None, cell: spec.Cell | None = None):
    """(result dict, stderr lines) of one run."""
    cell = cell or spec.load_cell(name)
    outcome = run_outcome(cell, seed, seconds, trace, device, fault)
    return result_of(cell, outcome, trace, device)


def result_of(cell: spec.Cell, outcome, trace: bool, device):
    import torch

    lines = list(outcome.notes)
    if trace:
        metrics = {}
        ctx = outcome.trace
        for entry in cell.per_layer:
            value = spec.load_reader(entry["name"]).read(ctx) if ctx is not None else None
            if value is not None:
                metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    else:
        metrics = {}
        for entry in cell.end_to_end:
            if entry["name"] not in outcome.end_to_end:
                raise KeyError(f"{cell.kind} cells do not measure {entry['name']}")
            metrics[entry["name"]] = {"value": outcome.end_to_end[entry["name"]],
                                      "unit": entry["unit"]}
    cuda = torch.device(device).type == "cuda"
    info = {"platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
            "count": cell.chips, "memory_peak_bytes": outcome.memory_peak}
    result = {"correct": False, "attempted": outcome.attempted, "failed": outcome.failed,
              "metrics": metrics, "device": info}
    if trace and outcome.trace is not None:
        from harness import devtrace

        stretch = outcome.trace.stretch
        busy = devtrace.union_seconds((op.start, op.start + op.dur) for op in stretch.ops)
        info.update(busy_s=busy, window_s=stretch.seconds)
        result["breakdown"] = devtrace.breakdown(stretch, outcome.trace.host_spans)
        lines += kernel_lines(outcome.trace)
    result["setup"] = outcome.setup
    checks, correct = {}, outcome.failed == 0 and outcome.attempted > 0
    for check, value, limit in outcome.checks:
        if limit is None:
            lines.append(f"reading {check}: {value!r} (not compared)")
            continue
        checks[check] = {"value": value, "limit": limit}
        if not (math.isfinite(value) and value <= limit):
            correct = False
    if not checks:
        correct = False
    result["correct"] = correct
    result["checks"] = checks
    lines += [f"check {k}: {v['value']!r} limit {v['limit']!r}" for k, v in checks.items()]
    return result, lines


def kernel_lines(ctx) -> list:
    """Each kernel of the traced stretch with its launches and seconds,
    and the program's launch counters over the stretch."""
    from harness import devtrace

    by_name: dict = {}
    for op in ctx.stretch.kernels():
        n, secs = by_name.get(op.name, (0, 0.0))
        by_name[op.name] = (n + 1, secs + op.dur)
    rt = sorted(ctx.stretch.runtime)
    lines = [f"traced {ctx.units} units in {ctx.stretch.seconds:.6f} s; launch counters "
             f"{json.dumps(ctx.launches)}; CUDA runtime calls on the host: {len(rt)}, "
             f"{sum(rt):.6f} s, median {rt[len(rt) // 2] if rt else 0.0:.6f} s, "
             f"longest {rt[-1] if rt else 0.0:.6f} s"]
    if ctx.enqueue_s and ctx.host_wall_s:
        lines.append(f"host a unit inside the program's call, outside the stretch: thread CPU "
                     f"{1e3 * sum(ctx.enqueue_s) / len(ctx.enqueue_s):.4f} ms, wall "
                     f"{1e3 * sum(ctx.host_wall_s) / len(ctx.host_wall_s):.4f} ms")
    for name, (n, secs) in sorted(by_name.items(), key=lambda kv: -kv[1][1]):
        lines.append(f"kernel {devtrace.kernel_id(name)} x{n} {secs:.6f} s: {name[:200]}")
    return lines
