"""Rendering cells: one client in a closed loop renders the scene's views
in turn through NeRFSystem.query_rays, as the eval CLI calls it, and
fetches each view's rgb map to the host. A view is timed from its rays'
hand-off to its map on the host.

Set-up builds the system with the benchmark's weights, makes every
view's rays, and renders one view (the one before the window's first),
which warms every shape of the window. After the window the reference
renders a sample of the pixels of the views finished in it, drawn from
the seed, and the program's maps are held to it.
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from harness import faults, program, reference, scene, spec
from harness.flops import forward_flops_per_ray
from harness.readers import TraceContext
from harness.window import (Outcome, SetupLegs, TracedStretch, free, memory_peak, now,
                            overhead_note, percentile, sync, thread_cpu)

# Pixels of each finished view that the check may compare.
CANDIDATES = 2048


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, device, process_age,
        fault: str | None = None) -> Outcome:
    legs = SetupLegs(process_age)
    legs.built = program.load_kernels(device)
    legs.mark("kernels")
    cfg = spec.program_cfg(cell, seed)
    scene_cfg = cell.config["scene"]
    H, W, _ = scene.hwf(scene_cfg)
    near, far = (float(v) for v in scene_cfg["bounds"])
    chunk = int(cell.traffic["chunk"])
    views = scene.view_rays(scene_cfg, scene.view_poses(scene_cfg, seed, device),
                            bool(cfg["dataset"]["use_ndc"]))
    weights = scene.initial_weights(cfg["models"], seed, device)
    sync(device)
    legs.mark("data")
    system = program.build_system(cfg, weights, device)
    undo = faults.apply(fault, system) if fault is not None else None
    sync(device)
    legs.mark("system")

    def render_view(v: int):
        origins, directions = views[v]
        t0, c0 = now(), thread_cpu()
        out = system.query_rays(origins, directions, near, far, chunk=chunk,
                                fields=("rgb_map",), as_numpy=False)
        c1, t1 = thread_cpu(), now()
        rgb = out.rgb_map.cpu().numpy()
        return rgb, t0, t1, now(), c1 - c0

    first = int(np.random.default_rng(scene.sub_seed(seed, "first-view")).integers(len(views)))
    render_view((first - 1) % len(views))
    sync(device)
    setup_s = process_age()
    legs.mark("first_call")

    pixel_seed = scene.sub_seed(seed, "check-pixels")
    finished, latency, enqueue, walls, spans = [], [], [], [], []
    gc_before = gc.get_stats()
    start = now()
    traced = TracedStretch(trace, device, start, seconds)
    end = start
    while True:
        traced.boundary(now(), program.launch_counts)
        if now() >= start + seconds:
            break
        v = (first + len(finished)) % len(views)
        rgb, t0, t1, t2, cpu = render_view(v)
        traced.count(1)
        finished.append(candidates(v, rgb, pixel_seed, len(finished)))
        latency.append(t2 - t0)
        spans += [("query_rays", t0, t1), ("fetch", t1, t2)]
        if not traced.active:
            enqueue.append(cpu)
            walls.append(t1 - t0)
        end = t2
    traced.finish(program.launch_counts)
    if undo is not None:
        undo()
    peak = memory_peak(device)
    window_s = end - start

    per_ray = forward_flops_per_ray(cfg, train=False)
    ctx = None
    if traced.stretch is not None:
        ctx = TraceContext(stretch=traced.stretch, units=traced.units,
                           forward_flops=float(H * W * per_ray),
                           window_s=window_s - traced.spent,
                           window_model_flops=float((len(finished) - traced.units) * H * W
                                                    * per_ray),
                           enqueue_s=enqueue, host_wall_s=walls, host_spans=spans,
                           launches=traced.launches)
    del system
    free(device)
    checks = compare(cell, cfg, weights, views, finished, seed, near, far)
    return Outcome(
        end_to_end={"render_rays_per_s": len(finished) * H * W / window_s,
                    "render_view_ms_p90": 1e3 * percentile(latency, 90),
                    "setup_s": setup_s},
        attempted=len(finished), failed=0, memory_peak=peak, checks=checks, trace=ctx,
        setup=legs.summary(),
        notes=[legs.note(), f"window: {len(finished)} views of {H}x{W} in {window_s:.4f} s, "
               f"median view {1e3 * percentile(latency, 50):.4f} ms",
               latency_note(latency, [v for v, _, _ in finished], gc_before)]
        + overhead_note(traced, len(finished), window_s, "views"))


def latency_note(latency: list, views: list, gc_before: list) -> str:
    """The views' latency quantiles, the views more than 1 ms over the
    median (how many, and their view ids), and the collections of
    Python's garbage collector in the window."""
    ms = [1e3 * t for t in latency]
    qs = {q: percentile(ms, q) for q in (10, 50, 80, 85, 90, 95, 99)}
    slow = [v for v, t in zip(views, ms) if t > qs[50] + 1.0]
    counts = np.bincount(slow) if slow else np.zeros(1, int)
    top = np.argsort(-counts)[:8]
    collected = [after["collections"] - before["collections"]
                 for before, after in zip(gc_before, gc.get_stats())]
    return ("view ms quantiles " + " ".join(f"p{q} {v:.3f}" for q, v in qs.items())
            + f" max {max(ms):.3f}; over median + 1 ms: {len(slow)} of {len(ms)}, views "
            + " ".join(f"{v}x{counts[v]}" for v in top if counts[v])
            + f"; gc collections by generation {collected}")


def candidates(view: int, rgb: np.ndarray, pixel_seed: int, position: int):
    """What the check keeps of the view finished at `position` in the
    window: CANDIDATES of its pixels, drawn from the seed, and the
    program's rgb there. The map itself is let go, as a user's would be."""
    pix = np.random.default_rng([pixel_seed, position]).integers(rgb.shape[0], size=CANDIDATES)
    return view, pix, rgb[pix]


def sample(finished: list, seed: int, count: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(view ids, pixels, the program's rgb there) of `count` of the
    finished views' candidate pixels, drawn from the seed."""
    ids = np.repeat([v for v, _, _ in finished], CANDIDATES)
    pix = np.concatenate([p for _, p, _ in finished])
    rgb = np.concatenate([c for _, _, c in finished])
    rng = np.random.default_rng(scene.sub_seed(seed, "check-sample"))
    rows = rng.choice(len(ids), size=min(count, len(ids)), replace=False)
    return ids[rows], pix[rows], rgb[rows]


def reference_rgb(cfg: dict, weights: dict, views: list, ids: np.ndarray, pix: np.ndarray,
                  near: float, far: float, precision: str = "f32") -> np.ndarray:
    """The reference's rgb at pixels `pix` of views `ids`."""
    reference.set_true_f32()
    out = np.empty((len(ids), 3), np.float32)
    device = views[0][1].device
    for v in np.unique(ids):
        rows = np.nonzero(ids == v)[0]
        at = torch.as_tensor(pix[rows], device=device)
        origins, directions = views[v]
        out[rows] = reference.render_rays(weights, cfg, origins[at], directions[at], near, far,
                                          precision=precision).cpu().numpy()
    return out


def gaps(program_rgb: np.ndarray, reference_rgb: np.ndarray) -> dict:
    """The numbers compared: the median, the 90th, 99th and 99.9th
    percentiles, the widest and the root-mean-square gap, over every
    channel of every pixel of the sample."""
    gap = np.abs(program_rgb - reference_rgb).reshape(-1)
    return {"rgb_median_gap": float(np.median(gap)),
            "rgb_p90_gap": float(np.quantile(gap, 0.9)),
            "rgb_max_gap": float(gap.max()),
            "rgb_rms_gap": float(np.sqrt(np.mean(gap.astype(np.float64) ** 2))),
            "rgb_p99_gap": float(np.quantile(gap, 0.99)),
            "rgb_p999_gap": float(np.quantile(gap, 0.999))}


def compare(cell, cfg, weights, views, finished, seed, near, far) -> list:
    """Every number of gaps() beside its limit in the cell's limits (None:
    printed, not compared)."""
    if not finished:
        return [("no_view_finished", 1.0, 0.0)]
    ids, pix, rgb = sample(finished, seed, int(cell.traffic["check_rays"]))
    got = gaps(rgb, reference_rgb(cfg, weights, views, ids, pix, near, far))
    return [(name, value, cell.limits.get(name)) for name, value in got.items()]
