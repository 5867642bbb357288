"""Training cells: NeRFSystem's train call (make_train_step's multi_step,
`steps_per_call` optimizer steps) back to back, as NeRFSystem.fit calls
it, with the metrics read to the host at the config's print cadence.

Set-up builds the system on the benchmark's data and weights and makes
its first call, which warms every shape of the window. That call's first
three steps are what the reference follows, on the random numbers the
program drew in them: each step's loss, the first step's maps and the
loss taken of them, the first gradient as Adam got it, the parameters'
change after the three. The window then drives the same system object.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from harness import faults, program, reference, scene, spec
from harness.flops import forward_flops_per_ray
from harness.readers import TraceContext
from harness.window import (Outcome, SetupLegs, TracedStretch, free, memory_peak, now,
                            overhead_note, sync, thread_cpu)

CHECKED_STEPS = 3
# Leaves whose first gradient in the reference is under this share of the
# median leaf's move under Adam by round-off alone: their change is not
# compared.
MOVING_LEAF = 1e-3


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, device, process_age,
        fault: str | None = None) -> Outcome:
    legs = SetupLegs(process_age)
    legs.built = program.load_kernels(device)
    legs.mark("kernels")
    cfg = spec.program_cfg(cell, seed)
    data = scene.train_data(cell.config["scene"], seed, device)
    weights = scene.initial_weights(cfg["models"], seed, device)
    sync(device)
    legs.mark("data")
    system = program.build_system(cfg, weights, device, train_data=data)
    undo = faults.apply(fault, system) if fault is not None else None
    sync(device)
    legs.mark("system")
    probe = program.StepProbe(system, steps=CHECKED_STEPS)
    system.state, metrics = system._train_fn(system.state, system._data)
    probe.close()
    sync(device)
    setup_s = process_age()
    legs.mark("first_call")

    spc = int(cfg["experiment"]["steps_per_call"])
    rays = int(cfg["nerf"]["train"]["num_random_rays"])
    print_every = int(cfg["experiment"]["print_every"])
    calls, failed, enqueue, walls, spans = 0, 0, [], [], []
    start = now()
    traced = TracedStretch(trace, device, start, seconds)
    while True:
        traced.boundary(now(), program.launch_counts)
        t0 = now()
        if t0 >= start + seconds:
            break
        c0 = thread_cpu()
        system.state, metrics = system._train_fn(system.state, system._data)
        c1, t1 = thread_cpu(), now()
        calls += 1
        traced.count(spc)
        spans.append(("train_call", t0, t1))
        if not traced.active:
            enqueue.append((c1 - c0) / spc)
            walls.append((t1 - t0) / spc)
        step = system.state.step
        if step % print_every < spc:
            loss = float(metrics["train/loss"])
            spans.append(("metrics_read", t1, now()))
            if not math.isfinite(loss):
                failed += spc
    traced.finish(program.launch_counts)
    if undo is not None:
        undo()
    sync(device)
    end = now()
    peak = memory_peak(device)
    window_s = end - start

    per_ray = forward_flops_per_ray(cfg, train=True)
    ctx = None
    if traced.stretch is not None:
        ctx = TraceContext(stretch=traced.stretch, units=traced.units,
                           forward_flops=float(rays * per_ray),
                           window_s=window_s - traced.spent,
                           window_model_flops=3.0 * rays * per_ray * (calls * spc - traced.units),
                           enqueue_s=enqueue, host_wall_s=walls, host_spans=spans,
                           launches=traced.launches)

    losses = [float(v) for v in probe.losses]
    first_maps = probe.first_maps
    first_grads = probe.first_grads()
    after = probe.params_after
    notes = []
    try:
        draws = [reference.assign_draws(records, cfg, rays) for records in probe.draws]
    except ValueError as err:  # the program did not draw a whole step's numbers
        draws = None
        notes.append(str(err))
    del system, metrics, probe
    free(device)
    if draws is None:
        checks = [("draws_missing", 1.0, 0.0)]
    else:
        checks = compare(cell, cfg, weights, data, draws, losses, first_maps, first_grads, after)
    return Outcome(
        end_to_end={"train_rays_per_s": calls * spc * rays / window_s, "setup_s": setup_s},
        attempted=calls * spc, failed=failed, memory_peak=peak, checks=checks, trace=ctx,
        setup=legs.summary(),
        notes=notes + [legs.note(), f"window: {calls} calls of {spc} steps of {rays} rays in {window_s:.4f} s",
               "call ms: " + " ".join(f"{1e3 * (t1 - t0):.1f}" for label, t0, t1 in spans
                                      if label == "train_call")]
        + overhead_note(traced, calls * spc, window_s, "steps"))


def readings(cfg: dict, weights: dict, data: dict, draws: list, losses: list, first_maps: tuple,
             first_grads: dict, after: dict, precision: str = "f32") -> dict:
    """The numbers compared: the program's (losses, first_maps,
    first_grads, after) against the reference's steps at `precision` from
    the same weights and data, on the steps' (image, pixels, Draws)
    `draws`. `loss_map_gap` holds the program's first loss to the loss of
    its own first maps against the reference's targets for those rays:
    the loss is taken over every ray that was rendered."""
    reference.set_true_f32()
    ref = reference.train_steps(weights, cfg, data, draws, precision=precision)
    loss_gaps = [reference.relative_gap(p, r) for p, r in zip(losses, ref.losses)]
    of_maps = reference.map_loss(first_maps, ref.first_targets)
    loss_map_gap = (reference.relative_gap(losses[0], of_maps) if math.isfinite(of_maps)
                    else math.inf)
    grad = reference.leaf_gaps(first_grads, ref.first_grads)
    ref_norms = {k: float(torch.linalg.vector_norm(g)) for k, g in ref.first_grads.items()}
    median = sorted(ref_norms.values())[len(ref_norms) // 2]
    moving = {k for k, v in ref_norms.items() if v >= MOVING_LEAF * median}
    change = reference.leaf_gaps({k: after[k] - weights[k] for k in moving},
                                 {k: ref.params[k] - weights[k] for k in moving})
    return {
        **reference.map_gaps(first_maps, ref.first_maps),
        "loss_gap": max(loss_gaps),
        "loss_map_gap": loss_map_gap,
        "first_loss_gap": loss_gaps[0],
        "grad_gap": max(grad.values()),
        "grad_gap_median": float(np.median(list(grad.values()))),
        "change_gap": max(change.values()),
        "change_gap_median": float(np.median(list(change.values()))),
        "leaves_not_moving": float(len(ref_norms) - len(moving)),
        "losses": {"program": losses, "reference": ref.losses},
    }


def compare(cell, cfg, weights, data, draws, losses, first_maps, first_grads, after) -> list:
    """Every number of readings() that the cell's limits name, beside its
    limit; the others beside None (printed, not compared)."""
    got = readings(cfg, weights, data, draws, losses, first_maps, first_grads, after)
    return [(name, value, cell.limits.get(name)) for name, value in got.items()
            if isinstance(value, float)]
