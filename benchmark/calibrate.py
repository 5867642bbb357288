"""Readings that the limits of `correct` are set from, for one cell, in
one process on a CUDA card (the benchmark's runs never run this):

- the program's numbers over many seeds (each a full run of the cell
  with a short window, its checks as a run prints them);
- the control's: the reference put in the program's place, computed in
  fp8 (reference.py's precision="fp8"), on other seeds;
- the faults of harness/faults.py planted under the timed path.

    python3 benchmark/calibrate.py --workload lego.train --seeds 1-12 \
        --control-seeds 101-103 --fault-seeds 201-203 --seconds 3

Writes one JSON line per reading to --out and prints a summary.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def seeds(text: str) -> list:
    out = []
    for part in filter(None, text.split(",")):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def control_train(cell, seed: int, device) -> dict:
    from harness import kind_train, reference, scene, spec

    cfg = spec.program_cfg(cell, seed)
    data = scene.train_data(cell.config["scene"], seed, device)
    weights = scene.initial_weights(cfg["models"], seed, device)
    draws = control_draws(cfg, data, seed, device)
    reference.set_true_f32()
    low = reference.train_steps(weights, cfg, data, draws, precision="fp8")
    return kind_train.readings(cfg, weights, data, draws, low.losses, low.first_maps,
                               low.first_grads, low.params)


def control_draws(cfg: dict, data: dict, seed: int, device) -> list:
    """The control's draws for kind_train.CHECKED_STEPS steps, from a
    generator of the benchmark's seeded `seed`: the control and the
    reference it is held to take the same ones."""
    from harness import kind_train, reference, scene

    gen = scene.generator(seed, "control-draws", device)
    H, W, _ = data["hwf"]
    rays = int(cfg["nerf"]["train"]["num_random_rays"])
    return [reference.seeded_draws(gen, cfg, data["poses"].shape[0], H, W, rays, device)
            for _ in range(kind_train.CHECKED_STEPS)]


def control_render(cell, seed: int, device, views_in_run: int) -> dict:
    import numpy as np

    from harness import kind_render, scene, spec

    cfg = spec.program_cfg(cell, seed)
    sc = cell.config["scene"]
    near, far = (float(v) for v in sc["bounds"])
    views = scene.view_rays(sc, scene.view_poses(sc, seed, device), bool(cfg["dataset"]["use_ndc"]))
    weights = scene.initial_weights(cfg["models"], seed, device)
    first = int(np.random.default_rng(scene.sub_seed(seed, "first-view")).integers(len(views)))
    H, W, _ = scene.hwf(sc)
    # The views a run of the cell finishes, with placeholder maps: sample()
    # draws the same pixels from them that a run would.
    pixel_seed = scene.sub_seed(seed, "check-pixels")
    blank = np.zeros((H * W, 3), np.float32)
    finished = [kind_render.candidates((first + k) % len(views), blank, pixel_seed, k)
                for k in range(views_in_run)]
    ids, pix, _ = kind_render.sample(finished, seed, int(cell.traffic["check_rays"]))
    low = kind_render.reference_rgb(cfg, weights, views, ids, pix, near, far, precision="fp8")
    ref = kind_render.reference_rgb(cfg, weights, views, ids, pix, near, far)
    return kind_render.gaps(low, ref)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--fault-seeds", default="")
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--views-in-run", type=int, default=100,
                        help="views a run of a render cell finishes (for the control's sample)")
    parser.add_argument("--out", default="chiprun_out/calibrate")
    parser.add_argument("--device", default="cuda:0")
    args = parser.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(BENCH_DIR)]
    import torch

    from harness import faults, runner, spec, window

    device = args.device
    if device.startswith("cuda") and not torch.cuda.is_available():
        print("no CUDA card here", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    out_dir = ROOT / args.out
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{args.workload}.jsonl"
    rows = []

    def record(mode, seed, numbers, extra=None):
        row = {"mode": mode, "seed": seed, **numbers, **(extra or {})}
        rows.append(row)
        with path.open("a") as f:
            f.write(json.dumps(row) + "\n")
        shown = {k: v for k, v in numbers.items() if isinstance(v, float)}
        print(mode, seed, json.dumps(shown), flush=True)

    plan = [("program", s, None) for s in seeds(args.seeds)]
    plan += [(f"fault:{f}", s, f) for f in faults.FAULTS[cell.kind] for s in seeds(args.fault_seeds)]
    for mode, seed, fault in plan:
        t = time.perf_counter()
        outcome = runner.run_outcome(cell, seed, args.seconds, False, device, fault)
        result, _ = runner.result_of(cell, outcome, False, device)
        numbers = {name: value for name, value, _ in outcome.checks}
        record(mode, seed, numbers, {"correct": result["correct"],
                                     "attempted": result["attempted"],
                                     "seconds": time.perf_counter() - t})
        window.free(device)
    for seed in seeds(args.control_seeds):
        if cell.kind == "train":
            got = control_train(cell, seed, device)
        else:
            got = control_render(cell, seed, device, args.views_in_run)
        record("control", seed, {k: v for k, v in got.items() if isinstance(v, float)})
        window.free(device)

    names = sorted({k for r in rows for k, v in r.items() if isinstance(v, float)
                    and k != "seconds"})
    for mode in dict.fromkeys(r["mode"] for r in rows):
        picked = [r for r in rows if r["mode"] == mode]
        print(f"== {mode} ({len(picked)} seeds)")
        for name in names:
            vals = [r[name] for r in picked if name in r]
            if vals:
                print(f"  {name}: min {min(vals):.6g} max {max(vals):.6g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
