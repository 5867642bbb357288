#!/usr/bin/env python3
"""Where the zoo models' f32 field leaves chip_smoke.py's 1e-5 bar on the
card: each model in f32 on the card against its CPU run, over many seeds
and repeated calls, and for every excursion (a point past the bar) a
float64 CPU run of the worst point through the same weights.

    python3 scripts/torch_zoo_f32_excursions.py [--seeds 24] [--calls 2] [--models SimpleModel]

Needs a CUDA card; run from the repo root. Each seed s draws the weights
from torch.Generator().manual_seed(s) (init_params) and the points from
numpy's generator seeded s + 7 (chip_smoke._zoo_points' rays; seed 0 is the
smoke's own case). Per excursion it prints the worst point's field on the
card, on the CPU and in float64, every leaf module's largest card - CPU
difference there (chip_smoke.leaf_taps), and for each ReLU's
pre-activation (a SimpleModule with torch.relu) its units nearest 0 in
float64 beside f32's rounding bound there (chip_smoke.relu_margins), and
whether the card and the CPU put the unit on different sides of 0. The
last line says whether every excursion's worst point has such a flipped
unit within the bound.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from nerfmeshes_tpu_torch.models import nerf_models as tm  # noqa: E402
from nerfmeshes_tpu_torch.train.system import init_params  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seeds", type=int, default=24)
    parser.add_argument("--calls", type=int, default=2, help="card calls per seed")
    parser.add_argument("--models", nargs="*", default=["SimpleModel"])
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    bar = cs.ZOO_FIELD_TOL["float32"]
    verdicts = []
    for name in opts.models:
        for seed in range(opts.seeds):
            cpu = tm.build_model(name, {}, compute_dtype=torch.float32)
            init_params(cpu, None, torch.Generator().manual_seed(seed))
            card = tm.build_model(name, {}, compute_dtype=torch.float32)
            card.load_state_dict(cpu.state_dict())
            card.to(dev)
            pts, dirs = cs._zoo_points(dev, seed + 7)
            want, _ = cs._zoo_step(cpu, pts.cpu(), dirs.cpu())
            want = want.float().reshape(-1, want.shape[-1])
            calls = []
            for _ in range(opts.calls):
                card.zero_grad(set_to_none=True)
                got, _ = cs._zoo_step(card, pts, dirs)
                calls.append(got.cpu().float().reshape(-1, got.shape[-1]))
            same = all(torch.equal(calls[0], c) for c in calls[1:])
            excess = ((calls[0] - want).abs() / (1.0 + want.abs())).amax(-1)  # per point
            worst = int(excess.argmax())
            print(f"{name} seed {seed}: {opts.calls} card calls bitwise equal {same}; worst "
                  f"|card - cpu| / (1 + |cpu|) {float(excess[worst]):.3e} at point {worst} "
                  f"(bar {bar}); {int((excess > bar).sum())} of {excess.numel()} points past it",
                  flush=True)
            if float(excess[worst]) <= bar:
                continue
            rows = torch.tensor([worst])
            rec_cpu, h_cpu = cs.leaf_taps(cpu, rows)
            rec_card, h_card = cs.leaf_taps(card, rows.to(dev))
            with torch.no_grad():
                cpu(pts.cpu(), dirs.cpu())
                card(pts, dirs)
            for h in h_cpu + h_card:
                h.remove()
            p1 = pts.reshape(-1, 3)[worst:worst + 1].cpu()
            d1 = dirs.reshape(-1, 3)[worst:worst + 1].cpu()
            f64, near, margins = cs.relu_margins(cpu, p1, d1, detail=True)
            print(f"  worst point: card {calls[0][worst].tolist()}, cpu {want[worst].tolist()}, "
                  f"float64 {f64[0].tolist()}")
            for mod in rec_cpu:
                if mod not in rec_card:
                    continue
                d_cc = float((rec_card[mod] - rec_cpu[mod]).abs().max())
                print(f"  {mod}: max |card - cpu| {d_cc:.3e}")
            flipped_within = False
            for mod, (z, bound) in margins.items():
                z_cpu = rec_cpu[f"{mod}.linear"][0]
                z_card = rec_card[f"{mod}.linear"][0]
                order = torch.argsort(z[0].abs())[:3]
                for u in order.tolist():
                    flip = bool((z_cpu[u] > 0) != (z_card[u] > 0))
                    within = bool(abs(z[0, u]) <= bound[0, u])
                    flipped_within |= flip and within
                    print(f"  {mod} unit {u}: float64 {float(z[0, u]):.3e}, cpu "
                          f"{float(z_cpu[u]):.3e}, card {float(z_card[u]):.3e}, f32 rounding "
                          f"bound {float(bound[0, u]):.3e}; sides differ {flip}")
                flips = int(((z_cpu > 0) != (z_card > 0)).sum())
                print(f"  {mod}: {flips} units on different sides of 0 on card and cpu")
            print(f"  near zero within the bound at this point: {bool(near[0])}; a flipped "
                  f"unit within the bound: {flipped_within}")
            verdicts.append(flipped_within)
    print(f"excursions: {len(verdicts)}; every one a ReLU flipped within f32 rounding of 0: "
          f"{bool(verdicts) and all(verdicts)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
