#!/usr/bin/env python3
"""Time the fused field kernels against the layer route at every fused
width above 256, in turns on one CUDA card: the measurement behind the
route question (which widths `fm.field_route` should send where).

    python3 scripts/torch_route_compare.py [--hidden 384 512 ...]

Per width, chip_smoke.py's wide field (hard-blender.yml's fine field at
that width, L 10/4, random weights from the smoke's seed), which the
fused kernels' plans hold (the split plan at 384 and 512, the 2-CTA pair
plan from 640) and `fm.field_route` sends to the fused kernels at 384 and
to the layer route from 512 on, is run through both routes' kernels,
called directly, on the same inputs: the forward at 2048 x 64 and 2048 x
192 points, the backward
at 2048 x 192 and sigma at a 262,144-point grid tile. Each read is timed
in turns, fused, layers, layers, fused (median of 7 calls each by CUDA
events, chip_smoke._median_ms), and the two routes' outputs are held to
each other (forward and sigma within chip_smoke.ATOL; grads' worst
relative error printed). The script only measures: it changes no route.
The card's name and power limit come first, as nvidia-smi prints them;
the table last, one line per width and read.
"""

from __future__ import annotations

import argparse
import gc
import statistics
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from nerfmeshes_tpu_torch.ops.kernels import field_layers as fl  # noqa: E402
from nerfmeshes_tpu_torch.ops.kernels import fused_mlp as fm  # noqa: E402

RAYS = 2048


def reads(packed, device) -> dict:
    """read -> (fused call, layer-route call) on seeded inputs."""
    rng = np.random.default_rng(chip_smoke.SEED)
    out = {}
    for S in (64, 192):
        o, d, z = chip_smoke._rays(RAYS, S, rng, device)
        out[f"fwd {RAYS}x{S}"] = (lambda o=o, d=d, z=z: fm.fused_mlp_cuda(packed, o, d, z),
                                  lambda o=o, d=d, z=z: fl.layers_mlp_cuda(packed, o, d, z))
    cot = torch.from_numpy(rng.standard_normal((4, RAYS, 192)).astype(np.float32)).to(device)
    out[f"bwd {RAYS}x192"] = (  # on the 2048 x 192 rays
        lambda o=o, d=d, z=z: fm.fused_mlp_bwd_cuda(packed, o, d, z, cot),
        lambda o=o, d=d, z=z: fl.layers_bwd_cuda(packed, o, d, z, cot))
    pts = torch.from_numpy(rng.uniform(-chip_smoke.MESH_LIMIT, chip_smoke.MESH_LIMIT,
                                       (chip_smoke.GRID_TILE, 3)).astype(np.float32)).to(device)
    out[f"sigma {chip_smoke.GRID_TILE}"] = (lambda: fm.fused_sigma_cuda(packed, pts),
                                             lambda: fl.layers_sigma_cuda(packed, pts))
    return out


def compare(what: str, fused, layers) -> str:
    """The two routes' outputs held to each other."""
    if what.startswith("bwd"):
        worst = max(float((a - b).abs().max() / (b.abs().max() + 1e-6))
                    for a, b in zip(layers, fused))
        return f"grads' worst rel diff {worst:.3e}"
    err = float((layers - fused).abs().max())
    if err > chip_smoke.ATOL:
        raise AssertionError(f"{what}: the routes differ by {err}")
    return f"max abs diff {err:.3e}"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--hidden", type=int, nargs="+", default=list(chip_smoke.WIDE_HIDDEN))
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_route_compare.py needs a CUDA device")
    from nerfmeshes_tpu_torch.models import build_model
    from nerfmeshes_tpu_torch.train.system import init_params

    card = chip_smoke._run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"]).splitlines()[0]
    print(card)
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    table = []
    for H in opts.hidden:
        cfg = chip_smoke.wide_cfg(H)
        model = build_model(cfg.models.fine_type, dict(cfg.models.fine),
                            compute_dtype=torch.bfloat16)
        init_params(model, None, torch.Generator().manual_seed(chip_smoke.SEED))
        packed = fm.pack_weights(model.to(device).eval())
        del model
        if any(fm.field_plan(packed.spec, k) is None for k in ("fwd", "sigma", "bwd")):
            raise AssertionError(f"the fused kernels' plans refuse H = {H}")
        plan = "pair" if H > 512 else "split"
        print(f"H {H}: fm.field_route takes the {fm.field_route(packed.spec)} route")
        for what, (fused, layers) in reads(packed, device).items():
            check = compare(what, fused(), layers())
            t = [chip_smoke._median_ms(f) for f in (fused, layers, layers, fused)]
            f_ms, l_ms = statistics.median([t[0], t[3]]), statistics.median([t[1], t[2]])
            line = (f"H {H} ({plan} plan) {what}: fused {t[0]:.4f}, {t[3]:.4f} ms; layer route "
                    f"{t[1]:.4f}, {t[2]:.4f} ms; fused / layers {f_ms / l_ms:.3f}; {check}")
            print(f"{line} [{card}]", flush=True)
            table.append(line)
        del packed
        gc.collect()
        torch.cuda.empty_cache()
    print(f"route table (in turns fused, layers, layers, fused; medians of 7) [{card}]:")
    for line in table:
        print("  " + line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
