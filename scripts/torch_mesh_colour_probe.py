#!/usr/bin/env python3
"""Probe chip_smoke.py's mesh colour check of one wide_phase width on a
CUDA card: train the width's hard-blender field as wide_phase does (3 + 30
steps on its route), mesh it at WIDE_MESH_RES, and hold every vertex's
colour, not only the smoke's three 2048-vertex slices, against the
nn.Module render of the same ray; then, for the worst vertex, the coarse
and fine passes of both paths step by step: the fine samples' depths, the
fields on the same depths (route, fused kernel, plain version, nn.Module,
and the nn.Module's weights in float64), the last samples' raw sigma and
the samples whose raw sigma has another sign on the route than in the
nn.Module (the renderer's 1e10 last interval turns a sign into an
opacity of 1).

    python3 scripts/torch_mesh_colour_probe.py [H]      # default 640; needs a card
"""

from __future__ import annotations

import copy
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from nerfmeshes_tpu_torch.mesh.extract import export_marching_cubes  # noqa: E402
from nerfmeshes_tpu_torch.ops.kernels import fused_mlp as fm  # noqa: E402
from nerfmeshes_tpu_torch.ops.render import volume_render  # noqa: E402
from nerfmeshes_tpu_torch.ops.sampling import (  # noqa: E402
    hierarchical_intervals,
    ray_sample_interval,
)
from nerfmeshes_tpu_torch.train.render import (  # noqa: E402
    RenderSettings,
    _apply_field,
    render_rays,
)


def float64_copy(model):
    """The model's weights in float64, computing in float64."""
    out = copy.deepcopy(model).double()
    for mod in out.modules():
        if hasattr(mod, "compute_dtype"):
            mod.compute_dtype = torch.float64
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("torch_mesh_colour_probe.py needs a CUDA device")
    hidden = int(sys.argv[1]) if len(sys.argv) > 1 else 640
    device = torch.device("cuda")
    card = cs._run(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]).splitlines()[0]
    print(card)
    cfg = cs.wide_cfg(hidden)
    route = "fused" if hidden in fm.FUSED_WIDTHS else "layers"  # wide_phase's routes
    system = cs.train_phase(card, device, cfg, route=route).pop("system")
    with tempfile.TemporaryDirectory() as tmp:
        args = cs._mesh_args(tmp, res=cs.WIDE_MESH_RES[hidden])
        verts, _, colors, normals = export_marching_cubes(system, args)
    module = RenderSettings.from_cfg(cfg, train=False)._replace(use_fused_kernel=False)
    far = args.view_disparity_max_bound
    diffs = []
    for start in range(0, len(verts), 2048):
        rows = slice(start, start + 2048)
        d = torch.as_tensor(-normals[rows], dtype=torch.float32, device=device)
        o = torch.as_tensor(verts[rows], dtype=torch.float32, device=device) \
            - args.view_disparity * d
        with torch.inference_mode():
            rgb = render_rays(system.coarse, system.fine, o, d, 0.0, far, module,
                              train=False)[1].rgb_map
        ref = (torch.round(rgb.clamp(0.0, 1.0) * 255.0) / 255.0).cpu().numpy()
        diffs.append(np.abs(colors[rows] - ref).max(1))
    diffs = np.concatenate(diffs)
    bar = cs.ATOL + 1.0 / 255.0
    print(f"w{hidden}: {len(verts)} vertices; colours against the nn.Module render: max "
          f"{diffs.max():.4e}, {int((diffs > bar).sum())} past the bar {bar:.4f}; quantiles "
          f"0.99 {np.quantile(diffs, 0.99):.3e}, 0.999 {np.quantile(diffs, 0.999):.3e} [{card}]")

    v = int(np.argmax(diffs))
    d = torch.as_tensor(-normals[v:v + 1], dtype=torch.float32, device=device)
    o = torch.as_tensor(verts[v:v + 1], dtype=torch.float32, device=device) \
        - args.view_disparity * d
    packed = fm.pack_weights(system.fine)
    fine64 = float64_copy(system.fine)
    with torch.inference_mode():
        coarse_z = ray_sample_interval(module.num_coarse, 1, 0.0, far, lindisp=module.lindisp,
                                       perturb=False, generator=None, dtype=d.dtype,
                                       device=device)

        def composite(field, depths, dirs):
            return volume_render(field, depths, dirs, train=False, radiance_field_noise_std=0.0,
                                 white_background=module.white_background,
                                 attenuation_threshold=module.attenuation_threshold,
                                 generator=None, channels_first=True)

        fine_z = {}
        for name, fused in (("nn.Module", False), ("route", True)):
            coarse = composite(_apply_field(system.coarse, o, d, coarse_z, use_fused=fused,
                                            inference=True), coarse_z, d)
            fine_z[name] = hierarchical_intervals(coarse_z, coarse.weights, module.num_fine,
                                                  perturb=False, generator=None)
        print(f"vertex {v}: colour diff {diffs[v]:.4f}; fine depths, max |nn.Module - route| "
              f"{float((fine_z['nn.Module'] - fine_z['route']).abs().max()):.4e}")
        for name, z in fine_z.items():
            mod = _apply_field(system.fine, o, d, z, use_fused=False, inference=True)
            route = _apply_field(system.fine, o, d, z, use_fused=True, inference=True)
            plain = fm.fused_mlp_plain(packed, o, d, z)
            truth = _apply_field(fine64, o.double(), d.double(), z.double(), use_fused=False,
                                 inference=True)
            flips = ((mod[3, 0] > 0) != (route[3, 0] > 0)).nonzero().flatten().tolist()
            print(f"  on the {name}'s fine depths: fields max |nn.Module - route| "
                  f"{float((mod - route).abs().max()):.3e}, |route - plain| "
                  f"{float((route - plain).abs().max()):.3e}, |float64 - nn.Module| "
                  f"{float((truth - mod.double()).abs().max()):.3e}, |float64 - route| "
                  f"{float((truth - route.double()).abs().max()):.3e}; acc nn.Module "
                  f"{float(composite(mod, z, d).acc_map[0]):.4f}, route "
                  f"{float(composite(route, z, d).acc_map[0]):.4f}, float64 "
                  f"{float(composite(truth, z.double(), d.double()).acc_map[0]):.4f}")
            print(f"    last 3 raw sigma: float64 {truth[3, 0, -3:].tolist()}, nn.Module "
                  f"{mod[3, 0, -3:].tolist()}, route {route[3, 0, -3:].tolist()}; samples of "
                  f"another sign on the route {flips} (float64 there "
                  f"{[float(truth[3, 0, i]) for i in flips]})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
