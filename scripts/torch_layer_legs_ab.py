#!/usr/bin/env python3
"""Time the layer route's backward, its dW leg, PE kernel, heads kernel and
reductions of several source trees against each other on one CUDA card, in
turns; and the dW leg alone in this tree's launch against the launch before
it, with probes of what bounds it.

    python3 scripts/torch_layer_legs_ab.py OLD NEW NEW OLD [--cases w512 ...]

Each argument is the root of a checkout of this repository (for example a
`git archive` of another commit unpacked under build/). Its
`nerfmeshes_tpu_torch/csrc/field_layers.cu` is compiled alone, with the
flags of this tree's build (scripts/torch_layer_product_ab.py's
compile_tree), and its nm_field_layers is called through this tree's
wrappers (ops/kernels/field_layers.py, `lib=`; the C contract is the same
in every tree but for the launch counts, which this tree's array of
len(fl.KERNELS) holds for a tree with fewer counters too; the workspace
this tree's, which holds every tree's layout). Cases (CASES): chip_smoke.py's 8-layer
L 10/4 fields at 512 and
1024 wide (wide_cfg) and its layer cases 8x1024 at L 16/4, 8x2048 and
16x256 (layer_cfg), at 2048 x 192 points (16x256: 2048 x 64).

Per case and tree it checks the forward (the case's rays), sigma (65,536
points), every dW and the dir layer's cotangent dy_dir (the heads' output,
of the call's last slab, read from the workspace) bitwise against the
first tree, and prints dB's and dW's largest difference. Then, per turn (tree), case
and read, the median of 7: the backward call by CUDA events
(chip_smoke._median_ms); by torch.profiler, in device ms per call
(chip_smoke._device_ms_per_call over 7 calls) with their launches per
call, its dW leg (dw_kernel or layer_dw_kernel and the range
reductions), its PE kernel, its heads kernel and its reductions (the dW
partials' reduce_rows_kernel and the bias grads' bias_grads_kernel, where
a tree has it); and the PE kernel alone (fl.layers_pe_cuda through the
tree's nm_field_layers_pe, 20 launches back to back). Then, per read,
each tree's values over its turns, their median and spread (max - min).

The dW leg alone (fl.layers_dw_launcher, this tree's build) on a trunk
matrix and the skip's [x | PE] of each case's backward slab, in turns
(old, new, new, old): "old" is the launch the route made before this
tree's (the fused backward's dw_kernel, a CTA a unit, job-major units),
"new" this tree's (layer_dw_kernel: whole waves, then the last wave in
column pieces), both on ranges_for's point ranges, their bits compared;
once each, the probes: the new kernel without pieces (every unit at 256
columns), the old kernel on as many ranges as one wave of
units takes, and the new kernel with every range reading the first
range's points (its slabs from L2: what the leg's device-memory bytes
cost). The card's name and power limit come first, as nvidia-smi prints
them.
"""

from __future__ import annotations

import argparse
import ctypes
import gc
import statistics
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

import chip_smoke  # noqa: E402
from nerfmeshes_tpu_torch.ops.kernels import build  # noqa: E402
from nerfmeshes_tpu_torch.ops.kernels import field_layers as fl  # noqa: E402
from torch_layer_product_ab import compile_tree, load  # noqa: E402

CASES = {"w512": (512, None, 192), "w1024": (1024, None, 192),
         "w1024-L16": (None, "w1024-L16", 192), "w2048": (None, "w2048", 192),
         "16x256": (None, "deep16", 64)}
RAYS, SIGMA_POINTS = 2048, 65536
# The route's backward kernels by name, keyed as fl.KERNELS counts them. A
# tree whose backward heads share the forward's counter counts them under
# "heads", a tree with their own counter under "heads_bwd"; a backward call
# launches only the backward's heads kernel, so each tree's heads time is
# the sum of both groups (the other reads 0 launches).
LEGS = {"heads": ("layer_heads",), "heads_bwd": ("layer_heads",),
        "reduce": ("reduce_rows_kernel",), "bias": ("bias_grads_kernel",),
        "dw": ("dw_kernel",), "pe": ("layer_pe_kernel",)}


def dw_alone(case: str, packed, device) -> dict:
    """name -> (launch, info, FLOPs) of the dW leg alone on a trunk matrix's
    and the first skip's seeded jobs over the case's backward slab: this
    tree's launch ("new"), the launch before it ("old"), and the probes
    (the module's docstring). Prints whether new and old give the same
    bits."""
    spec = packed.spec
    H, L = spec.hidden, spec.num_layers
    _, _, S = CASES[case]
    m = fl.slab_points(spec, "bwd", RAYS * S)
    g = torch.Generator(device).manual_seed(chip_smoke.SEED + m)
    skips = [k for k in range(1, L + 1) if spec.gemm_shapes()[k][1] > H]
    out = {}
    for what, k in (("trunk", 1), *((("skip", skips[0]),) if skips else ())):
        n, kk = spec.gemm_shapes()[k]
        dy = torch.randn((m, n), generator=g, device=device).to(torch.bfloat16)
        x = torch.randn((m, H), generator=g, device=device).to(torch.bfloat16)
        pe = (torch.randn((m, kk - H), generator=g, device=device).to(torch.bfloat16)
              if kk > H else None)
        jobs, _, cols = fl.route_dw_jobs(packed, k, dy, x, pe)
        zeros = torch.zeros(cols, device=device)
        same = torch.equal(fl.layers_dw_cuda(jobs, zeros),
                           fl.layers_dw_cuda(jobs, zeros, variant="fused"))
        print(f"{case} {what} m={m}: layer_dw_kernel and dw_kernel on the same ranges "
              f"{'bitwise equal' if same else 'DIFFER'}")
        per_range = sum(fl._job_units(j.dy.shape[1], j.x.shape[1]) for j in jobs)
        ranges = fl._ranges_for(per_range)
        wave = max(1, fl.card_sms(device) // per_range)  # one wave of units
        flops = sum(2 * m * j.dy.shape[1] * j.x.shape[1] for j in jobs)
        for name, r, variant in (("old", ranges, "fused"), ("new", ranges, "route"),
                                 ("new, no pieces", ranges, "plain"),
                                 ("old kernel, one wave of ranges", wave, "fused"),
                                 ("new, every range on one range's points", ranges,
                                  "same_points")):
            launch = fl.layers_dw_launcher(jobs, zeros.clone(), ranges=r, variant=variant)
            out[f"{case} {what} m={m}: {name}"] = (launch, launch(), flops)
    return out


def case_inputs(case: str, device):
    """(packed, o, d, z, cot, pts) of a case: its config's fine field with
    the smoke's seeded weights, seeded rays, cotangent and points."""
    from nerfmeshes_tpu_torch.models import build_model
    from nerfmeshes_tpu_torch.ops.kernels import fused_mlp as fm
    from nerfmeshes_tpu_torch.train.system import init_params

    hidden, layer_case, S = CASES[case]
    cfg = chip_smoke.wide_cfg(hidden) if hidden else chip_smoke.layer_cfg(layer_case)
    model = build_model(cfg.models.fine_type, dict(cfg.models.fine), compute_dtype=torch.bfloat16)
    init_params(model, None, torch.Generator().manual_seed(chip_smoke.SEED))
    packed = fm.pack_weights(model.to(device).eval())
    if fm.field_route(packed.spec) != "layers":
        raise AssertionError(f"{case} is not a model of the layer route")
    rng = np.random.default_rng(chip_smoke.SEED)
    o, d, z = chip_smoke._rays(RAYS, S, rng, device)
    cot = torch.from_numpy(rng.standard_normal((4, RAYS, S)).astype(np.float32)).to(device)
    pts = torch.from_numpy(rng.uniform(-1.2, 1.2, (SIGMA_POINTS, 3)).astype(np.float32)).to(device)
    return packed, o, d, z, cot, pts


def bwd_with_dy_dir(packed, o, d, z, cot, lib):
    """One backward call through `lib`'s nm_field_layers on a workspace of
    this tree's layout: (dW, dB, dy_dir of the last slab)."""
    spec = packed.spec
    R, S = z.shape
    n = R * S
    slab = fl.slab_points(spec, "bwd", n)
    layout = fl.workspace_layout(spec, "bwd", slab)
    nbytes = layout["total"][0]
    workspace = torch.empty(nbytes, dtype=torch.uint8, device=z.device)
    dW = torch.zeros(packed.weights.shape, device=z.device)
    dB = torch.zeros(packed.biases.shape, device=z.device)
    counts = (ctypes.c_int * len(fl.KERNELS))()
    rc = lib.nm_field_layers(
        fl.KINDS["bwd"], o.data_ptr(), d.data_ptr(), z.data_ptr(), R, S, cot.data_ptr(),
        packed.weights.data_ptr(), packed.biases.data_ptr(), packed.desc.ctypes.data,
        packed.desc.size, packed.freqs.ctypes.data, packed.freqs.size, workspace.data_ptr(),
        nbytes, slab, None, 1, dW.data_ptr(), dB.data_ptr(), ctypes.addressof(counts),
        torch.cuda.current_stream().cuda_stream)
    build.check(build.load_library(), rc, "field_layers bwd")
    last = n - (n - 1) // slab * slab
    off = layout["dy_dir"][0]
    dy_dir = workspace[off:off + last * spec.hidden].view(torch.bfloat16).view(last, -1).clone()
    return dW, dB, dy_dir


def outputs(inputs, lib) -> dict:
    packed, o, d, z, cot, pts = inputs
    dW, dB, dy_dir = bwd_with_dy_dir(packed, o, d, z, cot, lib)
    out = {"fwd": fl.layers_mlp_cuda(packed, o, d, z, lib=lib),
           "sigma": fl.layers_sigma_cuda(packed, pts, lib=lib),
           "dW": dW, "dB": dB, "dy_dir": dy_dir}
    torch.cuda.synchronize()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("trees", nargs="+", type=Path, help="checkout roots, timed in this order")
    parser.add_argument("--cases", nargs="+", default=list(CASES), choices=list(CASES))
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_layer_legs_ab.py needs a CUDA device")
    card = chip_smoke._run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"]).splitlines()[0]
    print(card)
    roots = [t.resolve() for t in opts.trees]
    unique = list(dict.fromkeys(roots))
    libs = {root: load(compile_tree(root)) for root in unique}
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    times = {}
    for case in opts.cases:
        inputs = case_inputs(case, device)
        packed, o, d, z, cot, _ = inputs
        ref = outputs(inputs, libs[roots[0]])
        for root in unique[1:]:
            got = outputs(inputs, libs[root])
            checks = [f"{k} {'bitwise equal' if torch.equal(got[k], ref[k]) else 'DIFFERS'}"
                      for k in ("fwd", "sigma", "dW", "dy_dir")]
            diffs = []
            for k in ("dB", "dW"):
                diff = float((got[k] - ref[k]).abs().max())
                diffs.append(f"{k} max abs diff {diff:.3e} "
                             f"({diff / (float(ref[k].abs().max()) + 1e-30):.3e} of max |{k}|)")
            print(f"{case}: {root.name or root} vs {roots[0].name or roots[0]}: "
                  + ", ".join(checks) + "; " + "; ".join(diffs))
        del ref
        for turn, root in enumerate(roots):
            lib = libs[root]

            def call(lib=lib):
                return fl.layers_bwd_cuda(packed, o, d, z, cot, lib=lib)

            ms = chip_smoke._median_ms(call)
            legs = chip_smoke._device_ms_per_call(call, LEGS, runs=7)
            heads = [a + b for a, b in zip(legs["heads"], legs["heads_bwd"])]
            pe_alone = chip_smoke._back_to_back_ms(
                lambda lib=lib: fl.layers_pe_cuda(packed, o, d, z, lib=lib))
            reads = {"bwd call": ms, "dW leg": legs["dw"][0] + legs["reduce"][0],
                     "PE": legs["pe"][0], "PE alone": pe_alone, "heads": heads[0],
                     "reductions": legs["reduce"][0] + legs["bias"][0]}
            for read, t in reads.items():
                times.setdefault((case, read), {r: [] for r in unique})[root].append(t)
            print(f"turn {turn} {root.name or root}: {case} backward {z.shape[0]}x{z.shape[1]}: "
                  f"call {ms:.4f} ms (CUDA events, median of 7); dW leg {reads['dW leg']:.4f} "
                  f"ms in {legs['dw'][1]} + {legs['reduce'][1]} launches (dW kernel + range "
                  f"reductions); PE {legs['pe'][0]:.4f} ms in {legs['pe'][1]} launches, alone "
                  f"{pe_alone:.4f} ms (20 back to back); heads {heads[0]:.4f} ms "
                  f"in {heads[1]} launches; reductions {reads['reductions']:.4f} ms in "
                  f"{legs['reduce'][1]} + {legs['bias'][1]} launches (reduce_rows + bias "
                  f"grads; torch.profiler, device ms per call) [{card}]", flush=True)
        alone = dw_alone(case, packed, device)
        order = [k for k in alone if k.endswith(": old")]
        order = [k for old in order for k in (old, old[:-3] + "new", old[:-3] + "new", old)]
        for name in order + [k for k in alone if not k.endswith(("old", "new"))]:
            launch, (ranges, units, kernels, pieces), flops = alone[name]
            t = chip_smoke._back_to_back_ms(launch)
            times.setdefault((case, f"dW alone {name.split(' ', 1)[1]}"), {"": []})[""].append(t)
            print(f"{name}: {t:.4f} ms ({ranges} ranges, {units} units, {kernels} launches, "
                  f"{pieces} pieces a last-wave unit; "
                  f"{flops / t / 1e9:.1f} TFLOP/s; CUDA events, 20 launches back to back) "
                  f"[{card}]", flush=True)
        del alone
        del inputs, packed, o, d, z, cot
        gc.collect()
        torch.cuda.empty_cache()
    print(f"summary (each tree's values over its turns, or each launch's over its "
          f"turns; median, spread max - min) [{card}]:")
    for (case, read), by_root in times.items():
        print(f"  {case} {read}: " + "; ".join(
            f"{str(root) and (root.name or root)} {', '.join(f'{t:.4f}' for t in ts)} -> "
            f"{statistics.median(ts):.4f} ms (spread {max(ts) - min(ts):.4f})"
            for root, ts in by_root.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
