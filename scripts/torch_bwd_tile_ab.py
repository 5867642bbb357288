#!/usr/bin/env python3
"""Time the fused backward's tile kernel of several source trees against
each other on one CUDA card, in turns.

    python3 scripts/torch_bwd_tile_ab.py OLD NEW NEW OLD [--shapes NAME ...]

Each argument is the root of a checkout of this repository (for example a
`git archive` of another commit unpacked under build/). Its
`nerfmeshes_tpu_torch/csrc/fused_mlp_bwd.cu` and `fused_mlp_bwd_wide.cu`
(the backward's entry points and tile kernel at every width) are compiled,
one nvcc per source and every tree's at once, with the flags of this
tree's build, into build/bwd_tile_ab/, and each tree's nm_fused_mlp_bwd is
called through this tree's wrapper (fm.fused_mlp_bwd_cuda, `lib=`; the C
contract is the same in every tree). ptxas's report of each tree's
bwd_tile_kernel instantiations comes first: registers, stack, spill bytes
and C7519 notes (ptxas serialising the kernel's wgmma).

At SHAPES (lego's fine and coarse calls at H 256, a rank's share of the
fine call, hard-llff.yml's 8x128 fine call, and H 384), on 8-layer fields
at L 10/4 with seeded weights, rays and cotangent, per tree (turn) and
shape: the tile kernel's device time by torch.profiler (median over 7
calls) and the whole call's by CUDA events (median of 7); dW, dB and the
stash (the workspace the call leaves, stash_layout) checked bitwise
against the first tree, else the largest difference printed. Then, per
read, each tree's values over its turns, their median and spread (max -
min). The card's name and power limit come first, as nvidia-smi prints
them.
"""

from __future__ import annotations

import argparse
import gc
import hashlib
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from nerfmeshes_tpu_torch.models import FlexibleNeRFModel  # noqa: E402
from torch_layer_product_ab import load  # noqa: E402
from nerfmeshes_tpu_torch.ops.kernels import build  # noqa: E402
from nerfmeshes_tpu_torch.ops.kernels import fused_mlp as fm  # noqa: E402

OUT_DIR = REPO / "build" / "bwd_tile_ab"
SOURCES = ("fused_mlp_bwd.cu", "fused_mlp_bwd_wide.cu")
# name -> (hidden width, rays, samples)
SHAPES = {"w256 2048x192": (256, 2048, 192), "w256 2048x64": (256, 2048, 64),
          "w256 1024x192": (256, 1024, 192), "w128 2048x128": (128, 2048, 128),
          "w384 2048x192": (384, 2048, 192)}
TILE_KERNEL = "bwd_tile_kernel"


def _library_path(csrc: Path, flags: tuple) -> Path:
    digest = hashlib.sha256(" ".join((*build.NVCC_FLAGS, *flags)).encode())
    for src in sorted(csrc.glob("*.cu*")):
        digest.update(src.name.encode() + src.read_bytes())
    return OUT_DIR / f"libfused_mlp_bwd_{digest.hexdigest()[:16]}.so"


def compile_many(jobs: list[tuple[Path, tuple]]) -> list[tuple[Path, str]]:
    """Build each (csrc directory, extra nvcc flags)'s SOURCES into one
    shared library, every nvcc started at once; cached by content.
    Returns [(library, nvcc's log: '' when cached)]."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = build.find_nvcc()
    started = []
    for csrc, flags in jobs:
        lib = _library_path(csrc, flags)
        procs = []
        if not lib.exists():
            for src in SOURCES:
                obj = lib.with_name(f"{lib.stem}.{Path(src).stem}.o")
                cmd = [nvcc, *build.NVCC_FLAGS, *flags, "-c", "-o", str(obj), str(csrc / src)]
                procs.append((obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                    stderr=subprocess.STDOUT, text=True)))
        started.append((lib, procs))
    out = []
    for (csrc, _), (lib, procs) in zip(jobs, started):
        log = ""
        for obj, proc in procs:
            text, _ = proc.communicate()
            log += text
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {csrc}:\n{text}")
        if procs:
            objs = [str(obj) for obj, _ in procs]
            proc = subprocess.run([nvcc, "-shared", "-o", str(lib), *objs], capture_output=True,
                                  text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc link failed for {csrc}:\n{proc.stdout}{proc.stderr}")
            for obj in objs:
                Path(obj).unlink()
        out.append((lib, log))
    return out


def compile_tree(root: Path):
    """root's backward compiled alone and loaded; ptxas's report printed."""
    (lib, log), = compile_many([(root / "nerfmeshes_tpu_torch" / "csrc", ())])
    for H, usage in chip_smoke.tile_kernel_usage(log).items():
        print(f"  ptxas [{root.name or root}] {TILE_KERNEL}<{H}>: {usage}")
    return load(lib)


def shape_inputs(name: str, device):
    """(packed, o, d, z, cot) of a shape: an 8-layer field at L 10/4 of its
    width, weights, rays and cotangent from numpy generators seeded 0."""
    hidden, R, S = SHAPES[name]
    rng = np.random.default_rng(0)
    model = FlexibleNeRFModel(num_layers=8, hidden_size=hidden, skip_step=4,
                              num_encoding_fn_xyz=10, num_encoding_fn_dir=4,
                              compute_dtype=torch.bfloat16)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(
                (rng.standard_normal(tuple(p.shape)) / np.sqrt(p.shape[-1])).astype(np.float32)))
    packed = fm.pack_weights(model.to(device))
    o, d, z = chip_smoke._rays(R, S, rng, device)
    cot = torch.from_numpy(rng.standard_normal((4, R, S)).astype(np.float32)).to(device)
    return packed, o, d, z, cot


def outputs(inputs, lib) -> dict:
    """dW, dB and the stash of one call through lib."""
    packed, o, d, z, cot = inputs
    n = z.numel()
    workspace = torch.empty(fm.bwd_workspace_bytes(packed, n, lib), dtype=torch.uint8,
                            device=z.device)
    dW, dB = fm.fused_mlp_bwd_cuda(packed, o, d, z, cot, lib=lib, workspace=workspace)
    torch.cuda.synchronize()
    end = fm.stash_layout(packed.spec, -(-n // 128) * 128)["end"]
    return {"dW": dW, "dB": dB, "stash": workspace.view(torch.bfloat16)[:end]}


def compare(got: dict, ref: dict) -> str:
    out = []
    for k, want in ref.items():
        if torch.equal(got[k].view(torch.int16) if k == "stash" else got[k],
                       want.view(torch.int16) if k == "stash" else want):
            out.append(f"{k} bitwise equal")
        else:
            diff = (got[k].float() - want.float()).abs()
            diff = diff[torch.isfinite(diff)]
            out.append(f"{k} DIFFERS (max abs diff {float(diff.max()) if diff.numel() else 0:.3e})")
    return ", ".join(out)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("trees", nargs="+", type=Path, help="checkout roots, timed in this order")
    parser.add_argument("--shapes", nargs="+", default=list(SHAPES), choices=list(SHAPES))
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_bwd_tile_ab.py needs a CUDA device")
    card = chip_smoke._run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"]).splitlines()[0]
    print(card)
    roots = [t.resolve() for t in opts.trees]
    unique = list(dict.fromkeys(roots))
    built = compile_many([(root / "nerfmeshes_tpu_torch" / "csrc", ()) for root in unique])
    libs = {}
    for root, (path, log) in zip(unique, built):
        for H, usage in chip_smoke.tile_kernel_usage(log).items():
            print(f"ptxas [{root.name or root}] {TILE_KERNEL}<{H}>: {usage['registers']} "
                  f"registers, {usage['stack']} B stack, {usage['spill_stores']} B spill stores, "
                  f"{usage['spill_loads']} B spill loads, {usage['c7519']} C7519 notes")
        libs[root] = load(path)
    device = torch.device("cuda")
    build.load_library()  # this tree's, for the wrapper's error strings
    times = {}
    for shape in opts.shapes:
        inputs = shape_inputs(shape, device)
        ref = outputs(inputs, libs[roots[0]])
        for root in unique[1:]:
            print(f"{shape}: {root.name or root} vs {roots[0].name or roots[0]}: "
                  + compare(outputs(inputs, libs[root]), ref), flush=True)
        del ref
        for turn, root in enumerate(roots):
            lib = libs[root]

            def call(lib=lib):
                return fm.fused_mlp_bwd_cuda(*inputs, lib=lib)

            tile = chip_smoke._kernel_device_ms(call, TILE_KERNEL)
            ms = chip_smoke._median_ms(call)
            for read, t in (("tile kernel", tile), ("bwd call", ms)):
                times.setdefault((shape, read), {r: [] for r in unique})[root].append(t)
            print(f"turn {turn} {root.name or root}: {shape}: tile kernel {tile:.4f} ms "
                  f"(torch.profiler, median of 7), call {ms:.4f} ms (CUDA events, median of 7) "
                  f"[{card}]", flush=True)
        del inputs
        gc.collect()
        torch.cuda.empty_cache()
    print(f"summary (each tree's values over its turns; median, spread max - min) [{card}]:")
    for (shape, read), by_root in times.items():
        print(f"  {shape} {read}: " + "; ".join(
            f"{root.name or root} {', '.join(f'{t:.4f}' for t in ts)} -> "
            f"{statistics.median(ts):.4f} ms (spread {max(ts) - min(ts):.4f})"
            for root, ts in by_root.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
