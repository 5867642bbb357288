#!/usr/bin/env python3
"""Time the fused forward and sigma kernels of several source trees against
each other on one CUDA card, in turns.

    python3 scripts/torch_fwd_tile_ab.py OLD NEW NEW OLD [--shapes NAME ...]

Each argument is the root of a checkout of this repository (for example a
`git archive` of another commit unpacked under build/), or a copy of its
`nerfmeshes_tpu_torch/csrc/` under `<root>/nerfmeshes_tpu_torch/`. Its
`fused_mlp_fwd.cu` and `fused_sigma.cu` are compiled, one nvcc per source
and every tree's at once, with the flags of this tree's build, into
build/fwd_tile_ab/, and each tree's nm_fused_mlp_fwd / nm_fused_sigma is
called through this tree's wrappers (fm.fused_mlp_cuda, fm.fused_sigma_cuda,
`lib=`; the C contract is the same in every tree). ptxas's report of each
tree's fused_mlp_fwd_kernel and fused_sigma_kernel at H = 128, 256 and 384
comes first: registers, stack, spill bytes and C7519 notes.

At SHAPES (the forward at lego's fine and coarse calls, a rank's share of
them, hard-llff.yml's 8x128 calls, H 384 and the mesh's 65,536-ray
appearance chunk; sigma at a 262,144-point grid tile at 128, 256 and 384
and a rank's half of it), on 8-layer fields at L 10/4 with seeded weights,
rays and points, per tree (turn) and shape: the call's time by CUDA events
(median of 7 after 2 warm-ups). Every tree's output is checked bitwise
against the first tree's (else the largest difference is printed), and
sigma bitwise against the same tree's forward channel 3. Then, per shape,
each tree's times over its turns, their median and spread (max - min).
The card's name and power limit come first, as nvidia-smi prints them.
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
sys.path.insert(0, str(REPO / "scripts"))

import chip_smoke  # noqa: E402
from nerfmeshes_tpu_torch.models import FlexibleNeRFModel  # noqa: E402
from nerfmeshes_tpu_torch.ops.kernels import build  # noqa: E402
from nerfmeshes_tpu_torch.ops.kernels import fused_mlp as fm  # noqa: E402
from torch_layer_product_ab import load  # noqa: E402

OUT_DIR = REPO / "build" / "fwd_tile_ab"
SOURCES = ("fused_mlp_fwd.cu", "fused_sigma.cu")
# name -> (kernel, hidden width, rays or points, samples)
SHAPES = {
    "fwd w256 2048x192": ("fwd", 256, 2048, 192),
    "fwd w256 2048x64": ("fwd", 256, 2048, 64),
    "fwd w256 1024x192": ("fwd", 256, 1024, 192),
    "fwd w256 1024x64": ("fwd", 256, 1024, 64),
    "fwd w128 2048x128": ("fwd", 128, 2048, 128),
    "fwd w128 2048x64": ("fwd", 128, 2048, 64),
    "fwd w384 2048x192": ("fwd", 384, 2048, 192),
    "fwd w384 2048x64": ("fwd", 384, 2048, 64),
    "fwd w256 65536x192": ("fwd", 256, 65536, 192),
    "sigma w256 262144": ("sigma", 256, 262144, 1),
    "sigma w256 131072": ("sigma", 256, 131072, 1),
    "sigma w128 262144": ("sigma", 128, 262144, 1),
    "sigma w384 262144": ("sigma", 384, 262144, 1),
}
KERNELS = ("fused_mlp_fwd_kernel", "fused_sigma_kernel")


def compile_many(jobs: list[tuple[Path, tuple]], sources=SOURCES, out_dir: Path = OUT_DIR,
                 stem: str = "libfused_fwd") -> list[tuple[Path, str]]:
    """Build each (csrc directory, extra nvcc flags)'s `sources` into one
    shared library under out_dir, every nvcc started at once; cached by
    content. Returns [(library, nvcc's log: '' when cached)]."""
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = build.find_nvcc()
    started = []
    for csrc, flags in jobs:
        digest = hashlib.sha256(" ".join((*build.NVCC_FLAGS, *flags)).encode())
        for src in sorted(csrc.glob("*.cu*")):
            digest.update(src.name.encode() + src.read_bytes())
        lib = out_dir / f"{stem}_{digest.hexdigest()[:16]}.so"
        procs = []
        if not lib.exists():
            for src in sources:
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


def print_usage(label: str, log: str, widths=(128, 256, 384)) -> None:
    """ptxas's report of the forward's and sigma's instantiations at
    `widths` in an nvcc log."""
    for H, kernel, u in chip_smoke.field_kernel_usage(log, widths):
        print(f"ptxas [{label}] {kernel}<{H}>: {u['registers']} registers, {u['stack']} B "
              f"stack, {u['spill_stores']} B spill stores, {u['spill_loads']} B spill loads, "
              f"{u['c7519']} C7519 notes", flush=True)


def field(hidden: int, rng: np.random.Generator, device):
    """A bf16 8-layer FlexibleNeRF field at L 10/4 of width `hidden`, its
    weights from rng, packed on device."""
    model = FlexibleNeRFModel(num_layers=8, hidden_size=hidden, skip_step=4,
                              num_encoding_fn_xyz=10, num_encoding_fn_dir=4,
                              compute_dtype=torch.bfloat16)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(
                (rng.standard_normal(tuple(p.shape)) / np.sqrt(p.shape[-1])).astype(np.float32)))
    return fm.pack_weights(model.to(device))


def shape_call(name: str, device):
    """call(lib) -> output of a shape: the kernel on seeded inputs."""
    kind, hidden, n, S = SHAPES[name]
    rng = np.random.default_rng(0)
    packed = field(hidden, rng, device)
    if kind == "fwd":
        o, d, z = chip_smoke._rays(n, S, rng, device)
        return lambda lib: fm.fused_mlp_cuda(packed, o, d, z, lib=lib)
    pts = torch.from_numpy(rng.uniform(-1.2, 1.2, (n, 3)).astype(np.float32)).to(device)
    zeros = torch.zeros_like(pts)

    def call(lib, channel3=False):
        if channel3:
            return fm.fused_mlp_cuda(packed, pts, zeros, zeros[:, :1], lib=lib)[3, :, 0]
        return fm.fused_sigma_cuda(packed, pts, lib=lib)

    return call


def compare(got: torch.Tensor, want: torch.Tensor) -> str:
    if torch.equal(got, want):
        return "bitwise equal"
    diff = (got - want).abs()
    diff = diff[torch.isfinite(diff)]
    return f"DIFFERS (max abs diff {float(diff.max()) if diff.numel() else 0:.3e})"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("trees", nargs="+", type=Path, help="checkout roots, timed in this order")
    parser.add_argument("--shapes", nargs="+", default=list(SHAPES), choices=list(SHAPES))
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_fwd_tile_ab.py needs a CUDA device")
    card = chip_smoke._run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"]).splitlines()[0]
    print(card)
    roots = [t.resolve() for t in opts.trees]
    unique = list(dict.fromkeys(roots))
    built = compile_many([(root / "nerfmeshes_tpu_torch" / "csrc", ()) for root in unique])
    libs = {}
    for root, (path, log) in zip(unique, built):
        print_usage(root.name or str(root), log)
        libs[root] = load(path)
    device = torch.device("cuda")
    build.load_library()  # this tree's, for the wrappers' error strings
    times = {}
    for shape in opts.shapes:
        call = shape_call(shape, device)
        ref = call(libs[roots[0]])
        torch.cuda.synchronize()
        for root in unique:
            label = root.name or str(root)
            if root != roots[0]:
                print(f"{shape}: {label} vs {roots[0].name or roots[0]}: "
                      + compare(call(libs[root]), ref), flush=True)
            if shape.startswith("sigma"):
                print(f"{shape}: {label} sigma vs its forward channel 3: "
                      + compare(call(libs[root]), call(libs[root], channel3=True)), flush=True)
        del ref
        for turn, root in enumerate(roots):
            lib = libs[root]
            ms = chip_smoke._median_ms(lambda lib=lib: call(lib))
            times.setdefault(shape, {r: [] for r in unique})[root].append(ms)
            print(f"turn {turn} {root.name or root}: {shape}: {ms:.4f} ms (CUDA events, median "
                  f"of 7) [{card}]", flush=True)
        del call
        gc.collect()
        torch.cuda.empty_cache()
    print(f"summary (each tree's values over its turns; median, spread max - min) [{card}]:")
    for shape, by_root in times.items():
        print(f"  {shape}: " + "; ".join(
            f"{root.name or root} {', '.join(f'{t:.4f}' for t in ts)} -> "
            f"{statistics.median(ts):.4f} ms (spread {max(ts) - min(ts):.4f})"
            for root, ts in by_root.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
