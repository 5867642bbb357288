#!/usr/bin/env python3
"""Time the chord kernels of several source trees against each other on
one CUDA card, in turns, on the chord phase's inputs (chip_smoke.py).

    python3 scripts/torch_chords_ab.py OLD NEW NEW OLD

Each argument is the root of a checkout of this repository (for example a
`git archive` of another commit unpacked under build/). Its
`nerfmeshes_tpu_torch/csrc/chords.cu` is compiled alone, with the flags of
this tree's build, into build/chords_ab/, and its C entry point
`nm_compact_chords` is called directly on the same inputs: the timed
reads of chip_smoke.chord_timed_cases (2048 x 4096 x 64 on the
consolidated and on the initial tree, 65536 x 4096 x 64), and 16 rays on
the consolidated tree (one CTA: the table's staging and one tile). Per tree and
read it prints the kernel's device time from torch.profiler (median of 7
launches, chip_smoke._kernel_device_ms, as the kernels line reads it) and
the time per launch of 20 back to back (CUDA events, the launches
enqueued behind a spinning kernel so the card never waits for the host;
launch gaps included; median of 7; chip_smoke._back_to_back_ms), beside
the bound chip_smoke.py reckons, and checks that every tree's outputs are
bitwise those of the first. The card's name and power limit come first,
as nvidia-smi prints them.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from nerfmeshes_tpu_torch.ops.kernels import build  # noqa: E402
from nerfmeshes_tpu_torch.ops.kernels import chords as ch  # noqa: E402

OUT_DIR = REPO / "build" / "chords_ab"
K = 64


def compile_tree(root: Path) -> Path:
    """Build root's chords.cu alone into a shared library (cached by content)."""
    src = root / "nerfmeshes_tpu_torch" / "csrc" / "chords.cu"
    tag = hashlib.sha256(src.read_bytes() + " ".join(build.NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = OUT_DIR / f"libchords_{tag}.so"
    if not lib.exists():
        OUT_DIR.mkdir(parents=True, exist_ok=True)
        cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(lib), str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
        for line in (proc.stdout + proc.stderr).splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas [{root}]: {line.strip()}")
    return lib


def launcher(lib_path: Path):
    """fn(voxels, active, origins, dirs, near, far) -> Chords through the
    library's nm_compact_chords, called as ops/kernels/chords.py calls it."""
    entry = ctypes.CDLL(str(lib_path)).nm_compact_chords
    entry.restype, entry.argtypes = build.SIGNATURES["nm_compact_chords"]

    def run(voxels, active, origins, dirs, near, far):
        out = ch.empty_chords(dirs.shape[0], K, dirs.device)
        rc = ch.call_entry(entry, out, voxels, active, origins, dirs, near, far)
        if rc != 0:
            raise RuntimeError(f"nm_compact_chords returned CUDA error {rc}")
        return out

    return run


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("trees", nargs="+", type=Path, help="checkout roots, timed in this order")
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_chords_ab.py needs a CUDA device")
    card = chip_smoke._run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"]).splitlines()[0]
    print(card)
    roots = [t.resolve() for t in opts.trees]
    unique = list(dict.fromkeys(roots))
    with ThreadPoolExecutor(len(unique)) as pool:
        libs = dict(zip(unique, pool.map(compile_tree, unique)))
    runs = {root: launcher(libs[root]) for root in unique}
    device = torch.device("cuda")
    cases = chip_smoke.chord_timed_cases(chip_smoke._chord_inputs(device))
    voxels, active, o, d, near, far = cases["train"]
    cases["one tile"] = (voxels, active, o[:16], d[:16], near, far)
    reference = {name: runs[roots[0]](*args) for name, args in cases.items()}
    for turn, root in enumerate(roots):
        for name, args in cases.items():
            got = runs[root](*args)
            if not all(torch.equal(a, b) for a, b in zip(got, reference[name])):
                raise AssertionError(f"{root} differs from {roots[0]} on {name}")
            ms = chip_smoke._kernel_device_ms(lambda: runs[root](*args), "chords_kernel")
            b2b_ms = chip_smoke._back_to_back_ms(lambda: runs[root](*args))
            rays, V, active = args[3].shape[0], args[0].shape[0], int(args[1].sum())
            bound_ms, bound_by = chip_smoke._chord_bound(rays, V, active, K)
            print(f"turn {turn} {root.name or root}: {name} {rays}x{V}x{K} ({active} active): "
                  f"{ms:.4f} ms on the device (torch.profiler), {b2b_ms:.4f} ms a launch of 20 "
                  f"back to back (CUDA events; medians of 7), bound {bound_ms * 1e3:.3f} us "
                  f"({bound_by}, {100.0 * bound_ms / ms:.1f}% of the profiler's time) [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
