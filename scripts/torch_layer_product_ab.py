#!/usr/bin/env python3
"""Time the layer route's product kernel of several source trees against
each other on one CUDA card, in turns, alone and inside the route.

    python3 scripts/torch_layer_product_ab.py OLD NEW NEW OLD

Each argument is the root of a checkout of this repository (for example a
`git archive` of another commit unpacked under build/). Its
`nerfmeshes_tpu_torch/csrc/field_layers.cu` is compiled alone, with the
flags of this tree's build, into build/layer_product_ab/, and its C entry
points are called through this tree's wrappers (ops/kernels/field_layers.py,
`lib=`; the C contract is the same in every tree):
- the product kernel alone (nm_field_layers_product) at chip_smoke.py's
  PRODUCT_SHAPES, as the forward runs it (NN 0: bias, ReLU) and as the
  backward's dX chain does (NN 1: the mask and the column sums);
- the route's forward and backward at 2048 x 192 points on chip_smoke.py's
  8x1024 field at L 16/4 and its 8x2048 field (LAYER_CASES).
Per tree (turn) and read it prints the median of 7 calls by CUDA events
(chip_smoke._median_ms), and checks that every tree's outputs and grads
are bitwise those of the first tree, or prints the largest difference.
Then, per read, each tree's medians over its turns, their median and
spread (max - min). The card's name and power limit come first, as
nvidia-smi prints them.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from nerfmeshes_tpu_torch.ops.kernels import build  # noqa: E402
from nerfmeshes_tpu_torch.ops.kernels import field_layers as fl  # noqa: E402

OUT_DIR = REPO / "build" / "layer_product_ab"
ROUTE_CASES = ("w1024-L16", "w2048")
R, S = 2048, 192


def compile_tree(root: Path) -> Path:
    """Build root's field_layers.cu alone into a shared library (cached by
    the content of its csrc/)."""
    csrc = root / "nerfmeshes_tpu_torch" / "csrc"
    digest = hashlib.sha256(" ".join(build.NVCC_FLAGS).encode())
    for src in sorted(csrc.glob("*.cu*")):
        digest.update(src.name.encode() + src.read_bytes())
    lib = OUT_DIR / f"libfield_layers_{digest.hexdigest()[:16]}.so"
    if not lib.exists():
        OUT_DIR.mkdir(parents=True, exist_ok=True)
        cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(lib),
               str(csrc / "field_layers.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {root}:\n{proc.stdout}{proc.stderr}")
        entry = ""
        for line in (proc.stdout + proc.stderr).splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line
            if "C7519" in line or ("layer_product_kernel" in entry
                                   and ("spill" in line or "registers" in line)):
                print(f"  ptxas [{root.name or root}] {entry[-48:]}: {line.strip()}")
    return lib


def load(lib_path: Path) -> ctypes.CDLL:
    """The library with the signature of every entry point it has."""
    lib = ctypes.CDLL(str(lib_path))
    for name, signature in build.SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = signature
    return lib


def product_reads(device) -> dict:
    """name -> (call(lib) -> tensors): the product kernel alone."""
    reads = {}
    for M, K, N in chip_smoke.PRODUCT_SHAPES:
        for nn in (False, True):
            args, kw = chip_smoke.product_operands(M, K, N, nn, device)
            reads[f"product M={M} K={K} N={N} NN {int(nn)}"] = (
                lambda lib, args=args, kw=kw: fl.layers_product_cuda(*args, **kw, lib=lib))
    return reads


def route_reads(device) -> dict:
    """name -> (call(lib) -> tensors): the route's forward and backward."""
    from nerfmeshes_tpu_torch.models import build_model
    from nerfmeshes_tpu_torch.ops.kernels import fused_mlp as fm
    from nerfmeshes_tpu_torch.train.system import init_params

    reads = {}
    for case in ROUTE_CASES:
        cfg = chip_smoke.layer_cfg(case)
        model = build_model(cfg.models.fine_type, dict(cfg.models.fine),
                            compute_dtype=torch.bfloat16)
        init_params(model, None, torch.Generator().manual_seed(chip_smoke.SEED))
        packed = fm.pack_weights(model.to(device).eval())
        rng = np.random.default_rng(chip_smoke.SEED)
        o, d, z = chip_smoke._rays(R, S, rng, device)
        cot = torch.from_numpy(rng.standard_normal((4, R, S)).astype(np.float32)).to(device)
        reads[f"{case} forward {R}x{S}"] = (
            lambda lib, p=packed, o=o, d=d, z=z: (fl.layers_mlp_cuda(p, o, d, z, lib=lib),))
        reads[f"{case} backward {R}x{S}"] = (
            lambda lib, p=packed, o=o, d=d, z=z, c=cot: fl.layers_bwd_cuda(p, o, d, z, c,
                                                                            lib=lib))
    return reads


def max_diff(got, want) -> float:
    return max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want)
               if a is not None)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("trees", nargs="+", type=Path, help="checkout roots, timed in this order")
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_layer_product_ab.py needs a CUDA device")
    card = chip_smoke._run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"]).splitlines()[0]
    print(card)
    roots = [t.resolve() for t in opts.trees]
    unique = list(dict.fromkeys(roots))
    with ThreadPoolExecutor(len(unique)) as pool:
        libs = {root: load(path) for root, path in zip(unique, pool.map(compile_tree, unique))}
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    reads = {**product_reads(device), **route_reads(device)}
    reference = {name: [t.clone() for t in call(libs[roots[0]]) if t is not None]
                 for name, call in reads.items()}
    times = {name: {root: [] for root in unique} for name in reads}
    for turn, root in enumerate(roots):
        lib = libs[root]
        for name, call in reads.items():
            got = [t for t in call(lib) if t is not None]
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(got, reference[name]))
            check = "bitwise equal" if same else f"max abs diff {max_diff(got, reference[name]):.3e}"
            ms = chip_smoke._median_ms(lambda: call(lib))
            times[name][root].append(ms)
            print(f"turn {turn} {root.name or root}: {name}: {ms:.4f} ms (CUDA events, median "
                  f"of 7); vs {roots[0].name or roots[0]}: {check} [{card}]")
    print(f"summary (each tree's medians over its turns; median, spread max - min) [{card}]:")
    for name, by_root in times.items():
        print(f"  {name}: " + "; ".join(
            f"{root.name or root} {', '.join(f'{t:.4f}' for t in ts)} -> "
            f"{statistics.median(ts):.4f} ms (spread {max(ts) - min(ts):.4f})"
            for root, ts in by_root.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
