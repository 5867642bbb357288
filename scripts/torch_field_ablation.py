#!/usr/bin/env python3
"""Where the fused field kernels' time goes, on the card: the forward of
nerfmeshes_tpu_torch/csrc/fused_mlp_fwd.cu and the sigma kernel of
csrc/fused_sigma.cu at lego's 8x256 and hard-llff.yml's 8x128 widths (the
forward at the train path's fine shapes, 2048 x 192 and 2048 x 128 points;
sigma at a 262,144-point grid tile), and the backward's tile kernel
(csrc/fused_mlp_bwd.cuh) at 2048 x 192 and 2048 x 128, as they are and
with parts cut out of a copy of their sources.

    python3 scripts/torch_field_ablation.py [--fwd | --bwd] [--tree ROOT]   # one CUDA card, nvcc

--tree ROOT ablates another checkout's sources (for example a `git
archive` of the parent commit unpacked under build/): the switches are
patched into whichever of the known source texts (EDITS) it holds.

Variants (compile-time switches patched into a copy under
build/field_ablation/, never into the package). The forward and sigma:
- full: the kernels as they are;
- no PE: the positional-encoding tiles are never built (the products read
  whatever the tiles hold);
- no epilogue: no bias, ReLU or bf16 rounding between products (each layer
  reads its input as the layer before left it);
- neither: both cut;
- no products: no wgmma at all (the ring, the PE, the epilogues and the
  heads run on zero sums).
The backward's tile kernel:
- full;
- no stash stores: neither the TMA stores of the activation tiles (act,
  feat, dy, dy_dir) nor the PE rows and the dir layer's h;
- no column sums: no colsum8 and no flush of the bias partials;
- no mask words: the forward's ReLU mask bits neither stored nor loaded
  (the dX epilogues mask with zero words);
- none of the three.
The cut variants compute garbage; only their times mean anything. Each
variant is built with its own nvcc per source, all in parallel, and timed
twice in turn (the forward and sigma by CUDA events, median of 7 after 2
warm-ups; the tile kernel by torch.profiler, median of 7 calls, and its
call by CUDA events), beside the card's name and power limit; ptxas's
registers and spills of each forward and sigma instantiation come first.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

import chip_smoke  # noqa: E402
from torch_layer_product_ab import load  # noqa: E402
from nerfmeshes_tpu_torch.ops.kernels import build  # noqa: E402
from nerfmeshes_tpu_torch.ops.kernels import fused_mlp as fm  # noqa: E402

OUT = REPO / "build" / "field_ablation"
VARIANTS = {"full": [], "no PE": ["-DABLATE_PE"], "no epilogue": ["-DABLATE_EPILOGUE"],
            "neither": ["-DABLATE_PE", "-DABLATE_EPILOGUE"], "no products": ["-DABLATE_MMA"]}
# (kernel, hidden width, rays or points, samples)
FWD_CASES = [("fwd", 256, 2048, 192), ("fwd", 128, 2048, 128), ("sigma", 256, 262144, 1),
             ("sigma", 128, 262144, 1)]
FWD_SOURCES = ("fused_mlp_fwd.cu", "fused_sigma.cu")
BWD_VARIANTS = {"full": [], "no stash stores": ["-DABLATE_STASH"],
                "no column sums": ["-DABLATE_COLSUM"], "no mask words": ["-DABLATE_MASK"],
                "none of the three": ["-DABLATE_STASH", "-DABLATE_COLSUM", "-DABLATE_MASK"]}
BWD_WIDTHS = (256, 128)

# (switch, file, text to patch, its replacement), each switch off by
# default. A tree holds some of these texts (the forward's design changed
# in its history): patched_sources applies those it finds and requires at
# least one for each switch a run needs.
EDITS = [
    # the forward's and sigma's design with the PE built between the
    # consumers' products and the activations in shared memory
    ("ABLATE_PE", "fused_field.cuh", "    if (chunk >= chunks) return;\n",
     "#ifdef ABLATE_PE\n    chunk = chunks;\n#endif\n    if (chunk >= chunks) return;\n"),
    ("ABLATE_EPILOGUE", "fused_field.cuh",
     "#pragma unroll\n  for (int n0 = 0; n0 < CHUNKS; n0 += 8) {",
     "#ifdef ABLATE_EPILOGUE\n  if (wa != nullptr) s0 += acc[0];\n  return;\n#endif\n"
     "#pragma unroll\n  for (int n0 = 0; n0 < CHUNKS; n0 += 8) {"),
    ("ABLATE_MMA", "fused_field.cuh", "      wgmma_bf16(acc, sw128_desc(a), bd, k0 + k);\n",
     "#ifndef ABLATE_MMA\n      wgmma_bf16(acc, sw128_desc(a), bd, k0 + k);\n#endif\n"),
    # the forward's and sigma's design with the PE built by the producer
    # warpgroup's PE warps and the activations in registers
    ("ABLATE_PE", "fused_field.cuh", "  for (int l = 0; l < L; ++l) {\n    const float fl = f[l];\n",
     "#ifdef ABLATE_PE\n  if (L >= 0) return;\n#endif\n"
     "  for (int l = 0; l < L; ++l) {\n    const float fl = f[l];\n"),
    ("ABLATE_EPILOGUE", "fused_field.cuh",
     "  constexpr int KB = R / 8;  // k16 blocks of the output\n",
     "  constexpr int KB = R / 8;  // k16 blocks of the output\n"
     "#ifdef ABLATE_EPILOGUE\n  if (wa != nullptr) s0 += acc[0];\n  return;\n#endif\n"),
    ("ABLATE_MMA", "fused_field.cuh",
     "      wgmma_rs(acc, a[4 * (k0 / 16 + k)], a[4 * (k0 / 16 + k) + 1],\n",
     "#ifdef ABLATE_MMA\n      if constexpr (false)\n#endif\n"
     "      wgmma_rs(acc, a[4 * (k0 / 16 + k)], a[4 * (k0 / 16 + k) + 1],\n"),
    ("ABLATE_MMA", "fused_field.cuh",
     "      wgmma_bf16(acc, sw128_desc(pe + col_addr(c)), sw128_desc(b + 32 * k), AS + k0 + k);\n",
     "#ifndef ABLATE_MMA\n"
     "      wgmma_bf16(acc, sw128_desc(pe + col_addr(c)), sw128_desc(b + 32 * k), AS + k0 + k);\n"
     "#endif\n"),
    # the backward's tile kernel
    ("ABLATE_STASH", "fused_field.cuh", "      if constexpr (STASH)\n",
     "#ifndef ABLATE_STASH\n      if constexpr (STASH)\n#else\n      if constexpr (false)\n#endif\n"),
    ("ABLATE_MASK", "fused_mlp_bwd.cuh",
     "    if (bits != nullptr) bits[n0 / 8 * WG_THREADS] = mb;\n",
     "#ifndef ABLATE_MASK\n    if (bits != nullptr) bits[n0 / 8 * WG_THREADS] = mb;\n#endif\n"),
    ("ABLATE_STASH", "fused_mlp_bwd.cuh", "      if (!storer) return;\n",
     "#ifdef ABLATE_STASH\n      return;\n#endif\n      if (!storer) return;\n"),
    ("ABLATE_STASH", "fused_mlp_bwd.cuh",
     "        *reinterpret_cast<uint32_t*>(h_out + r * (H / 2) + col) = lo;\n"
     "        *reinterpret_cast<uint32_t*>(h_out + (r + 8) * (H / 2) + col) = hi;\n",
     "#ifndef ABLATE_STASH\n"
     "        *reinterpret_cast<uint32_t*>(h_out + r * (H / 2) + col) = lo;\n"
     "        *reinterpret_cast<uint32_t*>(h_out + (r + 8) * (H / 2) + col) = hi;\n#endif\n"),
    ("ABLATE_COLSUM", "fused_mlp_bwd.cuh", "    colsum8<R / 4>(cs, part, n0, q, lane);\n",
     "#ifndef ABLATE_COLSUM\n    colsum8<R / 4>(cs, part, n0, q, lane);\n#endif\n"),
    ("ABLATE_COLSUM", "fused_mlp_bwd.cuh",
     "        flush_colsum(part, part_ld(H), NW, db + d.b_off[g] + col0, t);\n",
     "#ifndef ABLATE_COLSUM\n"
     "        flush_colsum(part, part_ld(H), NW, db + d.b_off[g] + col0, t);\n#endif\n"),
    ("ABLATE_MASK", "fused_mlp_bwd.cuh",
     "        if (g > 0) load_mask(mw, a.bits + mask_words(H, a.n_tiles, g, tile, u, t));\n",
     "#ifndef ABLATE_MASK\n"
     "        if (g > 0) load_mask(mw, a.bits + mask_words(H, a.n_tiles, g, tile, u, t));\n"
     "#endif\n"),
]
FWD_SWITCHES = ("ABLATE_PE", "ABLATE_EPILOGUE", "ABLATE_MMA")
BWD_SWITCHES = ("ABLATE_STASH", "ABLATE_MASK", "ABLATE_COLSUM")


def patched_sources(csrc: Path = build.CSRC_DIR, switches=FWD_SWITCHES + BWD_SWITCHES,
                    out: Path = OUT) -> Path:
    """A copy of the sources at `csrc` under `out` whose field kernels
    honour the ABLATE_* switches (EDITS); raises where a text to patch
    appears more than once, or a switch of `switches` finds none."""
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(csrc, out)
    applied = set()
    for switch, name, old, new in EDITS:
        path = out / name
        text = path.read_text()
        if text.count(old) > 1:
            raise RuntimeError(f"{name} has the text to patch more than once: {old!r}")
        if text.count(old) == 1:
            path.write_text(text.replace(old, new))
            applied.add(switch)
    missing = [s for s in switches if s not in applied]
    if missing:
        raise RuntimeError(f"{csrc} has no text to patch for {missing}")
    return out


def bwd_ablation(src: Path, card: str) -> None:
    """The backward's variants (BWD_VARIANTS) at 2048 x 192 points on 8x256
    and 8x128 fields at L 10/4 (torch_bwd_tile_ab.py's shapes)."""
    import torch_bwd_tile_ab as ab

    libs = {name: ab.load(lib) for name, (lib, _) in
            zip(BWD_VARIANTS, ab.compile_many([(src, tuple(f)) for f in BWD_VARIANTS.values()]))}
    device = torch.device("cuda")
    build.load_library()
    for H in BWD_WIDTHS:
        shape = f"w{H} 2048x{192 if H == 256 else 128}"
        inputs = ab.shape_inputs(shape, device)
        for turn in range(2):
            for name, lib in libs.items():
                def call(lib=lib):
                    return fm.fused_mlp_bwd_cuda(*inputs, lib=lib)

                tile = chip_smoke._kernel_device_ms(call, ab.TILE_KERNEL)
                ms = chip_smoke._median_ms(call)
                print(f"bwd ablation turn {turn}, {shape}, {name}: tile kernel {tile:.4f} ms "
                      f"(torch.profiler, median of 7), call {ms:.4f} ms (CUDA events, median of "
                      f"7) [{card}]", flush=True)


def fwd_ablation(src: Path, card: str) -> None:
    """The forward's and sigma's variants (VARIANTS) at FWD_CASES."""
    from torch_fwd_tile_ab import compile_many, field, print_usage

    built = compile_many([(src, tuple(f)) for f in VARIANTS.values()], FWD_SOURCES,
                         OUT / "libs", "libfwd_ablation")
    libs = {}
    for name, (path, log) in zip(VARIANTS, built):
        print_usage(name, log, widths=(128, 256))
        libs[name] = load(path)
    device = torch.device("cuda")
    build.load_library()
    for kernel, H, n, S in FWD_CASES:
        rng = np.random.default_rng(0)
        packed = field(H, rng, device)
        if kernel == "fwd":
            o, d, z = chip_smoke._rays(n, S, rng, device)
            shape = f"fwd w{H} {n}x{S}"

            def call(lib):
                return fm.fused_mlp_cuda(packed, o, d, z, lib=lib)
        else:
            pts = torch.from_numpy(rng.uniform(-1.2, 1.2, (n, 3)).astype(np.float32)).to(device)
            shape = f"sigma w{H} {n}"

            def call(lib):
                return fm.fused_sigma_cuda(packed, pts, lib=lib)
        for turn in range(2):
            for name, lib in libs.items():
                ms = chip_smoke._median_ms(lambda lib=lib: call(lib))
                print(f"field ablation turn {turn}, {shape}, {name}: {ms:.4f} ms (CUDA events, "
                      f"median of 7) [{card}]", flush=True)
        del call, packed
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("torch_field_ablation.py needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.splitlines()[0]
    print(card)
    csrc = (Path(args[args.index("--tree") + 1]).resolve() / "nerfmeshes_tpu_torch" / "csrc"
            if "--tree" in args else build.CSRC_DIR)
    switches = (() if "--bwd" in args else FWD_SWITCHES) + (() if "--fwd" in args
                                                           else BWD_SWITCHES)
    src = patched_sources(csrc, switches)
    if "--fwd" not in args:
        bwd_ablation(src, card)
    if "--bwd" not in args:
        fwd_ablation(src, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
