#!/usr/bin/env python3
"""Where the fused field kernels' time goes, on the card: the forward of
nerfmeshes_tpu_torch/csrc/fused_mlp_fwd.cu and the backward's tile kernel
(csrc/fused_mlp_bwd.cuh) timed at 2048 x 192 points (the train path's fine
pass, lego width; the backward at hard-llff.yml's 8x128 too) as they are
and with parts cut out of a copy of their sources.

    python3 scripts/torch_field_ablation.py [--fwd | --bwd]   # needs one CUDA card and nvcc

Variants (compile-time switches patched into a copy under
build/field_ablation/, never into the package). The forward:
- full: the kernel as it is;
- no PE: the positional-encoding tiles are never built (the products read
  whatever the tiles hold);
- no epilogue: no bias, ReLU or store between products (each layer reads
  the activation tile as the layer before left it);
- neither: both cut, leaving the TMA weight ring and the wgmma products.
The backward's tile kernel:
- full;
- no stash stores: neither the TMA stores of the activation tiles (act,
  feat, dy, dy_dir) nor the PE rows and the dir layer's h;
- no column sums: no colsum8 and no flush of the bias partials;
- no mask words: the forward's ReLU mask bits neither stored nor loaded
  (the dX epilogues mask with zero words);
- none of the three.
The cut variants compute garbage; only their times mean anything. Each
variant is built with its own nvcc (the backward's two sources each), all
in parallel, and timed twice in turn (the forward by CUDA events, median of
7 after 2 warm-ups; the tile kernel by torch.profiler, median of 7 calls,
and its call by CUDA events), beside the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import shutil
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
from nerfmeshes_tpu_torch.ops.kernels import build  # noqa: E402
from nerfmeshes_tpu_torch.ops.kernels import fused_mlp as fm  # noqa: E402

OUT = REPO / "build" / "field_ablation"
R, S = 2048, 192
VARIANTS = {"full": [], "no PE": ["-DABLATE_PE"], "no epilogue": ["-DABLATE_EPILOGUE"],
            "neither": ["-DABLATE_PE", "-DABLATE_EPILOGUE"]}
BWD_VARIANTS = {"full": [], "no stash stores": ["-DABLATE_STASH"],
                "no column sums": ["-DABLATE_COLSUM"], "no mask words": ["-DABLATE_MASK"],
                "none of the three": ["-DABLATE_STASH", "-DABLATE_COLSUM", "-DABLATE_MASK"]}
BWD_WIDTHS = (256, 128)

# (file, line to patch, its replacement): each switch, off by default.
EDITS = [
    ("fused_field.cuh", "    if (chunk >= chunks) return;\n",
     "#ifdef ABLATE_PE\n    chunk = chunks;\n#endif\n    if (chunk >= chunks) return;\n"),
    ("fused_field.cuh", "#pragma unroll\n  for (int n0 = 0; n0 < CHUNKS; n0 += 8) {",
     "#ifdef ABLATE_EPILOGUE\n  if (wa != nullptr) s0 += acc[0];\n  return;\n#endif\n"
     "#pragma unroll\n  for (int n0 = 0; n0 < CHUNKS; n0 += 8) {"),
    ("fused_field.cuh", "      if constexpr (STASH)\n",
     "#ifndef ABLATE_STASH\n      if constexpr (STASH)\n#else\n      if constexpr (false)\n#endif\n"),
    ("fused_mlp_bwd.cuh", "    if (bits != nullptr) bits[n0 / 8 * WG_THREADS] = mb;\n",
     "#ifndef ABLATE_MASK\n    if (bits != nullptr) bits[n0 / 8 * WG_THREADS] = mb;\n#endif\n"),
    ("fused_mlp_bwd.cuh", "      if (!storer) return;\n",
     "#ifdef ABLATE_STASH\n      return;\n#endif\n      if (!storer) return;\n"),
    ("fused_mlp_bwd.cuh",
     "        *reinterpret_cast<uint32_t*>(h_out + r * (H / 2) + col) = lo;\n"
     "        *reinterpret_cast<uint32_t*>(h_out + (r + 8) * (H / 2) + col) = hi;\n",
     "#ifndef ABLATE_STASH\n"
     "        *reinterpret_cast<uint32_t*>(h_out + r * (H / 2) + col) = lo;\n"
     "        *reinterpret_cast<uint32_t*>(h_out + (r + 8) * (H / 2) + col) = hi;\n#endif\n"),
    ("fused_mlp_bwd.cuh", "    colsum8<R / 4>(cs, part, n0, q, lane);\n",
     "#ifndef ABLATE_COLSUM\n    colsum8<R / 4>(cs, part, n0, q, lane);\n#endif\n"),
    ("fused_mlp_bwd.cuh", "        flush_colsum(part, part_ld(H), NW, db + d.b_off[g] + col0, t);\n",
     "#ifndef ABLATE_COLSUM\n"
     "        flush_colsum(part, part_ld(H), NW, db + d.b_off[g] + col0, t);\n#endif\n"),
    ("fused_mlp_bwd.cuh",
     "        if (g > 0) load_mask(mw, a.bits + mask_words(H, a.n_tiles, g, tile, u, t));\n",
     "#ifndef ABLATE_MASK\n"
     "        if (g > 0) load_mask(mw, a.bits + mask_words(H, a.n_tiles, g, tile, u, t));\n"
     "#endif\n"),
]


def patched_sources(out: Path = OUT) -> Path:
    """A copy of csrc/ at `out` whose field kernels honour the ABLATE_*
    switches (EDITS); raises where a source no longer has a line to
    patch."""
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(build.CSRC_DIR, out)
    for name, old, new in EDITS:
        path = out / name
        text = path.read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"{name} no longer has the line to patch: {old!r}")
        path.write_text(text.replace(old, new))
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


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("torch_field_ablation.py needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.splitlines()[0]
    src = patched_sources()
    if "--fwd" not in args:
        bwd_ablation(src, card)
    if "--bwd" in args:
        return 0
    nvcc = build.find_nvcc()
    jobs = {}
    for name, flags in VARIANTS.items():
        lib = src / f"lib_{name.replace(' ', '_')}.so"
        cmd = [nvcc, *build.NVCC_FLAGS, *flags, "-shared", "-o", str(lib),
               str(src / "fused_mlp_fwd.cu")]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(str(lib)).nm_fused_mlp_fwd
        fn.restype, fn.argtypes = build.SIGNATURES["nm_fused_mlp_fwd"]
        fns[name] = fn

    device = torch.device("cuda")
    torch.manual_seed(0)
    model = FlexibleNeRFModel(num_layers=8, hidden_size=256, skip_step=4, num_encoding_fn_xyz=10,
                              num_encoding_fn_dir=4, compute_dtype=torch.bfloat16, device=device)
    packed = fm.pack_weights(model)
    rng = np.random.default_rng(0)
    o = rng.standard_normal((R, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = -o + rng.uniform(-1.0, 1.0, (R, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    z = np.sort(rng.uniform(2.0, 6.0, (R, S)), axis=1)
    o, d, z = (torch.from_numpy(a.astype(np.float32)).to(device) for a in (o, d, z))
    out = torch.empty((4, R, S), device=device)

    def launch(fn):
        rc = fn(o.data_ptr(), d.data_ptr(), z.data_ptr(), R, S, packed.weights.data_ptr(),
                packed.biases.data_ptr(), packed.desc.ctypes.data, packed.desc.size,
                packed.freqs.ctypes.data, packed.freqs.size, out.data_ptr(), 1,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: CUDA error {rc}")

    def median_ms(fn, runs=7, warmup=2):
        for _ in range(warmup):
            launch(fn)
        torch.cuda.synchronize()
        times = []
        for _ in range(runs):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            launch(fn)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    flops = 2 * sum(p.numel() for n, p in model.named_parameters() if n.endswith("weight"))
    for turn in range(2):
        for name, fn in fns.items():
            ms = median_ms(fn)
            print(f"field ablation turn {turn}, {name}: {ms:.4f} ms at {R}x{S} points, "
                  f"{flops * R * S / ms / 1e9:.1f} TFLOP/s [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
