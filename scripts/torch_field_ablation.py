#!/usr/bin/env python3
"""Where the forward field kernel's time goes, on the card: the kernel of
nerfmeshes_tpu_torch/csrc/fused_mlp_fwd.cu timed at 2048 x 192 points (the
render and train path's fine pass, lego width) as it is and with parts cut
out of a copy of its source.

    python3 scripts/torch_field_ablation.py      # needs one CUDA card and nvcc

Variants (compile-time switches patched into a copy under
build/field_ablation/, never into the package):
- full: the kernel as it is;
- no PE: the positional-encoding tiles are never built (the products read
  whatever the tiles hold);
- no epilogue: no bias, ReLU or store between products (each layer reads
  the activation tile as the layer before left it);
- neither: both cut, leaving the TMA weight ring and the wgmma products.
The cut variants compute garbage; only their times mean anything. Each
variant is built with its own nvcc, all in parallel, and timed twice in
turn (CUDA events, median of 7 after 2 warm-ups), beside the card's name and
power limit.
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

from nerfmeshes_tpu_torch.models import FlexibleNeRFModel  # noqa: E402
from nerfmeshes_tpu_torch.ops.kernels import build  # noqa: E402
from nerfmeshes_tpu_torch.ops.kernels import fused_mlp as fm  # noqa: E402

OUT = REPO / "build" / "field_ablation"
R, S = 2048, 192
VARIANTS = {"full": [], "no PE": ["-DABLATE_PE"], "no epilogue": ["-DABLATE_EPILOGUE"],
            "neither": ["-DABLATE_PE", "-DABLATE_EPILOGUE"]}


def patched_sources() -> Path:
    """A copy of csrc/ whose field kernel honours ABLATE_PE and
    ABLATE_EPILOGUE."""
    shutil.rmtree(OUT, ignore_errors=True)
    shutil.copytree(build.CSRC_DIR, OUT)
    path = OUT / "fused_field.cuh"
    text = path.read_text()
    edits = [
        ("    if (chunk >= chunks) return;\n",
         "#ifdef ABLATE_PE\n    chunk = chunks;\n#endif\n    if (chunk >= chunks) return;\n"),
        ("#pragma unroll\n  for (int n0 = 0; n0 < R / 4; n0 += 8) {",
         "#ifdef ABLATE_EPILOGUE\n  if (wa != nullptr) s0 += acc[0];\n  return;\n#endif\n"
         "#pragma unroll\n  for (int n0 = 0; n0 < R / 4; n0 += 8) {"),
    ]
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"fused_field.cuh no longer has the line to patch: {old!r}")
        text = text.replace(old, new)
    path.write_text(text)
    return OUT


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("torch_field_ablation.py needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.splitlines()[0]
    src = patched_sources()
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
