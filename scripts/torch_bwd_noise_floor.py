#!/usr/bin/env python3
"""The fused backward's worst relative grad error against its plain
version, beside the same metric between two plain runs that differ only in
the order of their f32 sums (the card's cuBLAS against the host CPU's
BLAS): the noise floor a kernel that rounds alike but sums in another
order cannot beat. Also where the kernel's error sits: for the worst
weight, its largest |kernel - plain| in each quarter of the output
columns (at H > 512 the quarters are the four warpgroups of a CTA pair; a
fault in one of them shows as one quarter far above the others).

    python scripts/torch_bwd_noise_floor.py [--seeds 0 1 2]    # needs a CUDA card

Cases: the GPU tests' deep edges (tests/test_torch_fused_mlp_gpu.py) at
2049 x 63 rays x samples: the 14-layer packs with skips at trunk layers 4
and 8 (`_pack_with_skips`) at (H, L_x, L_d) = (512, 15, 4), (640, 24,
24), (768, 24, 24), (1024, 15, 4), and the 14-layer FlexibleNeRF at 512
and 1024 (L 15/4, skip step 4).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import test_torch_fused_mlp_gpu as gpu_tests  # noqa: E402

from nerfmeshes_tpu_torch.ops.kernels import fused_mlp as fm  # noqa: E402

R, S = 2049, 63


def _rel(packed, got, want) -> dict:
    g, w = packed.segments(*got), packed.segments(*want)
    return {k: float((g[k] - w[k]).abs().max() / (w[k].abs().max() + 1e-6)) for k in w}


def case(label: str, packed, args) -> None:
    got = fm.fused_mlp_bwd_cuda(packed, *args)
    torch.cuda.synchronize()
    want = fm.fused_mlp_bwd_plain(packed, *args)
    cpu_packed = packed._replace(weights=packed.weights.cpu(), biases=packed.biases.cpu())
    host = fm.fused_mlp_bwd_plain(cpu_packed, *(a.cpu() for a in args))
    kern = _rel(packed, got, want)
    floor = _rel(packed, tuple(h.to(want[0].device) for h in host), want)
    worst = max(kern, key=kern.get)
    top = max(floor, key=floor.get)
    H = packed.spec.hidden
    g, w = packed.segments(*got), packed.segments(*want)
    diff = (g[worst] - w[worst]).abs()
    rows = diff.shape[0]
    quarters = [float(diff[q * rows // 4:(q + 1) * rows // 4].max()) for q in range(4)]
    print(f"{label} H={H}: kernel vs plain worst {kern[worst]:.4f} ({worst}); host plain vs "
          f"card plain worst {floor[top]:.4f} ({top}), at {worst} {floor[worst]:.4f}; "
          f"{worst} max |kernel - plain| by output-column quarter "
          + ", ".join(f"{v:.3e}" for v in quarters) + f" (max |plain| "
          f"{float(w[worst].abs().max()):.3e}) [{torch.cuda.get_device_name(0)}]", flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seeds", type=int, nargs="*", default=[0])
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    cuda = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    for seed in opts.seeds:
        for H, lx, ld in ((512, 15, 4), (640, 24, 24), (768, 24, 24), (1024, 15, 4)):
            packed = gpu_tests._pack_with_skips(H, fm.MAX_LAYERS, (4, 8), cuda, seed=seed,
                                                L_x=lx, L_d=ld)
            o, d, z = gpu_tests._rays(R, S, cuda, seed=7 + seed)
            cot = torch.from_numpy(np.random.default_rng(8 + seed).standard_normal((4, R, S))
                                   .astype(np.float32)).to(cuda)
            case(f"seed {seed} pack 14 layers L {lx}/{ld}", packed, (o, d, z, cot))
        for H in (512, 1024):
            kw = dict(gpu_tests.LEGO, hidden_size=H, num_layers=fm.MAX_LAYERS,
                      num_encoding_fn_xyz=15)
            case(f"seed {seed} FlexibleNeRF 14 layers L 15/4",
                 *gpu_tests._grad_case(kw, R, S, cuda, seed))
    return 0


if __name__ == "__main__":
    sys.exit(main())
