#!/usr/bin/env python3
"""The fused backward kernel against its plain version, layer by layer: the
activations the tile kernel stashes (csrc/fused_mlp_bwd.cu, stash_layout)
beside the plain version's bf16 recompute, and the worst relative error
of each weight and bias grad. It tells rounding noise from a fault: how
many stashed values differ, how many ReLU masks flipped and at what
values, and how the differences split between the two column halves
(the two consumer warpgroups' columns at H > 256).

    python scripts/torch_bwd_stash_diff.py          # needs a CUDA card

Cases: the hard-blender field (8 layers, L 10/4) at H = 256 and 512 on
1000 rays x 7 samples for seeds 0-2, 512 on 37 x 5, and a 14-layer
384-wide pack with 24/24 bands on 300 x 3. Prints one line per case and
one per stashed layer; the weights and rays come from the GPU tests'
seeded helpers.
"""

from __future__ import annotations

import ctypes
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import test_torch_fused_mlp_gpu as gpu_tests  # noqa: E402

from nerfmeshes_tpu_torch.ops.kernels import build  # noqa: E402
from nerfmeshes_tpu_torch.ops.kernels import fused_mlp as fm  # noqa: E402


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _plain_activations(packed, o, d, z) -> list:
    """The plain backward's recompute: each trunk layer's bf16 output."""
    spec = packed.spec
    pts = (o[:, None, :] + d[:, None, :] * z[..., None]).reshape(-1, 3)
    pe_x = _bf16(fm._padded_pe(pts, spec.L_x, spec.include_x, spec.log_x, spec.pxp))
    xs = [_bf16(fm._layer(packed, pe_x, 0, spec.hidden, relu=False))]
    for i in range(spec.num_layers - 1):
        a = torch.cat([xs[-1], pe_x], 1) if i in spec.skip_layers else xs[-1]
        xs.append(_bf16(fm._layer(packed, a, 1 + i, spec.hidden, relu=True)))
    return xs


def compare(label: str, packed, args) -> float:
    """Runs the kernel on a workspace it can read back; prints the worst
    grads and the stash's differences; returns the worst relative error."""
    spec = packed.spec
    H, L = spec.hidden, spec.num_layers
    o, d, z, _ = args
    n = z.numel()
    n_pad = -(-n // 128) * 128
    lib = build.load_library()
    nbytes = ctypes.c_longlong(0)
    rc = lib.nm_fused_mlp_bwd_workspace(packed.desc.ctypes.data, packed.desc.size,
                                        packed.freqs.ctypes.data, packed.freqs.size, n,
                                        ctypes.byref(nbytes))
    build.check(lib, rc, "fused_mlp_bwd workspace")
    workspace = torch.zeros(nbytes.value, dtype=torch.uint8, device=z.device)
    got = gpu_tests._bwd_into(packed, args, workspace)
    torch.cuda.synchronize()
    want = fm.fused_mlp_bwd_plain(packed, *args)
    g, w = packed.segments(*got), packed.segments(*want)
    rel = {k: float((g[k] - w[k]).abs().max() / (w[k].abs().max() + 1e-6)) for k in w}
    top = sorted(rel, key=rel.get, reverse=True)[:4]
    print(f"{label} H={H} L={L} {n} points: worst rel grad err "
          + ", ".join(f"{k} {rel[k]:.4f}" for k in top))
    stash = workspace.view(torch.bfloat16)
    act0 = n_pad * (spec.pxp + spec.pdp)
    for i, plain in enumerate(_plain_activations(packed, o, d, z)):
        kern = stash[act0 + i * n_pad * H:act0 + (i + 1) * n_pad * H].view(n_pad, H)[:n].float()
        differ = kern != plain
        flips = ((kern > 0) != (plain > 0)).nonzero()
        at = torch.maximum(kern, plain)[flips[:, 0], flips[:, 1]]
        near = float(at.max()) if len(flips) else 0.0
        print(f"  act[{i}]: {int(differ.sum())} of {kern.numel()} values differ "
              f"({int(differ[:, :H // 2].sum())} / {int(differ[:, H // 2:].sum())} by column "
              f"half), {len(flips)} ReLU masks flipped, at |x| <= {near:.3e}")
    return rel[top[0]]


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    cuda = torch.device("cuda")
    lego = gpu_tests.LEGO
    worst = {256: [], 512: []}
    for seed in (0, 1, 2):
        for H in (256, 512):
            packed, args = gpu_tests._grad_case(dict(lego, hidden_size=H), 1000, 7, cuda, seed)
            worst[H].append(compare(f"seed {seed}", packed, args))
    compare("ragged", *gpu_tests._grad_case(dict(lego, hidden_size=512), 37, 5, cuda))
    packed = gpu_tests._pack_with_skips(384, fm.MAX_LAYERS, (4, 8), cuda, L_x=24, L_d=24)
    o, d, z = gpu_tests._rays(300, 3, cuda, seed=7)
    cot = torch.randn((4, 300, 3), generator=torch.Generator(cuda).manual_seed(8), device=cuda)
    compare("edge", packed, (o, d, z, cot))
    for H, errs in worst.items():
        print(f"H={H}, 7000 points, seeds 0-2: worst rel grad err "
              f"{min(errs):.4f}-{max(errs):.4f} [{torch.cuda.get_device_name(0)}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
