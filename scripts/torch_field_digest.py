#!/usr/bin/env python3
"""SHA-256 digests of the fused forward and sigma kernels' outputs, and of
the backward's bias and weight grads, on one seeded lego-width case,
printed as one JSON line: the check that a change to a kernel leaves the
bits it does not mean to change as they were (the forward and sigma
kernels share nerfmeshes_tpu_torch/csrc/fused_field.cuh with the
backward's tile kernel; the backward's dB comes from the tile kernel
alone, its dW also from the dW leg). With --bwd, the fused backward's dW
and dB and its stash (bwd_digests) at H = 128, 256
and 384 on seeded 8-layer fields (BWD_R x S rays: a ragged last tile),
through another checkout's build with --tree ROOT (its fused_mlp_bwd.cu,
compiled alone as scripts/torch_bwd_tile_ab.py does). With --layers, the same four of the
layer route (csrc/field_layers.cu) on a seeded 8x1024 field at mip-NeRF's
16 position bands, and the digest of the dir layer's cotangent dy_dir
that its backward heads kernel leaves in the workspace: the check that a
change to the route's kernels keeps its bits. With --tree ROOT, the layer
route's digests through another checkout's field_layers.cu (compiled
alone, as scripts/torch_layer_product_ab.py does). With --fwd, the fused
forward's (4, BWD_R, S) output and the sigma kernel's (POINTS,) output at
H = 128, 256 and 384 on seeded 8-layer fields (fwd_digests), through
another checkout's fused_mlp_fwd.cu and fused_sigma.cu with --tree ROOT
(compiled alone, as scripts/torch_fwd_tile_ab.py does).
tests/test_torch_fused_mlp_gpu.py holds the kernels to the digests this
script printed before such a change.

    python scripts/torch_field_digest.py [--layers | --bwd | --fwd] [--tree ROOT]   # a CUDA card

The weights and inputs come from numpy's generator seeded 0, so the case
does not depend on torch's random streams.
"""

from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from nerfmeshes_tpu_torch.models import FlexibleNeRFModel  # noqa: E402
from nerfmeshes_tpu_torch.ops.kernels import build  # noqa: E402
from nerfmeshes_tpu_torch.ops.kernels import field_layers as fl  # noqa: E402
from nerfmeshes_tpu_torch.ops.kernels import fused_mlp as fm  # noqa: E402

R, S, POINTS = 2048, 64, 65536
LAYER_R = 512  # rays of the layer route's case (x S samples)
BWD_R = 1999  # rays of the fused backward's cases: 127,936 points, 64 past the last whole tile
BWD_WIDTHS = (128, 256, 384)


def _sha(t: torch.Tensor) -> str:
    t = t.contiguous()
    if t.dtype == torch.bfloat16:  # numpy has no bf16: the same bytes as int16
        t = t.view(torch.int16)
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()


def _seeded_case(rng, device, rays: int, **arch):
    """A bf16 FlexibleNeRF field of `arch` with weights from rng, packed on
    device, and (rays, S) camera-like rays and POINTS grid points."""
    model = FlexibleNeRFModel(**arch, compute_dtype=torch.bfloat16)
    with torch.no_grad():
        for p in model.parameters():
            w = rng.standard_normal(tuple(p.shape)) / np.sqrt(p.shape[-1])
            p.copy_(torch.from_numpy(w.astype(np.float32)))
    packed = fm.pack_weights(model.to(device))
    o = rng.standard_normal((rays, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = -o + rng.uniform(-1.0, 1.0, (rays, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    z = np.sort(rng.uniform(2.0, 6.0, (rays, S)), axis=1)
    pts = rng.uniform(-1.2, 1.2, (POINTS, 3))
    o, d, z, pts = (torch.from_numpy(a.astype(np.float32)).to(device) for a in (o, d, z, pts))
    cot = np.random.default_rng(1).standard_normal((4, rays, S))
    return packed, o, d, z, pts, torch.from_numpy(cot.astype(np.float32)).to(device)


def digests(device) -> dict:
    """{"fwd": digest of the (4, R, S) forward, "sigma": of the (POINTS,)
    sigma kernel's output, "bwd_dB" / "bwd_dW": of the backward's f32
    grads for a seeded (4, R, S) cotangent}, all launched on `device`."""
    packed, o, d, z, pts, cot = _seeded_case(
        np.random.default_rng(0), device, R, num_layers=8, hidden_size=256, skip_step=4,
        num_encoding_fn_xyz=10, num_encoding_fn_dir=4)
    fwd = fm.fused_mlp_cuda(packed, o, d, z)
    sigma = fm.fused_sigma_cuda(packed, pts)
    dW, dB = fm.fused_mlp_bwd_cuda(packed, o, d, z, cot)
    torch.cuda.synchronize()
    return {"fwd": _sha(fwd), "sigma": _sha(sigma), "bwd_dB": _sha(dB), "bwd_dW": _sha(dW)}


def bwd_digests(device, lib=None) -> dict:
    """{"w128" | "w256" | "w384": {"dW", "dB": of the fused backward's f32
    grads, "act", "dy", "stash": of its stash's act and feat regions, its
    dy and dy_dir regions (the rows the tile kernel sends by TMA stores),
    and the whole stash}}
    on an 8-layer field at L 10/4 of each of BWD_WIDTHS, weights, BWD_R x
    S rays and cotangent seeded, launched on `device` through `lib`
    (default this tree's build)."""
    out = {}
    for hidden in BWD_WIDTHS:
        packed, o, d, z, _, cot = _seeded_case(
            np.random.default_rng(0), device, BWD_R, num_layers=8, hidden_size=hidden,
            skip_step=4, num_encoding_fn_xyz=10, num_encoding_fn_dir=4)
        n = z.numel()
        workspace = torch.empty(fm.bwd_workspace_bytes(packed, n, lib), dtype=torch.uint8,
                                device=device)
        dW, dB = fm.fused_mlp_bwd_cuda(packed, o, d, z, cot, lib=lib, workspace=workspace)
        torch.cuda.synchronize()
        st = fm.stash_layout(packed.spec, -(-n // 128) * 128)
        stash = workspace.view(torch.bfloat16)
        out[f"w{hidden}"] = {"dW": _sha(dW), "dB": _sha(dB),
                             "act": _sha(stash[st["act"]:st["h"]]),
                             "dy": _sha(stash[st["dy"]:st["dy_a"]]),
                             "stash": _sha(stash[:st["end"]])}
    return out


def fwd_digests(device, lib=None) -> dict:
    """{"w128" | "w256" | "w384": {"fwd": of the forward's (4, BWD_R, S)
    output (a ragged last tile), "sigma": of the sigma kernel's (POINTS,)
    output}} on an 8-layer field at L 10/4 of each of BWD_WIDTHS, weights,
    rays and points seeded, launched on `device` through `lib` (default
    this tree's build)."""
    out = {}
    for hidden in BWD_WIDTHS:
        packed, o, d, z, pts, _ = _seeded_case(
            np.random.default_rng(0), device, BWD_R, num_layers=8, hidden_size=hidden,
            skip_step=4, num_encoding_fn_xyz=10, num_encoding_fn_dir=4)
        fwd = fm.fused_mlp_cuda(packed, o, d, z, lib=lib)
        sigma = fm.fused_sigma_cuda(packed, pts, lib=lib)
        torch.cuda.synchronize()
        out[f"w{hidden}"] = {"fwd": _sha(fwd), "sigma": _sha(sigma)}
    return out


def layer_digests(device, lib=None) -> dict:
    """The same four digests of the layer route on an 8x1024 field at L
    16/4 (LAYER_R x S rays, POINTS sigma points), launched on `device`
    through `lib` (default this tree's build), and "bwd_dy_dir", of the
    backward's dy_dir (one slab: every point's)."""
    from torch_layer_legs_ab import bwd_with_dy_dir

    packed, o, d, z, pts, cot = _seeded_case(
        np.random.default_rng(0), device, LAYER_R, num_layers=8, hidden_size=1024,
        skip_step=4, num_encoding_fn_xyz=16, num_encoding_fn_dir=4)
    if fm.field_route(packed.spec) != "layers":
        raise AssertionError("8x1024 at L 16/4 is not a model of the layer route")
    if fl.slab_points(packed.spec, "bwd", LAYER_R * S) < LAYER_R * S:
        raise AssertionError("the digest case's backward is not one slab")
    fwd = fl.layers_mlp_cuda(packed, o, d, z, lib=lib)
    sigma = fl.layers_sigma_cuda(packed, pts, lib=lib)
    dW, dB, dy_dir = bwd_with_dy_dir(packed, o, d, z, cot, lib or build.load_library())
    torch.cuda.synchronize()
    return {"fwd": _sha(fwd), "sigma": _sha(sigma), "bwd_dB": _sha(dB), "bwd_dW": _sha(dW),
            "bwd_dy_dir": _sha(dy_dir)}


if __name__ == "__main__":
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    args = sys.argv[1:]
    device = torch.device("cuda")
    tree = Path(args[args.index("--tree") + 1]).resolve() if "--tree" in args else None
    if "--bwd" in args:
        from torch_bwd_tile_ab import compile_tree as compile_bwd

        print(json.dumps(bwd_digests(device, compile_bwd(tree) if tree else None)))
    elif "--fwd" in args:
        from torch_fwd_tile_ab import compile_many
        from torch_layer_product_ab import load

        lib = (load(compile_many([(tree / "nerfmeshes_tpu_torch" / "csrc", ())])[0][0])
               if tree else None)
        print(json.dumps(fwd_digests(device, lib)))
    elif tree is not None:
        from torch_layer_product_ab import compile_tree, load

        print(json.dumps(layer_digests(device, load(compile_tree(tree)))))
    else:
        print(json.dumps((layer_digests if "--layers" in args else digests)(device)))
