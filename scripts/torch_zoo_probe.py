#!/usr/bin/env python3
"""The zoo models on a CUDA card against their CPU run, and their time.

    python3 scripts/torch_zoo_probe.py      # from the repo root, on a GPU host

For each MODEL_REGISTRY model but FlexibleNeRFModel, at its class
defaults, in f32 and bf16: random weights from a seeded generator on the
CPU, copied to the card; 2048 rays x 64 points along camera rays of the
scene (origins on the sphere of radius 4, depths 2-6). Prints the largest
difference of the spatial embedding's output and of the field between
the card and the CPU, the worst relative grad difference of sum(field^2),
and the wall time of one forward + backward on the card (the first, and
one after it) and on the CPU. chip_smoke.py's zoo_phase holds the same
comparison to its bars; this script only reports.
"""

import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from nerfmeshes_tpu_torch.models.nerf_models import MODEL_REGISTRY, build_model, field_of  # noqa: E402
from nerfmeshes_tpu_torch.train.system import init_params  # noqa: E402


def points(R: int = 2048, S: int = 64, seed: int = 0):
    rng = np.random.default_rng(seed)
    o = rng.standard_normal((R, 3))
    o = 4 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = -o / 4 + 0.2 * rng.standard_normal((R, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pts = (o[:, None] + d[:, None] * np.linspace(2, 6, S)[None, :, None]).astype(np.float32)
    dirs = np.broadcast_to(d[:, None], pts.shape).astype(np.float32).copy()
    return torch.from_numpy(pts), torch.from_numpy(dirs)


def step(model, pts, dirs):
    model.zero_grad(set_to_none=True)
    field = field_of(model(pts, dirs))
    (field ** 2).sum().backward()
    return field.detach()


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    pts, dirs = points()
    for name in MODEL_REGISTRY:
        if name == "FlexibleNeRFModel":
            continue
        for dtype in (torch.float32, torch.bfloat16):
            cpu = build_model(name, {}, compute_dtype=dtype)
            init_params(cpu, None, torch.Generator().manual_seed(0))
            card = build_model(name, {}, compute_dtype=dtype)
            card.load_state_dict(cpu.state_dict())
            card.cuda()
            with torch.no_grad():
                emb = (cpu.encode_xyz(pts) - card.encode_xyz(pts.cuda()).cpu()).abs()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(card, pts.cuda(), dirs.cuda())
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            got = step(card, pts.cuda(), dirs.cuda()).cpu()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            want = step(cpu, pts, dirs)
            t3 = time.perf_counter()
            grad = max(float((a.grad - b.grad.cpu()).abs().max() / (a.grad.abs().max() + 1e-9))
                       for a, b in zip(cpu.parameters(), card.parameters()))
            print(f"{name} {dtype}: embedding max diff {float(emb.max()):.3e}; field max diff "
                  f"{float((got - want).abs().max()):.3e}; grads worst rel {grad:.3e}; card ms "
                  f"{1e3 * (t2 - t1):.2f} (first {1e3 * (t1 - t0):.1f}); cpu s {t3 - t2:.2f}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
