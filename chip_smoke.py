#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port, nerfmeshes_tpu_torch.

    python3 chip_smoke.py          # needs one CUDA card; no arguments

Builds the port's CUDA kernels from csrc/, checks each kernel against its
plain PyTorch version on the card at the shapes of the render path, then
drives the render path itself: a NeRFSystem at the lego architecture of
get_default_cfg() (2 x 8x256 FlexibleNeRF MLPs, 64+128 samples, chunk
2048, bf16, fused kernel on, random weights from the config's seed)
renders 2 full 400x400 views of data/hard_blender's test poses through
query_rays -> render_image. It shows that every chunk went through the
kernel (2 launches per chunk: coarse and fine) and that the maps are
finite and in range, and holds one chunk against the nn.Module path.

Prints, on lines of their own: the card's name and power limit as
nvidia-smi reports them, the build time, per-kernel error and times,
render rays/s, then a JSON line of the kernels, and last
{"ok": true, "device": {...}}. Any failed check raises, so the exit code
is non-zero and no "ok" line is printed. There is no CPU path.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent

# bf16 bar of the fused kernel against its reference, as in
# tests/test_fused_mlp.py:37.
ATOL = RTOL = 2e-2
SEED = 0


def _run(cmd: list[str]) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed: {proc.stderr.strip()}")
    return proc.stdout.strip()


def _median_ms(fn, runs: int = 7, warmup: int = 2) -> float:
    """Median device time of fn() in ms over `runs` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _rays(R: int, S: int, rng: np.random.Generator, device):
    """Camera-like rays of the lego scene: origins on the camera sphere
    (radius 4), unit directions aimed near the centre, sorted depths in
    [near, far] = [2, 6]."""
    o = rng.standard_normal((R, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = -o + rng.uniform(-1.0, 1.0, (R, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    z = np.sort(rng.uniform(2.0, 6.0, (R, S)), axis=1)
    return tuple(torch.from_numpy(a.astype(np.float32)).to(device) for a in (o, d, z))


def kernel_phase(cfg, card: str, device) -> dict:
    """Fused MLP kernel against its plain version at the render path's
    coarse (S=64) and fine (S=192) shapes, R = 2048 rays."""
    from nerfmeshes_tpu_torch.models import build_model
    from nerfmeshes_tpu_torch.ops.kernels import fused_mlp as fm
    from nerfmeshes_tpu_torch.train.system import init_params

    model = build_model(cfg.models.fine_type, dict(cfg.models.fine),
                        compute_dtype=torch.bfloat16)
    init_params(model, None, torch.Generator().manual_seed(SEED))
    model.to(device).eval()
    packed = fm.pack_weights(model)
    rng = np.random.default_rng(SEED)
    R = int(cfg.nerf.validation.chunksize)
    worst = 0.0
    for S in (int(cfg.nerf.validation.num_coarse),
              int(cfg.nerf.validation.num_coarse) + int(cfg.nerf.validation.num_fine)):
        o, d, z = _rays(R, S, rng, device)
        before = fm.launches
        got = fm.fused_mlp_cuda(packed, o, d, z)
        torch.cuda.synchronize()
        if fm.launches != before + 1:
            raise AssertionError(f"launch counter moved {fm.launches - before}, expected 1")
        ref = fm.fused_mlp_plain(packed, o, d, z)
        if got.shape != (4, R, S) or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"kernel output shape {tuple(got.shape)} or non-finite values")
        err_rgb = float((got[:3] - ref[:3]).abs().max())
        err_sigma = float((got[3] - ref[3]).abs().max())
        print(f"fused_mlp_fwd R={R} S={S}: max abs err rgb {err_rgb:.3e} sigma "
              f"{err_sigma:.3e} (bar atol=rtol={ATOL})")
        if not torch.allclose(got, ref, atol=ATOL, rtol=RTOL):
            raise AssertionError(f"kernel disagrees with the plain version at S={S}")
        worst = max(worst, err_rgb, err_sigma)

    # Times at the fine shape (the last one checked above).
    ms = _median_ms(lambda: fm.fused_mlp_cuda(packed, o, d, z))
    plain_ms = _median_ms(lambda: fm.fused_mlp_plain(packed, o, d, z))
    for name, t in (("kernel", ms), ("plain", plain_ms)):
        print(f"fused_mlp_fwd {name}: {t:.4f} ms median of 7, {R * S / t * 1e3:.4e} points/s "
              f"at {R}x{S} points [{card}]")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms)


def slice_phase(cfg, card: str, device) -> dict:
    """Two full views through NeRFSystem.query_rays with the kernel on."""
    from nerfmeshes_tpu_torch.data.blender_poses import read_blender_poses
    from nerfmeshes_tpu_torch.ops.kernels import fused_mlp as fm
    from nerfmeshes_tpu_torch.train.render import RenderSettings, render_rays
    from nerfmeshes_tpu_torch.train.step import make_pose_rays
    from nerfmeshes_tpu_torch.train.system import NeRFSystem

    system = NeRFSystem(cfg, device=device).setup_eval()
    poses, H, W, focal = read_blender_poses(REPO / "data" / "hard_blender", "test")
    pose_rays = make_pose_rays(H, W, focal, device=device)
    near, far = float(cfg.dataset.near), float(cfg.dataset.far)
    chunk = int(cfg.nerf.validation.chunksize)
    fields = ("rgb_map", "depth_map", "acc_map")

    # Warm-up: one chunk, before the counted run.
    o0, d0 = pose_rays(poses[0])
    system.query_rays(o0[:chunk], d0[:chunk], near, far, fields=fields, as_numpy=False)
    torch.cuda.synchronize()

    views = 2
    fm.launches = 0
    t0 = time.perf_counter()
    outs = []
    for v in range(views):
        o, d = pose_rays(poses[v])
        outs.append(system.query_rays(o, d, near, far, fields=fields, as_numpy=False))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = fm.launches

    n = H * W
    chunks = math.ceil(n / chunk)
    for out in outs:
        shapes = (tuple(out.rgb_map.shape), tuple(out.depth_map.shape), tuple(out.acc_map.shape))
        if shapes != ((n, 3), (n,), (n,)):
            raise AssertionError(f"map shapes {shapes}")
        for name in fields:
            if not bool(torch.isfinite(getattr(out, name)).all()):
                raise AssertionError(f"non-finite values in {name}")
        # rgb = sum_i w_i * sigmoid_i with sum_i w_i = acc <= 1 up to f32
        # rounding of the compositing sum.
        lo, hi = float(out.rgb_map.min()), float(out.rgb_map.max())
        if lo < 0.0 or hi > 1.0 + 1e-6:
            raise AssertionError(f"rgb outside [0, 1]: [{lo}, {hi}]")
    if launches != 2 * views * chunks:
        raise AssertionError(f"{launches} kernel launches for {views * chunks} chunks")
    rays_per_s = views * n / seconds
    print(f"render: {views} views {H}x{W}, {views * chunks} chunks of {chunk} rays, "
          f"{launches} kernel launches (2 per chunk), {seconds:.4f} s, "
          f"{rays_per_s:.6e} rays/s [{card}]")

    # One chunk through the nn.Module path (bf16 layers, no kernel).
    settings = RenderSettings.from_cfg(cfg, train=False)
    with torch.inference_mode():
        fused = render_rays(system.coarse, system.fine, o0[:chunk], d0[:chunk], near, far,
                            settings, train=False)[1]
        plain = render_rays(system.coarse, system.fine, o0[:chunk], d0[:chunk], near, far,
                            settings._replace(use_fused_kernel=False), train=False)[1]
    diff = float((fused.rgb_map - plain.rgb_map).abs().max())
    print(f"render chunk, fused kernel vs nn.Module path: max abs rgb diff {diff:.3e} (bar {ATOL})")
    # The nn.Module rounds every layer's output to bf16 where the kernel
    # keeps f32 until the next product, and the fine samples follow the
    # coarse weights continuously: both stay within the bf16 bar.
    if diff > ATOL:
        raise AssertionError("fused and nn.Module renders disagree")
    return dict(launches=launches, rays_per_s=rays_per_s, seconds=seconds)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    from nerfmeshes_tpu.config import get_default_cfg
    from nerfmeshes_tpu_torch.ops.kernels import build

    card = _run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    card = card.splitlines()[0]
    print(card)
    nvcc = _run([build.find_nvcc(), "--version"]).splitlines()[-1]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} nvcc {nvcc}")
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions: true f32 sums
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    path, log = build.build_library()
    build.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {path.name}")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    cfg = get_default_cfg()
    cfg.experiment.compute_dtype = "bfloat16"
    cfg.experiment.use_fused_kernel = True
    kern = kernel_phase(cfg, card, device)
    render = slice_phase(cfg, card, device)

    print(json.dumps({"kernels": [{
        "name": "fused_mlp_fwd",
        "route": "cuda",
        "source": "nerfmeshes_tpu_torch/csrc/fused_mlp_fwd.cu",
        "replaces": "nerfmeshes_tpu/ops/pallas/fused_mlp.py:387",
        "launches": render["launches"],
        "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"],
        "plain_ms": kern["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
