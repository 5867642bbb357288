#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port, nerfmeshes_tpu_torch.

    python3 chip_smoke.py          # needs one CUDA card; no arguments
    python3 chip_smoke.py --profile-mesh [STEPS ...]   # the mesh profile only
    python3 chip_smoke.py --profile-buff               # the BuFF step profile only

Builds the port's CUDA kernels from csrc/ (one nvcc per source, in
parallel) and the native mesh library (g++), checks each kernel against
its plain PyTorch version on the card at the shapes of the render, train
and mesh paths, then drives the hierarchical paths and the BuFF ones:

- render: a NeRFSystem at the lego architecture of get_default_cfg()
  (2 x 8x256 FlexibleNeRF MLPs, 64+128 samples, chunk 2048, bf16, fused
  kernels on, random weights from the config's seed) renders 2 full
  400x400 views of data/hard_blender's test poses through query_rays ->
  render_image. Every chunk goes through the forward kernel (2 launches
  per chunk: coarse and fine); the maps are finite and in range; one
  chunk is held against the nn.Module path.
- train: a NeRFSystem with the settings of configs/hard-blender.yml
  (built in code: the card's host may lack PyYAML), on the 20 training
  images of data/hard_blender, runs 30 steps through setup + fit after 3
  warm-up steps. Every step launches the forward and the backward kernel
  twice each (coarse and fine); the loss is finite at every step and
  falls; one step's grads through the kernels are held against the
  nn.Module path on the same batch; train rays/s is timed over the 30
  steps, synchronised.
- mesh: the train phase's system trains on to step 1000 (its field has a
  surface then), and export_marching_cubes meshes it with the mesh CLI's
  defaults (iso 32 with the adaptive clamp, limit 1.2, batch 65536) at
  480^3: 422 sigma-kernel launches of 262,144 grid points, sparse 8^3
  block transfer, native marching, the appearance pass along inverse
  normals (2 forward launches per chunk of 65536 rays), a binary .ply.
  The mesh is non-empty, finite, with unit normals, colours in [0, 1] and
  triangles inside the vertices, and the .ply reads back with its counts;
  the colours of three 2048-vertex slices agree with the nn.Module path's
  render of the same rays. The sigma kernel is held against its plain
  version and against the forward kernel's channel 3 on a 262,144-point
  tile of that grid first, and the forward kernel against its plain
  version at the appearance chunk's 65536 x 64 and 65536 x 192 points
  (plain on three 2048-ray slices of each launch).
- chords: the chord-compaction kernel against its plain version, bit for
  bit, at the BuFF paths' shapes (chords_kernel_phase).
- BuFF train: a BuFFSystem with the settings of configs/buff-hard-250k.yml
  (one 8x256 FlexibleNeRF, 2048 rays x 192 tree samples, a 12^3 tree of
  capacity 4096; cut to data/hard_blender and a 200-step consolidation
  schedule) runs 30 timed steps after 3 warm-ups (one chord, one forward
  and one backward launch per step; the loss falls), trains on to step
  1000 through four consolidations (the render right after the last one
  reads the new tree), then 30 more timed steps with integration on.
- BuFF render: 2 400x400 views through query_rays at chunk 65536 (one
  chord and one forward launch per chunk); one chunk's sampler is held bit
  for bit against the plain compaction's, its rgb against the nn.Module.
- BuFF mesh: export_marching_cubes of the trained BuFF field at 480^3,
  restricted to the tree's leaves, its appearance pass through the tree
  (one chord and one forward launch per chunk), with the mesh checks
  above.

Prints, on lines of their own: the card's name and power limit as
nvidia-smi reports them, the build time, per-kernel error, times, bound
and library yardstick, render and train rays/s of both systems, the mesh
phases' times, then a JSON line of the kernels, and last {"ok": true,
"device": {...}}. Any failed check
raises, so the exit code is non-zero and no "ok" line is printed. There
is no CPU path.
"""

from __future__ import annotations

import argparse
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

# bf16 bars of the fused kernels against their references: forward as in
# tests/test_fused_mlp.py:37, grads (worst relative error per weight) as
# in tests/test_fused_mlp.py:65.
ATOL = RTOL = 2e-2
GRAD_BAR = 5e-2
# Sigma kernel vs the forward kernel's channel 3: one trunk and alpha head
# code (tests/test_fused_mlp.py:182-193 holds the TPU kernels to 1e-5).
SIGMA_FWD_BAR = 1e-5
SEED = 0
WARMUP_STEPS = 3
TRAIN_STEPS = 30
# The mesh grid of scripts/bench_mesh.py and scripts/quality_800.py, the
# mesh CLI's extent, and the grid tile per sigma launch (extract.py).
MESH_RES = 480
MESH_LIMIT = 1.2
GRID_TILE = 262144
# The appearance pass's chunk at the mesh CLI's batch 65536 (extract.py),
# and the rays per slice its kernel output and colours are checked on.
APPEARANCE_CHUNK = 65536
CHECK_RAYS = 2048
# The field after the train phase's 33 steps is noise that fills the grid
# (some 4e7 vertices at 480^3, over a minute of appearance rendering);
# half of scripts/bench_mesh.py's 2000 steps gives a field with a surface.
MESH_TRAIN_STEPS = 1000

# configs/hard-blender.yml, the lego training workload, as overrides of
# get_default_cfg(); tests/test_torch_train.py holds them to the file.
HARD_BLENDER = {
    "experiment": {"id": "hard-blender", "randomseed": 42, "compute_dtype": "bfloat16",
                   "use_early_stopping": False},
    "dataset": {"type": "blender", "basedir": str(REPO / "data" / "hard_blender"),
                "near": 2.0, "far": 6.0, "white_background": False,
                "reduced_resolution": 1, "testskip": 1,
                "caching": {"use_caching": False,
                            "cache_dir": str(REPO / "cache" / "hard_blender")}},
    "models": {
        "coarse_type": "FlexibleNeRFModel", "fine_type": "FlexibleNeRFModel",
        "use_fine": True,
        "coarse": {"num_layers": 8, "skip_step": 4, "hidden_size": 256,
                   "num_encoding_fn_xyz": 10, "num_encoding_fn_dir": 4,
                   "use_viewdirs": True},
        "fine": {"num_layers": 8, "skip_step": 4, "hidden_size": 256,
                 "num_encoding_fn_xyz": 10, "num_encoding_fn_dir": 4,
                 "use_viewdirs": True},
    },
    "optimizer": {"type": "Adam", "lr": 5.0e-4},
    "scheduler": {"type": "DefaultScheduler", "options": {"gamma": 0.1, "step_size": 450000}},
    "nerf": {
        "train": {"num_random_rays": 2048, "chunksize": 2048, "perturb": True,
                  "num_coarse": 64, "num_fine": 128, "radiance_field_noise_std": 0.2,
                  "lindisp": False},
        "validation": {"chunksize": 65536, "perturb": False, "num_coarse": 64,
                       "num_fine": 128, "radiance_field_noise_std": 0.0,
                       "lindisp": False, "num_samples": 1},
    },
}


# configs/buff-hard-250k.yml's workload, as overrides of get_default_cfg();
# tests/test_torch_buff.py holds them to the file. One 8x256 FlexibleNeRF,
# 2048 rays of 192 tree samples, a 12^3 tree of capacity 4096. Cut: the
# 20 400x400 images of data/hard_blender instead of the procedural scene
# at 800^2 (not ported), and integration and consolidation every 200
# steps from step 200 instead of every 6000 from 6000, so that both run
# inside the smoke (consolidations after steps 400, 600, 800, 1000).
BUFF_TREE_STEP = 200
BUFF_TRAIN_STEPS = 1000
BUFF_CONSOLIDATIONS = [400, 600, 800, 1000]
_FLEX = {"num_layers": 8, "skip_step": 4, "hidden_size": 256, "num_encoding_fn_xyz": 10,
         "num_encoding_fn_dir": 4, "use_viewdirs": True}
BUFF_HARD = {
    "experiment": {"id": "buff-hard-250k", "model": "BuFFModel", "randomseed": 42,
                   "compute_dtype": "bfloat16", "use_early_stopping": False},
    "dataset": {"type": "blender", "basedir": str(REPO / "data" / "hard_blender"),
                "near": 2.0, "far": 6.0, "white_background": False},
    "models": {"coarse_type": "FlexibleNeRFModel", "fine_type": "FlexibleNeRFModel",
               "use_fine": False, "coarse": _FLEX, "fine": _FLEX},
    "optimizer": {"type": "Adam", "lr": 5.0e-4},
    "scheduler": {"type": "DefaultScheduler", "options": {"gamma": 0.1, "step_size": 450000}},
    "nerf": {
        "train": {"num_random_rays": 2048, "chunksize": 2048, "perturb": True,
                  "num_coarse": 192, "num_fine": 128, "radiance_field_noise_std": 0.2,
                  "lindisp": False},
        "validation": {"chunksize": 65536, "perturb": False, "num_coarse": 192,
                       "num_fine": 128, "radiance_field_noise_std": 0.0, "lindisp": False,
                       "num_samples": 2},
    },
    "tree": {"subdivision_outer_count": 12, "subdivision_inner_count": 2, "max_depth": 4,
             "eps": 1.0e-4, "use_random_sampling": False, "max_voxel_count": 4096,
             "step_size_integration_offset": BUFF_TREE_STEP, "step_size_tree": BUFF_TREE_STEP},
}
# Published dense peaks of one H100 SXM (the rates chip_smoke.py reckons
# each kernel's bound from): HBM bytes/s, bf16 tensor-core and f32 FLOP/s.
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
# FP32 operations per (ray, voxel) slab test of the chord kernel: 6
# subtractions, 6 multiplies, 6 selects, 8 comparisons, 4 max/min, 6
# logical ands (csrc/chords.cu).
CHORD_TEST_OPS = 36


def _merge(node, overrides: dict) -> None:
    for key, value in overrides.items():
        if key not in node:
            raise KeyError(f"unknown config key {key!r}")
        if isinstance(value, dict):
            _merge(node[key], value)
        else:
            node[key] = value


def hard_blender_cfg():
    """configs/hard-blender.yml's settings, plus the smoke's own: no
    validation (not ported yet), one step per call (a loss per step), and
    a print only at the end of a fit."""
    from nerfmeshes_tpu_torch.config import get_default_cfg

    cfg = get_default_cfg()
    _merge(cfg, HARD_BLENDER)
    cfg.experiment.validate_every = 0
    cfg.experiment.steps_per_call = 1
    cfg.experiment.print_every = 10 ** 9
    return cfg


def buff_hard_cfg():
    """configs/buff-hard-250k.yml's settings with the smoke's cuts
    (BUFF_HARD), no validation, one step per call, no prints."""
    from nerfmeshes_tpu_torch.config import get_default_cfg

    cfg = get_default_cfg()
    _merge(cfg, BUFF_HARD)
    cfg.experiment.validate_every = 0
    cfg.experiment.steps_per_call = 1
    cfg.experiment.print_every = 10 ** 9
    return cfg


def _bound_ms(flops: float, nbytes: float, peak_ops: float) -> tuple[float, str]:
    """(least time in ms, what bounds it): the larger of the operations over
    the peak rate of their type and the bytes over HBM's rate."""
    t_ops, t_bytes = flops / peak_ops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _field_flops(model, heads: bool = True) -> int:
    """FLOPs per point of a FlexibleNeRF field (2 per weight of each
    product, no padding): all products, or with heads=False the trunk and
    the alpha head only (the sigma kernel's work)."""
    skip = () if heads else ("fc_feat", "layers_dir", "fc_rgb")
    return 2 * sum(p.numel() for n, p in model.named_parameters()
                   if n.endswith("weight") and not n.startswith(skip))


def _run(cmd: list[str]) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed: {proc.stderr.strip()}")
    return proc.stdout.strip()


def _autocast(fn):
    """fn run under bf16 autocast: F.linear takes the cuBLAS bf16
    tensor-core path (the library yardstick of the MLP kernels)."""
    def run():
        with torch.autocast("cuda", dtype=torch.bfloat16):
            return fn()
    return run


def _kernel_device_ms(fn, key: str, runs: int = 7, warmup: int = 2) -> float:
    """Median device time in ms of the kernel named `key` that fn()
    launches once, from torch.profiler over `runs` calls. CUDA events
    around one call of a kernel that lasts microseconds time the host's
    enqueue of its wrapper instead."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        trace = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text())["traceEvents"]
    times = [e["dur"] / 1e3 for e in events if e.get("cat") == "kernel" and key in e["name"]]
    if len(times) != runs:
        raise AssertionError(f"{len(times)} {key} launches traced for {runs} calls")
    return statistics.median(times)


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


def _surface_rays(R: int, S: int, rng: np.random.Generator, device):
    """Rays of the mesh appearance pass: origins inside the mesh extent
    [-1.2, 1.2]^3, unit directions, sorted depths in [near, far] = [0, 4]
    (view_disparity_max_bound)."""
    o = rng.uniform(-MESH_LIMIT, MESH_LIMIT, (R, 3))
    d = rng.standard_normal((R, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    z = np.sort(rng.uniform(0.0, 4.0, (R, S)), axis=1)
    return tuple(torch.from_numpy(a.astype(np.float32)).to(device) for a in (o, d, z))


def kernel_phase(cfg, card: str, device) -> dict:
    """Fused MLP kernel against its plain version at the render path's
    coarse (S=64) and fine (S=192) shapes, R = 2048 rays, and at the mesh
    appearance pass's, R = 65536 rays (the plain version on three
    2048-ray slices of each launch: start, middle, end)."""
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

    # Times at the render fine shape (the last one checked above).
    ms = _median_ms(lambda: fm.fused_mlp_cuda(packed, o, d, z))
    plain_ms = _median_ms(lambda: fm.fused_mlp_plain(packed, o, d, z))
    # Library yardstick: the nn.Module at the same points under bf16
    # autocast (cuBLAS tensor-core products layer by layer), beside the
    # module as it is (f32 products of bf16-rounded operands); the port
    # never calls either for a fused-eligible model.
    pts = (o[:, None, :] + d[:, None, :] * z[..., None]).reshape(-1, 3)
    dirs = d[:, None, :].expand(R, S, 3).reshape(-1, 3)
    with torch.inference_mode():
        module_ms = _median_ms(lambda: model(pts, dirs))
        library_ms = _median_ms(_autocast(lambda: model(pts, dirs)))
    nbytes = (R * 24 + R * S * 4 + R * S * 16 + packed.weights.numel() * 2
              + packed.biases.numel() * 4)
    bound_ms, bound_by = _bound_ms(_field_flops(model) * R * S, nbytes, PEAK_BF16)
    for name, t in (("kernel", ms), ("plain", plain_ms), ("nn.Module", module_ms),
                    ("nn.Module bf16 autocast", library_ms), ("bound", bound_ms)):
        print(f"fused_mlp_fwd {name}: {t:.4f} ms, {R * S / t * 1e3:.4e} points/s "
              f"at {R}x{S} points [{card}]")

    # The appearance chunk: 4.2 M and 12.6 M points per launch. The plain
    # version works point by point, so slices of rays check it exactly.
    R = APPEARANCE_CHUNK
    for S in (int(cfg.nerf.validation.num_coarse),
              int(cfg.nerf.validation.num_coarse) + int(cfg.nerf.validation.num_fine)):
        o, d, z = _surface_rays(R, S, rng, device)
        before = fm.launches
        got = fm.fused_mlp_cuda(packed, o, d, z)
        torch.cuda.synchronize()
        if fm.launches != before + 1:
            raise AssertionError(f"launch counter moved {fm.launches - before}, expected 1")
        if got.shape != (4, R, S) or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"kernel output shape {tuple(got.shape)} or non-finite values")
        err = 0.0
        for start in (0, (R - CHECK_RAYS) // 2, R - CHECK_RAYS):
            rays = slice(start, start + CHECK_RAYS)
            ref = fm.fused_mlp_plain(packed, o[rays], d[rays], z[rays])
            if not torch.allclose(got[:, rays], ref, atol=ATOL, rtol=RTOL):
                raise AssertionError(f"kernel disagrees with the plain version at R={R} S={S}, "
                                     f"rays {start}..{start + CHECK_RAYS}")
            err = max(err, float((got[:, rays] - ref).abs().max()))
        print(f"fused_mlp_fwd R={R} S={S} (appearance chunk): max abs err {err:.3e} on rays "
              f"0, {(R - CHECK_RAYS) // 2}, {R - CHECK_RAYS} + {CHECK_RAYS} (bar atol=rtol={ATOL})")
        worst = max(worst, err)
    big_ms = _median_ms(lambda: fm.fused_mlp_cuda(packed, o, d, z))
    print(f"fused_mlp_fwd kernel: {big_ms:.4f} ms median of 7, {R * S / big_ms * 1e3:.4e} "
          f"points/s at {R}x{S} points [{card}]")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by)


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


def _rel_errors(packed, got, want) -> dict:
    """Worst |got - want| / max |want| per weight and bias of the pack."""
    g, w = packed.segments(*got), packed.segments(*want)
    return {k: float((g[k] - w[k]).abs().max() / (w[k].abs().max() + 1e-6)) for k in w}


def bwd_kernel_phase(cfg, card: str, device) -> dict:
    """Backward kernel against its plain version at the train path's
    coarse (S=64) and fine (S=192) shapes, R = 2048 rays, lego width, a
    seeded normal cotangent; two launches bitwise equal."""
    from nerfmeshes_tpu_torch.models import build_model
    from nerfmeshes_tpu_torch.ops.kernels import fused_mlp as fm
    from nerfmeshes_tpu_torch.train.system import init_params

    model = build_model(cfg.models.fine_type, dict(cfg.models.fine),
                        compute_dtype=torch.bfloat16)
    init_params(model, None, torch.Generator().manual_seed(SEED))
    model.to(device)
    packed = fm.pack_weights(model)
    rng = np.random.default_rng(SEED)
    R = int(cfg.nerf.train.num_random_rays)
    worst_rel = worst_abs = 0.0
    for S in (int(cfg.nerf.train.num_coarse),
              int(cfg.nerf.train.num_coarse) + int(cfg.nerf.train.num_fine)):
        o, d, z = _rays(R, S, rng, device)
        cot = torch.from_numpy(rng.standard_normal((4, R, S)).astype(np.float32)).to(device)
        before = fm.bwd_launches
        got = fm.fused_mlp_bwd_cuda(packed, o, d, z, cot)
        again = fm.fused_mlp_bwd_cuda(packed, o, d, z, cot)
        torch.cuda.synchronize()
        if fm.bwd_launches != before + 2:
            raise AssertionError(f"bwd launch counter moved {fm.bwd_launches - before}, "
                                 "expected 2")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"two backward launches differ at S={S}")
        want = fm.fused_mlp_bwd_plain(packed, o, d, z, cot)
        if not all(bool(torch.isfinite(g).all()) for g in got):
            raise AssertionError(f"non-finite grads from the backward kernel at S={S}")
        rel = _rel_errors(packed, got, want)
        name = max(rel, key=rel.get)
        abs_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        print(f"fused_mlp_bwd R={R} S={S}: worst rel grad err {rel[name]:.3e} ({name}), "
              f"max abs err {abs_err:.3e} (bar rel {GRAD_BAR}); 2 launches bitwise equal")
        if rel[name] >= GRAD_BAR:
            raise AssertionError(f"backward kernel disagrees with the plain version at S={S}")
        worst_rel = max(worst_rel, rel[name])
        worst_abs = max(worst_abs, abs_err)

    # Times at the fine shape (the last one checked above).
    ms = _median_ms(lambda: fm.fused_mlp_bwd_cuda(packed, o, d, z, cot))
    plain_ms = _median_ms(lambda: fm.fused_mlp_bwd_plain(packed, o, d, z, cot))
    # Library yardstick: the nn.Module's forward and autograd backward for
    # the same cotangent under bf16 autocast (the kernel recomputes the
    # forward too), beside the module as it is.
    pts = (o[:, None, :] + d[:, None, :] * z[..., None]).reshape(-1, 3)
    dirs = d[:, None, :].expand(R, S, 3).reshape(-1, 3)
    cot_points = cot.reshape(4, -1).t().contiguous()

    def module_grads():
        for p in model.parameters():
            p.grad = None
        model(pts, dirs).float().backward(cot_points)

    module_ms = _median_ms(module_grads)
    library_ms = _median_ms(_autocast(module_grads))
    for p in model.parameters():
        p.grad = None
    # Forward recompute, the dX chain and the dW products: 3x the forward.
    nbytes = (R * 24 + R * S * 4 + R * S * 16 + packed.weights.numel() * 2
              + (packed.weights.numel() + packed.biases.numel()) * 4)
    bound_ms, bound_by = _bound_ms(3 * _field_flops(model) * R * S, nbytes, PEAK_BF16)
    for name, t in (("kernel", ms), ("plain", plain_ms), ("nn.Module + autograd", module_ms),
                    ("nn.Module + autograd, bf16 autocast", library_ms), ("bound", bound_ms)):
        print(f"fused_mlp_bwd {name}: {t:.4f} ms, {R * S / t * 1e3:.4e} points/s "
              f"at {R}x{S} points [{card}]")
    return dict(max_abs_err=worst_abs, max_rel_err=worst_rel, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)


def train_phase(card: str, device) -> dict:
    """The train path: NeRFSystem.setup + fit at the hard-blender settings."""
    from nerfmeshes_tpu_torch.data.blender import train_arrays
    from nerfmeshes_tpu_torch.ops.kernels import fused_mlp as fm
    from nerfmeshes_tpu_torch.train.render import RenderSettings
    from nerfmeshes_tpu_torch.train.step import _sample_ray_batch, train_loss
    from nerfmeshes_tpu_torch.train.system import NeRFSystem

    class RecordingSystem(NeRFSystem):
        """Keeps every step's loss on the device (steps_per_call is 1)."""

        def on_step(self, step, metrics):
            self.losses.append(metrics["train/loss"])

    cfg = hard_blender_cfg()
    t0 = time.perf_counter()
    data = train_arrays(cfg, device)
    n_img, H, W = (int(v) for v in data["targets"].shape[:3])
    print(f"train data: {n_img} images {H}x{W} decoded and on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    system = RecordingSystem(cfg, device=device).setup(data)
    system.losses = []
    system.fit(WARMUP_STEPS)
    torch.cuda.synchronize()

    system.losses = []
    fm.launches = fm.bwd_launches = 0
    t0 = time.perf_counter()
    metrics = system.fit(WARMUP_STEPS + TRAIN_STEPS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    fwd, bwd = fm.launches, fm.bwd_launches
    losses = torch.stack(system.losses).cpu().tolist()  # the one fetch of the run

    if system.state.step != WARMUP_STEPS + TRAIN_STEPS or len(losses) != TRAIN_STEPS:
        raise AssertionError(f"step {system.state.step}, {len(losses)} losses recorded")
    if fwd != 2 * TRAIN_STEPS or bwd != 2 * TRAIN_STEPS:
        raise AssertionError(f"{fwd} forward and {bwd} backward launches for "
                             f"{TRAIN_STEPS} steps; expected 2 each per step")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    print(f"train losses: first 5 mean {first:.6f}, last 5 mean {last:.6f}; "
          f"step {system.state.step} loss {metrics['train/loss']:.6f} "
          f"lr {metrics['train/lr']:.6e}")
    if not last < first:
        raise AssertionError(f"loss did not fall: {losses}")

    # One step's grads, kernels vs nn.Module, on one batch at deterministic
    # settings so both paths sample the same depths.
    settings = RenderSettings.from_cfg(cfg, train=True)._replace(
        perturb=False, radiance_field_noise_std=0.0)
    batch = _sample_ray_batch(data, torch.Generator(device).manual_seed(SEED), H=H, W=W,
                              focal=float(data["hwf"][2]),
                              num_rays=int(cfg.nerf.train.num_random_rays), use_ndc=False)
    named = [(f"{tag}.{n}", p) for tag, m in (("coarse", system.coarse), ("fine", system.fine))
             for n, p in m.named_parameters()]

    def grads(use_fused):
        system.optimizer.zero_grad()
        loss, _ = train_loss(cfg, system.coarse, system.fine, *batch[:5],
                             settings=settings._replace(use_fused_kernel=use_fused))
        loss.backward()
        return {n: p.grad.clone() for n, p in named}

    fused, module = grads(True), grads(False)
    system.optimizer.zero_grad()
    rel = {n: float((fused[n] - module[n]).abs().max() / (module[n].abs().max() + 1e-6))
           for n in module}
    name = max(rel, key=rel.get)
    print(f"train step grads, fused kernels vs nn.Module path: worst rel err "
          f"{rel[name]:.3e} ({name}; bar {GRAD_BAR})")
    # The nn.Module rounds each layer's output (and its weight grads) to
    # bf16 where the kernels keep f32 until the next product, and the fine
    # samples follow the coarse weights continuously.
    if rel[name] >= GRAD_BAR:
        raise AssertionError("fused and nn.Module train grads disagree")

    rays_per_s = TRAIN_STEPS * int(cfg.nerf.train.num_random_rays) / seconds
    print(f"train: {TRAIN_STEPS} steps of {cfg.nerf.train.num_random_rays} rays in "
          f"{seconds:.4f} s, {fwd} forward + {bwd} backward kernel launches "
          f"(2 + 2 per step), {rays_per_s:.6e} rays/s [{card}]")
    return dict(fwd_launches=fwd, bwd_launches=bwd, rays_per_s=rays_per_s, seconds=seconds,
                grad_rel_err=rel[name], system=system)


def sigma_kernel_phase(cfg, card: str, device) -> dict:
    """Sigma kernel against its plain version and against the forward
    kernel's channel 3, on the lego fine model, at one grid tile of the
    480^3 mesh grid (limit 1.2) and at random points."""
    from nerfmeshes_tpu_torch.mesh.extract import grid_points
    from nerfmeshes_tpu_torch.models import build_model
    from nerfmeshes_tpu_torch.ops.kernels import fused_mlp as fm
    from nerfmeshes_tpu_torch.train.system import init_params

    model = build_model(cfg.models.fine_type, dict(cfg.models.fine),
                        compute_dtype=torch.bfloat16)
    init_params(model, None, torch.Generator().manual_seed(SEED))
    model.to(device).eval()
    packed = fm.pack_weights(model)
    n = MESH_RES ** 3
    start = (n // 2) // GRID_TILE * GRID_TILE  # the tile through the grid's centre
    idx = torch.arange(start, start + GRID_TILE, device=device)
    rng = np.random.default_rng(SEED)
    sets = {
        "grid tile": grid_points(idx, (MESH_RES,) * 3, MESH_LIMIT),
        "random": torch.from_numpy(rng.uniform(-MESH_LIMIT, MESH_LIMIT, (GRID_TILE, 3))
                                   .astype(np.float32)).to(device),
    }
    worst = 0.0
    for name, pts in sets.items():
        before = fm.sigma_launches
        got = fm.fused_sigma_cuda(packed, pts)
        torch.cuda.synchronize()
        if fm.sigma_launches != before + 1:
            raise AssertionError(f"sigma launch counter moved {fm.sigma_launches - before}, "
                                 "expected 1")
        if got.shape != (GRID_TILE,) or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"sigma kernel output shape {tuple(got.shape)} or non-finite")
        ref = fm.fused_sigma_plain(packed, pts)
        err = float((got - ref).abs().max())
        zeros = torch.zeros_like(pts)
        full = fm.fused_mlp_cuda(packed, pts, zeros, zeros[:, :1])[3, :, 0]
        err_fwd = float((got - full).abs().max())
        print(f"fused_sigma {name}, {GRID_TILE} points: max abs err vs plain {err:.3e} "
              f"(bar atol=rtol={ATOL}); vs forward kernel channel 3 {err_fwd:.3e} "
              f"(bar {SIGMA_FWD_BAR}; bitwise equal: {bool(torch.equal(got, full))})")
        if not torch.allclose(got, ref, atol=ATOL, rtol=RTOL):
            raise AssertionError(f"sigma kernel disagrees with the plain version ({name})")
        if err_fwd > SIGMA_FWD_BAR:
            raise AssertionError(f"sigma kernel disagrees with forward channel 3 ({name})")
        worst = max(worst, err)

    pts = sets["grid tile"]
    ms = _median_ms(lambda: fm.fused_sigma_cuda(packed, pts))
    plain_ms = _median_ms(lambda: fm.fused_sigma_plain(packed, pts))
    # Library yardstick: the nn.Module at the same points under bf16
    # autocast, beside the module as it is (all four channels: no PyTorch
    # call computes sigma alone).
    zeros = torch.zeros_like(pts)
    with torch.inference_mode():
        module_ms = _median_ms(lambda: model(pts, zeros))
        library_ms = _median_ms(_autocast(lambda: model(pts, zeros)))
    nbytes = GRID_TILE * 16 + packed.weights.numel() * 2 + packed.biases.numel() * 4
    bound_ms, bound_by = _bound_ms(_field_flops(model, heads=False) * GRID_TILE, nbytes,
                                   PEAK_BF16)
    for name, t in (("kernel", ms), ("plain", plain_ms), ("nn.Module", module_ms),
                    ("nn.Module bf16 autocast", library_ms), ("bound", bound_ms)):
        print(f"fused_sigma {name}: {t:.4f} ms, {GRID_TILE / t * 1e3:.4e} points/s "
              f"at {GRID_TILE} points [{card}]")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def _mesh_args(save_dir: str, res: int = MESH_RES):
    """The mesh CLI's defaults at `res`, to a binary .ply in save_dir."""
    from nerfmeshes_tpu_torch.mesh.extract import MeshArgs

    return MeshArgs(iso_level=32.0, limit=MESH_LIMIT, res=res, batch_size=APPEARANCE_CHUNK,
                    save_dir=save_dir, mesh_name="mesh.ply")


def mesh_phase(system, card: str) -> dict:
    """export_marching_cubes on the system the train phase trained, trained
    on to MESH_TRAIN_STEPS, with the mesh CLI's defaults (iso 32 with the
    clamp, limit 1.2, batch 65536) at 480^3, to a binary .ply in a
    temporary directory."""
    from nerfmeshes_tpu_torch.train.render import RenderSettings, render_rays

    t0 = time.perf_counter()
    system.fit(MESH_TRAIN_STEPS)
    torch.cuda.synchronize()
    print(f"mesh: trained on to step {system.state.step} in {time.perf_counter() - t0:.2f} s")
    settings = RenderSettings.from_cfg(system.cfg, train=False)._replace(use_fused_kernel=False)

    def module_rgb(o, d, near, far):
        return render_rays(system.coarse, system.fine, o, d, near, far, settings,
                           train=False)[1].rgb_map

    return export_and_check(system, card, "mesh", fwd_per_chunk=2, chords_per_chunk=0,
                            module_rgb=module_rgb)


def export_and_check(system, card: str, label: str, *, fwd_per_chunk: int,
                     chords_per_chunk: int, module_rgb) -> dict:
    """Mesh `system` at MESH_RES^3 with the mesh CLI's defaults and check
    the result: one sigma launch per grid tile, `fwd_per_chunk` forward and
    `chords_per_chunk` chord launches per appearance chunk; a non-empty,
    finite mesh with unit normals, colours in [0, 1], triangles inside the
    vertices, and a .ply that reads back; the colours of three vertex
    slices (start, middle, end) against `module_rgb(o, d, near, far)`, the
    nn.Module path's render of the same rays, quantized alike: the render
    bar plus one uint8 step."""
    import tempfile

    from nerfmeshes_tpu_torch.mesh.export import read_ply_binary
    from nerfmeshes_tpu_torch.mesh.extract import LAST_TIMINGS, export_marching_cubes
    from nerfmeshes_tpu_torch.ops.kernels import chords as ch
    from nerfmeshes_tpu_torch.ops.kernels import fused_mlp as fm

    with tempfile.TemporaryDirectory() as tmp:
        args = _mesh_args(tmp)
        torch.cuda.synchronize()
        fm.launches = fm.sigma_launches = ch.launches = 0
        t0 = time.perf_counter()
        verts, tris, colors, normals = export_marching_cubes(system, args)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        fwd, sigma, chords = fm.launches, fm.sigma_launches, ch.launches
        timings = dict(LAST_TIMINGS)
        ply = read_ply_binary(str(Path(tmp) / args.mesh_name))

    n_v, n_t = len(verts), len(tris)
    tiles = math.ceil(MESH_RES ** 3 / GRID_TILE)
    chunks = math.ceil(n_v / args.batch_size)
    if sigma != tiles:
        raise AssertionError(f"{label}: {sigma} sigma launches for {tiles} grid tiles")
    if fwd != fwd_per_chunk * chunks or chords != chords_per_chunk * chunks:
        raise AssertionError(f"{label}: {fwd} forward and {chords} chord launches for "
                             f"{chunks} appearance chunks")
    if n_v == 0 or n_t == 0:
        raise AssertionError(f"{label}: empty mesh")
    if tris.min() < 0 or tris.max() >= n_v:
        raise AssertionError(f"{label}: a triangle indexes outside the vertices")
    if not (np.isfinite(verts).all() and np.isfinite(normals).all()):
        raise AssertionError(f"{label}: non-finite vertices or normals")
    lengths = np.linalg.norm(normals, axis=1)
    if np.abs(lengths - 1.0).max() > 1e-3:
        raise AssertionError(f"{label}: normal lengths in [{lengths.min()}, {lengths.max()}]")
    if colors.min() < 0.0 or colors.max() > 1.0:
        raise AssertionError(f"{label}: colours outside [0, 1]: [{colors.min()}, {colors.max()}]")
    if ply[0].shape != verts.shape or ply[1].shape != tris.shape or ply[3].shape != verts.shape:
        raise AssertionError(f"{label}: the .ply reads back with other counts")

    color_err = 0.0
    for start in sorted({0, max(n_v - CHECK_RAYS, 0) // 2, max(n_v - CHECK_RAYS, 0)}):
        rows = slice(start, start + CHECK_RAYS)
        dirs = -normals[rows]
        origins = verts[rows] - args.view_disparity * dirs  # as export_marching_cubes casts
        o, d = (torch.as_tensor(a, dtype=torch.float32, device=system.device)
                for a in (origins, dirs))
        with torch.inference_mode():
            rgb = module_rgb(o, d, 0.0, args.view_disparity_max_bound)
        ref = (torch.round(rgb.clamp(0.0, 1.0) * 255.0) / 255.0).cpu().numpy()
        color_err = max(color_err, float(np.abs(colors[rows] - ref).max()))
    print(f"{label} colours vs nn.Module render on 3 x {CHECK_RAYS} vertices: max abs diff "
          f"{color_err:.3e} (bar {ATOL} + 1/255)")
    if color_err > ATOL + 1.0 / 255.0:
        raise AssertionError(f"{label}: mesh colours disagree with the nn.Module render")

    phases = {k: timings[k] for k in ("grid_eval_device_s", "grid_transfer_s",
                                      "marching_cubes_s", "appearance_s", "write_s")}
    masked = timings.get("tree_masked_blocks")
    print(f"{label} {MESH_RES}^3: {n_v} vertices, {n_t} triangles; iso "
          f"{timings['iso_effective']:.6g} (requested {timings['iso_requested']:g}); "
          f"blocks fetched {timings['sparse_blocks_fetched']} of "
          f"{timings['sparse_blocks_total']} ({timings['transfer_packed_mb']:.3f} MB)"
          + ("" if masked is None else f", {masked} outside the tree")
          + f"; {sigma} sigma launches ({GRID_TILE} points per tile), {fwd} forward and "
          f"{chords} chord launches ({chunks} chunks of {args.batch_size} rays) [{card}]")
    print(f"{label} phases (s): " + ", ".join(f"{k} {v:.4f}" for k, v in phases.items())
          + f"; total {seconds:.4f} s; grid "
          f"{MESH_RES ** 3 / timings['grid_eval_device_s']:.4e} points/s [{card}]")
    return dict(fwd_launches=fwd, sigma_launches=sigma, chords_launches=chords, vertices=n_v,
                triangles=n_t, seconds=seconds, **phases)


def _chord_bound(R: int, V: int, active: int, K: int) -> tuple[float, str]:
    """The chord kernel's least time: a slab test of CHORD_TEST_OPS f32
    operations for each ray and active voxel (an inactive one needs none)
    at the f32 peak, against its bytes (voxels and activity read once,
    origins and directions read, four outputs written; scalar bounds)."""
    nbytes = V * 25 + R * 24 + R * K * 12 + R * 4
    return _bound_ms(float(R) * active * CHORD_TEST_OPS, nbytes, PEAK_F32)


def chords_kernel_phase(card: str, device) -> dict:
    """The chord kernel against compact_chords_plain on the card, bit for
    bit (torch.equal on all four outputs), at the BuFF paths' shapes: 2048
    camera rays against the initial 12^3 tree padded to capacity 4096 (K
    64), a tree after one consolidation of a seeded memm, per-ray bounds,
    axis-aligned rays from the grid's face planes, a binding cap (K 8), and
    the 65536-ray appearance chunk. Then both are timed at 2048 x 4096 x 64
    and 65536 x 4096 x 64."""
    from nerfmeshes_tpu_torch.buff.tree import TreeSampling
    from nerfmeshes_tpu_torch.ops.kernels import chords as ch

    cfg = buff_hard_cfg()
    tree = TreeSampling(cfg)
    initial = tree.device_state(device)
    rng = np.random.default_rng(SEED)
    memm = rng.uniform(0.0, 1.0, tree.capacity).astype(np.float32)
    memm[rng.uniform(size=tree.capacity) < 0.2] = 0.0
    grown = tree.consolidate(memm, device)
    R, K = int(cfg.nerf.train.num_random_rays), 64
    o, d, _ = _rays(R, 1, rng, device)
    near = torch.from_numpy(rng.uniform(1.5, 2.5, R).astype(np.float32)).to(device)
    far = near + torch.from_numpy(rng.uniform(3.0, 4.0, R).astype(np.float32)).to(device)
    # Axis-aligned rays whose other two origin coordinates lie on the 12^3
    # grid's face planes (NaN slab values: no hit) or at cell centres, with
    # +0 or -0 in the zero direction components (inv = +inf or -inf).
    edges = np.unique(initial.voxels[initial.active][:, :, 0].cpu().numpy())
    spots = np.concatenate([edges, (edges[:-1] + edges[1:]) / 2])
    axis, sign = rng.integers(0, 3, R), rng.choice([-1.0, 1.0], R).astype(np.float32)
    o_axis = rng.choice(spots, (R, 3)).astype(np.float32)
    o_axis[np.arange(R), axis] = -4.0 * sign
    d_axis = np.where(rng.uniform(size=(R, 3)) < 0.5, np.float32(0.0), np.float32(-0.0))
    d_axis = d_axis.astype(np.float32)
    d_axis[np.arange(R), axis] = sign
    o_axis, d_axis = (torch.from_numpy(a).to(device) for a in (o_axis, d_axis))
    o_app, d_app, _ = _surface_rays(APPEARANCE_CHUNK, 1, rng, device)
    cases = {
        "initial tree": (initial, o, d, 2.0, 6.0, K),
        "consolidated tree": (grown, o, d, 2.0, 6.0, K),
        "per-ray near/far": (grown, o, d, near, far, K),
        "axis-aligned rays": (initial, o_axis, d_axis, 2.0, 6.0, K),
        "binding cap": (grown, o, d, 2.0, 6.0, 8),
        "appearance chunk": (grown, o_app, d_app, 0.0, 4.0, K),
    }
    for name, (tree_state, oo, dd, n, f, k) in cases.items():
        args = (tree_state.voxels, tree_state.active, oo, dd, n, f)
        before = ch.launches
        got = ch.compact_chords_cuda(*args, K=k)
        torch.cuda.synchronize()
        if ch.launches != before + 1:
            raise AssertionError(f"chord launch counter moved {ch.launches - before}, expected 1")
        want = ch.compact_chords_plain(*args, K=k)
        equal = [torch.equal(g, w) for g, w in zip(got, want)]
        n_hit = got.n_hit.float()
        print(f"fused_chords {name}: R={dd.shape[0]} V={tree_state.voxels.shape[0]} "
              f"({int(tree_state.active.sum())} active) K={k}: bitwise equal "
              f"{dict(zip(ch.Chords._fields, equal))}; chords per ray mean "
              f"{float(n_hit.mean()):.2f} max {int(n_hit.max())}, rays over the cap "
              f"{int((got.n_hit > k).sum())}")
        if not all(equal):
            raise AssertionError(f"chord kernel and plain version differ ({name})")
        if name == "binding cap" and not bool((got.n_hit > k).any()):
            raise AssertionError("the cap of 8 binds on no ray")
        if not bool((got.n_hit > 0).any()):
            raise AssertionError(f"no ray hits the tree ({name})")

    times = {}
    for name, (oo, dd, n, f) in (("train", (o, d, 2.0, 6.0)),
                                 ("chunk", (o_app, d_app, 0.0, 4.0))):
        args = (grown.voxels, grown.active, oo, dd, n, f)
        rays, V = dd.shape[0], grown.voxels.shape[0]
        ms = _kernel_device_ms(lambda: ch.compact_chords_cuda(*args, K=K), "chords_kernel")
        call_ms = _median_ms(lambda: ch.compact_chords_cuda(*args, K=K))
        plain_ms = _median_ms(lambda: ch.compact_chords_plain(*args, K=K))
        bound_ms, bound_by = _chord_bound(rays, V, int(grown.active.sum()), K)
        print(f"fused_chords {rays}x{V}x{K}: kernel {ms:.4f} ms on the device (torch.profiler), "
              f"{call_ms:.4f} ms per call with its enqueue (CUDA events), plain {plain_ms:.4f} ms "
              f"(medians of 7), bound {bound_ms * 1e3:.3f} us ({bound_by}); "
              f"{rays * V / ms * 1e3:.4e} tests/s; no single PyTorch call computes it "
              f"[{card}]")
        times[name] = dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by)
    return dict(max_abs_err=0.0, bitwise_equal=True, **times["train"],
                chunk_ms=times["chunk"]["ms"], chunk_plain_ms=times["chunk"]["plain_ms"],
                chunk_bound_ms=times["chunk"]["bound_ms"])


def _buff_system(device):
    """The smoke's BuFF system, recording each call's loss and dropped
    chords on the device, and the tree before each consolidation."""
    from nerfmeshes_tpu_torch.buff.system import BuFFSystem

    class RecordingBuFF(BuFFSystem):
        def on_step(self, step, metrics):
            self.losses.append(metrics["train/loss"])
            self.dropped.append(metrics["train/dropped_chords"])
            before = self.tree_state
            super().on_step(step, metrics)
            if self.tree_state is not before:
                self.replaced[step] = before

    system = RecordingBuFF(buff_hard_cfg(), device=device)
    system.losses, system.dropped, system.replaced = [], [], {}
    return system


def _timed_buff_steps(system, steps: int) -> tuple[float, tuple[int, int, int], list]:
    """(seconds, (chord, forward, backward) launches, losses) of `steps`
    BuFF steps through fit, synchronised."""
    from nerfmeshes_tpu_torch.ops.kernels import chords as ch
    from nerfmeshes_tpu_torch.ops.kernels import fused_mlp as fm

    torch.cuda.synchronize()
    system.losses = []
    ch.launches = fm.launches = fm.bwd_launches = 0
    t0 = time.perf_counter()
    system.fit(system.state.step + steps)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = (ch.launches, fm.launches, fm.bwd_launches)
    if launches != (steps, steps, steps):
        raise AssertionError(f"{launches} chord, forward and backward launches for {steps} "
                             "BuFF steps; expected 1 each per step")
    return seconds, launches, torch.stack(system.losses).cpu().tolist()


def buff_train_phase(card: str, device) -> dict:
    """The BuFF train path: BuFFSystem.setup + fit at buff_hard_cfg(), 3
    warm-up steps, 30 timed; then on to step BUFF_TRAIN_STEPS through the
    four consolidations; then 30 more timed steps with integration on and
    the grown tree."""
    from nerfmeshes_tpu_torch.data.blender import train_arrays
    from nerfmeshes_tpu_torch.ops.kernels import chords as ch
    from nerfmeshes_tpu_torch.train.render import RenderSettings

    cfg = buff_hard_cfg()
    system = _buff_system(device).setup(train_arrays(cfg, device))
    rays = int(cfg.nerf.train.num_random_rays)
    system.fit(WARMUP_STEPS)
    seconds, launches, losses = _timed_buff_steps(system, TRAIN_STEPS)
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite BuFF loss: {losses}")
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    rays_per_s = TRAIN_STEPS * rays / seconds
    print(f"buff train: {TRAIN_STEPS} steps of {rays} rays x "
          f"{cfg.nerf.train.num_coarse} tree samples in {seconds:.4f} s, {launches[0]} chord + "
          f"{launches[1]} forward + {launches[2]} backward launches (1 + 1 + 1 per step), "
          f"{rays_per_s:.6e} rays/s; loss first 5 mean {first:.6f}, last 5 {last:.6f} [{card}]")
    if not last < first:
        raise AssertionError(f"BuFF loss did not fall: {losses}")

    active0 = int(system.tree_state.active.sum())
    t0 = time.perf_counter()
    metrics = system.fit(BUFF_TRAIN_STEPS)
    torch.cuda.synchronize()
    dropped = float(torch.stack(system.dropped).sum())
    active = int(system.tree_state.active.sum())
    print(f"buff train: on to step {system.state.step} in {time.perf_counter() - t0:.2f} s; "
          f"consolidations after steps {system.consolidation_steps}; active voxels {active0} "
          f"-> {active}; train/dropped_chords {dropped:.0f} over the run, cap "
          f"{system._effective_max_chords()}; step {system.state.step} loss "
          f"{metrics['train/loss']:.6f}")
    if system.consolidation_steps != BUFF_CONSOLIDATIONS:
        raise AssertionError(f"consolidations after {system.consolidation_steps}, expected "
                             f"{BUFF_CONSOLIDATIONS}")
    if active == active0:
        raise AssertionError("the active voxel count did not change")

    # The render right after the last consolidation reads the new tree: one
    # chord launch on it, and another image than the old tree gives.
    from nerfmeshes_tpu_torch.buff.system import buff_render_rays

    o, d, _ = _rays(4096, 1, np.random.default_rng(SEED + 1), device)
    ch.launches = 0
    fresh = system.query_rays(o, d, 2.0, 6.0, fields=("rgb_map", "depth_map"), as_numpy=False)
    torch.cuda.synchronize()
    if ch.launches != 1:
        raise AssertionError(f"{ch.launches} chord launches for one chunk after consolidation")
    old = system.replaced[BUFF_CONSOLIDATIONS[-1]]
    settings = RenderSettings.from_cfg(system.cfg, train=False)
    with torch.inference_mode():
        stale = buff_render_rays(system.coarse, old, o, d, 2.0, 6.0, settings, train=False,
                                 max_chords=system._effective_max_chords())[0]
    moved = float((fresh.depth_map - stale.depth_map).abs().max())
    print(f"buff render after the consolidation at step {BUFF_CONSOLIDATIONS[-1]}: 1 chord "
          f"launch on the new tree ({active} active voxels, {int(old.active.sum())} before); "
          f"max depth change vs the old tree {moved:.4e}")
    if moved == 0.0:
        raise AssertionError("the render after consolidation matches the old tree's")

    seconds2, launches2, losses2 = _timed_buff_steps(system, TRAIN_STEPS)
    rays_per_s2 = TRAIN_STEPS * rays / seconds2
    if not all(math.isfinite(v) for v in losses2):
        raise AssertionError(f"non-finite BuFF loss: {losses2}")
    print(f"buff train, integration on and the grown tree: {TRAIN_STEPS} steps in "
          f"{seconds2:.4f} s, {rays_per_s2:.6e} rays/s [{card}]")
    return dict(system=system, launches=launches[0], fwd_launches=launches[1] + launches2[1],
                bwd_launches=launches[2] + launches2[2], chords_launches=launches[0] + launches2[0],
                rays_per_s=rays_per_s, rays_per_s_grown=rays_per_s2, dropped=dropped)


def buff_render_phase(system, card: str, device) -> dict:
    """Two 400x400 test views through the trained BuFFSystem.query_rays at
    validation settings (chunk 65536, 192 tree samples): one chord and one
    forward launch per chunk; finite maps, rgb in [0, 1]. One chunk's
    sampler through the kernel is held bit for bit against the same call
    on compact_chords_plain, and its rgb through the fused kernel against
    the nn.Module field."""
    from nerfmeshes_tpu_torch.buff.system import buff_render_rays
    from nerfmeshes_tpu_torch.buff.tree import ray_voxel_intersect
    from nerfmeshes_tpu_torch.data.blender_poses import read_blender_poses
    from nerfmeshes_tpu_torch.ops.kernels import chords as ch
    from nerfmeshes_tpu_torch.ops.kernels import fused_mlp as fm
    from nerfmeshes_tpu_torch.train.render import RenderSettings
    from nerfmeshes_tpu_torch.train.step import make_pose_rays

    cfg = system.cfg
    poses, H, W, focal = read_blender_poses(REPO / "data" / "hard_blender", "test")
    pose_rays = make_pose_rays(H, W, focal, device=device)
    near, far = float(cfg.dataset.near), float(cfg.dataset.far)
    chunk = int(cfg.nerf.validation.chunksize)
    fields = ("rgb_map", "depth_map", "acc_map")
    o0, d0 = pose_rays(poses[0])
    system.query_rays(o0[:chunk], d0[:chunk], near, far, fields=fields, as_numpy=False)
    torch.cuda.synchronize()

    views = 2
    ch.launches = fm.launches = 0
    t0 = time.perf_counter()
    outs = [system.query_rays(*pose_rays(poses[v]), near, far, fields=fields, as_numpy=False)
            for v in range(views)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    chords, fwd = ch.launches, fm.launches
    n = H * W
    chunks = views * math.ceil(n / chunk)
    for out in outs:
        for name in fields:
            if not bool(torch.isfinite(getattr(out, name)).all()):
                raise AssertionError(f"non-finite values in the BuFF {name}")
        lo, hi = float(out.rgb_map.min()), float(out.rgb_map.max())
        if lo < 0.0 or hi > 1.0 + 1e-6:
            raise AssertionError(f"BuFF rgb outside [0, 1]: [{lo}, {hi}]")
    if chords != chunks or fwd != chunks:
        raise AssertionError(f"{chords} chord and {fwd} forward launches for {chunks} chunks")
    rays_per_s = views * n / seconds
    print(f"buff render: {views} views {H}x{W}, {chunks} chunks of {chunk} rays x "
          f"{cfg.nerf.validation.num_coarse} samples, {chords} chord + {fwd} forward launches, "
          f"{seconds:.4f} s, {rays_per_s:.6e} rays/s [{card}]")

    o, d = o0[:chunk].contiguous(), d0[:chunk].contiguous()
    tree = system.tree_state
    args = (tree.voxels, tree.active, o, d, near, far)
    kw = dict(samples_count=int(cfg.nerf.validation.num_coarse),
              max_chords=system._effective_max_chords())
    got = ray_voxel_intersect(*args, **kw)
    want = ray_voxel_intersect(*args, **kw, compact=ch.compact_chords_plain)
    equal = [torch.equal(g, w) for g, w in zip(got, want)]
    print(f"buff render chunk sampler, chord kernel vs plain compaction: bitwise equal "
          f"{dict(zip(got._fields, equal))}; {int(got.ray_mask.sum())} of {chunk} rays hit "
          "the tree")
    if not all(equal):
        raise AssertionError("the chunk's sampler differs between the kernel and plain chords")
    settings = RenderSettings.from_cfg(cfg, train=False)
    with torch.inference_mode():
        fused = buff_render_rays(system.coarse, tree, o, d, near, far, settings, train=False,
                                 max_chords=kw["max_chords"])[0]
        module = buff_render_rays(system.coarse, tree, o, d, near, far,
                                  settings._replace(use_fused_kernel=False), train=False,
                                  max_chords=kw["max_chords"])[0]
    diff = float((fused.rgb_map - module.rgb_map).abs().max())
    print(f"buff render chunk, fused kernel vs nn.Module field: max abs rgb diff {diff:.3e} "
          f"(bar {ATOL})")
    if diff > ATOL:
        raise AssertionError("BuFF fused and nn.Module renders disagree")
    return dict(chords_launches=chords, fwd_launches=fwd, rays_per_s=rays_per_s,
                seconds=seconds)


def buff_mesh_phase(system, card: str) -> dict:
    """export_marching_cubes on the trained BuFFSystem with the CLI's
    defaults at 480^3, restricted to mesh_mask_aabbs(); the appearance pass
    renders through the tree (one chord and one forward launch per chunk);
    colours against the nn.Module render of the same tree-sampled rays."""
    from nerfmeshes_tpu_torch.buff.system import buff_render_rays
    from nerfmeshes_tpu_torch.train.render import RenderSettings

    settings = RenderSettings.from_cfg(system.cfg, train=False)._replace(use_fused_kernel=False)

    def module_rgb(o, d, near, far):
        return buff_render_rays(system.coarse, system.tree_state, o, d, near, far, settings,
                                train=False, max_chords=system._effective_max_chords()
                                )[0].rgb_map

    return export_and_check(system, card, "buff mesh", fwd_per_chunk=1, chords_per_chunk=1,
                            module_rgb=module_rgb)


def profile_buff(card: str, device, steps: int = 5) -> None:
    """The BuFF train step breakdown of PERF.md section 5 (--profile-buff):
    buff_hard_cfg() trained past its first consolidation (integration on),
    then `steps` steps under torch.profiler: device time by kernel, the
    device's idle share over the steps' span, the host's time to enqueue
    the steps against the device's, and the host's CUDA calls."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from nerfmeshes_tpu_torch.data.blender import train_arrays

    cfg = buff_hard_cfg()
    system = _buff_system(device).setup(train_arrays(cfg, device))
    system.fit(BUFF_CONSOLIDATIONS[0] + 5)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # fit's loop body, without its read of the last metrics at the end
        # (that read waits for the device and would count as enqueue time).
        t0 = time.perf_counter()
        for _ in range(steps):
            system.state, metrics = system._train_fn(system.state, system._data)
            system.on_step(system.state.step, metrics)
        enqueued = time.perf_counter() - t0
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        trace = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text())["traceEvents"]
    kernels = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
               if e.get("cat") == "kernel"]
    lo, hi = min(s for _, s, _ in kernels), max(e for _, _, e in kernels)
    span = (hi - lo) / 1e3
    busy = _busy_ms([(s, e) for _, s, e in kernels])
    by_name: dict = {}
    for name, s, e in kernels:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e3
    total = sum(by_name.values())
    print(f"profile buff: {steps} steps, {span / steps:.3f} ms per step of device span, "
          f"kernels {total:.3f} ms in {len(kernels)} launches, device idle "
          f"{100.0 * (1.0 - busy / span):.2f}%, host enqueue {enqueued * 1e3:.3f} ms "
          f"({100.0 * enqueued * 1e3 / span:.1f}% of the device span), wall "
          f"{wall * 1e3:.3f} ms; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB [{card}]")
    groups = {"backward tile": ("bwd_tile_kernel",),
              "backward dW partials + reduction": ("dw_partial_kernel", "reduce_rows_kernel"),
              "forward": ("fused_mlp_fwd_kernel",), "chords": ("chords_kernel",)}
    shares = {label: sum(t for n, t in by_name.items() if any(k in n for k in keys))
              for label, keys in groups.items()}
    shares["everything else"] = total - sum(shares.values())
    for label, t in shares.items():
        print(f"profile buff: {label} {t:.3f} ms, {100.0 * t / total:.2f}% of kernel time")
    for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"profile buff kernel: {t / steps:.4f} ms per step  {name[:110]}")
    # Where the host's time goes: the CUDA runtime and driver calls (a
    # synchronising call shows as one long wait per step).
    calls: dict = {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            n, t = calls.get(e["name"], (0, 0.0))
            calls[e["name"]] = (n + 1, t + e.get("dur", 0) / 1e3)
    for name, (n, t) in sorted(calls.items(), key=lambda kv: -kv[1][1])[:8]:
        print(f"profile buff host call: {name} x{n}, {t:.3f} ms")
    ops = sum(1 for e in events if e.get("cat") == "cpu_op")
    print(f"profile buff: {ops / steps:.0f} torch ops dispatched per step")


def _busy_ms(spans) -> float:
    """Length in ms of the union of (start, end) spans in microseconds."""
    total, lo, hi = 0.0, None, None
    for s, e in sorted(spans):
        if hi is None or s > hi:
            total += 0.0 if hi is None else hi - lo
            lo, hi = s, e
        else:
            hi = max(hi, e)
    return (total + (0.0 if hi is None else hi - lo)) / 1e3


def profile_mesh(card: str, device, steps: list[int]) -> None:
    """The mesh breakdown of PERF.md section 5 (--profile-mesh). Trains the
    hard-blender system on to each step count in turn and meshes it as
    mesh_phase does: twice unprofiled (vertex count, the LAST_TIMINGS
    legs), then once under torch.profiler (peak device memory; for the
    grid and the appearance leg, the device time in the sigma or forward
    kernel and the device's idle share over the span of its launches)."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from nerfmeshes_tpu_torch.data.blender import train_arrays
    from nerfmeshes_tpu_torch.mesh.extract import LAST_TIMINGS, export_marching_cubes
    from nerfmeshes_tpu_torch.train.system import NeRFSystem

    cfg = hard_blender_cfg()
    system = NeRFSystem(cfg, device=device).setup(train_arrays(cfg, device))
    legs = ("grid_eval_device_s", "grid_transfer_s", "marching_cubes_s", "appearance_s",
            "write_s")
    with tempfile.TemporaryDirectory() as tmp:
        export_marching_cubes(system, _mesh_args(tmp, res=64))  # first launches
        for target in steps:
            system.fit(target)
            step = system.state.step
            for run in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                n_v = len(export_marching_cubes(system, _mesh_args(tmp))[0])
                seconds = time.perf_counter() - t0
                print(f"profile step {step} run {run}: {n_v} vertices, {seconds:.4f} s; "
                      + ", ".join(f"{k} {LAST_TIMINGS[k]:.4f}" for k in legs) + f" [{card}]")
            torch.cuda.reset_peak_memory_stats()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                export_marching_cubes(system, _mesh_args(tmp))
                torch.cuda.synchronize()
            trace = Path(tmp) / "trace.json"
            prof.export_chrome_trace(str(trace))
            kernels = [(e["name"], e["ts"], e["ts"] + e["dur"])
                       for e in json.loads(trace.read_text())["traceEvents"]
                       if e.get("cat") == "kernel"]
            print(f"profile step {step}: peak device memory "
                  f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB [{card}]")
            for leg, key in (("grid eval", "fused_sigma"), ("appearance", "fused_mlp_fwd")):
                mine = [(s, e) for name, s, e in kernels if key in name]
                lo, hi = min(s for s, _ in mine), max(e for _, e in mine)
                busy = _busy_ms([(max(s, lo), min(e, hi)) for _, s, e in kernels
                                 if e > lo and s < hi])
                span = (hi - lo) / 1e3
                print(f"profile step {step} {leg}: {len(mine)} {key} launches, "
                      f"{_busy_ms(mine):.3f} ms in them of a {span:.3f} ms span, device idle "
                      f"{100.0 * (1.0 - busy / span):.2f}% [{card}]")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile-mesh", type=int, nargs="*", metavar="STEPS",
                        help="instead of the smoke, profile the mesh phase after training "
                             f"to each STEPS (default {MESH_TRAIN_STEPS})")
    parser.add_argument("--profile-buff", action="store_true",
                        help="instead of the smoke, profile 5 BuFF train steps past the first "
                             "consolidation")
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    from nerfmeshes_tpu_torch.config import get_default_cfg
    from nerfmeshes_tpu_torch.mesh import native
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
    t0 = time.perf_counter()
    native.get_lib()
    print(f"native mesh library (g++): {time.perf_counter() - t0:.2f} s -> "
          f"{native.library_path().name}")
    if opts.profile_mesh is not None:
        profile_mesh(card, device, opts.profile_mesh or [MESH_TRAIN_STEPS])
        return 0
    if opts.profile_buff:
        profile_buff(card, device)
        return 0

    cfg = get_default_cfg()
    cfg.experiment.compute_dtype = "bfloat16"
    cfg.experiment.use_fused_kernel = True
    kern = kernel_phase(cfg, card, device)
    render = slice_phase(cfg, card, device)
    bkern = bwd_kernel_phase(cfg, card, device)
    train = train_phase(card, device)
    skern = sigma_kernel_phase(cfg, card, device)
    mesh = mesh_phase(train.pop("system"), card)
    ckern = chords_kernel_phase(card, device)
    buff = buff_train_phase(card, device)
    buff_system = buff.pop("system")
    buff_render = buff_render_phase(buff_system, card, device)
    buff_mesh = buff_mesh_phase(buff_system, card)

    def entry(name, source, replaces, phase, by_path, **extra):
        return {"name": name, "route": "cuda", "source": f"nerfmeshes_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": sum(by_path.values()),
                "launches_by_path": by_path, "max_abs_err": phase["max_abs_err"],
                "ms": phase["ms"], "plain_ms": phase["plain_ms"], "bound_ms": phase["bound_ms"],
                "bound_by": phase["bound_by"], "library_ms": phase["library_ms"], **extra}

    print(json.dumps({"kernels": [
        entry("fused_mlp_fwd", "fused_mlp_fwd.cu", "nerfmeshes_tpu/ops/pallas/fused_mlp.py:387", kern,
              {"render": render["launches"], "train": train["fwd_launches"],
               "mesh": mesh["fwd_launches"], "buff_train": buff["fwd_launches"],
               "buff_render": buff_render["fwd_launches"], "buff_mesh": buff_mesh["fwd_launches"]}),
        entry("fused_mlp_bwd", "fused_mlp_bwd.cu", "nerfmeshes_tpu/ops/pallas/fused_mlp.py:397", bkern,
              {"train": train["bwd_launches"], "buff_train": buff["bwd_launches"]},
              max_rel_err=bkern["max_rel_err"]),
        entry("fused_sigma", "fused_sigma.cu", "nerfmeshes_tpu/ops/pallas/fused_mlp.py:675", skern,
              {"mesh": mesh["sigma_launches"], "buff_mesh": buff_mesh["sigma_launches"]}),
        entry("fused_chords", "chords.cu", "nerfmeshes_tpu/ops/pallas/chords.py:98",
              dict(ckern, library_ms=None),
              {"train": buff["chords_launches"], "render": buff_render["chords_launches"],
               "mesh": buff_mesh["chords_launches"]},
              bitwise_equal=ckern["bitwise_equal"], bound_us=ckern["bound_ms"] * 1e3,
              call_ms=ckern["call_ms"],
              chunk_ms=ckern["chunk_ms"], chunk_plain_ms=ckern["chunk_plain_ms"],
              chunk_bound_ms=ckern["chunk_bound_ms"]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
