#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port, nerfmeshes_tpu_torch.

    python3 chip_smoke.py          # needs one CUDA card; no arguments
    python3 chip_smoke.py --profile-mesh [STEPS ...]   # the mesh profile only

Builds the port's CUDA kernels from csrc/ (one nvcc per source, in
parallel) and the native mesh library (g++), checks each kernel against
its plain PyTorch version on the card at the shapes of the render, train
and mesh paths, then drives the three paths:

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

Prints, on lines of their own: the card's name and power limit as
nvidia-smi reports them, the build time, per-kernel error and times,
render and train rays/s, the mesh phases' times, then a JSON line of the
kernels, and last {"ok": true, "device": {...}}. Any failed check
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
    for name, t in (("kernel", ms), ("plain", plain_ms)):
        print(f"fused_mlp_fwd {name}: {t:.4f} ms median of 7, {R * S / t * 1e3:.4e} points/s "
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
    for name, t in (("kernel", ms), ("plain", plain_ms)):
        print(f"fused_mlp_bwd {name}: {t:.4f} ms median of 7, {R * S / t * 1e3:.4e} points/s "
              f"at {R}x{S} points [{card}]")
    return dict(max_abs_err=worst_abs, max_rel_err=worst_rel, ms=ms, plain_ms=plain_ms)


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
    for name, t in (("kernel", ms), ("plain", plain_ms)):
        print(f"fused_sigma {name}: {t:.4f} ms median of 7, {GRID_TILE / t * 1e3:.4e} points/s "
              f"at {GRID_TILE} points [{card}]")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms)


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
    import tempfile

    from nerfmeshes_tpu_torch.mesh.export import read_ply_binary
    from nerfmeshes_tpu_torch.mesh.extract import LAST_TIMINGS, export_marching_cubes
    from nerfmeshes_tpu_torch.ops.kernels import fused_mlp as fm
    from nerfmeshes_tpu_torch.train.render import RenderSettings, render_rays

    t0 = time.perf_counter()
    system.fit(MESH_TRAIN_STEPS)
    torch.cuda.synchronize()
    print(f"mesh: trained on to step {system.state.step} in {time.perf_counter() - t0:.2f} s")
    with tempfile.TemporaryDirectory() as tmp:
        args = _mesh_args(tmp)
        torch.cuda.synchronize()
        fm.launches = fm.sigma_launches = 0
        t0 = time.perf_counter()
        verts, tris, colors, normals = export_marching_cubes(system, args)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        fwd, sigma = fm.launches, fm.sigma_launches
        timings = dict(LAST_TIMINGS)
        ply = read_ply_binary(str(Path(tmp) / args.mesh_name))

    n_v, n_t = len(verts), len(tris)
    tiles = math.ceil(MESH_RES ** 3 / GRID_TILE)
    chunks = math.ceil(n_v / args.batch_size)
    if sigma != tiles:
        raise AssertionError(f"{sigma} sigma launches for {tiles} grid tiles")
    if fwd != 2 * chunks:
        raise AssertionError(f"{fwd} forward launches for {chunks} appearance chunks")
    if n_v == 0 or n_t == 0:
        raise AssertionError("empty mesh")
    if tris.min() < 0 or tris.max() >= n_v:
        raise AssertionError("a triangle indexes outside the vertices")
    if not (np.isfinite(verts).all() and np.isfinite(normals).all()):
        raise AssertionError("non-finite vertices or normals")
    lengths = np.linalg.norm(normals, axis=1)
    if np.abs(lengths - 1.0).max() > 1e-3:
        raise AssertionError(f"normal lengths in [{lengths.min()}, {lengths.max()}]")
    if colors.min() < 0.0 or colors.max() > 1.0:
        raise AssertionError(f"colours outside [0, 1]: [{colors.min()}, {colors.max()}]")
    if ply[0].shape != verts.shape or ply[1].shape != tris.shape or ply[3].shape != verts.shape:
        raise AssertionError("the .ply reads back with other counts")

    # Colours of three vertex slices (start, middle, end) against the
    # nn.Module path's render of the same rays (bf16 layers, no kernel),
    # quantized alike: the render bar plus one uint8 step.
    settings = RenderSettings.from_cfg(system.cfg, train=False)._replace(use_fused_kernel=False)
    color_err = 0.0
    for start in sorted({0, max(n_v - CHECK_RAYS, 0) // 2, max(n_v - CHECK_RAYS, 0)}):
        rows = slice(start, start + CHECK_RAYS)
        dirs = -normals[rows]
        origins = verts[rows] - args.view_disparity * dirs  # as export_marching_cubes casts
        o, d = (torch.as_tensor(a, dtype=torch.float32, device=system.device)
                for a in (origins, dirs))
        with torch.inference_mode():
            rgb = render_rays(system.coarse, system.fine, o, d, 0.0,
                              args.view_disparity_max_bound, settings, train=False)[1].rgb_map
        ref = (torch.round(rgb.clamp(0.0, 1.0) * 255.0) / 255.0).cpu().numpy()
        color_err = max(color_err, float(np.abs(colors[rows] - ref).max()))
    print(f"mesh colours vs nn.Module render on 3 x {CHECK_RAYS} vertices: max abs diff "
          f"{color_err:.3e} (bar {ATOL} + 1/255)")
    if color_err > ATOL + 1.0 / 255.0:
        raise AssertionError("mesh colours disagree with the nn.Module render")

    phases = {k: timings[k] for k in ("grid_eval_device_s", "grid_transfer_s",
                                      "marching_cubes_s", "appearance_s", "write_s")}
    print(f"mesh {MESH_RES}^3: {n_v} vertices, {n_t} triangles; iso "
          f"{timings['iso_effective']:.6g} (requested {timings['iso_requested']:g}); "
          f"blocks fetched {timings['sparse_blocks_fetched']} of "
          f"{timings['sparse_blocks_total']} ({timings['transfer_packed_mb']:.3f} MB); "
          f"{sigma} sigma launches ({GRID_TILE} points per tile), {fwd} forward launches "
          f"(2 per chunk of {args.batch_size} rays) [{card}]")
    print("mesh phases (s): " + ", ".join(f"{k} {v:.4f}" for k, v in phases.items())
          + f"; total {seconds:.4f} s; grid "
          f"{MESH_RES ** 3 / timings['grid_eval_device_s']:.4e} points/s [{card}]")
    return dict(fwd_launches=fwd, sigma_launches=sigma, vertices=n_v, triangles=n_t,
                seconds=seconds, **phases)


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

    cfg = get_default_cfg()
    cfg.experiment.compute_dtype = "bfloat16"
    cfg.experiment.use_fused_kernel = True
    kern = kernel_phase(cfg, card, device)
    render = slice_phase(cfg, card, device)
    bkern = bwd_kernel_phase(cfg, card, device)
    train = train_phase(card, device)
    skern = sigma_kernel_phase(cfg, card, device)
    mesh = mesh_phase(train.pop("system"), card)

    print(json.dumps({"kernels": [{
        "name": "fused_mlp_fwd",
        "route": "cuda",
        "source": "nerfmeshes_tpu_torch/csrc/fused_mlp_fwd.cu",
        "replaces": "nerfmeshes_tpu/ops/pallas/fused_mlp.py:387",
        "launches": render["launches"] + train["fwd_launches"] + mesh["fwd_launches"],
        "launches_by_path": {"render": render["launches"], "train": train["fwd_launches"],
                             "mesh": mesh["fwd_launches"]},
        "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"],
        "plain_ms": kern["plain_ms"],
    }, {
        "name": "fused_mlp_bwd",
        "route": "cuda",
        "source": "nerfmeshes_tpu_torch/csrc/fused_mlp_bwd.cu",
        "replaces": "nerfmeshes_tpu/ops/pallas/fused_mlp.py:397",
        "launches": train["bwd_launches"],
        "launches_by_path": {"train": train["bwd_launches"]},
        "max_abs_err": bkern["max_abs_err"],
        "max_rel_err": bkern["max_rel_err"],
        "ms": bkern["ms"],
        "plain_ms": bkern["plain_ms"],
    }, {
        "name": "fused_sigma",
        "route": "cuda",
        "source": "nerfmeshes_tpu_torch/csrc/fused_sigma.cu",
        "replaces": "nerfmeshes_tpu/ops/pallas/fused_mlp.py:675",
        "launches": mesh["sigma_launches"],
        "launches_by_path": {"mesh": mesh["sigma_launches"]},
        "max_abs_err": skern["max_abs_err"],
        "ms": skern["ms"],
        "plain_ms": skern["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
