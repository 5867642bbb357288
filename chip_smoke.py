#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port, nerfmeshes_tpu_torch.

    python3 chip_smoke.py          # needs one CUDA card; no arguments
    python3 chip_smoke.py --profile-mesh [STEPS ...]   # the mesh profile only
    python3 chip_smoke.py --profile-buff               # the BuFF step profile only
    python3 chip_smoke.py --profile-train              # the hierarchical step profile only
    python3 chip_smoke.py --profile-render             # the hierarchical render profile only

Builds the port's CUDA kernels from csrc/ (one nvcc per source, in
parallel), the native mesh library, the JPEG decoder and encoder and the
GIF encoder (g++), checks
each kernel against its plain PyTorch version on the card at the shapes
of the render, train and mesh paths, then drives the hierarchical paths
and the BuFF ones:

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
- the CLI chains (cli_chain): configs/hard-blender.yml and then
  configs/buff-hard-250k.yml (its procedural 800^2 scene) at full width
  through the CLIs' main(argv), in-process, into a temporary logdir:
  train_nerf with validation and checkpoints; the run's datasets, a
  fresh system restored from it (its state equal to the trained one bit
  for bit), a validation at the last step (the run's validation/loss bit
  for bit) and a save, each timed; train_nerf resumed with
  --log-checkpoint; eval_nerf on the test split; mesh_nerf at 480^3.
  Every leg's launches of each kernel equal the counts the code
  predicts; at most 3 numbered checkpoints stay beside `last`; the
  validation loss falls; the mesh is not empty. The hierarchical chain
  ends with surface_ray's CLI on its run (the 8 x 4 orbit of 400x400
  views at the run's focal, 2 forward launches per chunk); the PLY reads
  back with finite points and unit normals; then eval_nerf
  --synthesis-video (synthesis_leg): the 120 orbit views, each through the
  forward kernel as a test view, into one GIF by the port's g++-built
  writer, whose blocks are walked (120 frames of 400x400, 4 cs each, loop
  0, the trailer); the render and writer seconds and the file's MB.
- the normals chain (normals_chain): hard-blender.yml at
  reduced_resolution 3 (133x133, the fractional INTER_AREA) on a copy of
  data/hard_blender with a `*_normal.png` beside every frame, the split
  cache on: the splits' build (normals in every bundle and npz), 200
  train steps, eval of the test split; launches as predicted, the
  validation loss falls.
- export_color_images (export_color_phase): data/hard_scannet's 14 colour
  frames re-encoded as `{f}.jpg` by the port's g++-built JPEG encoder;
  each decodes within 30 dB PSNR of its source frame at least; host ms per
  1296x968 encode.
- H = 128: the forward kernel at 2048 x 64 and 2048 x 128, the backward
  at 2048 x 128 and sigma at a 262,144-point grid tile, at the width of
  configs/hard-llff.yml (8x128), held against their plain versions (sigma
  against the forward's channel 3 too) and timed (h128_kernel_phase).
- the wide fields (wide_phase, last): hard-blender.yml's two 8-layer L
  10/4 FlexibleNeRFs widened to 384-1024, the fused kernels called
  directly (64-point tiles split in N; from 640 on across a 2-CTA
  cluster as well): each kernel's shared-memory plan; the forward at
  2048 x 64 and 2048 x 192, the backward at both (its legs at 512 and
  1024) and sigma at a 262,144-point tile against their plain versions,
  timed (640-896 at 2048 x 64); from 640 on sigma bit for bit the
  forward's channel 3 and repeat launches bitwise; then, through the
  normal entry points on the width's route (fused at 384, the layer route
  from 512 on, whose kernels' launches are held to fl.call_launches),
  setup + fit (3 + 30 steps, 2 + 2 calls a step, the loss falls, grads vs
  the nn.Module), at 512 and 1024 two 400x400 views of the trained
  system, and export_marching_cubes (WIDE_MESH_RES) with the colour check.
- the layer route (layers_phase, after wide_phase; csrc/field_layers.cu):
  its backward's heads kernel and bias-grad reduction alone at an 8x2048
  and an 8x1024 slab against their plain versions, timed beside their
  bounds and a torch.sum per bias vector; the fields fm.field_route sends
  there: 8 layers at 512 and 1024 wide (L 10/4), at 1024 wide with 16
  position bands, at 1152 and 2048 wide, 16 layers and 32 bands at 256
  wide: forward, backward and sigma against their plain versions and
  timed, sigma bit for bit the route's forward channel 3, the backward
  bitwise repeatable, each kernel's device time per forward and backward
  call at 512, 1024 (L 10/4 and 16/4) and 2048 wide; its PE bit for bit
  the fused kernels'; the chains at 1024 L 16/4 (3 + 30 steps, 2 views, a
  128^3 mesh) and 2048 (3 + 30 steps, a 64^3 mesh), every launch the
  layer route's, each kernel's launches those fl.call_launches predicts;
  the route beside the pair kernels at 8x1024 L 10/4.
- the forward-facing chain (llff_cli): configs/hard-llff.yml as shipped on
  data/hard_llff (21 training views, 3 held out; NDC rays, per-image
  COLMAP bounds, two 8x128 fields through the fused kernels): train 500
  steps validating every 250, the restore check, resume to 1000, eval of
  the 3 held-out views; no mesh (JAX meshes no NDC field either).
- JPEG (jpeg_phase): the port's decoder, built with g++, decodes the 14
  1296x968 4:2:0 frames of data/hard_scannet/scene.sens; every frame's
  pixels hash to data/hard_scannet/digests.json (PIL's decode where the
  stream was written); ms per frame and MB/s are host times. Then the
  progressive and 4:1:1 fixtures of tests/data/jpeg/ against their
  digests.json, and the decode time of its 1296x968 progressive fixture
  beside the same pixels as a baseline file.
- the ScanNet-layout chain (scannet_cli): configs/hard-blender.yml's 2 x
  8x256 fields on that stream (dataset.type scannet): +z rays from an
  off-centre principal point, unnormalised directions, depth targets,
  1296x968 views (20 validation chunks of 65,536 rays, 40 forward
  launches a view); train 500 steps validating every 250, the restore
  check, resume to 1000, eval of the 2 test frames, mesh 480^3.

- the zoo chain (zoo_cli): configs/hard-blender.yml with a
  SpecularSimpleModel coarse model at its class defaults (its (field,
  specular) output through every render) and AdamW; the fine 8x256
  FlexibleNeRF through the kernels, one forward and one backward launch a
  step; train 500 steps validating every 250, the restore check, resume
  to 1000, eval, mesh 480^3.
- the zoo (zoo_phase): each of the six other MODEL_REGISTRY models at its
  class defaults, f32 and bf16, one forward and backward at 2048 x 64
  points on the card against the CPU run of the same weights; ms per
  forward + backward; DropModel's dropout from a CUDA generator.
- BuFF's random sampler (buff_random): the BuFF workload with
  tree.use_random_sampling and RMSprop, 200 steps and a 400x400 view; no
  chord launch; every tree sample inside a chord its ray hits.
- event files: every chain's run directory is read back through
  utils/tb_events.py:read_events (both CRCs of every record): each metric
  a scalar at its step, the description and config texts once per train
  CLI call, and in buff_cli the "Tree" mesh and "Tree Memm" image at each
  consolidation and the step after; the seconds inside the event writer
  and, for BuFF, in _log_tree per consolidation.
- the reference importer (import_cli, inside the cli and buff_cli
  chains): the chain's run written as a reference Lightning checkpoint
  (weights under the reference's names, BuFF's tree in the reference's
  layout, the flat hparams.yaml beside it), imported with
  import_checkpoint's CLI, evaluated and meshed: weights and tree equal
  the source's, eval PSNR/SSIM/MSE and the mesh's vertex count equal the
  source run's, launches as the chain's.
- tb_phase: configs/hard-blender.yml on the ScanNet stream (depth
  targets), 300 steps, a depth projection every 100 steps (2 forward
  launches each), one validation: the event file's scalars, images,
  texts and 3 "Point Cloud" meshes checked; crc_phase: the writer's
  CRC32C in MB/s on this host; depth_sampling: every strategy of
  ops/depth_sampling.py on the card from a CUDA generator, sorted and in
  bounds, linear and proximal equal to the CPU within 1e-6.
- data parallelism (dist_phase, parallel/mesh.py): on a forced one-rank
  NCCL group, a hierarchical and a BuFF step on one injected 2048-ray
  batch bitwise equal to the unforced steps (grads; memm under torch's
  deterministic algorithms), DIST_ROUNDS rounds of 30 timed steps each
  way, the flat grad all-reduce's ms and bytes; then 2 gloo ranks
  sharing the card (spawned by parallel.mesh.launch), each on its 1024
  rays of the batch: reduced grads within 1e-4 of max |grad| of one
  process's, BuFF memm within 1e-5, a 400x400 view through the sharded
  render and the 480^3 sharded sigma grid bit for bit against one
  rank's, each rank's launches (train 2 + 2, BuFF 1 + 1 + 1, view 158,
  grid 422) as the code predicts; then each kernel alone at the per-rank
  shapes, beside its bound and its library yardstick (the nn.Module under
  bf16 autocast; none for chords).
- quality: scripts/torch_quality_parity.py's runners cut to 300 steps at
  seed 42 (quality_phase): the kernel-width protocol (lego's 2 x 8x256
  fields through the fused kernels on 12 synthetic 64^2 views, 2 + 2
  launches a step, read at steps 0 and 300) and blobs hierarchical and
  BuFF (4x64 nn.Module fields, one chord launch a BuFF step); the
  forward-facing protocol (hard-llff.yml's 2 x 8x128 fields through the
  CLIs on data/hard_llff, 2 + 2 launches a step, eval on one test view)
  and quality_800 (the lego workload on 64^2 hard-scene views, 2 + 2 a
  step, a 128^3 mesh at 8 sigma launches, its chamfer distance to the
  analytic surface); the losses fall, every PSNR is finite and above its
  untrained read, the chamfer distance is finite; the entries go to
  build/quality_smoke.json.

Prints, on lines of their own: the card's name and power limit as
nvidia-smi reports them, the build time, per-kernel error, times, bound
and library yardstick, render and train rays/s of both systems, the mesh
phases' times, the backward's legs (its transpose, tile kernel and dW
products) by kernel name, each beside its bound, and the dW leg beside
its torch.mm yardstick (these breakdowns, and the layer route's, from a
process of their own: breakdowns_process), then a JSON line of
the kernels, and last {"ok": true,
"device": {...}}. Any failed check
raises, so the exit code is non-zero and no "ok" line is printed. There
is no CPU path.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import gc
import json
import math
import re
import shutil
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
# The host's sleep at each end of a torch.profiler trace (_traced_kernels).
TRACE_PAD_S = 0.01
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
# A trained scene, the unit of user work the kernels are ranked in: the
# hierarchical workload's 20k steps (configs/hard-blender.yml), 200 rendered
# 400x400 views and one 480^3 mesh, at the smoke's shapes.
SCENE_STEPS, SCENE_VIEWS, SCENE_MESHES = 20000, 200, 1
# Published dense peaks of one H100 SXM (the rates chip_smoke.py reckons
# each kernel's bound from): HBM bytes/s, bf16 tensor-core and f32 FLOP/s.
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
# FP32 operations per (ray, voxel) slab test of the chord kernel: 6
# subtractions, 6 multiplies, 6 selects, 8 comparisons, 4 max/min, 6
# logical ands (csrc/chords.cu).
CHORD_TEST_OPS = 36
# The backward's legs by kernel name (csrc/fused_mlp_bwd.cu), as fused_legs
# and the step profiles group a trace (reduce_rows_kernel sums the dW
# partials and, twice, the bias partials); tests/test_torch_fused_mlp.py
# holds every name to a __global__ of the csrc/ sources.
BWD_LEGS = {"transpose": ("wt_transpose_kernel",), "tile": ("bwd_tile_kernel",),
            "dw": ("dw_kernel", "reduce_rows_kernel")}
PROFILE_GROUPS = {"backward transpose": BWD_LEGS["transpose"],
                  "backward tile": BWD_LEGS["tile"],
                  "backward dW + reductions": BWD_LEGS["dw"],
                  "forward": ("fused_mlp_fwd_kernel",), "chords": ("chords_kernel",)}


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


def llff_cfg():
    """configs/hard-llff.yml as shipped, on the repo's data/hard_llff."""
    from nerfmeshes_tpu_torch.config import load_config

    return load_config(str(REPO / "configs" / "hard-llff.yml"),
                       ["dataset.basedir", str(REPO / "data" / "hard_llff")])


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


def _dx_flops(model) -> int:
    """FLOPs per point of the backward's dX chain (csrc/fused_mlp_bwd.cu):
    the cotangent through the x part (first H input columns) of the dir,
    feat and trunk products, and the rgb and alpha heads' terms."""
    H = model.hidden_size
    products = (model.num_layers - 1) * H * H + H * H + (H // 2) * H
    return 2 * (products + 3 * (H // 2) + H)


def _stash_bytes(packed, n_pts: int) -> int:
    """Bytes of the backward's bf16 stash for n_pts points (stash_layout in
    csrc/fused_mlp_bwd.cu; rows padded to the tile kernel's 128)."""
    return 2 * _dw_products(packed.spec, n_pts)[1]


def _dw_products(spec, n_pts: int) -> tuple[list, int]:
    """The dW leg's products (dw_jobs in csrc/fused_mlp_bwd.cu) over the
    stash of n_pts points: ([(dY offset, dY row stride, dW rows, X offset,
    X row stride, X's first column, dW columns)], stash elements), offsets
    in bf16 elements of stash_layout, rows padded to 128 points."""
    from nerfmeshes_tpu_torch.ops.kernels import fused_mlp as fm

    H, L, pxp, pdp = spec.hidden, spec.num_layers, spec.pxp, spec.pdp
    n = -(-n_pts // 128) * 128
    st = fm.stash_layout(spec, n)
    act, feat, h, dy, dy_dir, dy_a, dy_rgb = (
        st[k] for k in ("act", "feat", "h", "dy", "dy_dir", "dy_a", "dy_rgb"))
    jobs = [(dy, H, H, 0, pxp + pdp, 0, pxp)]
    for i in range(L - 1):
        jobs.append((dy + (1 + i) * n * H, H, H, act + i * n * H, H, 0, H))
        if i in spec.skip_layers:
            jobs.append((dy + (1 + i) * n * H, H, H, 0, pxp + pdp, 0, pxp))
    jobs += [(dy + L * n * H, H, H, act + (L - 1) * n * H, H, 0, H),
             (dy_dir, H // 2, H // 2, feat, H, 0, H),
             (dy_dir, H // 2, H // 2, 0, pxp + pdp, pxp, pdp),
             (dy_a, 16, 1, act + (L - 1) * n * H, H, 0, H),
             (dy_rgb, 16, 3, h, H // 2, 0, H // 2)]
    return jobs, st["end"]


def _dw_library_ms(spec, n_pts: int, device) -> float:
    """The dW leg's library yardstick: torch.mm(dY^T, X) (cuBLAS, bf16 in,
    f32 sums, bf16 out) for each of its products on views with the stash's
    shapes and row strides, over a seeded bf16 stash; the median of 7 of
    each, summed. Never called by the port."""
    jobs, size = _dw_products(spec, n_pts)
    n = -(-n_pts // 128) * 128
    stash = torch.randn(size, generator=torch.Generator(device).manual_seed(SEED),
                        device=device, dtype=torch.bfloat16)
    total = 0.0
    for dy0, ldy, m, x0, ldx, c0, cols in jobs:
        dy = stash[dy0:dy0 + n * ldy].view(n, ldy)[:, :m]
        x = stash[x0:x0 + n * ldx].view(n, ldx)[:, c0:c0 + cols]
        total += _median_ms(lambda dy=dy, x=x: torch.mm(dy.t(), x))
    return total


def _rate(name: str, ms: float, flops: float, bound_ms: float, bound_by: str, shape: str,
          card: str) -> None:
    """One kernel time beside its bound: TFLOP/s and the bound's share."""
    print(f"{name} kernel at {shape}: {ms:.4f} ms, {flops / ms / 1e9:.1f} TFLOP/s, bound "
          f"{bound_ms:.4f} ms ({bound_by}), {100.0 * bound_ms / ms:.1f}% of the bound [{card}]")


def _route(route: str):
    """(launch counters, forward, backward, sigma, name prefix) of a field
    route: the fused kernels (ops/kernels/fused_mlp.py) or the layer route
    (ops/kernels/field_layers.py); both modules count `launches`,
    `bwd_launches` and `sigma_launches`."""
    from nerfmeshes_tpu_torch.ops.kernels import field_layers as fl
    from nerfmeshes_tpu_torch.ops.kernels import fused_mlp as fm

    if route == "fused":
        return fm, fm.fused_mlp_cuda, fm.fused_mlp_bwd_cuda, fm.fused_sigma_cuda, "fused_mlp"
    return fl, fl.layers_mlp_cuda, fl.layers_bwd_cuda, fl.layers_sigma_cuda, "field_layers"


def _yardsticks(route: str, plain, module, library) -> tuple:
    """(plain ms, f32 nn.Module ms, library ms) of a kernel's yardsticks:
    medians of 7 on the fused route; on the layer route, whose fields run
    to 2048 wide, medians of 3 and no f32 nn.Module call (None), which is
    no part of the kernels line and takes seconds there."""
    if route == "fused":
        return _median_ms(plain), _median_ms(module), _median_ms(library)
    return _median_ms(plain, runs=3, warmup=1), None, _median_ms(library, runs=3, warmup=1)


def _ms_text(t: float | None) -> str:
    return "not timed" if t is None else f"{t:.4f} ms"


def _zero_field_counts() -> None:
    """Both routes' launch counts, and the layer route's per kernel, to 0;
    the layer route's calls logged from here (_hold_layer_counts)."""
    from nerfmeshes_tpu_torch.ops.kernels import field_layers as fl
    from nerfmeshes_tpu_torch.ops.kernels import fused_mlp as fm

    for mod in (fm, fl):
        mod.launches = mod.bwd_launches = mod.sigma_launches = 0
    fl.kernel_launches.update(dict.fromkeys(fl.KERNELS, 0))
    fl.call_log = []


def _hold_layer_counts(label: str, card: str) -> None:
    """Each layer-route kernel's launches since _zero_field_counts held to
    the ones fl.call_launches predicts for the calls logged (a slab's PE,
    products, heads, dW launches, their range reductions and one bias-grad
    reduction); the log stops."""
    from nerfmeshes_tpu_torch.ops.kernels import field_layers as fl

    calls, fl.call_log = fl.call_log or [], None
    want = dict.fromkeys(fl.KERNELS, 0)
    for spec, kind, n_pts in calls:
        for k, v in fl.call_launches(spec, kind, n_pts).items():
            want[k] += v
    got = dict(fl.kernel_launches)
    print(f"{label}: {len(calls)} layer-route calls, kernel launches "
          + ", ".join(f"{k} {v}" for k, v in got.items()) + " (as fl.call_launches predicts: "
          + ("yes" if got == want else f"no, {want}") + f") [{card}]")
    if got != want:
        raise AssertionError(f"{label}: layer-route launches {got}, predicted {want}")


def rank_kernels(kern, bkern, skern, ckern, render, train, mesh, buff, buff_render, buff_mesh,
                 card: str) -> None:
    """What a kernel costs beyond its bound, launches x (time - bound), per
    kernel: in this smoke call's paths, and in a trained scene (SCENE_STEPS
    hierarchical steps, SCENE_VIEWS views, SCENE_MESHES meshes); with the
    launches per train step, per 400x400 view and per 480^3 mesh. The
    hierarchical paths launch coarse (S = 64) and fine (S = 192) passes in
    pairs; a coarse pass counts as a third of a fine one, the time timed."""
    fwd = kern["ms"] - kern["bound_ms"]  # 2048 x 192
    fwd_chunk = kern["chunk_ms"] - kern["chunk_bound_ms"]  # 65536 x 192
    bwd = bkern["ms"] - bkern["bound_ms"]
    sigma = skern["ms"] - skern["bound_ms"]
    chords = ckern["ms"] - ckern["bound_ms"]
    chords_chunk = ckern["chunk_ms"] - ckern["chunk_bound_ms"]
    pair = 2.0 / 3.0  # per launch of a coarse + fine pair: (1 + 1/3) / 2
    smoke_ms = {
        "fused_mlp_fwd": ((render["launches"] + train["fwd_launches"]) * pair * fwd
                          + mesh["fwd_launches"] * pair * fwd_chunk + buff["fwd_launches"] * fwd
                          + (buff_render["fwd_launches"] + buff_mesh["fwd_launches"])
                          * fwd_chunk),
        "fused_mlp_bwd": train["bwd_launches"] * pair * bwd + buff["bwd_launches"] * bwd,
        "fused_sigma": (mesh["sigma_launches"] + buff_mesh["sigma_launches"]) * sigma,
        "fused_chords": (buff["chords_launches"] * chords
                         + (buff_render["chords_launches"] + buff_mesh["chords_launches"])
                         * chords_chunk),
    }
    per_step = {"fused_mlp_fwd": train["fwd_launches"] / TRAIN_STEPS,
                "fused_mlp_bwd": train["bwd_launches"] / TRAIN_STEPS}
    per_view = {"fused_mlp_fwd": render["launches"] / 2}  # the render phase's 2 views
    per_mesh = {"fused_mlp_fwd": mesh["fwd_launches"], "fused_sigma": mesh["sigma_launches"]}
    excess = {"fused_mlp_fwd": (pair * fwd, pair * fwd, pair * fwd_chunk),
              "fused_mlp_bwd": (pair * bwd, 0.0, 0.0), "fused_sigma": (0.0, 0.0, sigma),
              "fused_chords": (0.0, 0.0, 0.0)}
    scene_ms = {k: (SCENE_STEPS * per_step.get(k, 0) * excess[k][0]
                    + SCENE_VIEWS * per_view.get(k, 0) * excess[k][1]
                    + SCENE_MESHES * per_mesh.get(k, 0) * excess[k][2]) for k in smoke_ms}
    for k in sorted(smoke_ms, key=lambda k: -scene_ms[k]):
        print(f"rank {k}: launches per train step {per_step.get(k, 0):g}, per view "
              f"{per_view.get(k, 0):g}, per mesh {per_mesh.get(k, 0):g}; launches x (time - "
              f"bound) {smoke_ms[k] / 1e3:.4f} s in this smoke call, "
              f"{scene_ms[k] / 1e3:.4f} s per trained scene [{card}]")


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


def _traced_kernels(fn, runs: int = 7, warmup: int = 2) -> list:
    """(name, device ms) of each kernel launch that `runs` calls of fn()
    made, from torch.profiler. CUDA events around one call of a kernel that
    lasts microseconds time the host's enqueue of its wrapper instead. The
    host sleeps TRACE_PAD_S before the calls and after their
    synchronisation, inside the trace: the profiler keeps the kernel events
    that fall within its window, and places them on the host's clock with
    an error of up to ~0.2 ms (kernels that start before their launch in
    scripts/torch_trace_probe.py's traces), so a short run's events could
    otherwise fall outside it. A trace in a process that was running while
    another process used the card can lack kernel records altogether,
    whatever the sleep (scripts/torch_trace_after_child.py): late in the
    smoke's process 3 of 36 launches were traced, and after the breakdowns'
    process none of 7. So the smoke's process traces only before it starts
    another CUDA process, and every later trace runs in a fresh process
    (breakdowns_process)."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(TRACE_PAD_S)
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        time.sleep(TRACE_PAD_S)
    with tempfile.TemporaryDirectory() as tmp:
        trace = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text())["traceEvents"]
    return [(e["name"], e["dur"] / 1e3) for e in events if e.get("cat") == "kernel"]


def _kernel_device_ms(fn, key: str, runs: int = 7) -> float:
    """Median device time in ms of the kernel named `key` that fn()
    launches once, over the launches traced in `runs` calls."""
    times = [t for name, t in _traced_kernels(fn, runs) if key in name]
    if not 0 < len(times) <= runs:
        raise AssertionError(f"{len(times)} {key} launches traced for {runs} calls")
    return statistics.median(times)


def _device_ms_by_group(fn, groups: dict, runs: int = 7) -> dict:
    """Device time in ms per call of fn() of each group of kernels (name
    substrings): the group's traced time over `runs` calls. Each group's
    first name is launched once a call and every other name a fixed number
    of times; a trace that lacks a launch of any name (its count not a
    positive multiple of runs, the first's not runs) fails."""
    kernels = _traced_kernels(fn, runs)
    out = {}
    for group, keys in groups.items():
        for i, key in enumerate(keys):
            n = sum(1 for name, _ in kernels if key in name)
            if n == 0 or n % runs or (i == 0 and n != runs):
                raise AssertionError(f"{n} {key} launches traced for {runs} calls "
                                     f"({len(kernels)} kernels traced)")
        out[group] = sum(t for name, t in kernels if any(k in name for k in keys)) / runs
    return out


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


def _back_to_back_ms(fn, launches: int = 20, runs: int = 7) -> float:
    """Median over `runs` of the device time per launch of `launches`
    back-to-back calls of fn(), by CUDA events, each run enqueued behind a
    ~10 ms spin of the card so the host's enqueue never starves it: a
    kernel's time with the gaps between its launches, beside the
    profiler's time of the kernel alone."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        torch.cuda._sleep(20_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
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
        worst = max(worst, _fwd_check(packed, o, d, z, model.hidden_size))

    # Times at the render fine shape (the last one checked above).
    times = _fwd_times(model, packed, o, d, z, card)

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
    chunk_bound_ms, chunk_bound_by = _fwd_bound(model, packed, R, S)
    _rate("fused_mlp_fwd", big_ms, _field_flops(model) * R * S, chunk_bound_ms, chunk_bound_by,
          f"{R}x{S} (appearance chunk)", card)
    chunk_library_ms, chunk_plain_ms = _chunk_yardsticks(model, packed, o, d, z, card)
    return dict(max_abs_err=worst, **times, chunk_ms=big_ms, chunk_bound_ms=chunk_bound_ms,
                chunk_library_ms=chunk_library_ms, chunk_plain_ms=chunk_plain_ms)


def _chunk_yardsticks(model, packed, o, d, z, card: str) -> tuple[float, float | None]:
    """The appearance chunk's library yardstick (the nn.Module at its
    points under bf16 autocast) and its plain version's time where the
    card holds the plain version's f32 activations: their peak on a
    CHECK_RAYS slice, scaled to the chunk, against the free memory (else
    None, and the gigabytes it would need are printed)."""
    from nerfmeshes_tpu_torch.ops.kernels import fused_mlp as fm

    R, S = z.shape
    pts = (o[:, None, :] + d[:, None, :] * z[..., None]).reshape(-1, 3)
    dirs = d[:, None, :].expand(R, S, 3).reshape(-1, 3)
    with torch.inference_mode():
        library_ms = _median_ms(_autocast(lambda: model(pts, dirs)), runs=3, warmup=1)
    del pts, dirs
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fm.fused_mlp_plain(packed, o[:CHECK_RAYS], d[:CHECK_RAYS], z[:CHECK_RAYS])
    need = (torch.cuda.max_memory_allocated() - base) * (R / CHECK_RAYS)
    free = torch.cuda.mem_get_info()[0]
    plain_ms = None
    if need < 0.9 * free:
        plain_ms = _median_ms(lambda: fm.fused_mlp_plain(packed, o, d, z), runs=3, warmup=1)
    plain = (f"{plain_ms:.4f} ms" if plain_ms is not None else
             f"not measured (needs ~{need / 2 ** 30:.1f} GiB, {free / 2 ** 30:.1f} GiB free)")
    print(f"fused_mlp_fwd at {R}x{S} (appearance chunk): nn.Module bf16 autocast "
          f"{library_ms:.4f} ms, plain {plain} (medians of 3; plain's peak on {CHECK_RAYS} "
          f"rays x {R // CHECK_RAYS}: {need / 2 ** 30:.2f} GiB) [{card}]")
    return library_ms, plain_ms


def _fwd_check(packed, o, d, z, hidden: int, route: str = "fused") -> float:
    """One launch of the route's forward at rays (o, d, z), counted once,
    finite, of shape (4, R, S) and within atol = rtol = 2e-2 of the plain
    version; returns the max abs error."""
    from nerfmeshes_tpu_torch.ops.kernels import fused_mlp as fm

    counts, fwd, _, _, name = _route(route)
    R, S = z.shape
    before = counts.launches
    got = fwd(packed, o, d, z)
    torch.cuda.synchronize()
    if counts.launches != before + 1:
        raise AssertionError(f"launch counter moved {counts.launches - before}, expected 1")
    ref = fm.fused_mlp_plain(packed, o, d, z)
    if got.shape != (4, R, S) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"kernel output shape {tuple(got.shape)} or non-finite values")
    err_rgb = float((got[:3] - ref[:3]).abs().max())
    err_sigma = float((got[3] - ref[3]).abs().max())
    print(f"{name}_fwd H={hidden} R={R} S={S}: max abs err rgb {err_rgb:.3e} sigma "
          f"{err_sigma:.3e} (bar atol=rtol={ATOL})")
    if not torch.allclose(got, ref, atol=ATOL, rtol=RTOL):
        raise AssertionError(f"kernel disagrees with the plain version at H={hidden} S={S}")
    return max(err_rgb, err_sigma)


def _fwd_bound(model, packed, R: int, S: int) -> tuple[float, str]:
    """The forward kernel's bound at R rays x S samples: the field's
    products, against rays and depths read, the output written and the
    packed weights read once."""
    nbytes = (R * 24 + R * S * 4 + R * S * 16 + packed.weights.numel() * 2
              + packed.biases.numel() * 4)
    return _bound_ms(_field_flops(model) * R * S, nbytes, PEAK_BF16)


def _bwd_bound(model, packed, R: int, S: int) -> tuple[float, str]:
    """The backward kernel's bound at R rays x S samples: the forward
    recompute, the dX chain and the dW products (3x the forward's
    operations), against rays, depths and the cotangent read, the packed
    weights read once and the f32 grads written."""
    n_pts, n_w = R * S, packed.weights.numel()
    nbytes = (R * 24 + n_pts * 4 + n_pts * 16 + n_w * 2 + (n_w + packed.biases.numel()) * 4)
    return _bound_ms(3 * _field_flops(model) * n_pts, nbytes, PEAK_BF16)


def _fwd_times(model, packed, o, d, z, card: str, route: str = "fused") -> dict:
    """The route's forward at rays (o, d, z), timed beside its plain
    version, the library yardstick (the nn.Module at the same points under
    bf16 autocast: cuBLAS tensor-core products layer by layer; the module
    as it is beside it, f32 products of bf16-rounded operands; the port
    calls neither for a fused-eligible model) and its bound."""
    from nerfmeshes_tpu_torch.ops.kernels import fused_mlp as fm

    _, fwd, _, _, name = _route(route)
    R, S = z.shape
    ms = _median_ms(lambda: fwd(packed, o, d, z))
    pts = (o[:, None, :] + d[:, None, :] * z[..., None]).reshape(-1, 3)
    dirs = d[:, None, :].expand(R, S, 3).reshape(-1, 3)
    with torch.inference_mode():
        plain_ms, module_ms, library_ms = _yardsticks(
            route, lambda: fm.fused_mlp_plain(packed, o, d, z), lambda: model(pts, dirs),
            _autocast(lambda: model(pts, dirs)))
    bound_ms, bound_by = _fwd_bound(model, packed, R, S)
    for what, t in (("kernel", ms), ("plain", plain_ms), ("nn.Module", module_ms),
                    ("nn.Module bf16 autocast", library_ms), ("bound", bound_ms)):
        rate = "" if t is None else f", {R * S / t * 1e3:.4e} points/s"
        print(f"{name}_fwd {what}: {_ms_text(t)}{rate} "
              f"at {R}x{S} points, H={model.hidden_size} [{card}]")
    _rate(f"{name}_fwd", ms, _field_flops(model) * R * S, bound_ms, bound_by,
          f"{R}x{S}, H={model.hidden_size}", card)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def h128_kernel_phase(card: str, device) -> dict:
    """The forward, backward and sigma kernels at the width of
    configs/hard-llff.yml (8x128 FlexibleNeRF, PE 10/4), at its train
    shapes: 2048 rays x 64 coarse and x 128 fine samples. Each shape of the
    forward is held against its plain version (atol = rtol = 2e-2) and
    timed (_fwd_times); the backward is held at both shapes and timed at
    2048 x 128 (bwd_kernel_phase); sigma is held and timed at a
    262,144-point grid tile (sigma_kernel_phase). Returns {"fwd": {S:
    row}, "bwd": row, "sigma": row}."""
    from nerfmeshes_tpu_torch.models import build_model
    from nerfmeshes_tpu_torch.ops.kernels import fused_mlp as fm
    from nerfmeshes_tpu_torch.train.system import init_params

    cfg = llff_cfg()
    model = build_model(cfg.models.fine_type, dict(cfg.models.fine),
                        compute_dtype=torch.bfloat16)
    if model.hidden_size != 128 or not fm.supports_fused(model):
        raise AssertionError("hard-llff.yml's field is not an 8x128 fused model")
    init_params(model, None, torch.Generator().manual_seed(SEED))
    model.to(device).eval()
    packed = fm.pack_weights(model)
    rng = np.random.default_rng(SEED)
    R = int(cfg.nerf.train.num_random_rays)
    rows = {}
    for S in (int(cfg.nerf.train.num_coarse),
              int(cfg.nerf.train.num_coarse) + int(cfg.nerf.train.num_fine)):
        o, d, z = _rays(R, S, rng, device)
        rows[S] = dict(max_abs_err=_fwd_check(packed, o, d, z, model.hidden_size),
                       shape=f"{R}x{S}", **_fwd_times(model, packed, o, d, z, card))
    bwd = bwd_kernel_phase(cfg, card, device)
    sigma = sigma_kernel_phase(cfg, card, device)
    return {"fwd": rows, "bwd": dict(bwd, shape=f"{R}x{S}"),
            "sigma": dict(sigma, shape=f"{GRID_TILE} points")}


# The wide fields (csrc/fused_field.cuh at H > 256: 64-point tiles whose
# products the two consumer warpgroups split in N; at H > 512 split across
# a 2-CTA cluster as well): configs/hard-blender.yml's two 8-layer L 10/4
# FlexibleNeRFs widened to 384-1024 (JAX's Pallas kernels take any
# H % 128 == 0; 1024 is mip-NeRF 360's NeRF-MLP width). The fused kernels
# are called directly at every width; the chain goes through the normal
# entry points, whose route (fm.field_route) is the fused kernels at 384
# and the layer route from 512 on. At 512 and 1024 the whole chain (train,
# 2 views, a WIDE_MESH_RES^3 mesh); at the others the train leg and a
# mesh.
WIDE_HIDDEN = (384, 512, 640, 768, 896, 1024)
WIDE_MESH_RES = {384: 128, 512: 256, 640: 64, 768: 64, 896: 64, 1024: 128}
WIDE_VIEWS = (512, 1024)
# Widths whose kernels are timed at the coarse shape alone (2048 x 64),
# checked at both: the smoke's time stays near its budget.
WIDE_COARSE_TIMES = (640, 768, 896)


def wide_cfg(hidden: int):
    """hard_blender_cfg() with both fields `hidden` wide."""
    cfg = hard_blender_cfg()
    _merge(cfg, {"models": {"coarse": {"hidden_size": hidden}, "fine": {"hidden_size": hidden}}})
    return cfg


def wide_phase(card: str, device, legs: dict) -> dict:
    """Per width of WIDE_HIDDEN, the fused kernels called directly: the
    shared-memory plans of the three kernels (fm.field_plan, as the
    launches make them: ring stages, PE tiles, slab K-columns, CTAs per
    tile, bytes) and the weight bytes each 64-point tile reads; the forward
    at 2048 x 64 and 2048 x 192, the backward at both (timed at 2048 x 192,
    with its legs at 512 and 1024 from `legs`, breakdowns_process's "fused"
    part, keyed "w512" and "w1024"; at WIDE_COARSE_TIMES the forward and
    backward timed at 2048 x 64 only) and sigma at a 262,144-point grid
    tile, each against its plain version and timed beside its bound and
    library yardstick; from 640 on, sigma bit for bit the forward's channel
    3 and a repeat forward launch bit for bit the first. Then the path
    through the normal entry points on the width's route (fm.field_route:
    the fused kernels at 384, the layer route from 512 on, every launch its
    kernels' and on the layer route each kernel's launches those
    fl.call_launches predicts): NeRFSystem.setup + fit (3 + 30 steps, 2 + 2
    calls a step, the loss falls, one step's grads against the nn.Module
    path), at WIDE_VIEWS two 400x400 views of the trained system through
    query_rays, and export_marching_cubes at WIDE_MESH_RES^3 (sigma calls
    per grid tile, 2 forward calls per appearance chunk, the colours
    against the nn.Module render)."""
    from nerfmeshes_tpu_torch.models import build_model
    from nerfmeshes_tpu_torch.ops.kernels import fused_mlp as fm
    from nerfmeshes_tpu_torch.train.render import RenderSettings, render_rays
    from nerfmeshes_tpu_torch.train.system import init_params

    out = {}
    for H in WIDE_HIDDEN:
        t0 = time.perf_counter()
        cfg = wide_cfg(H)
        model = build_model(cfg.models.fine_type, dict(cfg.models.fine),
                            compute_dtype=torch.bfloat16)
        init_params(model, None, torch.Generator().manual_seed(SEED))
        model.to(device).eval()
        packed = fm.pack_weights(model)
        spec = packed.spec
        plans = {k: fm.field_plan(spec, k) for k in ("fwd", "sigma", "bwd")}
        route = fm.field_route(spec)
        if (model.hidden_size != H or not fm.supports_fused(model) or None in plans.values()
                or route != ("fused" if H in fm.FUSED_WIDTHS else "layers")):
            raise AssertionError(f"the {H}-wide hard-blender field: route {route}, plans {plans}")
        trunk = int(packed.desc[fm._DESC_FIXED + spec.num_layers])  # bf16 weights before feat
        print(f"w{H} plans (stages, PE tiles, slab K, CTAs per tile, shared bytes per CTA): "
              + ", ".join(f"{k} {p.stages} {p.pe_slots} {p.slab_k} {p.cluster} {p.bytes}"
                          for k, p in plans.items())
              + f"; 64-point tiles, weights read from L2 per point: forward "
              f"{packed.weights.numel() * 2 / 64:.1f} B, sigma {trunk * 2 / 64:.1f} B")
        rng = np.random.default_rng(SEED)
        R = int(cfg.nerf.train.num_random_rays)
        coarse = int(cfg.nerf.train.num_coarse)
        fwd, untimed_err = {}, 0.0
        for S in (coarse, coarse + int(cfg.nerf.train.num_fine)):
            o, d, z = _rays(R, S, rng, device)
            err = _fwd_check(packed, o, d, z, H)
            if H in WIDE_COARSE_TIMES and S != coarse:
                untimed_err = err  # checked, not timed: folded into the timed row's error
            else:
                fwd[S] = dict(max_abs_err=err, shape=f"{R}x{S}",
                              **_fwd_times(model, packed, o, d, z, card))
            if H > 512:
                again = [fm.fused_mlp_cuda(packed, o, d, z) for _ in range(2)]
                torch.cuda.synchronize()
                if not torch.equal(*again):
                    raise AssertionError(f"w{H}: two forward launches differ at {R}x{S}")
                print(f"fused_mlp_fwd H={H} {R}x{S}: 2 launches bitwise equal")
        if H in WIDE_COARSE_TIMES:
            fwd[coarse]["max_abs_err"] = max(fwd[coarse]["max_abs_err"], untimed_err)
        del model, packed
        bwd = bwd_kernel_phase(cfg, card, device, time_fine=H not in WIDE_COARSE_TIMES)
        if f"w{H}" in legs:
            bwd["legs"] = legs[f"w{H}"]
        sigma = sigma_kernel_phase(cfg, card, device)
        if H > 512 and not sigma["bitwise"]:
            raise AssertionError(f"w{H}: sigma is not bit for bit the forward's channel 3")
        kernels_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        train = train_phase(card, device, cfg, route=route)
        system = train.pop("system")
        render = (slice_phase(cfg, card, device, system, route=route) if H in WIDE_VIEWS
                  else None)
        settings = RenderSettings.from_cfg(cfg, train=False)._replace(use_fused_kernel=False)

        def module_rgb(o, d, near, far, system=system, settings=settings):
            return render_rays(system.coarse, system.fine, o, d, near, far, settings,
                               train=False)[1].rgb_map

        mesh = export_and_check(system, card, f"w{H} mesh", fwd_per_chunk=2,
                                chords_per_chunk=0, module_rgb=module_rgb,
                                res=WIDE_MESH_RES[H], route=route)
        del system, module_rgb
        gc.collect()
        torch.cuda.empty_cache()
        print(f"w{H}: kernels {kernels_s:.2f} s, chain on the {route} route "
              f"{time.perf_counter() - t0:.2f} s [{card}]")
        out[H] = dict(fwd=fwd, bwd=bwd, sigma=sigma, train=train, render=render, mesh=mesh,
                      plans=plans, route=route)
    return out


# The layer route (csrc/field_layers.cu): the FlexibleNeRF fields that JAX's
# Pallas kernels take and fm.field_route does not send to the fused
# kernels. configs/hard-blender.yml's two 8-layer fields at 512 and 1024
# wide (L 10/4: the fused plans hold them, the route beat them), at 1024
# wide with mip-NeRF's 16 position bands (max_deg_point; the fused plans
# hold 15), at 1152 and 2048 wide; and at its own 256 wide with 16 layers
# or 32 position bands, checked and timed at 2048 x 64 only. The whole path
# at w1024-L16 (3 + 30 steps, 2 views, a 128^3 mesh with its colour check)
# and at 2048 wide with L 10/4 (3 + 30 steps, a 64^3 mesh: over 10 steps
# its loss's batch noise hides the fall, 0.1186 in the first 5 steps' mean,
# 0.1240 in the last 5's); at 512 and 1024 with L 10/4 wide_phase runs it.
LAYER_CASES = {
    "w512": {"hidden_size": 512},
    "w1024": {"hidden_size": 1024},
    "w1024-L16": {"hidden_size": 1024, "num_encoding_fn_xyz": 16},
    "w1152": {"hidden_size": 1152},
    "w2048": {"hidden_size": 2048},
    "deep16": {"num_layers": 16},
    "bands32": {"num_encoding_fn_xyz": 32},
}
LAYER_COARSE_ONLY = ("deep16", "bands32")
# The cases whose forward and backward calls are broken down by kernel.
LAYER_LEG_CASES = ("w512", "w1024", "w1024-L16", "w2048")
LAYER_CHAINS = {"w1024-L16": dict(steps=30, views=True, res=128, grad_rays=None),
                "w2048": dict(steps=30, views=False, res=64, grad_rays=512)}
# The route's kernels by name, as torch.profiler traces them
# (tests/test_torch_fused_mlp.py holds every name to a __global__ of csrc/).
LAYER_KERNELS = {"pe": ("layer_pe_kernel",), "product": ("layer_product_kernel",),
                 "heads": ("layer_heads_kernel",), "dw": ("layer_dw_kernel",),
                 "reduce": ("reduce_rows_kernel",), "bias": ("bias_grads_kernel",),
                 "heads_bwd": ("layer_heads_bwd_kernel",)}


# The product kernel's timed shapes, (points M, K, N): an 8x1024 product
# at 2048 x 192 points, an 8x2048 backward slab (42,240 points), and a
# 256-wide product at 2048 x 192 points.
PRODUCT_SHAPES = ((393216, 1024, 1024), (42240, 2048, 2048), (393216, 256, 256))


def product_operands(M: int, K: int, N: int, nn: bool, device):
    """Seeded operands of one product, ((a1, None, w, N), keywords of
    fl.layers_product_cuda): as the forward runs it (nn False: bias, ReLU)
    or as the backward's dX chain does (nn True: the mask and the column
    sums)."""
    g = torch.Generator(device).manual_seed(SEED + M + K + N)
    a = torch.randn((M, K), generator=g, device=device).to(torch.bfloat16)
    w = (torch.randn((K, N) if nn else (N, K), generator=g, device=device) / K ** 0.5
         ).to(torch.bfloat16)
    bias = None if nn else torch.randn(N, generator=g, device=device)
    mask = torch.randn((M, N), generator=g, device=device).to(torch.bfloat16) if nn else None
    return (a, None, w, N), dict(nn=nn, bias=bias, relu=not nn, mask=mask, colsum=nn)


def _product_bound(M: int, K: int, N: int, nn: bool) -> tuple[float, str]:
    """The least time of one product: 2 M K N bf16 operations, or its bytes
    read and written once (A, W, the output; the bias, or the mask and the
    column sums)."""
    nbytes = 2 * (M * K + K * N + M * N) + (2 * M * N + -(-M // 128) * N * 4 if nn else 4 * N)
    return _bound_ms(2 * M * K * N, nbytes, PEAK_BF16)


def product_phase(card: str, device) -> dict:
    """The layer route's product kernel alone (fl.layers_product_cuda) at
    PRODUCT_SHAPES, NN 0 and NN 1 (product_operands): against its plain
    version (bf16 outputs within 1e-2 of their magnitude plus 1e-2 of the
    largest, column sums within 1e-4 of the sum of magnitudes: the GPU
    tests' bars), timed (CUDA events, median of 7) beside its bound and one
    bf16 torch.mm of the same product (cuBLAS, f32 sums, bf16 out; never
    called by the port); the plain version's median of 3."""
    from nerfmeshes_tpu_torch.ops.kernels import field_layers as fl

    rows = {}
    for M, K, N in PRODUCT_SHAPES:
        for nn in (False, True):
            (a, _, w, n), kw = product_operands(M, K, N, nn, device)
            got, got_cs = fl.layers_product_cuda(a, None, w, n, **kw)
            want, want_cs = fl.layers_product_plain(a, None, w, n, **kw)
            diff = (got.float() - want.float()).abs()
            err = float(diff.max())
            ok = bool((diff <= 1e-2 * want.float().abs()
                       + 1e-2 * float(want.float().abs().max())).all())
            del got, want, diff
            if nn:
                mag = fl.layers_product_plain(a.abs(), None, w.abs(), n, nn=True)[1]
                ok = ok and bool(((got_cs - want_cs).abs() <= 1e-4 * mag + 1e-2).all())
                del mag
            name = f"M={M} K={K} N={N} NN {int(nn)}"
            if not ok:
                raise AssertionError(f"product kernel at {name} differs from plain ({err})")
            b = w if nn else w.t()
            ms = _median_ms(lambda: fl.layers_product_cuda(a, None, w, n, **kw))
            library_ms = _median_ms(lambda: torch.mm(a, b))
            plain_ms = _median_ms(lambda: fl.layers_product_plain(a, None, w, n, **kw), runs=3,
                                  warmup=1)
            bound_ms, bound_by = _product_bound(M, K, N, nn)
            rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                              bound_by=bound_by, library_ms=library_ms)
            print(f"field_layers product kernel at {name}: {ms:.4f} ms, "
                  f"{2 * M * K * N / ms / 1e9:.1f} TFLOP/s, bound {bound_ms:.4f} ms "
                  f"({bound_by}), {100.0 * bound_ms / ms:.1f}% of the bound; one bf16 torch.mm "
                  f"{library_ms:.4f} ms; plain {plain_ms:.4f} ms; max abs err vs plain "
                  f"{err:.3e} [{card}]")
            del a, w, b, kw, got_cs, want_cs
            gc.collect()
            torch.cuda.empty_cache()
    return rows


def leg_kernel_phase(card: str, device) -> dict:
    """The backward's heads kernel, the bias-grad reduction and the dW leg
    alone (fl.layers_heads_bwd_cuda, fl.layers_bias_cuda,
    fl.layers_dw_cuda) at the shapes of a backward slab of the 8x2048 and
    8x1024 (L 10/4) fields at 2048 x 192 points (LAYER_CASES' fine fields,
    their weights from SEED; h a ReLU output and seeded cotangents,
    partials and dW operands; the dW leg on a trunk matrix, the skip's [x |
    PE] and dir's with the heads, fl.route_dw_jobs): against their plain
    versions (heads outputs within 1e-2 of each other's magnitude plus 1e-2
    of the largest, the product kernel's bar; bias grads within 1e-5 of the
    sums of magnitudes; dW within 1e-4 of the sums of the products'
    magnitudes), timed by CUDA events over 20 launches back to back
    behind a spin of the card (_back_to_back_ms: a trace late in the smoke
    may miss kernels this short) beside their bounds (each input read
    once, each output written once), the plain versions (CUDA events,
    median of 3) and, for the reduction, one torch.sum(partials, dim=0) per
    bias vector, for the dW leg one bf16 torch.mm per product, timed alike
    and never called by the port. Then the PE kernel (_layer_pe_rows)."""
    from nerfmeshes_tpu_torch.models import build_model
    from nerfmeshes_tpu_torch.ops.kernels import field_layers as fl
    from nerfmeshes_tpu_torch.ops.kernels import fused_mlp as fm
    from nerfmeshes_tpu_torch.train.system import init_params

    rows = {}
    for case in ("w2048", "w1024"):
        cfg = layer_cfg(case)
        model = build_model(cfg.models.fine_type, dict(cfg.models.fine),
                            compute_dtype=torch.bfloat16)
        init_params(model, None, torch.Generator().manual_seed(SEED))
        packed = fm.pack_weights(model.to(device))
        del model
        spec = packed.spec
        H2 = spec.hidden // 2
        m = fl.slab_points(spec, "bwd", 2048 * 192)
        g = torch.Generator(device).manual_seed(SEED + m)
        h = torch.randn((m, H2), generator=g, device=device).clamp_min(0.0).to(torch.bfloat16)
        grad = torch.randn((4, m), generator=g, device=device)
        got = fl.layers_heads_bwd_cuda(packed, h, grad)
        want = fl.layers_heads_bwd_plain(packed, h, grad)
        err, ok = 0.0, True
        for a, b in zip(got, want):
            diff = (a.float() - b.float()).abs()
            err = max(err, float(diff.max()))
            ok = ok and bool((diff <= 1e-2 * b.float().abs()
                              + 1e-2 * float(b.float().abs().max())).all())
        if not ok:
            raise AssertionError(f"{case}: the backward heads kernel differs from plain ({err})")
        nbytes = m * H2 * 4 + m * 16 + m * 64 + -(-m // 64) * (H2 + 4) * 4
        bound_ms, bound_by = _bound_ms(2 * m * 3 * H2 + 5 * m * H2, nbytes, PEAK_F32)
        rows[f"heads {case} m={m}"] = dict(
            max_abs_err=err, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
            ms=_back_to_back_ms(lambda: fl.layers_heads_bwd_cuda(packed, h, grad)),
            plain_ms=_median_ms(lambda: fl.layers_heads_bwd_plain(packed, h, grad), runs=3,
                                warmup=1))
        del got, want, h, grad

        segs = fl.bias_segments(spec, m)
        parts = [torch.randn(shape, generator=g, device=device) for shape in segs]
        outs = [torch.randn(shape[1], generator=g, device=device) for shape in segs]
        got = fl.layers_bias_cuda(parts, outs)
        want = fl.layers_bias_plain(parts, outs)
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        if not all(bool(((a - b).abs() <= 1e-5 * (o.abs() + p.abs().sum(0)) + 1e-6).all())
                   for a, b, o, p in zip(got, want, outs, parts)):
            raise AssertionError(f"{case}: the bias-grad reduction differs from plain ({err})")
        nbytes = sum(4 * r * c + 8 * c for r, c in segs)
        bound_ms, bound_by = _bound_ms(sum(r * c for r, c in segs), nbytes, PEAK_F32)
        rows[f"bias {case} m={m}"] = dict(
            max_abs_err=err, bound_ms=bound_ms, bound_by=bound_by,
            ms=_back_to_back_ms(fl.layers_bias_launcher(parts, [o.clone() for o in outs])),
            plain_ms=_median_ms(lambda: fl.layers_bias_plain(parts, outs), runs=3, warmup=1),
            library_ms=_back_to_back_ms(lambda: [torch.sum(p, dim=0) for p in parts]))
        del got, want, parts, outs
        rows.update(_dw_alone_rows(case, packed, m, g, card, device))
        del packed
        torch.cuda.empty_cache()
    for name, row in rows.items():
        if name.startswith("dw"):
            continue
        kernel = "layer_heads_bwd_kernel" if name.startswith("heads") else "bias_grads_kernel"
        print(f"field_layers {name} ({kernel} alone): {row['ms']:.4f} ms (CUDA events, 20 "
              "launches back to back), "
              f"bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}), {100 * row['bound_ms'] / row['ms']:.1f}% of it; plain "
              f"{row['plain_ms']:.4f} ms; library "
              + ("none" if row["library_ms"] is None else
                 f"{row['library_ms']:.4f} ms (torch.sum(partials, dim=0) per bias vector)")
              + f"; max abs err vs plain {row['max_abs_err']:.3e} [{card}]")
    rows.update(_layer_pe_rows(card, device))
    return rows


def _dw_alone_rows(case: str, packed, m: int, g: torch.Generator, card: str, device) -> dict:
    """The route's dW leg alone (fl.layers_dw_cuda: layer_dw_kernel and its
    range reduction) on a backward slab of m points of `case`'s field: a
    trunk matrix, the first skip's [x | PE] and dir's with the heads, on
    seeded operands (fl.route_dw_jobs), each against its plain version at
    the ranges the kernel plans and an f32 torch.mm of the same bf16
    operands (within 1e-4 of the sums of the products' magnitudes), two
    launches bitwise equal, and bit for bit the fused backward's dw_kernel
    on the same ranges; timed (_back_to_back_ms) beside its bound (bf16
    operations, or the operands read once and the grads read and written
    once), the plain version and one bf16 torch.mm per product."""
    from nerfmeshes_tpu_torch.ops.kernels import field_layers as fl

    spec = packed.spec
    H, L = spec.hidden, spec.num_layers
    skip = next(k for k in range(1, L + 1) if spec.gemm_shapes()[k][1] > H)
    rows = {}
    for what, k in (("trunk", 1), ("skip", skip), ("dir+heads", L + 1)):
        n, kk = spec.gemm_shapes()[k]

        def randn(cols):
            return torch.randn((m, cols), generator=g, device=device).to(torch.bfloat16)

        heads = (randn(16), randn(H), randn(16), randn(H // 2)) if k == L + 1 else None
        pe = randn(kk - H) if kk > H else None
        jobs, _, cols = fl.route_dw_jobs(packed, k, randn(n), randn(H), pe, heads)
        out = torch.randn(cols, generator=g, device=device)
        got = fl.layers_dw_cuda(jobs, out)
        again = fl.layers_dw_cuda(jobs, out)
        fused = fl.layers_dw_cuda(jobs, out, variant="fused")  # dw_kernel, the same ranges
        scratch = out.clone()
        launch = fl.layers_dw_launcher(jobs, scratch)
        ranges, units, kernels, pieces = launch()
        want = fl.layers_dw_plain(jobs, out, ranges=ranges)
        mag = fl.layers_dw_plain([j._replace(dy=j.dy.abs(), x=j.x.abs()) for j in jobs],
                                 out.abs(), ranges=1)
        mm = out.clone()
        for j in jobs:
            block = j.dy.float().t() @ j.x.float()
            mm.as_strided(block.shape, (j.ldw, 1), j.w_off + j.col_off).add_(block)
        err = float((got - want).abs().max())
        ok = torch.equal(got, again) and torch.equal(got, fused) and all(
            bool(((got - ref).abs() <= 1e-4 * mag + 1e-6).all()) for ref in (want, mm))
        if not ok:
            raise AssertionError(f"{case} {what}: the dW leg differs from plain or torch.mm, or "
                                 f"from dw_kernel's bits, or two launches differ ({err})")
        flops = sum(2 * m * j.dy.shape[1] * j.x.shape[1] for j in jobs)
        operands = {(j.dy.data_ptr(), j.dy.shape[1]) for j in jobs} | {
            (j.x.data_ptr(), j.x.shape[1]) for j in jobs}
        bound_ms, bound_by = _bound_ms(flops, 2 * m * sum(c for _, c in operands) + 8 * cols,
                                       PEAK_BF16)
        rows[f"dw {case} {what} m={m}"] = dict(
            max_abs_err=err, bound_ms=bound_ms, bound_by=bound_by, ranges=ranges, units=units,
            kernels=kernels, pieces=pieces, ms=_back_to_back_ms(launch),
            plain_ms=_median_ms(lambda: fl.layers_dw_plain(jobs, out, ranges=ranges), runs=3,
                                warmup=1),
            library_ms=_back_to_back_ms(lambda: [torch.mm(j.dy.t(), j.x) for j in jobs]))
        del jobs, got, again, fused, want, mag, mm, out, scratch, launch
        torch.cuda.empty_cache()
    for name, row in rows.items():
        print(f"field_layers {name} (layer_dw_kernel + its range reduction alone, "
              f"{row['ranges']} ranges, {row['units']} units, {row['kernels']} launches, the "
              f"last wave in {256 // row['pieces']}-column pieces): "
              f"{row['ms']:.4f} ms (CUDA events, 20 launches back to back), bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}), "
              f"{100 * row['bound_ms'] / row['ms']:.1f}% of it; plain {row['plain_ms']:.4f} ms; "
              f"library {row['library_ms']:.4f} ms (a bf16 torch.mm per product); max abs err "
              f"vs plain {row['max_abs_err']:.3e} [{card}]")
    return rows


def layer_cfg(case: str):
    """hard_blender_cfg() with both fields changed as LAYER_CASES[case]."""
    cfg = hard_blender_cfg()
    _merge(cfg, {"models": {"coarse": LAYER_CASES[case], "fine": LAYER_CASES[case]}})
    return cfg


def _device_ms_per_call(fn, groups: dict, runs: int = 3) -> dict:
    """(device ms, launches) per call of fn(), a layer-route call, of each
    of the route's kernels (groups keyed as fl.KERNELS): the launches one
    call makes by fl.kernel_launches, times torch.profiler's mean device
    time a traced launch of the kernel (a trace of a long run may drop
    events, so the trace's own count is not used; a kernel the call
    launches and the trace lacks fails)."""
    from nerfmeshes_tpu_torch.ops.kernels import field_layers as fl

    before = dict(fl.kernel_launches)
    fn()
    torch.cuda.synchronize()
    per_call = {k: fl.kernel_launches[k] - before[k] for k in groups}
    kernels = _traced_kernels(fn, runs, warmup=0)
    out = {}
    for group, keys in groups.items():
        times = [t for name, t in kernels if any(k in name for k in keys)]
        if per_call[group] and not times:
            raise AssertionError(f"the trace holds none of {per_call[group]} {group} launches "
                                 f"a call ({len(kernels)} kernels traced)")
        out[group] = ((statistics.mean(times) if times else 0.0) * per_call[group],
                      per_call[group])
    return out


def _layer_leg_yardsticks(spec, kind: str, n_pts: int, device) -> dict:
    """Per kernel of a layer-route call of `kind` ("fwd" or "bwd") over
    n_pts points (fl.KERNELS): (bound ms, what bounds it, library ms or
    None). The bound sums each launch's (_bound_ms at the shapes the call
    gives it: each input read once, each output written once; products
    and dW in bf16 operations, the heads' dot products in f32). Library:
    one bf16 torch.mm per product (fl.route_products) and, in the
    backward, per weight matrix's dW = dY^T X; one torch.sum(partials,
    dim=0) per reduction of the same f32 partials (dW's point ranges, each
    bias vector's rows: fl.bias_segments); medians of 7 on seeded operands
    of each distinct shape, times its launches. None for the PE and heads,
    which no one PyTorch call computes."""
    from nerfmeshes_tpu_torch.ops.kernels import field_layers as fl

    H, pxp, pdp = spec.hidden, spec.pxp, spec.pdp
    slab = fl.slab_points(spec, kind, n_pts)
    bound = dict.fromkeys(fl.KERNELS, 0.0)
    bound_by = {k: set() for k in fl.KERNELS}
    mm, dw = {}, {}  # shape -> launches
    sums = {"reduce": {}, "bias": {}}  # kernel -> partials' shape -> reductions

    def add(kernel, flops, nbytes, peak=PEAK_BF16):
        t, by = _bound_ms(flops, nbytes, peak)
        bound[kernel] += t
        bound_by[kernel].add(by)

    for row0 in range(0, n_pts, slab):
        m = min(slab, n_pts - row0)
        mt = -(-m // 128)
        add("pe", 0, m * 4 + m * (pxp + pdp) * 2)  # z in (a ray's o, d shared), PE out
        for k1, k2, n, nn in fl.route_products(spec, kind):
            k = k1 + k2
            add("product", 2 * m * k * n, 2 * (m * k + k * n + m * n)
                + (2 * m * n + mt * n * 4 if nn else 4 * n))
            mm[(m, k, n)] = mm.get((m, k, n), 0) + 1
        if kind == "fwd":  # trunk and h in, (4, m) out
            add("heads", 2 * m * (H + 3 * H // 2), m * (H + H // 2) * 2 + m * 16, PEAK_F32)
            continue
        # heads: h and the cotangent in; dy_rgb, dy_a, dy_dir and partials out
        add("heads_bwd", 2 * m * 3 * H // 2, m * (H // 2) * 4 + m * 16 + m * 64
            + -(-m // 64) * (H // 2 + 4) * 4, PEAK_F32)
        reduce_bytes = bias_bytes = 0
        for (n_g, k_g), (cols, ranges) in zip(spec.gemm_shapes(), fl.dw_groups(spec)):
            used = fl._range_split(m, ranges)[1]
            # operands in; the range partials out, or at one range the grads in and out
            add("dw", 2 * m * cols, 2 * m * (n_g + k_g) + (4 * used if used > 1 else 8) * cols)
            dw[(m, n_g, k_g)] = dw.get((m, n_g, k_g), 0) + 1
            if used > 1:
                reduce_bytes += 4 * used * cols + 8 * cols  # partials in; grads in and out
                sums["reduce"][(used, cols)] = sums["reduce"].get((used, cols), 0) + 1
        for rows, cols in fl.bias_segments(spec, m):
            bias_bytes += 4 * rows * cols + 8 * cols
            sums["bias"][(rows, cols)] = sums["bias"].get((rows, cols), 0) + 1
        add("reduce", 0, reduce_bytes)
        add("bias", 0, bias_bytes)
    g = torch.Generator(device).manual_seed(SEED)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device).to(torch.bfloat16)

    library = {k: None for k in fl.KERNELS}
    library["product"] = 0.0
    for (m, k, n), count in mm.items():
        a, b = randn(m, k), randn(k, n)
        library["product"] += count * _median_ms(lambda: torch.mm(a, b))
    if dw:
        library["dw"] = 0.0
    for (m, n_g, k_g), count in dw.items():
        dy, x = randn(m, n_g), randn(m, k_g)
        library["dw"] += count * _median_ms(lambda: torch.mm(dy.t(), x))
    for kernel, shapes in sums.items():
        for shape, count in shapes.items():
            part = torch.randn(shape, generator=g, device=device)
            library[kernel] = (library[kernel] or 0.0) + count * _median_ms(
                lambda: torch.sum(part, dim=0))
            del part
    torch.cuda.empty_cache()
    return {k: (bound[k], "/".join(sorted(bound_by[k])) or "-", library[k])
            for k in fl.KERNELS}


def layer_legs(card: str, device) -> dict:
    """Each of the route's kernels' device time in one forward and one
    backward call at 2048 x 192 points (_device_ms_per_call: torch.profiler
    over 3 calls) beside its bound and library yardstick
    (_layer_leg_yardsticks), for the fine fields of LAYER_LEG_CASES (weights
    from SEED, seeded rays and cotangent); printed, and returned as
    {case: {"fwd" | "bwd": {kernel: {ms, launches, bound_ms, bound_by,
    library_ms}}}}."""
    from nerfmeshes_tpu_torch.models import build_model
    from nerfmeshes_tpu_torch.ops.kernels import field_layers as fl
    from nerfmeshes_tpu_torch.ops.kernels import fused_mlp as fm
    from nerfmeshes_tpu_torch.train.system import init_params

    out = {}
    for case in LAYER_LEG_CASES:
        cfg = layer_cfg(case)
        model = build_model(cfg.models.fine_type, dict(cfg.models.fine),
                            compute_dtype=torch.bfloat16)
        init_params(model, None, torch.Generator().manual_seed(SEED))
        packed = fm.pack_weights(model.to(device).eval())
        del model
        spec = packed.spec
        rng = np.random.default_rng(SEED)
        R = int(cfg.nerf.train.num_random_rays)
        S = int(cfg.nerf.train.num_coarse) + int(cfg.nerf.train.num_fine)
        o, d, z = _rays(R, S, rng, device)
        cot = torch.from_numpy(rng.standard_normal((4, R, S)).astype(np.float32)).to(device)
        calls = {"fwd": lambda: fl.layers_mlp_cuda(packed, o, d, z),
                 "bwd": lambda: fl.layers_bwd_cuda(packed, o, d, z, cot)}
        out[case] = {}
        for what, call in calls.items():
            groups = _device_ms_per_call(call, LAYER_KERNELS)
            sticks = _layer_leg_yardsticks(spec, what, R * S, device)
            legs = {k: dict(ms=ms, launches=n, bound_ms=sticks[k][0], bound_by=sticks[k][1],
                            library_ms=sticks[k][2]) for k, (ms, n) in groups.items()}
            out[case][what] = legs
            print(f"{case} {what} at {R}x{S}, per call by kernel: device ms "
                  "(torch.profiler's ms a launch over 3 calls x launches a call) / launches / "
                  "bound ms / library ms (bf16 torch.mm per product or dW product, "
                  "torch.sum(partials, dim=0) per reduction): "
                  + ", ".join(f"{k} {v['ms']:.4f} / {v['launches']:g} / {v['bound_ms']:.4f} "
                              f"({v['bound_by']}) / "
                              + ("none" if v["library_ms"] is None else f"{v['library_ms']:.4f}")
                              for k, v in legs.items())
                  + f" [{card}]")
            if what == "bwd":
                red = {k: legs[k] for k in ("reduce", "bias")}
                ms = sum(v["ms"] for v in red.values())
                bound_ms = sum(v["bound_ms"] for v in red.values())
                launches = red["reduce"]["launches"] + red["bias"]["launches"]
                print(f"{case} bwd reductions (dW range partials + bias grads): {ms:.4f} ms in "
                      f"{red['reduce']['launches']} + {red['bias']['launches']} launches "
                      f"({launches / legs['pe']['launches']:g} a slab), bound {bound_ms:.4f} ms "
                      f"(bytes), {100 * bound_ms / ms:.1f}% of it; torch.sum yardstick "
                      f"{sum(v['library_ms'] for v in red.values()):.4f} ms [{card}]")
        del packed, o, d, z, cot, calls
        gc.collect()
        torch.cuda.empty_cache()
    return out


# The widths whose fused backward's legs are broken down (wide_phase).
WIDE_LEG_WIDTHS = (512, 1024)


def breakdowns(card: str, device) -> dict:
    """The device times by torch.profiler that the smoke takes once other
    CUDA processes have run (a trace in a process that outlived another
    process's use of the card can lack kernels): the fused backward's legs
    (fused_legs) on the lego field and at WIDE_LEG_WIDTHS, the layer
    route's kernels at LAYER_LEG_CASES (layer_legs), the chord kernel at
    the per-rank shape (per_rank_chords_ms). {"fused": {"lego" |
    "lego_coarse" (its coarse call) | "w512" | "w1024": legs}, "layers":
    layer_legs' result, "per_rank_chords": ms}."""
    fused = {"lego": fused_legs(_lego_bf16_cfg(), card, device),
             "lego_coarse": fused_legs(_lego_bf16_cfg(), card, device, coarse=True)}
    for H in WIDE_LEG_WIDTHS:
        fused[f"w{H}"] = fused_legs(wide_cfg(H), card, device)
        gc.collect()
        torch.cuda.empty_cache()
    return {"fused": fused, "layers": layer_legs(card, device),
            "per_rank_chords": per_rank_chords_ms(device)}


def breakdowns_process(card: str) -> dict:
    """breakdowns in a process of its own (`chip_smoke.py --breakdowns`,
    its output printed here): a fresh process's traces hold every kernel,
    the smoke's own lose kernels once other CUDA processes have run
    (_traced_kernels), and a breakdown needs every kernel. After it the
    smoke's process traces nothing. Returns its result."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py"), "--breakdowns"],
                          capture_output=True, text=True, cwd=REPO, timeout=900)
    lines = proc.stdout.strip().splitlines()
    print("\n".join(lines[:-1]))
    if proc.returncode != 0:
        raise AssertionError(f"chip_smoke.py --breakdowns failed ({proc.returncode}):\n"
                             f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
    print(f"breakdowns (a process of their own): {time.perf_counter() - t0:.2f} s [{card}]")
    return json.loads(lines[-1])


# The PE kernel's checks: position bands of the lego field (8x256, dir 4
# bands) at 2048 x 192 rays, L 10 and mip-NeRF's 16 (the fused kernels
# take both, so their PE is the bitwise reference).
PE_BANDS = (10, 16)


def _layer_pe_rows(card: str, device) -> dict:
    """The layer route's PE kernel bit for bit what the fused kernels feed
    their first product, on lego fields both could take at PE_BANDS (2048
    x 192 rays): the PE the fused backward's tile kernel builds and stashes
    (the workspace's first rows, [PE(xyz) | PE(dir)]); and within the bf16
    bar of its plain version; timed (_back_to_back_ms of fl.layers_pe_cuda,
    its column table's copy to the card included) beside its bound (bytes:
    z in, each ray's o and d once, the bf16 PE out) and the plain version.
    No one PyTorch call computes it."""
    from nerfmeshes_tpu_torch.models import FlexibleNeRFModel
    from nerfmeshes_tpu_torch.ops.kernels import build
    from nerfmeshes_tpu_torch.ops.kernels import field_layers as fl
    from nerfmeshes_tpu_torch.ops.kernels import fused_mlp as fm

    rows = {}
    R, S = 2048, 192
    o, d, z = _rays(R, S, np.random.default_rng(SEED), device)
    cot = torch.zeros((4, R, S), device=device)
    lib = build.load_library()
    for L_x in PE_BANDS:
        torch.manual_seed(SEED)
        model = FlexibleNeRFModel(**dict(_FLEX, num_encoding_fn_xyz=L_x),
                                  compute_dtype=torch.bfloat16, device=device)
        packed = fm.pack_weights(model)
        del model
        spec = packed.spec
        nbytes = ctypes.c_longlong(0)
        build.check(lib, lib.nm_fused_mlp_bwd_workspace(
            packed.desc.ctypes.data, packed.desc.size, packed.freqs.ctypes.data,
            packed.freqs.size, R * S, ctypes.byref(nbytes)), "fused_mlp_bwd workspace")
        workspace = torch.zeros(nbytes.value, dtype=torch.uint8, device=device)
        dW = torch.zeros(packed.weights.shape, device=device)
        dB = torch.zeros(packed.biases.shape, device=device)
        build.check(lib, lib.nm_fused_mlp_bwd(
            o.data_ptr(), d.data_ptr(), z.data_ptr(), R, S, cot.data_ptr(),
            packed.weights.data_ptr(), packed.biases.data_ptr(), packed.desc.ctypes.data,
            packed.desc.size, packed.freqs.ctypes.data, packed.freqs.size,
            workspace.data_ptr(), nbytes.value, dW.data_ptr(), dB.data_ptr(),
            torch.cuda.current_stream().cuda_stream), "fused_mlp_bwd launch")
        cols = spec.pxp + spec.pdp
        stash = workspace[:R * S * cols * 2].view(torch.bfloat16).view(R * S, cols)
        pe_x, pe_d = fl.layers_pe_cuda(packed, o, d, z)
        torch.cuda.synchronize()
        bitwise = torch.equal(pe_x, stash[:, :spec.pxp]) and torch.equal(pe_d,
                                                                          stash[:, spec.pxp:])
        del workspace, stash, dW, dB
        want_x, want_d = fl.layers_pe_plain(packed, o, d, z)
        err = max(float((pe_x.float() - want_x.float()).abs().max()),
                  float((pe_d.float() - want_d.float()).abs().max()))
        print(f"field_layers PE at {R}x{S} (lego L {L_x}/4): bit for bit the fused backward's "
              f"stashed PE: {bitwise}; max abs err vs plain {err:.3e} (bar {ATOL}) [{card}]")
        if not bitwise or err > ATOL:
            raise AssertionError("the layer route's PE is not the fused kernels' PE")
        bound_ms, bound_by = _bound_ms(0, R * S * (4 + 2 * cols) + R * 24, PEAK_F32)
        rows[f"pe L {L_x}/4 {R}x{S}"] = dict(
            max_abs_err=err, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
            bitwise=bitwise, ms=_back_to_back_ms(lambda: fl.layers_pe_cuda(packed, o, d, z)),
            plain_ms=_median_ms(lambda: fl.layers_pe_plain(packed, o, d, z), runs=3, warmup=1))
        del packed, pe_x, pe_d, want_x, want_d
        torch.cuda.empty_cache()
    for name, row in rows.items():
        print(f"field_layers {name} (layer_pe_kernel alone): {row['ms']:.4f} ms (CUDA events, 20 "
              f"launches back to back, the table's copy included), bound {row['bound_ms']:.4f} "
              f"ms ({row['bound_by']}), {100 * row['bound_ms'] / row['ms']:.1f}% of it; plain "
              f"{row['plain_ms']:.4f} ms; library none [{card}]")
    return rows


def _layers_vs_pair(card: str, device) -> dict:
    """8x1024 at L 10/4 (a model of the layer route that the pair kernels'
    plans hold): the layer route's forward and backward at 2048 x 192 timed
    beside the pair kernels' (called directly), in turns (pair, layers,
    layers, pair; medians of 7 each), the layer route's output held to the
    pair kernels' at the forward's bar."""
    from nerfmeshes_tpu_torch.models import build_model
    from nerfmeshes_tpu_torch.ops.kernels import field_layers as fl
    from nerfmeshes_tpu_torch.ops.kernels import fused_mlp as fm
    from nerfmeshes_tpu_torch.train.system import init_params

    cfg = wide_cfg(1024)
    model = build_model(cfg.models.fine_type, dict(cfg.models.fine),
                        compute_dtype=torch.bfloat16)
    init_params(model, None, torch.Generator().manual_seed(SEED))
    model.to(device).eval()
    packed = fm.pack_weights(model)
    if any(fm.field_plan(packed.spec, k) is None for k in ("fwd", "sigma", "bwd")):
        raise AssertionError("the pair kernels' plans refuse 8x1024 at L 10/4")
    rng = np.random.default_rng(SEED)
    R, S = 2048, 192
    o, d, z = _rays(R, S, rng, device)
    cot = torch.from_numpy(rng.standard_normal((4, R, S)).astype(np.float32)).to(device)
    err = float((fl.layers_mlp_cuda(packed, o, d, z) - fm.fused_mlp_cuda(packed, o, d, z))
                .abs().max())
    if err > ATOL:
        raise AssertionError(f"layer route and pair kernels differ by {err} at 8x1024")
    calls = {"fwd": (lambda: fm.fused_mlp_cuda(packed, o, d, z),
                     lambda: fl.layers_mlp_cuda(packed, o, d, z)),
             "bwd": (lambda: fm.fused_mlp_bwd_cuda(packed, o, d, z, cot),
                     lambda: fl.layers_bwd_cuda(packed, o, d, z, cot))}
    out = {}
    for what, (pair, layers) in calls.items():
        t = [_median_ms(f) for f in (pair, layers, layers, pair)]
        out[what] = dict(pair_ms=[t[0], t[3]], layers_ms=[t[1], t[2]])
        print(f"8x1024 L 10/4 {what} at {R}x{S}: pair kernels {t[0]:.4f}, {t[3]:.4f} ms; layer "
              f"route {t[1]:.4f}, {t[2]:.4f} ms (in turns, medians of 7) [{card}]")
    print(f"8x1024 L 10/4: layer route vs pair kernels, max abs forward diff {err:.3e}")
    return out


def layers_phase(card: str, device, legs: dict) -> dict:
    """The layer route, per case of LAYER_CASES: the forward at 2048 x 64
    and 2048 x 192 (LAYER_COARSE_ONLY: x 64), the backward at the last of
    them, sigma at a 262,144-point grid tile, each against its plain
    version (forward and sigma atol = rtol = 2e-2, grads 5e-2 or the
    float64 truth), sigma bit for bit the route's forward channel 3, two
    backward calls bitwise equal, each timed beside its bound and the
    nn.Module's call; at LAYER_LEG_CASES each kernel's device time in a
    forward and a backward call beside its bound and library yardstick
    (`legs`, breakdowns_process's "layers" part). Before them the product
    kernel alone (product_phase), the backward's heads kernel, bias-grad
    reduction and dW leg and the PE kernel alone (leg_kernel_phase); then
    the chains of LAYER_CHAINS through the
    normal entry points (NeRFSystem.setup + fit, query_rays,
    export_marching_cubes), every launch the layer route's, and the layer
    route beside the pair kernels at 8x1024 L 10/4."""
    from nerfmeshes_tpu_torch.models import build_model
    from nerfmeshes_tpu_torch.ops.kernels import field_layers as fl
    from nerfmeshes_tpu_torch.ops.kernels import fused_mlp as fm
    from nerfmeshes_tpu_torch.train.render import RenderSettings, render_rays
    from nerfmeshes_tpu_torch.train.system import init_params

    out = {"cases": {}, "chains": {}, "products": product_phase(card, device),
           "leg_kernels": leg_kernel_phase(card, device)}
    for case in LAYER_CASES:
        t0 = time.perf_counter()
        cfg = layer_cfg(case)
        model = build_model(cfg.models.fine_type, dict(cfg.models.fine),
                            compute_dtype=torch.bfloat16)
        init_params(model, None, torch.Generator().manual_seed(SEED))
        model.to(device).eval()
        packed = fm.pack_weights(model)
        if not fm.supports_fused(model) or fm.field_route(packed.spec) != "layers":
            raise AssertionError(f"{case}: not a model of the layer route")
        spec = packed.spec
        print(f"{case}: {spec.num_layers}x{spec.hidden}, L {spec.L_x}/{spec.L_d}, PE "
              f"{spec.pxp} + {spec.pdp} columns; slabs of 2048x192 points: fwd "
              f"{fl.slab_points(spec, 'fwd', 2048 * 192)}, bwd "
              f"{fl.slab_points(spec, 'bwd', 2048 * 192)} (workspace bound "
              f"{fl.LAYER_WORKSPACE_BOUND / 2 ** 30:g} GiB)")
        rng = np.random.default_rng(SEED)
        R = int(cfg.nerf.train.num_random_rays)
        coarse = int(cfg.nerf.train.num_coarse)
        shapes = (coarse,) if case in LAYER_COARSE_ONLY else (
            coarse, coarse + int(cfg.nerf.train.num_fine))
        fwd = {}
        for S in shapes:
            o, d, z = _rays(R, S, rng, device)
            fwd[S] = dict(max_abs_err=_fwd_check(packed, o, d, z, spec.hidden, "layers"),
                          shape=f"{R}x{S}",
                          **_fwd_times(model, packed, o, d, z, card, "layers"))
        del model, packed
        bwd = bwd_kernel_phase(cfg, card, device, route="layers", samples=shapes[-1:])
        sigma = sigma_kernel_phase(cfg, card, device, route="layers")
        if not sigma["bitwise"]:
            raise AssertionError(f"{case}: sigma is not bit for bit the forward's channel 3")
        out["cases"][case] = dict(fwd=fwd, bwd=bwd, sigma=sigma, legs=legs.get(case, {}))
        gc.collect()
        torch.cuda.empty_cache()
        print(f"{case}: kernels {time.perf_counter() - t0:.2f} s [{card}]")

    for case, chain in LAYER_CHAINS.items():
        t0 = time.perf_counter()
        cfg = layer_cfg(case)
        train = train_phase(card, device, cfg, route="layers", steps=chain["steps"],
                            grad_rays=chain["grad_rays"])
        system = train.pop("system")
        render = slice_phase(cfg, card, device, system, route="layers") if chain["views"] \
            else None
        settings = RenderSettings.from_cfg(cfg, train=False)._replace(use_fused_kernel=False)

        def module_rgb(o, d, near, far, system=system, settings=settings):
            return render_rays(system.coarse, system.fine, o, d, near, far, settings,
                               train=False)[1].rgb_map

        mesh = export_and_check(system, card, f"{case} mesh", fwd_per_chunk=2,
                                chords_per_chunk=0, module_rgb=module_rgb, res=chain["res"],
                                route="layers")
        del system, module_rgb
        gc.collect()
        torch.cuda.empty_cache()
        print(f"{case} chain: {time.perf_counter() - t0:.2f} s [{card}]")
        out["chains"][case] = dict(train=train, render=render, mesh=mesh)
    out["vs_pair"] = _layers_vs_pair(card, device)
    return out


def slice_phase(cfg, card: str, device, system=None, route: str = "fused") -> dict:
    """Two full views through NeRFSystem.query_rays with the kernel on: of
    `system`, or of a fresh one with the config's random weights; the
    route's forward launches counted."""
    from nerfmeshes_tpu_torch.data.blender_poses import read_blender_poses
    from nerfmeshes_tpu_torch.ops.kernels import fused_mlp as fm
    from nerfmeshes_tpu_torch.train.render import RenderSettings, render_rays
    from nerfmeshes_tpu_torch.train.step import make_pose_rays
    from nerfmeshes_tpu_torch.train.system import NeRFSystem

    if system is None:
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
    counts = _route(route)[0]
    _zero_field_counts()
    t0 = time.perf_counter()
    outs = []
    for v in range(views):
        o, d = pose_rays(poses[v])
        outs.append(system.query_rays(o, d, near, far, fields=fields, as_numpy=False))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = counts.launches
    if route == "layers" and fm.launches:
        raise AssertionError(f"{fm.launches} fused forward launches on the layer route")
    if route == "layers":
        _hold_layer_counts(f"render ({views} views)", card)

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

    # One chunk through the nn.Module path (bf16 layers, no kernel); of a
    # chunk over CHECK_RAYS, its first CHECK_RAYS rays (the module's f32
    # activations of 65,536 x 192 points at 512 wide outgrow the card).
    settings = RenderSettings.from_cfg(cfg, train=False)
    n_check = min(chunk, CHECK_RAYS)
    with torch.inference_mode():
        fused = render_rays(system.coarse, system.fine, o0[:n_check], d0[:n_check], near, far,
                            settings, train=False)[1]
        plain = render_rays(system.coarse, system.fine, o0[:n_check], d0[:n_check], near, far,
                            settings._replace(use_fused_kernel=False), train=False)[1]
    diff = float((fused.rgb_map - plain.rgb_map).abs().max())
    print(f"render chunk, fused kernel vs nn.Module path on {n_check} rays: max abs rgb diff "
          f"{diff:.3e} (bar {ATOL})")
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


def _truth_grads(packed, o, d, z, cot) -> tuple[torch.Tensor, torch.Tensor]:
    """Float64 grads of sum(field * cot) in the packed layout: the field of
    the packed weights in float64 with no bf16 rounding, through autograd,
    summed over chunks of at most 16,384 points (as the GPU tests'
    _truth_grads)."""
    from nerfmeshes_tpu_torch.ops.kernels import fused_mlp as fm

    spec = packed.spec
    H, L = spec.hidden, spec.num_layers
    w = packed.weights.double().requires_grad_()
    b = packed.biases.double().requires_grad_()
    R, S = z.shape
    step = max(1, 16384 // S)

    def layer(g, a, n):
        wg, bg = packed.gemm(g, n, a.shape[1], w, b)
        return torch.nn.functional.linear(a, wg, bg)

    for r0 in range(0, R, step):
        rays = slice(r0, r0 + step)
        oo, dd, zz = o[rays].double(), d[rays].double(), z[rays].double()
        pts = (oo[:, None, :] + dd[:, None, :] * zz[..., None]).reshape(-1, 3)
        dirs = dd[:, None, :].expand(zz.shape[0], S, 3).reshape(-1, 3)
        pe_x = fm._padded_pe(pts, spec.L_x, spec.include_x, spec.log_x, spec.pxp)
        pe_d = fm._padded_pe(dirs, spec.L_d, spec.include_d, spec.log_d, spec.pdp)
        x = layer(0, pe_x, H)
        for i in range(L - 1):
            x = torch.relu(layer(1 + i, torch.cat([x, pe_x], 1) if i in spec.skip_layers
                                 else x, H))
        wa, ba, wr, br = packed.heads(w, b)
        alpha = torch.nn.functional.linear(x, wa, ba)
        feat = torch.relu(layer(L, x, H))
        h = torch.relu(layer(L + 1, torch.cat([feat, pe_d], 1), H // 2))
        rgb = torch.sigmoid(torch.nn.functional.linear(h, wr, br))
        out = torch.cat([rgb, alpha], 1).t()
        (out * cot[:, rays].reshape(4, -1).double()).sum().backward()
    return w.grad.float(), b.grad.float()


def bwd_kernel_phase(cfg, card: str, device, time_fine: bool = True, route: str = "fused",
                     samples: tuple | None = None) -> dict:
    """The route's backward against its plain version at the train path's
    coarse (S=64) and fine (S=192) shapes (or `samples`), R = 2048 rays,
    the config's fine field, a seeded normal cotangent; two launches
    bitwise equal. Timed at the fine shape (the last of `samples`), or with
    time_fine False at the coarse one. On the layer route a worst relative
    error past the bar is judged, as the GPU tests' _hold_layer_grads, by a
    float64 truth: no worse than twice the plain version's."""
    from nerfmeshes_tpu_torch.models import build_model
    from nerfmeshes_tpu_torch.ops.kernels import fused_mlp as fm
    from nerfmeshes_tpu_torch.train.system import init_params

    counts, _, bwd, _, prefix = _route(route)
    model = build_model(cfg.models.fine_type, dict(cfg.models.fine),
                        compute_dtype=torch.bfloat16)
    init_params(model, None, torch.Generator().manual_seed(SEED))
    model.to(device)
    packed = fm.pack_weights(model)
    rng = np.random.default_rng(SEED)
    R = int(cfg.nerf.train.num_random_rays)
    worst_rel = worst_abs = 0.0
    timed = None
    if samples is None:
        samples = (int(cfg.nerf.train.num_coarse),
                   int(cfg.nerf.train.num_coarse) + int(cfg.nerf.train.num_fine))
    for S in samples:
        o, d, z = _rays(R, S, rng, device)
        cot = torch.from_numpy(rng.standard_normal((4, R, S)).astype(np.float32)).to(device)
        if timed is None or time_fine:
            timed = (S, o, d, z, cot)
        before = counts.bwd_launches
        got = bwd(packed, o, d, z, cot)
        again = bwd(packed, o, d, z, cot)
        torch.cuda.synchronize()
        if counts.bwd_launches != before + 2:
            raise AssertionError(f"bwd launch counter moved {counts.bwd_launches - before}, "
                                 "expected 2")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"two backward launches differ at S={S}")
        want = fm.fused_mlp_bwd_plain(packed, o, d, z, cot)
        if not all(bool(torch.isfinite(g).all()) for g in got):
            raise AssertionError(f"non-finite grads from the backward kernel at S={S}")
        rel = _rel_errors(packed, got, want)
        name = max(rel, key=rel.get)
        abs_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        print(f"{prefix}_bwd H={model.hidden_size} R={R} S={S}: worst rel grad err "
              f"{rel[name]:.3e} ({name}), max abs err {abs_err:.3e} (bar rel {GRAD_BAR}); "
              "2 launches bitwise equal")
        if rel[name] >= GRAD_BAR and route == "layers":
            truth = _truth_grads(packed, o, d, z, cot)
            err_kernel = max(_rel_errors(packed, got, truth).values())
            err_plain = max(_rel_errors(packed, want, truth).values())
            print(f"{prefix}_bwd H={model.hidden_size} S={S}: against a float64 truth, kernel "
                  f"{err_kernel:.3e}, plain {err_plain:.3e} (bar: under twice plain's or "
                  f"{GRAD_BAR})")
            if err_kernel >= max(2.0 * err_plain, GRAD_BAR):
                raise AssertionError(f"backward disagrees with the float64 truth at S={S}")
        elif rel[name] >= GRAD_BAR:
            raise AssertionError(f"backward kernel disagrees with the plain version at S={S}")
        worst_rel = max(worst_rel, rel[name])
        worst_abs = max(worst_abs, abs_err)

    # Times at the fine shape (the last one checked above), or the coarse.
    S, o, d, z, cot = timed
    ms = _median_ms(lambda: bwd(packed, o, d, z, cot))
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

    plain_ms, module_ms, library_ms = _yardsticks(
        route, lambda: fm.fused_mlp_bwd_plain(packed, o, d, z, cot), module_grads,
        _autocast(module_grads))
    for p in model.parameters():
        p.grad = None
    n_pts, n_w = R * S, packed.weights.numel()
    bound_ms, bound_by = _bwd_bound(model, packed, R, S)
    for name, t in (("kernel", ms), ("plain", plain_ms), ("nn.Module + autograd", module_ms),
                    ("nn.Module + autograd, bf16 autocast", library_ms), ("bound", bound_ms)):
        rate = "" if t is None else f", {n_pts / t * 1e3:.4e} points/s"
        print(f"{prefix}_bwd {name}: {_ms_text(t)}{rate} "
              f"at {R}x{S} points, H={model.hidden_size} [{card}]")
    _rate(f"{prefix}_bwd", ms, 3 * _field_flops(model) * n_pts, bound_ms, bound_by,
          f"{R}x{S}, H={model.hidden_size}", card)

    return dict(max_abs_err=worst_abs, max_rel_err=worst_rel, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by, shape=f"{R}x{S}")


def _bwd_leg_bounds(model, packed, R: int, S: int) -> dict:
    """The fused backward's legs' bounds (_bound_ms) at R x S points under
    the stash design. The transpose: the x parts of the dX chain's
    matrices read and written. The tile kernel: the recomputed forward and
    the dX chain; rays, the cotangent and the weights read, the stash and
    the bias partials written. The dW leg: the dW products; the stash
    read, the grads written."""
    H, L = model.hidden_size, model.num_layers
    n_pts, n_w = R * S, packed.weights.numel()
    stash = _stash_bytes(packed, n_pts)
    wt_bytes = 2 * (L + 1) * H * H
    db_rows = 2 * (-(-n_pts // 128))
    return {
        "transpose": _bound_ms(0.0, 2 * wt_bytes, PEAK_BF16),
        "tile": _bound_ms((_field_flops(model) + _dx_flops(model)) * n_pts,
                          R * 24 + n_pts * 20 + n_w * 2 + wt_bytes + stash
                          + db_rows * packed.biases.numel() * 4, PEAK_BF16),
        "dw": _bound_ms(_field_flops(model) * n_pts,
                        stash + (n_w + packed.biases.numel()) * 4, PEAK_BF16),
    }


def fused_legs(cfg, card: str, device, coarse: bool = False) -> dict:
    """The fused backward's legs, by kernel name from torch.profiler (7
    calls, _device_ms_by_group), at bwd_kernel_phase's fine shape (or with
    `coarse` its coarse one) on the config's fine field (weights from SEED,
    the same seeded rays and cotangent), each beside its bound
    (_bwd_leg_bounds) and, for the dW leg, its library yardstick: {leg:
    {ms, bound_ms, bound_by, library_ms}}."""
    from nerfmeshes_tpu_torch.models import build_model
    from nerfmeshes_tpu_torch.ops.kernels import fused_mlp as fm
    from nerfmeshes_tpu_torch.train.system import init_params

    model = build_model(cfg.models.fine_type, dict(cfg.models.fine),
                        compute_dtype=torch.bfloat16)
    init_params(model, None, torch.Generator().manual_seed(SEED))
    model.to(device)
    packed = fm.pack_weights(model)
    rng = np.random.default_rng(SEED)
    R, S0 = int(cfg.nerf.train.num_random_rays), int(cfg.nerf.train.num_coarse)
    draws = []
    for S in (S0, S0 + int(cfg.nerf.train.num_fine)):  # bwd_kernel_phase's draws
        o, d, z = _rays(R, S, rng, device)
        cot = torch.from_numpy(rng.standard_normal((4, R, S)).astype(np.float32)).to(device)
        draws.append((o, d, z, cot))
    args = draws[0 if coarse else -1]
    S = args[2].shape[1]
    shape = f"{R}x{S}"
    leg_bounds = _bwd_leg_bounds(model, packed, R, S)
    legs = _device_ms_by_group(lambda: fm.fused_mlp_bwd_cuda(packed, *args), BWD_LEGS)
    library = {leg: None for leg in legs}
    library["dw"] = _dw_library_ms(packed.spec, args[2].numel(), args[2].device)
    for leg, t in legs.items():
        b, by = leg_bounds[leg]
        lib = ("none: no one PyTorch call" if library[leg] is None else
               f"{library[leg]:.4f} ms (torch.mm per product, median of 7, summed)")
        print(f"fused_mlp_bwd H={model.hidden_size} leg {leg} ({' + '.join(BWD_LEGS[leg])}): "
              f"{t:.4f} ms of device "
              f"time per call (torch.profiler, mean over 7 calls) at {shape}, bound {b:.4f} ms "
              f"({by}), {100.0 * b / t:.1f}% of the bound; library {lib} [{card}]")
    return {leg: dict(ms=t, bound_ms=leg_bounds[leg][0], bound_by=leg_bounds[leg][1],
                      library_ms=library[leg]) for leg, t in legs.items()}


def train_phase(card: str, device, cfg=None, route: str = "fused",
                steps: int = TRAIN_STEPS, grad_rays: int | None = None) -> dict:
    """The train path: NeRFSystem.setup + fit at the hard-blender settings,
    or at `cfg`'s, `steps` timed steps through the route's kernels (on the
    layer route none of the fused kernels', and its kernels' launches a
    step printed); one step's grads against the nn.Module path's on a batch
    of the config's rays, or of `grad_rays` (the module's autograd at 2048
    wide holds ~64 GB for 2048 rays)."""
    from nerfmeshes_tpu_torch.ops.kernels import field_layers as fl
    from nerfmeshes_tpu_torch.data.blender import train_arrays
    from nerfmeshes_tpu_torch.ops.kernels import fused_mlp as fm
    from nerfmeshes_tpu_torch.train.render import RenderSettings
    from nerfmeshes_tpu_torch.train.step import _sample_ray_batch, train_loss
    from nerfmeshes_tpu_torch.train.system import NeRFSystem

    class RecordingSystem(NeRFSystem):
        """Keeps every step's loss on the device (steps_per_call is 1)."""

        def on_step(self, step, metrics):
            self.losses.append(metrics["train/loss"])

    cfg = hard_blender_cfg() if cfg is None else cfg
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
    counts = _route(route)[0]
    _zero_field_counts()
    t0 = time.perf_counter()
    metrics = system.fit(WARMUP_STEPS + steps)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    fwd, bwd = counts.launches, counts.bwd_launches
    others = (fm.launches + fm.bwd_launches if route == "layers"
              else fl.launches + fl.bwd_launches)
    per_kernel = dict(fl.kernel_launches)
    losses = torch.stack(system.losses).cpu().tolist()  # the one fetch of the run

    if system.state.step != WARMUP_STEPS + steps or len(losses) != steps:
        raise AssertionError(f"step {system.state.step}, {len(losses)} losses recorded")
    if fwd != 2 * steps or bwd != 2 * steps or others:
        raise AssertionError(f"{fwd} forward and {bwd} backward launches for "
                             f"{steps} steps; expected 2 each per step (and {others} of "
                             "the other route's, expected 0)")
    if route == "layers":
        _hold_layer_counts(f"train ({steps} steps)", card)
        print(f"train {route} kernels a step: "
              + ", ".join(f"{k} {v / steps:g}" for k, v in per_kernel.items()))
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
                              num_rays=grad_rays or int(cfg.nerf.train.num_random_rays),
                              use_ndc=False)
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

    rays_per_s = steps * int(cfg.nerf.train.num_random_rays) / seconds
    print(f"train: {steps} steps of {cfg.nerf.train.num_random_rays} rays in "
          f"{seconds:.4f} s, {fwd} forward + {bwd} backward {route} launches "
          f"(2 + 2 per step), {rays_per_s:.6e} rays/s [{card}]")
    return dict(fwd_launches=fwd, bwd_launches=bwd, rays_per_s=rays_per_s, seconds=seconds,
                grad_rel_err=rel[name], system=system, kernel_launches=per_kernel)


def sigma_kernel_phase(cfg, card: str, device, route: str = "fused") -> dict:
    """The route's sigma against its plain version and against the route's
    forward's channel 3, on the config's fine model, at one grid tile of
    the 480^3 mesh grid (limit 1.2) and at random points."""
    from nerfmeshes_tpu_torch.mesh.extract import grid_points
    from nerfmeshes_tpu_torch.models import build_model
    from nerfmeshes_tpu_torch.ops.kernels import fused_mlp as fm
    from nerfmeshes_tpu_torch.train.system import init_params

    counts, fwd, _, sigma_fn, prefix = _route(route)

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
    worst, bitwise = 0.0, True
    for name, pts in sets.items():
        before = counts.sigma_launches
        got = sigma_fn(packed, pts)
        torch.cuda.synchronize()
        if counts.sigma_launches != before + 1:
            raise AssertionError(f"sigma launch counter moved {counts.sigma_launches - before}, "
                                 "expected 1")
        if got.shape != (GRID_TILE,) or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"sigma kernel output shape {tuple(got.shape)} or non-finite")
        ref = fm.fused_sigma_plain(packed, pts)
        err = float((got - ref).abs().max())
        zeros = torch.zeros_like(pts)
        full = fwd(packed, pts, zeros, zeros[:, :1])[3, :, 0]
        err_fwd = float((got - full).abs().max())
        print(f"{prefix}_sigma {name}, {GRID_TILE} points: max abs err vs plain {err:.3e} "
              f"(bar atol=rtol={ATOL}); vs forward kernel channel 3 {err_fwd:.3e} "
              f"(bar {SIGMA_FWD_BAR}; bitwise equal: {bool(torch.equal(got, full))})")
        if not torch.allclose(got, ref, atol=ATOL, rtol=RTOL):
            raise AssertionError(f"sigma kernel disagrees with the plain version ({name})")
        if err_fwd > SIGMA_FWD_BAR:
            raise AssertionError(f"sigma kernel disagrees with forward channel 3 ({name})")
        worst = max(worst, err)
        bitwise = bitwise and bool(torch.equal(got, full))

    pts = sets["grid tile"]
    ms = _median_ms(lambda: sigma_fn(packed, pts))
    # Library yardstick: the nn.Module at the same points under bf16
    # autocast, beside the module as it is (all four channels: no PyTorch
    # call computes sigma alone).
    zeros = torch.zeros_like(pts)
    with torch.inference_mode():
        plain_ms, module_ms, library_ms = _yardsticks(
            route, lambda: fm.fused_sigma_plain(packed, pts), lambda: model(pts, zeros),
            _autocast(lambda: model(pts, zeros)))
    nbytes = GRID_TILE * 16 + packed.weights.numel() * 2 + packed.biases.numel() * 4
    bound_ms, bound_by = _bound_ms(_field_flops(model, heads=False) * GRID_TILE, nbytes,
                                   PEAK_BF16)
    for name, t in (("kernel", ms), ("plain", plain_ms), ("nn.Module", module_ms),
                    ("nn.Module bf16 autocast", library_ms), ("bound", bound_ms)):
        rate = "" if t is None else f", {GRID_TILE / t * 1e3:.4e} points/s"
        print(f"{prefix}_sigma {name}: {_ms_text(t)}{rate} "
              f"at {GRID_TILE} points, H={model.hidden_size} [{card}]")
    _rate(f"{prefix}_sigma", ms, _field_flops(model, heads=False) * GRID_TILE, bound_ms,
          bound_by, f"{GRID_TILE} points, H={model.hidden_size}", card)
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by, bitwise=bitwise)


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
                     chords_per_chunk: int, module_rgb, res: int = MESH_RES,
                     route: str = "fused") -> dict:
    """Mesh `system` at res^3 with the mesh CLI's defaults and check
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

    counts = _route(route)[0]
    with tempfile.TemporaryDirectory() as tmp:
        args = _mesh_args(tmp, res)
        torch.cuda.synchronize()
        _zero_field_counts()
        ch.launches = 0
        t0 = time.perf_counter()
        verts, tris, colors, normals = export_marching_cubes(system, args)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        fwd, sigma, chords = counts.launches, counts.sigma_launches, ch.launches
        if route == "layers" and fm.launches + fm.sigma_launches:
            raise AssertionError(f"{label}: fused launches on the layer route")
        if route == "layers":
            _hold_layer_counts(label, card)
        timings = dict(LAST_TIMINGS)
        ply = read_ply_binary(str(Path(tmp) / args.mesh_name))

    n_v, n_t = len(verts), len(tris)
    tiles = math.ceil(res ** 3 / GRID_TILE)
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
    print(f"{label} {res}^3: {n_v} vertices, {n_t} triangles; iso "
          f"{timings['iso_effective']:.6g} (requested {timings['iso_requested']:g}); "
          f"blocks fetched {timings['sparse_blocks_fetched']} of "
          f"{timings['sparse_blocks_total']} ({timings['transfer_packed_mb']:.3f} MB)"
          + ("" if masked is None else f", {masked} outside the tree")
          + f"; {sigma} sigma launches ({GRID_TILE} points per tile), {fwd} forward and "
          f"{chords} chord launches ({chunks} chunks of {args.batch_size} rays) [{card}]")
    print(f"{label} phases (s): " + ", ".join(f"{k} {v:.4f}" for k, v in phases.items())
          + f"; total {seconds:.4f} s; grid "
          f"{res ** 3 / timings['grid_eval_device_s']:.4e} points/s [{card}]")
    return dict(fwd_launches=fwd, sigma_launches=sigma, chords_launches=chords, vertices=n_v,
                triangles=n_t, seconds=seconds, **phases)


def _chord_bound(R: int, V: int, active: int, K: int) -> tuple[float, str]:
    """The chord kernel's least time: a slab test of CHORD_TEST_OPS f32
    operations for each ray and active voxel (an inactive one needs none)
    at the f32 peak, against its bytes (voxels and activity read once,
    origins and directions read, four outputs written; scalar bounds)."""
    nbytes = V * 25 + R * 24 + R * K * 12 + R * 4
    return _bound_ms(float(R) * active * CHORD_TEST_OPS, nbytes, PEAK_F32)


def _chord_inputs(device) -> dict:
    """The chord phase's inputs, made from SEED: the initial 12^3 tree of
    configs/buff-hard-250k.yml padded to capacity 4096 (1728 active), a
    tree after one consolidation of a seeded memm, 2048 camera rays with
    per-ray bounds, 2048 axis-aligned rays, the 65536-ray appearance chunk,
    the consolidated tree with 10% of its voxels active, and a table of
    20,000 random boxes (past one shared-memory stage of the kernel)."""
    from nerfmeshes_tpu_torch.buff.tree import TreeSampling

    cfg = buff_hard_cfg()
    tree = TreeSampling(cfg)
    initial = tree.device_state(device)
    rng = np.random.default_rng(SEED)
    memm = rng.uniform(0.0, 1.0, tree.capacity).astype(np.float32)
    memm[rng.uniform(size=tree.capacity) < 0.2] = 0.0
    grown = tree.consolidate(memm, device)
    R = int(cfg.nerf.train.num_random_rays)
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
    sparse = grown.active & torch.from_numpy(rng.uniform(size=tree.capacity) < 0.1).to(device)
    lo = rng.uniform(-2.0, 2.0, (20000, 3)).astype(np.float32)
    boxes = np.stack([lo, lo + rng.uniform(0.02, 0.3, (20000, 3)).astype(np.float32)], axis=1)
    large = (torch.from_numpy(boxes).to(device),
             torch.from_numpy(rng.uniform(size=20000) < 0.6).to(device))
    return dict(initial=initial, grown=grown, o=o, d=d, near=near, far=far,
                o_axis=o_axis, d_axis=d_axis, o_app=o_app, d_app=d_app, sparse=sparse,
                large=large)


def chord_timed_cases(inputs: dict) -> dict:
    """name -> (voxels, active, origins, dirs, near, far) of the chord
    kernel's timed reads: the train step's 2048 rays on the consolidated
    tree (4095 active) and on the initial one (1728 of 4096 active), and
    the 65536-ray appearance chunk on the consolidated tree."""
    grown, initial = inputs["grown"], inputs["initial"]
    o, d = inputs["o"], inputs["d"]
    return {"train": (grown.voxels, grown.active, o, d, 2.0, 6.0),
            "initial": (initial.voxels, initial.active, o, d, 2.0, 6.0),
            "chunk": (grown.voxels, grown.active, inputs["o_app"], inputs["d_app"], 0.0, 4.0)}


def chords_kernel_phase(card: str, device) -> dict:
    """The chord kernel against compact_chords_plain on the card, bit for
    bit (torch.equal on all four outputs), at the BuFF paths' shapes: 2048
    camera rays against the initial 12^3 tree padded to capacity 4096 (K
    64), a tree after one consolidation of a seeded memm, per-ray bounds,
    axis-aligned rays from the grid's face planes, a binding cap (K 8), the
    65536-ray appearance chunk, a sparse active set and a table larger than
    one shared-memory stage. Then both are timed at 2048 x 4096 x 64 on the
    consolidated and the initial tree, and at 65536 x 4096 x 64."""
    from nerfmeshes_tpu_torch.ops.kernels import chords as ch

    inputs = _chord_inputs(device)
    initial, grown = inputs["initial"], inputs["grown"]
    o, d, o_app, d_app = inputs["o"], inputs["d"], inputs["o_app"], inputs["d_app"]
    K = 64
    cases = {
        "initial tree": (initial.voxels, initial.active, o, d, 2.0, 6.0, K),
        "consolidated tree": (grown.voxels, grown.active, o, d, 2.0, 6.0, K),
        "per-ray near/far": (grown.voxels, grown.active, o, d, inputs["near"], inputs["far"], K),
        "axis-aligned rays": (initial.voxels, initial.active, inputs["o_axis"], inputs["d_axis"],
                              2.0, 6.0, K),
        "binding cap": (grown.voxels, grown.active, o, d, 2.0, 6.0, 8),
        "appearance chunk": (grown.voxels, grown.active, o_app, d_app, 0.0, 4.0, K),
        "sparse active": (grown.voxels, inputs["sparse"], o, d, 2.0, 6.0, K),
        "large table": (*inputs["large"], o, d, 2.0, 6.0, K),
    }
    for name, (*args, k) in cases.items():
        voxels, active, dd = args[0], args[1], args[3]
        before = ch.launches
        got = ch.compact_chords_cuda(*args, K=k)
        torch.cuda.synchronize()
        if ch.launches != before + 1:
            raise AssertionError(f"chord launch counter moved {ch.launches - before}, expected 1")
        want = ch.compact_chords_plain(*args, K=k)
        equal = [torch.equal(g, w) for g, w in zip(got, want)]
        n_hit = got.n_hit.float()
        print(f"fused_chords {name}: R={dd.shape[0]} V={voxels.shape[0]} "
              f"({int(active.sum())} active) K={k}: bitwise equal "
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
    for name, args in chord_timed_cases(inputs).items():
        voxels, active, rays = args[0], args[1], args[3].shape[0]
        V, n_active = voxels.shape[0], int(active.sum())
        ms = _kernel_device_ms(lambda: ch.compact_chords_cuda(*args, K=K), "chords_kernel")
        b2b_ms = _back_to_back_ms(lambda: ch.compact_chords_cuda(*args, K=K))
        call_ms = _median_ms(lambda: ch.compact_chords_cuda(*args, K=K))
        plain_ms = _median_ms(lambda: ch.compact_chords_plain(*args, K=K))
        bound_ms, bound_by = _chord_bound(rays, V, n_active, K)
        print(f"fused_chords {rays}x{V}x{K} ({n_active} active): kernel {ms:.4f} ms on the "
              f"device (torch.profiler), {b2b_ms:.4f} ms a launch of 20 back to back, "
              f"{call_ms:.4f} ms per call with its enqueue, plain {plain_ms:.4f} ms (CUDA events; "
              f"medians of 7), bound {bound_ms * 1e3:.3f} us ({bound_by}, "
              f"{100.0 * bound_ms / ms:.1f}% of the kernel's time); "
              f"{rays * n_active / ms * 1e3:.4e} tests/s; no single PyTorch call computes it "
              f"[{card}]")
        times[name] = dict(ms=ms, b2b_ms=b2b_ms, call_ms=call_ms, plain_ms=plain_ms,
                           bound_ms=bound_ms, bound_by=bound_by)
    print(f"fused_chords bound: {CHORD_TEST_OPS} f32 operations a test at {PEAK_F32 / 1e12:.0f} "
          f"TFLOP/s, a rate that counts a fused multiply-add as two; the slab test cannot fuse "
          f"and keep its bits, so a test of ~24 issued instructions at the full issue rate "
          f"would read ~75% of this bound")
    return dict(max_abs_err=0.0, bitwise_equal=True, **times["train"],
                chunk_ms=times["chunk"]["ms"], chunk_b2b_ms=times["chunk"]["b2b_ms"],
                chunk_plain_ms=times["chunk"]["plain_ms"],
                chunk_bound_ms=times["chunk"]["bound_ms"], initial_ms=times["initial"]["ms"],
                initial_b2b_ms=times["initial"]["b2b_ms"],
                initial_bound_ms=times["initial"]["bound_ms"])


def _buff_system(device, cfg=None):
    """The smoke's BuFF system (at `cfg`, default buff_hard_cfg()), recording
    each call's loss and dropped chords on the device, and the tree before
    each consolidation."""
    from nerfmeshes_tpu_torch.buff.system import BuFFSystem

    class RecordingBuFF(BuFFSystem):
        def on_step(self, step, metrics):
            self.losses.append(metrics["train/loss"])
            self.dropped.append(metrics["train/dropped_chords"])
            before = self.tree_state
            super().on_step(step, metrics)
            if self.tree_state is not before:
                self.replaced[step] = before

    system = RecordingBuFF(cfg if cfg is not None else buff_hard_cfg(), device=device)
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


# The CLI phases: the shipped configs through train -> resume -> eval ->
# mesh, each CLI's main(argv) called in-process so that every kernel's
# launches can be read per leg. (config, first train_iters, resumed
# train_iters, the first leg's overrides.)
CLI_RUN = ("hard-blender.yml", 500, 1000,
           ["experiment.validate_every", "250"])
BUFF_CLI_RUN = ("buff-hard-250k.yml", 400, 600,
                ["experiment.validate_every", "200", "tree.step_size_integration_offset", "100",
                 "tree.step_size_tree", "100"])
LLFF_CLI_RUN = ("hard-llff.yml", 500, 1000, ["experiment.validate_every", "250"])
# hard-blender.yml's 2 x 8x256 fields on ScanNet's camera layout: the
# data/hard_scannet stream (1296x968 JPEG frames, +z rays from an
# off-centre principal point, unnormalised directions).
SCANNET = REPO / "data" / "hard_scannet"
SCANNET_CLI_RUN = ("hard-blender.yml", 500, 1000,
                   ["experiment.validate_every", "250", "dataset.type", "scannet"])
# hard-blender.yml with a zoo coarse model and AdamW: the coarse model a
# SpecularSimpleModel at its class defaults (the reference's widths; the
# config's coarse keys, and the schema's num_layers_view -1, set to them),
# its (field, specular) output through the render from the first step;
# the fine model the config's 8x256 FlexibleNeRF through the fused kernels.
ZOO_COARSE = {"num_layers": 4, "num_layers_view": 2, "hidden_size": 128, "skip_step": 1,
              "num_encoding_fn_xyz": 128, "num_encoding_fn_dir": 4}
ZOO_CLI_RUN = ("hard-blender.yml", 500, 1000,
               ["experiment.validate_every", "250", "models.coarse_type", "SpecularSimpleModel",
                "optimizer.type", "AdamW",
                *(x for k, v in ZOO_COARSE.items() for x in (f"models.coarse.{k}", str(v)))])
ZOO_COARSE_PARAMS = 435_717  # SpecularSimpleModel at its class defaults
CLI_RUNS = {"cli": CLI_RUN, "buff_cli": BUFF_CLI_RUN, "llff_cli": LLFF_CLI_RUN,
            "scannet_cli": SCANNET_CLI_RUN, "zoo_cli": ZOO_CLI_RUN}
# The surface-ray leg of the hierarchical chain: the CLI's 8 x 4 orbit of
# 400^2 views at the run's own focal (--focal 0).
SURFACE_VIEWS, SURFACE_SIZE = 8 * 4, 400
KERNELS = ("fwd", "bwd", "sigma", "chords")


def _launch_counts() -> dict:
    from nerfmeshes_tpu_torch.ops.kernels import chords as ch
    from nerfmeshes_tpu_torch.ops.kernels import fused_mlp as fm

    return {"fwd": fm.launches, "bwd": fm.bwd_launches, "sigma": fm.sigma_launches,
            "chords": ch.launches}


def _leg(fn):
    """(fn(), seconds, launches of each kernel) of one CLI leg, the counts
    set to 0 just before it and read just after, synchronised."""
    from nerfmeshes_tpu_torch.ops.kernels import chords as ch
    from nerfmeshes_tpu_torch.ops.kernels import fused_mlp as fm

    torch.cuda.synchronize()
    fm.launches = fm.bwd_launches = fm.sigma_launches = ch.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, _launch_counts()


def _checked_legs(name: str, out: dict, card: str):
    """leg(label, fn, want): fn() as one leg (_leg), printed with its
    seconds and launches, which must equal `want` (absent kernels: 0);
    recorded in out["legs"]. Returns fn()'s result."""
    def leg(label, fn, want):
        result, seconds, got = _leg(fn)
        want = {k: want.get(k, 0) for k in KERNELS}
        print(f"{name} {label}: {seconds:.4f} s; launches {got} (predicted {want}) [{card}]")
        if got != want:
            raise AssertionError(f"{name} {label}: launches {got}, predicted {want}")
        out["legs"][label] = dict(seconds=seconds, launches=got)
        return result

    return leg


def _state_equal(a, b) -> bool:
    """Nested checkpoint states equal bit for bit (tensors on any device)."""
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a.cpu(), b.cpu()))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_state_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_state_equal(x, y) for x, y in zip(a, b))
    return a == b


def _validations(cfg, start: int, stop: int) -> int:
    """Validations fit makes from step `start` to `stop` (NeRFSystem.fit's
    cadence)."""
    spc, every = int(cfg.experiment.steps_per_call), int(cfg.experiment.validate_every)
    return sum(1 for step in range(start + spc, stop + 1, spc)
               if step % every < spc or step >= stop)


def cli_chain(name: str, card: str) -> dict:
    """One shipped config through the CLIs at its full width, on the card
    (the CLIs' default), into a temporary logdir: train_nerf to the first
    step count (validating and checkpointing); the run's datasets, a fresh
    system restored from the run (its state equal to the trained one bit
    for bit), a validation at the last step (the run's logged
    validation/loss bit for bit) and a save, each a leg of its own;
    train_nerf resumed with --log-checkpoint to the second step count,
    eval_nerf on the test split and mesh_nerf at MESH_RES^3 (not for the
    forward-facing llff_cli: JAX meshes no NDC field either); for the
    hierarchical chain, surface_ray's point cloud of the run. Each leg's
    kernel launches equal the counts the code predicts; at most 3 numbered
    checkpoints stay beside `last`; the validation loss is finite and
    falls; the mesh and the point cloud are not empty."""
    import tempfile

    from nerfmeshes_tpu_torch.cli import eval_nerf, mesh_nerf, train_nerf
    from nerfmeshes_tpu_torch.config import load_config
    from nerfmeshes_tpu_torch.config.paths import load_hparams, resolve_paths
    from nerfmeshes_tpu_torch.data.datasets import DatasetType, build_dataset
    from nerfmeshes_tpu_torch.train.factory import build_system

    config, first, second, overrides = CLI_RUNS[name]
    buff = name == "buff_cli"
    llff = name == "llff_cli"
    scannet = name == "scannet_cli"
    zoo = name == "zoo_cli"
    # Forward launches per render chunk and backward launches per step: one
    # field through the kernels in BuFF and the zoo chain (its coarse model
    # runs as the nn.Module), two elsewhere.
    per_chunk = 1 if buff or zoo else 2
    out = {"legs": {}}
    leg = _checked_legs(name, out, card)

    from nerfmeshes_tpu_torch.buff.system import BuFFSystem
    from nerfmeshes_tpu_torch.utils.tb_events import EventWriter

    with (tempfile.TemporaryDirectory() as tmp,
          _CallTimer(EventWriter, EVENT_WRITES) as writes,
          _CallTimer(BuFFSystem, ("_log_tree",), sync=True) as trees):
        opts = ["experiment.logdir", tmp, *overrides]
        if scannet:
            opts += ["dataset.basedir", str(SCANNET / "scene.sens")]
        elif not buff:
            scene = "hard_llff" if llff else "hard_blender"
            opts += ["dataset.basedir", str(REPO / "data" / scene)]
        cfg = load_config(str(REPO / "configs" / config), opts)
        val_views = int(cfg.nerf.validation.num_samples)
        chunk = int(cfg.nerf.validation.chunksize)

        def render_launches(views: int, H: int, W: int) -> dict:
            chunks = views * math.ceil(H * W / chunk)
            return {"fwd": per_chunk * chunks, "chords": chunks if buff else 0}

        def train_launches(start: int, stop: int, H: int, W: int) -> dict:
            steps = stop - start
            val = render_launches(_validations(cfg, start, stop) * val_views, H, W)
            return {"fwd": per_chunk * steps + val["fwd"], "bwd": per_chunk * steps,
                    "chords": (steps + val["chords"]) if buff else 0}

        if buff:
            syn = cfg.dataset.synthetic
            val_hw = test_hw = (int(syn.image_size),) * 2
            test_views = max(2, int(syn.num_images) // 4)
        elif llff:
            from nerfmeshes_tpu_torch.data.blender_poses import png_size

            if int(cfg.dataset.llff_downsample_factor) != 1:
                raise AssertionError("llff_cli predicts launches for full-size images only")
            images = sorted((Path(cfg.dataset.basedir) / "images").iterdir())
            val_hw = test_hw = png_size(images[0])
            # Every llff_hold_step-th view is held out; TEST follows validation.
            test_views = len(range(0, len(images), int(cfg.dataset.llff_hold_step)))
        elif scannet:
            from nerfmeshes_tpu_torch.data.loaders.scannet import SensorData

            sens = SensorData(cfg.dataset.basedir)
            val_hw = test_hw = (sens.color_height, sens.color_width)
            # TEST: every 8th frame from frame 2, those with a finite pose.
            test_views = sum(1 for i in range(2, len(sens.frames), 8)
                             if np.isfinite(sens.frames[i].camera_to_world).all())
            del sens
        else:
            from nerfmeshes_tpu_torch.data.blender_poses import read_blender_poses

            reduced = cfg.dataset.reduced_resolution
            _, H, W, _ = read_blender_poses(cfg.dataset.basedir, "val", reduced)
            val_hw = test_hw = (H, W)
            test_views = len(read_blender_poses(cfg.dataset.basedir, "test")[0])

        argv = ["--config", str(REPO / "configs" / config), "--override",
                "experiment.train_iters", str(first), *opts]
        system = leg("train", lambda: train_nerf.main(argv), train_launches(0, first, *val_hw))
        run = system.paths.log_dir
        records = [json.loads(line) for line in (run / "events" / "metrics.jsonl").open()]
        train_rps = [r["train/rays_per_sec"] for r in records if "train/rays_per_sec" in r][-1]
        val_losses = {r["step"]: r["validation/loss"] for r in records if "validation/loss" in r}
        print(f"{name} train: step {system.state.step}, train/rays_per_sec {train_rps:.6e}; "
              f"validation/loss by step {val_losses} [{card}]")
        if zoo:
            coarse_params = sum(p.numel() for p in system.coarse.parameters())
            print(f"{name} models: coarse {type(system.coarse).__name__} ({coarse_params} "
                  f"parameters), fine {type(system.fine).__name__}; optimizer "
                  f"{system.optimizer.kind}")
            if (type(system.coarse).__name__, coarse_params, system.optimizer.kind) != (
                    "SpecularSimpleModel", ZOO_COARSE_PARAMS, "AdamW"):
                raise AssertionError(f"{name}: not the zoo coarse model at its class defaults")

        # A fresh system restored from the run, as eval and mesh restore it,
        # leg by leg: the datasets (for BuFF the ground-truth renders), the
        # restore, a validation at the run's last step, a checkpoint save.
        cfg2, paths2 = resolve_paths(log_checkpoint=str(run))
        leg("train_set", lambda: build_dataset(cfg2, DatasetType.TRAIN), {})
        val_set = leg("val_set", lambda: build_dataset(cfg2, DatasetType.VALIDATION), {})
        fresh = leg("restore",
                    lambda: build_system(cfg2, paths2).setup_eval(val_set).restore(last=True), {})
        metrics = leg("validate", lambda: fresh.validate(step=first),
                      render_launches(val_views, *val_hw))
        leg("save", lambda: fresh.save(val_loss=metrics["validation/loss"]), {})
        same_state = _state_equal(fresh.checkpoint_state(), system.checkpoint_state())
        same_loss = metrics["validation/loss"] == val_losses[first]
        print(f"{name} restore: state (step, parameters, optimizer, schedule, generator"
              + (", tree" if buff else "") + f") equal bit for bit: {same_state}; "
              f"validation/loss at step {first} {metrics['validation/loss']!r} vs the run's "
              f"{val_losses[first]!r}: equal {same_loss}")
        if not (same_state and same_loss):
            raise AssertionError(f"{name}: the restored system differs from the saved run")
        if buff:
            cap = load_hparams(run).tree.max_chords_per_ray
            print(f"{name} chord cap in hparams.yaml {cap}, the system's "
                  f"{system.cfg.tree.max_chords_per_ray}; consolidations after "
                  f"{system.consolidation_steps}")
            if cap != system.cfg.tree.max_chords_per_ray or not system.consolidation_steps:
                raise AssertionError(f"{name}: chord cap or consolidations not as saved")
        del fresh, system, val_set

        resume = ["--log-checkpoint", str(run), "--override", "experiment.train_iters",
                  str(second)]
        system = leg("resume", lambda: train_nerf.main(resume),
                     train_launches(first, second, *val_hw))
        records = [json.loads(line) for line in (run / "events" / "metrics.jsonl").open()]
        val_losses = {r["step"]: r["validation/loss"] for r in records if "validation/loss" in r}
        steps = sorted(int(p.name) for p in (run / "checkpoints").iterdir() if p.name.isdigit())
        kept = sorted(p.name for p in (run / "checkpoints").iterdir() if not p.name.isdigit())
        first_val, last_val = val_losses[min(val_losses)], val_losses[max(val_losses)]
        print(f"{name} resume: step {system.state.step}; validation/loss by step {val_losses}; "
              f"checkpoints {steps} + {kept}")
        if system.state.step != second or len(steps) > 3 or kept != ["last"]:
            raise AssertionError(f"{name}: step {system.state.step}, checkpoints {steps} {kept}")
        if not all(math.isfinite(v) for v in val_losses.values()) or not last_val < first_val:
            raise AssertionError(f"{name}: validation loss not finite and falling: {val_losses}")
        out["events"] = check_run_events(name, run, records, 2,
                                         system.consolidation_steps if buff else [], card)
        del system

        result = leg("eval", lambda: eval_nerf.main(["--log-checkpoint", str(run)]),
                     render_launches(test_views, *test_hw))
        print(f"{name} eval: {test_views} test views {test_hw[0]}x{test_hw[1]}: psnr "
              f"{result['psnr']:.4f} ssim {result['ssim']:.4f} mse {result['mse']:.6f} [{card}]")

        out.update(train_rays_per_s=train_rps, val_losses=val_losses, eval=result)

        def mesh_leg(label: str, log_dir: Path) -> int:
            """mesh_nerf at MESH_RES^3 on a run; the appearance pass's
            chunks follow the vertex count. Returns the vertex count."""
            def mesh():
                return mesh_nerf.main(["--log-checkpoint", str(log_dir), "--res", str(MESH_RES),
                                       "--save-dir", str(Path(tmp) / label),
                                       "--mesh-name", "mesh.ply"])

            (vertices, triangles, _, _), seconds, got = _leg(mesh)
            chunks = math.ceil(len(vertices) / APPEARANCE_CHUNK)
            want = {"fwd": per_chunk * chunks, "chords": chunks if buff else 0, "bwd": 0,
                    "sigma": math.ceil(MESH_RES ** 3 / GRID_TILE)}
            print(f"{name} {label}: {seconds:.4f} s; {len(vertices)} vertices, "
                  f"{len(triangles)} triangles; launches {got} (predicted {want}) [{card}]")
            if got != want or len(vertices) == 0 or len(triangles) == 0:
                raise AssertionError(f"{name} {label}: launches {got} (predicted {want}), "
                                     f"{len(vertices)} vertices")
            out["legs"][label] = dict(seconds=seconds, launches=got)
            return len(vertices)

        if not llff:
            out["vertices"] = mesh_leg("mesh", run)
        if name in IMPORT_CHAINS:
            out["import"] = import_cli(name, run, Path(tmp), out, leg, mesh_leg,
                                       render_launches(test_views, *test_hw), card)
        if name == "cli":
            out["surface_points"] = _surface_ray_leg(name, run, Path(tmp), leg, card)
            out["synthesis"] = _synthesis_leg(name, run, Path(tmp), leg,
                                              render_launches(SYNTHESIS_VIEWS, *test_hw),
                                              test_hw, card)
            total = out["legs"]["synthesis"]["seconds"]
            out["synthesis"]["render_s"] = total - out["synthesis"]["writer_s"]
            print(f"{name} synthesis: {total:.4f} s: render and fetch "
                  f"{out['synthesis']['render_s']:.4f} s ({SYNTHESIS_VIEWS} views, "
                  f"{1e3 * out['synthesis']['render_s'] / SYNTHESIS_VIEWS:.4f} ms a view), GIF "
                  f"writer {out['synthesis']['writer_s']:.4f} s "
                  f"({1e3 * out['synthesis']['writer_s'] / SYNTHESIS_VIEWS:.4f} ms a frame) "
                  f"[{card}]")
    out["event_s"] = writes.seconds
    print(f"{name} legs (s): " + ", ".join(f"{k} {v['seconds']:.4f}" for k, v in out["legs"].items())
          + f"; total {sum(v['seconds'] for v in out['legs'].values()):.4f}; inside the event "
          f"writer {writes.seconds:.4f} s over {writes.calls} calls"
          + (f", _log_tree {trees.seconds:.4f} s over {trees.calls} calls "
             f"({trees.seconds / max(trees.calls // 2, 1):.4f} s a consolidation)" if buff else "")
          + f" [{card}]")
    if buff:
        out["log_tree_s_per_consolidation"] = trees.seconds / max(trees.calls // 2, 1)
    return out


# Event writes timed inside each chain: the writer's public calls.
EVENT_WRITES = ("add_scalar", "add_image", "add_png", "add_text", "add_mesh")
# The chains whose runs import_cli carries over through a reference-layout
# checkpoint.
IMPORT_CHAINS = ("cli", "buff_cli")


class _CallTimer:
    """While active, sums the host seconds of the outermost calls of the
    named methods of `cls` (patched on the class, restored on exit);
    `sync` synchronises the card at both ends of a call."""

    def __init__(self, cls, names, sync: bool = False):
        self.cls, self.names, self.sync = cls, tuple(names), sync
        self.seconds, self.calls, self._depth = 0.0, 0, 0

    def __enter__(self):
        self._saved = {n: self.cls.__dict__[n] for n in self.names}
        for n, fn in self._saved.items():
            setattr(self.cls, n, self._wrap(fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self._saved.items():
            setattr(self.cls, n, fn)

    def _wrap(self, fn):
        timer = self

        @functools.wraps(fn)
        def timed(*args, **kwargs):
            if timer._depth:
                return fn(*args, **kwargs)
            timer._depth += 1
            if timer.sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                if timer.sync:
                    torch.cuda.synchronize()
                timer.seconds += time.perf_counter() - t0
                timer.calls += 1
                timer._depth -= 1

        return timed


def _run_events(run: Path) -> tuple[list, list, float]:
    """(files, every event after each file's version record, seconds to
    read them): read_events checks both CRCs of every record and raises on
    a bad one."""
    from nerfmeshes_tpu_torch.utils.tb_events import FILE_VERSION, event_files, read_events

    files = event_files(run / "events")
    t0 = time.perf_counter()
    events = []
    for path in files:
        got = read_events(path)
        if got[0].get("file_version") != FILE_VERSION:
            raise AssertionError(f"{path.name}: first record {got[0]}")
        events += got[1:]
    return files, events, time.perf_counter() - t0


def _steps_of(events: list, tag: str) -> list:
    return sorted(e["step"] for e in events if e["summary"] and e["summary"][0]["tag"] == tag)


def check_run_events(name: str, run: Path, records: list, train_calls: int,
                     consolidations: list, card: str) -> dict:
    """A chain's event files after its train and resume legs: every CRC
    valid; each metric of metrics.jsonl a scalar at its step (and no other
    scalar); the description and config texts once per train CLI call;
    with `consolidations` (BuFF) the "Tree" mesh and the "Tree Memm"
    image at each consolidation step and the step after, once each."""
    files, events, read_s = _run_events(run)
    scalars = sorted((e["step"], v["tag"]) for e in events for v in e["summary"]
                     if "simple_value" in v)
    want = sorted((r["step"], k) for r in records for k in r if k not in ("step", "time"))
    texts = [v["tag"] for e in events for v in e["summary"] if v["tag"].endswith("/text_summary")]
    tree_steps = sorted(s + d for s in consolidations for d in (0, 1))
    trees, memms = _steps_of(events, "Tree_VERTEX"), _steps_of(events, "Tree Memm")
    size = sum(p.stat().st_size for p in files)
    print(f"{name} events: {len(files)} files, {len(events)} events, {size} bytes, read and "
          f"CRC-checked in {read_s:.4f} s; {len(scalars)} scalars at steps "
          f"{sorted({s for s, _ in scalars})}; texts {sorted(set(texts))} x {len(texts) // 2}"
          + (f"; Tree at {trees}, Tree Memm at {memms}" if consolidations else "") + f" [{card}]")
    if scalars != want:
        raise AssertionError(f"{name} events: scalars {scalars[:6]}..., metrics.jsonl {want[:6]}")
    if sorted(texts) != sorted(["description/text_summary", "config/text_summary"] * train_calls):
        raise AssertionError(f"{name} events: texts {texts}")
    if trees != tree_steps or memms != tree_steps:
        raise AssertionError(f"{name} events: Tree at {trees}, Tree Memm at {memms}, "
                             f"consolidations {consolidations}")
    return {"files": len(files), "events": len(events), "bytes": size, "read_s": read_s}


def import_cli(name: str, run: Path, tmp: Path, source: dict, leg, mesh_leg, eval_launches: dict,
               card: str) -> dict:
    """The chain's trained run carried over as the reference would hand it
    over: its weights under the reference's names in a Lightning-layout
    model_last.ckpt ({"state_dict": model_coarse.* and model_fine.*, or
    model.* and, for BuFF, the reference's tree {voxels (V, 2, 3), memm,
    counter}; "global_step"; "epoch"}), the run's flat dot-keyed
    hparams.yaml one directory up; imported with the port's
    import_checkpoint CLI, then eval_nerf and mesh_nerf on the new run.
    The imported weights equal the source's bit for bit, the step its
    global_step, a BuFF tree's serialization the source's; eval equals the
    source run's PSNR, SSIM and MSE to the last digit and the mesh its
    vertex count (same weights, same kernels); launches as the chain's."""
    from nerfmeshes_tpu_torch.cli import eval_nerf, import_checkpoint
    from nerfmeshes_tpu_torch.config.paths import resolve_paths
    from nerfmeshes_tpu_torch.train.factory import build_system

    buff = name == "buff_cli"
    cfg, paths = resolve_paths(log_checkpoint=str(run))
    src = build_system(cfg, paths).restore(last=True)
    models = ({"model.": (src.coarse, cfg.models.coarse)} if buff else
              {"model_coarse.": (src.coarse, cfg.models.coarse),
               "model_fine.": (src.fine, cfg.models.fine)})
    state_dict = {}
    for prefix, (model, model_cfg) in models.items():
        names = import_checkpoint._torch_linear_order(int(model_cfg.num_layers),
                                                      bool(model_cfg.use_viewdirs))
        own = model.state_dict()
        if sorted(own) != sorted(f"{n}.{p}" for n in names for p in ("weight", "bias")):
            raise AssertionError(f"import_cli {name}: {sorted(own)} are not the reference's names")
        state_dict.update({f"{prefix}{k}": v.detach().cpu().clone() for k, v in own.items()})
    ckpt = {"state_dict": state_dict, "global_step": src.state.step, "epoch": 0}
    if buff:
        leaves = src.tree.leaves
        ckpt["tree"] = {
            "voxels": torch.from_numpy(np.stack([np.stack([l.lo, l.hi]) for l in leaves])),
            "memm": src.tree_state.memm[:len(leaves)].cpu().clone(),
            "counter": src.tree_state.counter}
    reference = tmp / "reference"
    (reference / "checkpoints").mkdir(parents=True)
    ckpt_path = reference / "checkpoints" / "model_last.ckpt"
    torch.save(ckpt, ckpt_path)
    shutil.copyfile(run / "hparams.yaml", reference / "hparams.yaml")
    print(f"import_cli {name}: {ckpt_path.stat().st_size} bytes of Lightning-layout checkpoint, "
          f"{len(state_dict)} tensors under {sorted(models)}"
          + (f", a tree of {len(ckpt['tree']['voxels'])} voxels" if buff else ""))

    imported = leg("import", lambda: import_checkpoint.main(
        ["--ckpt", str(ckpt_path), "--override", "experiment.logdir", str(tmp / "imported")]), {})
    same_weights = all(
        torch.equal(v.cpu(), state_dict[f"{prefix}{k}"])
        for prefix, model in (("model." if buff else "model_coarse.", imported.coarse),
                              *((("model_fine.", imported.fine),) if not buff else ()))
        for k, v in model.state_dict().items())
    same_tree = True
    if buff:
        got = imported.tree.serialize(imported.tree_state)
        want = src.tree.serialize(src.tree_state)
        same_tree = all(np.array_equal(got[k], want[k]) for k in
                        ("leaf_lo", "leaf_hi", "leaf_depth", "memm", "num_leaves"))
        same_tree &= int(got["counter"]) == int(want["counter"])
    print(f"import_cli {name}: weights equal bit for bit {same_weights}; step "
          f"{imported.state.step} (global_step {ckpt['global_step']})"
          + (f"; tree serialization equal {same_tree}" if buff else ""))
    if not (same_weights and same_tree and imported.state.step == ckpt["global_step"]):
        raise AssertionError(f"import_cli {name}: the imported run differs from the source")
    new_run = imported.paths.log_dir
    del imported, src

    result = leg("import_eval", lambda: eval_nerf.main(["--log-checkpoint", str(new_run)]),
                 eval_launches)
    was = source["eval"]
    print(f"import_cli {name} eval: psnr {result['psnr']!r} ssim {result['ssim']!r} mse "
          f"{result['mse']!r}; the source run's {was['psnr']!r} {was['ssim']!r} "
          f"{was['mse']!r} [{card}]")
    if (result["psnr"], result["ssim"], result["mse"]) != (was["psnr"], was["ssim"], was["mse"]):
        raise AssertionError(f"import_cli {name}: eval differs from the source run's")
    vertices = mesh_leg("import_mesh", new_run)
    if vertices != source["vertices"]:
        raise AssertionError(f"import_cli {name}: {vertices} vertices, the source's "
                             f"{source['vertices']}")
    return {"eval": result, "vertices": vertices}


# The event-file phase: hard-blender.yml's 2 x 8x256 fields on the ScanNet
# stream (depth targets), 300 steps printing every 100, a depth projection
# every 100 steps, one validation at the end.
TB_RUN = ("hard-blender.yml", 300,
          ["experiment.validate_every", "300", "experiment.print_every", "100",
           "logging.use_projection", "True", "logging.projection_step_size", "100",
           "dataset.type", "scannet"])
PROBE_RAYS = 2048  # NeRFSystem._log_depth_projection's max_rays
POINT_CODES = {(0, 0, 255): "target", (0, 255, 0): "within 0.2", (0, 0, 0): "false void",
               (255, 0, 0): "false surface"}


def tb_phase(card: str, extra=()) -> dict:
    """train_nerf on TB_RUN (`extra`: more overrides), then its event file
    read back: every CRC valid; each metric of metrics.jsonl a scalar at its
    print step; the validation images at the last step; the description
    and config texts; a "Point Cloud" mesh at each projection step, its
    colours the four codes of depth_point_clouds, the target's points
    first, target + predicted points in all. Launches: the train steps',
    the validation's, and 2 forward launches (coarse, fine) per projection,
    whose probe is one chunk."""
    import tempfile

    from nerfmeshes_tpu_torch.cli import train_nerf
    from nerfmeshes_tpu_torch.config import load_config
    from nerfmeshes_tpu_torch.data.loaders.scannet import SensorData
    from nerfmeshes_tpu_torch.train.system import NeRFSystem
    from nerfmeshes_tpu_torch.utils.tb_events import EventWriter

    config, steps, overrides = TB_RUN
    with tempfile.TemporaryDirectory() as tmp:
        opts = ["experiment.logdir", tmp, "experiment.train_iters", str(steps), *overrides,
                "dataset.basedir", str(SCANNET / "scene.sens"), *extra]
        cfg = load_config(str(REPO / "configs" / config), opts)
        spc, every = int(cfg.experiment.steps_per_call), int(cfg.logging.projection_step_size)
        projections = [s for s in range(spc, steps + 1, spc) if s >= every and s % every < spc]
        sens = SensorData(cfg.dataset.basedir)
        H, W = sens.color_height, sens.color_width
        del sens
        probe = len(range(0, H * W, max(1, H * W // PROBE_RAYS)))
        chunk = int(cfg.nerf.validation.chunksize)
        per_chunk = 2 if cfg.models.use_fine else 1
        val_views = _validations(cfg, 0, steps) * int(cfg.nerf.validation.num_samples)
        want = {"fwd": per_chunk * (steps + val_views * math.ceil(H * W / chunk)
                                    + len(projections) * math.ceil(probe / min(chunk, probe))),
                "bwd": per_chunk * steps, "sigma": 0, "chords": 0}
        argv = ["--config", str(REPO / "configs" / config), "--override", *opts]
        with (_CallTimer(NeRFSystem, ("_log_depth_projection",), sync=True) as proj,
              _CallTimer(EventWriter, EVENT_WRITES) as writes):
            system, seconds, got = _leg(lambda: train_nerf.main(argv))
        print(f"tb_phase train: {steps} steps, {len(projections)} projections at {projections} "
              f"of {probe} rays: {seconds:.4f} s ({proj.seconds:.4f} s in the projections, "
              f"{proj.seconds / max(proj.calls, 1):.4f} s each; {writes.seconds:.4f} s inside "
              f"the event writer); launches {got} (predicted "
              f"{want}) [{card}]")
        if got != want or proj.calls != len(projections):
            raise AssertionError(f"tb_phase: launches {got} (predicted {want}), "
                                 f"{proj.calls} projections")
        run = system.paths.log_dir
        records = [json.loads(line) for line in (run / "events" / "metrics.jsonl").open()]
        files, events, read_s = _run_events(run)
        scalars = sorted((e["step"], v["tag"]) for e in events for v in e["summary"]
                         if "simple_value" in v)
        print_steps = sorted({r["step"] for r in records})
        if scalars != sorted((r["step"], k) for r in records for k in r
                             if k not in ("step", "time")) or len(print_steps) != steps // 100:
            raise AssertionError(f"tb_phase: scalars at {sorted({s for s, _ in scalars})}")
        kinds = ("rgb_fine", "rgb_coarse", "disparity", "img_target") if per_chunk == 2 else (
            "rgb_coarse", "disparity", "img_target")
        images = sorted((e["step"], v["tag"]) for e in events for v in e["summary"]
                        if "image" in v)
        views = int(cfg.nerf.validation.num_samples)
        if images != sorted((steps, f"validation/{k}/{i}") for k in kinds for i in range(views)):
            raise AssertionError(f"tb_phase: images {images}")
        texts = {v["tag"]: v["tensor"]["string_val"][0].decode("utf-8") for e in events
                 for v in e["summary"] if v["tag"].endswith("/text_summary")}
        if texts != {"description/text_summary": str(system.cfg.experiment.description),
                     "config/text_summary": system.cfg.dump()}:
            raise AssertionError(f"tb_phase: texts {sorted(texts)}")
        clouds = [e for e in events if e["summary"][0]["tag"] == "Point Cloud_VERTEX"]
        codes, distinct = {}, {}
        for e in clouds:
            verts, colors = (v["tensor"] for v in e["summary"])
            # Eval depth is 0 where a ray's accumulated weight is under 1 (JAX's
            # volume_render, and the reference's): those rays' predicted points
            # all sit at the camera, one distinct point.
            predicted = verts["float_val"].reshape(-1, 3)[probe:]
            distinct[e["step"]] = len(np.unique(predicted, axis=0))
            rgb = colors["float_val"].reshape(-1, 3).astype(np.int64)
            found = {k: int((rgb == k).all(-1).sum()) for k in POINT_CODES}
            if (verts["shape"] != [1, 2 * probe, 3] or colors["shape"] != verts["shape"]
                    or sum(found.values()) != 2 * probe or not (rgb[:probe] == (0, 0, 255)).all()
                    or not np.isfinite(verts["float_val"]).all()):
                raise AssertionError(f"tb_phase: point cloud at {e['step']}: {verts['shape']}, "
                                     f"codes {found}")
            codes[e["step"]] = {POINT_CODES[k]: n for k, n in found.items()}
        size = sum(p.stat().st_size for p in files)
        print(f"tb_phase events: {len(files)} file, {len(events)} events, {size} bytes, read and "
              f"CRC-checked in {read_s:.4f} s; scalars at {print_steps}; {len(images)} images at "
              f"step {steps}; texts {sorted(texts)}; point clouds at {sorted(codes)}, points by "
              f"code {codes}; distinct predicted points by step {distinct} (eval depth is 0 "
              f"where the accumulated weight is under 1) [{card}]")
        if sorted(codes) != projections:
            raise AssertionError(f"tb_phase: point clouds at {sorted(codes)}, want {projections}")
    return {"legs": {"train": dict(seconds=seconds, launches=got)},
            "projection_s": proj.seconds / max(proj.calls, 1), "event_s": writes.seconds,
            "events": len(events),
            "bytes": size, "read_s": read_s}


def crc_phase(card: str, nbytes: int = 1_400_000) -> dict:
    """The event writer's CRC32C on the host, over a grown tree's mesh
    record size (4096 voxels: ~1.4 MB): median of 5 after one warm-up,
    and the same data through the table-driven loop alone."""
    from nerfmeshes_tpu_torch.utils import tb_events

    data = np.random.default_rng(SEED).integers(0, 256, nbytes, dtype=np.uint8).tobytes()
    if tb_events.crc32c(data) != tb_events._crc_loop(data, 0xFFFFFFFF) ^ 0xFFFFFFFF:
        raise AssertionError("crc32c: the lane path differs from the table-driven loop")
    runs = []
    for _ in range(6):
        t0 = time.perf_counter()
        tb_events.crc32c(data)
        runs.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    tb_events._crc_loop(data, 0xFFFFFFFF)
    loop_s = time.perf_counter() - t0
    sec = statistics.median(runs[1:])
    print(f"crc32c: {nbytes} bytes in {1e3 * sec:.4f} ms (median of 5), {nbytes / sec / 1e6:.4f} "
          f"MB/s, {1e3 * sec / (nbytes / 1e6):.4f} ms per MB; the table-driven loop alone "
          f"{1e3 * loop_s:.4f} ms ({nbytes / loop_s / 1e6:.4f} MB/s) [{card}]")
    return {"mb_per_s": nbytes / sec / 1e6, "loop_mb_per_s": nbytes / loop_s / 1e6}


DEPTH_RAYS, DEPTH_SAMPLES = 65536, 64


def depth_sampling_phase(card: str, device) -> dict:
    """Each strategy of ops/depth_sampling.py on the card from a CUDA
    generator, at 65,536 rays x 64 samples with half the rays' depth
    unknown: sorted along every ray, inside the strategy's bounds per ray;
    linear and proximal (deterministic) equal their CPU run within 1e-6;
    ms per call (CUDA events, median of 7)."""
    from nerfmeshes_tpu_torch.ops import depth_sampling as ds

    rng = np.random.default_rng(SEED)
    depth_np = rng.uniform(2.5, 4.5, DEPTH_RAYS).astype(np.float32)
    depth_np[::2] = 0.0
    near, far, empty = 2.0, 6.0, 0.0
    has = torch.from_numpy(depth_np != empty)[:, None]
    depth_t = torch.from_numpy(depth_np)[:, None]
    band = ((0.0 - 0.5) / 2.0, (1.0 - 0.5) / 2.0)  # surface_band's defaults (off, fc2)
    bounds = {
        "linear": (near, far), "random": (near, far),
        "depth_informed": (near, torch.where(has, depth_t + 0.5, far)),
        "surface_band": (torch.where(has, band[0], near), torch.where(has, band[1], far)),
        "proximal": (torch.where(has, depth_t - 0.4, near), far)}
    out = {}
    for strategy in ds.STRATEGIES:
        def call(dev):
            gen = torch.Generator(dev).manual_seed(SEED)
            return ds.depth_guided_intervals(strategy, near, far, DEPTH_RAYS, DEPTH_SAMPLES,
                                             generator=gen, empty=empty,
                                             depth=torch.from_numpy(depth_np).to(dev))

        z = call(device)
        torch.cuda.synchronize()
        lo, hi = bounds[strategy]
        zc = z.cpu()
        ok = (z.device.type == "cuda" and zc.shape == (DEPTH_RAYS, DEPTH_SAMPLES)
              and bool((zc[:, 1:] >= zc[:, :-1]).all())
              and bool((zc >= torch.as_tensor(lo) - 1e-5).all())
              and bool((zc <= torch.as_tensor(hi) + 1e-5).all()))
        err = None
        if strategy in ("linear", "proximal"):
            err = float((zc - call("cpu")).abs().max())
            ok &= err <= 1e-6
        ms = _median_ms(lambda: call(device))
        print(f"depth_sampling {strategy}: on the card sorted and inside its bounds {ok}"
              + (f", max |card - cpu| {err:.3e}" if err is not None else "")
              + f"; {ms:.4f} ms per call at {DEPTH_RAYS}x{DEPTH_SAMPLES} [{card}]")
        if not ok:
            raise AssertionError(f"depth_sampling {strategy}: out of bounds, unsorted or off "
                                 f"the CPU run ({err})")
        out[strategy] = {"ms": ms, "max_abs_err": err}
    return out


ZOO = ("SimpleModel", "SpecularSimpleModel", "FlatModel", "ResModel", "DropModel",
       "RotFlexibleNeRFModel")
ZOO_RAYS, ZOO_SAMPLES = 2048, 64
# The field within 1e-5 in f32 (TF32 off) and 2e-2 in bf16, the CPU tests'
# bars (tests/test_torch_zoo.py); every grad's worst relative error (max
# |card - cpu| / max |cpu|) within 1e-3 in f32 and 5e-2 in bf16. The CPU
# tests hold f32 grads to 1e-4 against JAX on the same CPU; across devices
# the f32 GEMMs sum in other orders, a pre-activation within rounding of 0
# flips its ReLU, and a leaf whose units fire at few points moves by that
# point's whole term: 1e-4 of max |grad| at 2048 x 64 points, 4.4e-4 at
# 256 x 64 on an H100 (the fields agree within 1.8e-7 meanwhile).
# Both bars hold given the same x @ B: zoo_compare holds the encodings'
# projections apart, to f32's rounding bound.
ZOO_FIELD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
ZOO_GRAD_TOL = {"float32": 1e-3, "bfloat16": 5e-2}


def worst_grad_error(cpu, card) -> tuple[float, str]:
    """(worst max |card - cpu| / max |cpu| over the leaves' grads, its leaf)."""
    return max((float((a.grad - b.grad.cpu()).abs().max() / (a.grad.abs().max() + 1e-9)), key)
               for (key, a), b in zip(cpu.named_parameters(), card.parameters()))


def _zoo_points(device, seed: int = SEED + 7):
    """(points, directions) (ZOO_RAYS, ZOO_SAMPLES, 3) along the scene's
    camera rays at sorted depths in [2, 6], on `device`."""
    o, d, z = _rays(ZOO_RAYS, ZOO_SAMPLES, np.random.default_rng(seed), device)
    pts = o[:, None] + d[:, None] * z[..., None]
    return pts, d[:, None].expand(pts.shape).contiguous()


# f32's rounding of a K-term dot product, whatever order its sums take:
# |fl(z) - z| <= K u (|W| |x| + |b|), u = 2^-24 the unit roundoff.
F32_UNIT = 2.0 ** -24


def relu_margins(model, pts, dirs, detail: bool = False):
    """A float64 run of `model` (a zoo module in f32, on the CPU) at (pts,
    dirs): (field, near, margins). field: the model's output; near (N,)
    bool: points where some ReLU's pre-activation z lies within f32's
    rounding of 0, |z| <= K u (|W| |x| + |b|) in float64, K the layer's
    fan-in; margins (with `detail`): {module: (z, bound)} of every ReLU
    layer, (N, units) each. The ReLUs are the SimpleModules with
    torch.relu; every other layer runs in float64 too."""
    import copy
    import functools

    import torch.nn.functional as F

    from nerfmeshes_tpu_torch.models import layers
    from nerfmeshes_tpu_torch.models.nerf_models import field_of

    m64 = copy.deepcopy(model).double()
    near = torch.zeros(pts.reshape(-1, 3).shape[0], dtype=torch.bool)
    margins, handles = {}, []

    def hook(mod, inp, out, name):
        x = inp[0].reshape(-1, inp[0].shape[-1])
        lin = mod.linear
        z = F.linear(x, lin.weight, lin.bias)
        bound = lin.in_features * F32_UNIT * F.linear(x.abs(), lin.weight.abs(),
                                                      lin.bias.abs())
        near.logical_or_((z.abs() <= bound).any(-1))
        if detail:
            margins[name] = (z, bound)

    for name, mod in m64.named_modules():
        if isinstance(mod, layers.SimpleModule) and mod.activation is torch.relu:
            handles.append(mod.register_forward_hook(functools.partial(hook, name=name)))
    forward = layers.TorchLinear.forward
    layers.TorchLinear.forward = lambda self, x: F.linear(x.double(), self.weight, self.bias)
    try:
        with torch.no_grad():
            field = field_of(m64(pts.double(), dirs.double()))
    finally:
        layers.TorchLinear.forward = forward
        for h in handles:
            h.remove()
    return field.reshape(-1, field.shape[-1]), near, margins


def leaf_taps(model, rows):
    """Forward hooks recording every leaf module's output at the flat rows
    `rows` (a tensor on the module's device): (records {name: float64 CPU
    tensor}, handles to remove)."""
    records, handles = {}, []
    for name, mod in model.named_modules():
        if next(mod.children(), None) is not None:
            continue

        def hook(mod, inp, out, name=name):
            if isinstance(out, torch.Tensor) and out.dim() >= 2:
                records[name] = out.reshape(-1, out.shape[-1])[rows].detach().double().cpu()

        handles.append(mod.register_forward_hook(hook))
    return records, handles


def zoo_excursion(cpu, card_model, pts, dirs, got, want) -> None:
    """What a zoo field past its f32 bar looks like at its worst point:
    the field on the card, on the CPU and in float64 (relu_margins); every
    leaf module's largest |card - CPU| there; each ReLU layer's unit
    nearest 0 in float64 beside f32's rounding bound, and how many units
    the card and the CPU put on different sides of 0. Printed before
    zoo_phase fails, so that a rare excursion leaves its reads."""
    got, want = (t.reshape(-1, t.shape[-1]).float().cpu() for t in (got, want))
    worst = int(((got - want).abs() / (1.0 + want.abs())).amax(-1).argmax())
    rows = torch.tensor([worst])
    rec_cpu, h_cpu = leaf_taps(cpu, rows)
    rec_card, h_card = leaf_taps(card_model, rows.to(pts.device))
    with torch.no_grad():
        cpu(pts.cpu(), dirs.cpu())
        card_model(pts, dirs)
    for h in h_cpu + h_card:
        h.remove()
    f64, near, margins = relu_margins(cpu, pts.reshape(-1, 3)[worst:worst + 1].cpu(),
                                      dirs.reshape(-1, 3)[worst:worst + 1].cpu(), detail=True)
    print(f"  excursion at point {worst}: card {got[worst].tolist()}, cpu {want[worst].tolist()}, "
          f"float64 {f64[0].tolist()}; a ReLU within f32 rounding of 0 there: {bool(near[0])}")
    for name in rec_cpu:
        if name in rec_card:
            diff = float((rec_card[name] - rec_cpu[name]).abs().max())
            print(f"  {name}: max |card - cpu| {diff:.3e}")
    for name, (z, bound) in margins.items():
        u = int(z[0].abs().argmin())
        z_cpu, z_card = rec_cpu[f"{name}.linear"][0], rec_card[f"{name}.linear"][0]
        flips = int(((z_cpu > 0) != (z_card > 0)).sum())
        print(f"  {name}: unit {u} nearest 0, float64 {float(z[0, u]):.3e}, f32 rounding bound "
              f"{float(bound[0, u]):.3e}; {flips} units on other sides of 0 on card and cpu")


def _zoo_step(model, pts, dirs, **kw):
    """(field, loss) of one forward and backward of sum(field^2); a
    (field, specular) output gives its field."""
    from nerfmeshes_tpu_torch.models.nerf_models import field_of

    field = field_of(model(pts, dirs, **kw))
    loss = (field.float() ** 2).sum()
    loss.backward()
    return field.detach(), loss.detach()


class _TakeProjection(torch.autograd.Function):
    """Forward: `value`, another device's x @ B; backward: the gradient
    goes to `own` (this device's x @ B) as it would through `own` itself."""

    @staticmethod
    def forward(ctx, own, value):
        return value.clone()

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def zoo_compare(cpu, card_model, pts, dirs, dtype: str) -> tuple[torch.Tensor, dict]:
    """One forward and backward of sum(field^2) of `card_model` at (pts,
    dirs) against the same of `cpu` (the same weights, on the CPU) at the
    zoo bars: (the card's field, reads).

    The Fourier projections x @ B of the encodings (layers.SpatialEmbedding
    and its subclasses) are held apart. At the class defaults |B| reaches
    2^31 and |x @ B| 2^32, where an ulp is 2^9, so sin(x @ B) of two
    summation orders of the same 3-term sum may differ by anything, and the
    field by 5e-2 (one ulp on every feature): held end to end, the f32
    field bar would test the order of that sum. So each of the card's
    projections is held within 2 gamma_K (|x| |B|) of the CPU's, the most
    two f32 sums of the K products can differ by (gamma_K = K u / (1 - K
    u), u = F32_UNIT, operands rounded to the compute dtype), and the
    CPU's run then goes on from the card's projection, its gradient still
    reaching B. Where the two projections agree bit for bit, as on every
    call read so far, this is the end-to-end comparison itself. Reads:
    field_err, field_ok, grad_err, worst (its leaf), proj_ok, proj_ratio
    (the worst |card - cpu| / bound), proj_moved (elements not equal bit
    for bit) of proj_elements."""
    from nerfmeshes_tpu_torch.models import layers

    card_enc = [m for m in card_model.modules() if isinstance(m, layers.SpatialEmbedding)]
    cpu_enc = [m for m in cpu.modules() if isinstance(m, layers.SpatialEmbedding)]
    seen = [[] for _ in card_enc]

    def recording(mod, out):
        def projection(x):
            p = type(mod).projection(mod, x)
            out.append(p.detach())
            return p
        return projection

    for mod, out in zip(card_enc, seen):
        mod.projection = recording(mod, out)
    try:
        card_model.zero_grad(set_to_none=True)
        got, _ = _zoo_step(card_model, pts, dirs)
    finally:
        for mod in card_enc:
            del mod.projection

    reads = dict(proj_ok=True, proj_ratio=0.0, proj_moved=0, proj_elements=0)

    def replaying(mod, queue):
        def projection(x):
            own = type(mod).projection(mod, x)
            if not queue:
                raise AssertionError("the CPU run projects more often than the card's")
            theirs = queue.pop(0).to(own.device)
            xr = x.detach().to(mod.compute_dtype).double()
            br = mod.b.detach().to(mod.compute_dtype).double()
            k = xr.shape[-1]
            bound = 2.0 * (k * F32_UNIT / (1.0 - k * F32_UNIT)) * (xr.abs() @ br.abs())
            diff = (theirs.double() - own.detach().double()).abs()
            reads["proj_ok"] &= bool((diff <= bound).all())
            ratio = diff / torch.where(bound > 0, bound, torch.ones_like(bound))
            reads["proj_ratio"] = max(reads["proj_ratio"], float(ratio.max()))
            reads["proj_moved"] += int((diff != 0).sum())
            reads["proj_elements"] += diff.numel()
            return _TakeProjection.apply(own, theirs)
        return projection

    queues = [list(out) for out in seen]
    for mod, queue in zip(cpu_enc, queues):
        mod.projection = replaying(mod, queue)
    try:
        cpu.zero_grad(set_to_none=True)
        want, _ = _zoo_step(cpu, pts.cpu(), dirs.cpu())
    finally:
        for mod in cpu_enc:
            del mod.projection
    if len(cpu_enc) != len(card_enc) or any(queues):
        raise AssertionError("the CPU run projects less often than the card's")

    diff = (got.cpu().float() - want.float()).abs()
    # assert_allclose's test: |card - cpu| <= atol + rtol |cpu|, atol = rtol.
    reads["field_ok"] = bool((diff <= ZOO_FIELD_TOL[dtype] * (1.0 + want.float().abs())).all())
    reads["field_err"] = float(diff.max())
    reads["grad_err"], reads["worst"] = worst_grad_error(cpu, card_model)
    reads["want"] = want
    return got, reads


def zoo_phase(card: str, device) -> dict:
    """The six zoo models (no kernel of their own: XLA in the JAX package,
    torch ops here) at their class defaults, in f32 and bf16: one forward
    and one backward of sum(field^2) at ZOO_RAYS x ZOO_SAMPLES points on
    the card, held against the CPU run of the same module with the same
    weights (ZOO_FIELD_TOL, ZOO_GRAD_TOL; the encodings' x @ B held apart
    to f32's rounding bound, zoo_compare); ms per forward + backward on the
    card, CUDA events, median of 5 after one warm-up. DropModel's dropout
    in training then draws from a CUDA generator: the share kept among the
    trunk's non-zero values within 3 sigma of 0.5."""
    from nerfmeshes_tpu_torch.models import nerf_models as tm
    from nerfmeshes_tpu_torch.train.system import init_params

    pts, dirs = _zoo_points(device)
    out = {}
    for name in ZOO:
        for dtype in ("float32", "bfloat16"):
            compute = getattr(torch, dtype)
            cpu = tm.build_model(name, {}, compute_dtype=compute)
            init_params(cpu, None, torch.Generator().manual_seed(SEED))
            card_model = tm.build_model(name, {}, compute_dtype=compute)
            card_model.load_state_dict(cpu.state_dict())
            card_model.to(device)

            def step():
                card_model.zero_grad(set_to_none=True)
                return _zoo_step(card_model, pts, dirs)

            ms = _median_ms(step, runs=5, warmup=1)
            got, r = zoo_compare(cpu, card_model, pts, dirs, dtype)
            field_err, grad_err, worst = r["field_err"], r["grad_err"], r["worst"]
            params = sum(p.numel() for p in cpu.parameters())
            print(f"zoo {name} {dtype}: {params} parameters; {ZOO_RAYS}x{ZOO_SAMPLES} points "
                  f"forward + backward {ms:.4f} ms on the card; vs the CPU run: x @ B "
                  f"{r['proj_moved']} of {r['proj_elements']} elements not bitwise, worst "
                  f"|diff| / f32 bound {r['proj_ratio']:.3e} (bar 1); field max abs err "
                  f"{field_err:.3e} (bar {ZOO_FIELD_TOL[dtype]}), grads worst rel err "
                  f"{grad_err:.3e} at {worst} (bar {ZOO_GRAD_TOL[dtype]}) [{card}]")
            if not (r["proj_ok"] and r["field_ok"] and grad_err < ZOO_GRAD_TOL[dtype]):
                if not r["field_ok"]:
                    zoo_excursion(cpu, card_model, pts, dirs, got, r["want"])
                raise AssertionError(f"zoo {name} {dtype}: the card's run differs from the CPU's")
            out[f"{name}_{dtype}"] = dict(ms=ms, field_err=field_err, grad_err=grad_err,
                                          params=params, proj_moved=r["proj_moved"],
                                          proj_ratio=r["proj_ratio"])
            if name == "DropModel" and dtype == "bfloat16":
                out["dropout"] = _dropout_check(tm, card_model, pts, dirs)
            del cpu, card_model
    return out


def _dropout_check(tm, model, pts, dirs) -> dict:
    """DropModel in training on the card: its dropout draws from a CUDA
    generator; the share kept among the non-zero trunk values within 3
    sigma of 0.5; the same seed draws the same mask."""
    seen = []
    real = tm.dropout

    def recording(x, rate, generator):
        if generator is None or generator.device.type != "cuda":
            raise AssertionError("DropModel's dropout did not draw from a CUDA generator")
        y = real(x, rate, generator)
        seen.append((y != 0, x != 0))
        return y

    tm.dropout = recording
    try:
        with torch.no_grad():
            a = model(pts, dirs, deterministic=False,
                      generator=torch.Generator(pts.device).manual_seed(SEED))
            b = model(pts, dirs, deterministic=False,
                      generator=torch.Generator(pts.device).manual_seed(SEED))
    finally:
        tm.dropout = real
    kept, nonzero = seen[0]
    n = int(nonzero.sum())
    share = float(kept[nonzero].float().mean())
    sigma = math.sqrt(0.25 / n)
    print(f"zoo DropModel dropout on the card: kept {share:.6f} of {n} non-zero trunk values "
          f"(0.5 +- 3 sigma = {3 * sigma:.2e}); repeatable from a seed: {torch.equal(a, b)}")
    if abs(share - 0.5) > 3 * sigma or not torch.equal(a, b):
        raise AssertionError("DropModel's dropout rate or repeatability is off on the card")
    return dict(share=share, n=n)


BUFF_RANDOM_STEPS = 200


def buff_random_phase(card: str, device) -> dict:
    """buff_hard_cfg() with tree.use_random_sampling and RMSprop: 200 train
    steps, then one 400x400 test view. No chord launch (the random sampler
    slab-tests every voxel itself, as JAX's does); one forward and one
    backward launch a step, one forward launch a view chunk; the loss is
    finite and falls; every tree sample of a 2048-ray batch on the trained
    tree lies in a chord of a voxel its ray hits (to 1e-6 * far), sorted,
    with no chord dropped."""
    from nerfmeshes_tpu_torch.buff.tree import ray_voxel_intersect
    from nerfmeshes_tpu_torch.data.blender import train_arrays
    from nerfmeshes_tpu_torch.data.blender_poses import read_blender_poses
    from nerfmeshes_tpu_torch.ops.kernels import chords as ch
    from nerfmeshes_tpu_torch.ops.kernels import fused_mlp as fm
    from nerfmeshes_tpu_torch.train.step import make_pose_rays

    cfg = buff_hard_cfg()
    cfg.tree.use_random_sampling = True
    cfg.optimizer.type = "RMSprop"
    system = _buff_system(device, cfg).setup(train_arrays(cfg, device))
    torch.cuda.synchronize()
    ch.launches = fm.launches = fm.bwd_launches = 0
    t0 = time.perf_counter()
    system.fit(BUFF_RANDOM_STEPS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    train = {"chords": ch.launches, "fwd": fm.launches, "bwd": fm.bwd_launches}
    losses = torch.stack(system.losses).cpu().tolist()
    first, last = statistics.mean(losses[:10]), statistics.mean(losses[-10:])
    rays = int(cfg.nerf.train.num_random_rays)
    print(f"buff_random train: {BUFF_RANDOM_STEPS} steps (random sampler, RMSprop) in "
          f"{seconds:.4f} s, {BUFF_RANDOM_STEPS * rays / seconds:.6e} rays/s; launches {train} "
          f"(predicted chords 0, fwd {BUFF_RANDOM_STEPS}, bwd {BUFF_RANDOM_STEPS}); loss first "
          f"10 mean {first:.6f}, last 10 {last:.6f} [{card}]")
    if train != {"chords": 0, "fwd": BUFF_RANDOM_STEPS, "bwd": BUFF_RANDOM_STEPS}:
        raise AssertionError(f"buff_random train launches {train}")
    if not all(math.isfinite(v) for v in losses) or not last < first:
        raise AssertionError(f"buff_random loss not finite and falling: {first} -> {last}")

    poses, H, W, focal = read_blender_poses(REPO / "data" / "hard_blender", "test")
    o, d = make_pose_rays(H, W, focal, device=device)(poses[0])
    near, far = float(cfg.dataset.near), float(cfg.dataset.far)
    chunk = int(cfg.nerf.validation.chunksize)
    torch.cuda.synchronize()
    ch.launches = fm.launches = 0
    t0 = time.perf_counter()
    view = system.query_rays(o, d, near, far, fields=("rgb_map", "acc_map"), as_numpy=False)
    torch.cuda.synchronize()
    view_s = time.perf_counter() - t0
    view_launches = {"chords": ch.launches, "fwd": fm.launches}
    chunks = math.ceil(H * W / chunk)
    print(f"buff_random view {H}x{W}: {view_s:.4f} s, launches {view_launches} (predicted "
          f"chords 0, fwd {chunks}); acc mean {float(view.acc_map.mean()):.4f} [{card}]")
    if view_launches != {"chords": 0, "fwd": chunks}:
        raise AssertionError(f"buff_random view launches {view_launches}")
    if not bool(torch.isfinite(view.rgb_map).all()):
        raise AssertionError("buff_random view: non-finite rgb")

    tree = system.tree_state
    ob, db = o[:CHECK_RAYS].contiguous(), d[:CHECK_RAYS].contiguous()
    S = int(cfg.nerf.validation.num_coarse)
    z, idx, hit, dropped = ray_voxel_intersect(
        tree.voxels, tree.active, ob, db, near, far, samples_count=S, use_random_sampling=True,
        generator=torch.Generator(device).manual_seed(SEED))
    inv = 1.0 / db
    mask, tmin, tmax = ch.slab_test(tree.voxels, tree.active, ob, inv, inv < 0.0, near, far)
    rows = hit.nonzero()[:, 0]
    ids = idx[rows].long()
    inside = torch.gather(mask[rows], 1, ids).all()
    tol = 1e-6 * far
    in_chord = ((z[rows] >= torch.gather(tmin[rows], 1, ids) - tol)
                & (z[rows] <= torch.gather(tmax[rows], 1, ids) + tol)).all()
    ordered = bool((z[rows].diff(dim=1) >= 0).all())
    print(f"buff_random sampler on the trained tree: {int(hit.sum())} of {CHECK_RAYS} rays hit; "
          f"every sample in a hit voxel {bool(inside)}, inside its chord {bool(in_chord)}, "
          f"sorted {ordered}, dropped {int(dropped.sum())}")
    if not (bool(inside) and bool(in_chord) and ordered and int(dropped.sum()) == 0
            and int(hit.sum()) > 0):
        raise AssertionError("buff_random: a tree sample lies outside its ray's hit chords")
    return dict(train=train, view=view_launches, seconds=seconds, view_s=view_s,
                loss_first=first, loss_last=last)


QUALITY_STEPS = 300  # the quality protocols' runs, cut
QUALITY_SEED = 42
QUALITY_800_VIEW = 64  # quality_800's views and mesh, cut
QUALITY_800_MESH = 128


def quality_phase(card: str, device) -> dict:
    """The runners of scripts/torch_quality_parity.py, cut to QUALITY_STEPS
    steps at seed 42, their entries written to build/quality_smoke.json
    (never the repo's torch_quality_parity.json): the kernel-width protocol
    (configs/nerf-synthetic-lego.yml's 2 x 8x256 fields through the fused
    kernels, 12 views at 64^2; reads at 0 and QUALITY_STEPS), then blobs
    hierarchical and BuFF (4x64 nn.Module fields; BuFF's chords through the
    chord kernel); the forward-facing protocol (configs/hard-llff.yml's 2 x
    8x128 fields on data/hard_llff's 400^2 NDC views through train_nerf,
    eval_nerf on the first test view) and quality_800 (the lego workload on
    the hard scene's 64^2 views, a 128^3 mesh through the sigma kernel, its
    chamfer distance to the analytic surface). Exact launch counts: 2
    forward and 2 backward a train step on the field kernels (kernel width,
    forward-facing, quality_800), the same forward launches a view in every
    forward-facing read, one sigma launch a grid tile, 1 chord launch a
    BuFF step, no field kernel on blobs; the losses fall; every PSNR is
    finite and above the run's untrained read; the chamfer distance is
    finite. Two lines of reads."""
    import importlib.util
    import tempfile

    spec = importlib.util.spec_from_file_location(
        "torch_quality_parity", REPO / "scripts" / "torch_quality_parity.py")
    quality = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(quality)
    out = REPO / "build" / "quality_smoke.json"
    out.unlink(missing_ok=True)
    kept = quality.OUT.read_bytes() if quality.OUT.exists() else None
    t0 = time.perf_counter()
    kw = quality.run("kernel_width", "hier", "on", QUALITY_SEED, device, out,
                     reads=[QUALITY_STEPS])
    blobs = {system: quality.run("blobs", system, "module", QUALITY_SEED, device, out,
                                 steps=QUALITY_STEPS) for system in ("hier", "buff")}
    seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ff = quality.run("forward_facing", "hier", "on", QUALITY_SEED, device, out,
                         steps=QUALITY_STEPS, eval_views=1, logdir=tmp)
    q8 = quality.run("quality_800", "hier", "on", QUALITY_SEED, device, out,
                     steps=QUALITY_STEPS, image_size=QUALITY_800_VIEW,
                     mesh_res=QUALITY_800_MESH)
    new_seconds = time.perf_counter() - t0
    if set(json.loads(out.read_text())) != {
            f"kernel_width_hier_on_{QUALITY_SEED}", f"blobs_hier_module_{QUALITY_SEED}",
            f"blobs_buff_module_{QUALITY_SEED}", f"forward_facing_hier_on_{QUALITY_SEED}",
            f"quality_800_hier_on_{QUALITY_SEED}"}:
        raise AssertionError(f"quality entries in {out}: {sorted(json.loads(out.read_text()))}")
    if (quality.OUT.read_bytes() if quality.OUT.exists() else None) != kept:
        raise AssertionError(f"the quality phase wrote {quality.OUT}")

    steps = kw["steps"]
    if steps != QUALITY_STEPS or kw["launches"] != {"fwd": 2 * steps, "bwd": 2 * steps}:
        raise AssertionError(f"kernel width: {steps} steps, launches {kw['launches']}; "
                             f"expected 2 + 2 a step")
    first, last = (kw["reads"][k] for k in ("0", str(QUALITY_STEPS)))
    for view in ("validation", "train_views"):
        if not last[view]["validation/loss"] < first[view]["validation/loss"]:
            raise AssertionError(f"kernel width {view} loss did not fall: "
                                 f"{first[view]['validation/loss']} -> "
                                 f"{last[view]['validation/loss']}")
        for name in ("fine", "coarse"):
            a, b = (r[view][f"validation/{name}_psnr"] for r in (first, last))
            if not (math.isfinite(b) and b > a):
                raise AssertionError(f"kernel width {view} {name} PSNR {a} -> {b}")
    for system, entry in blobs.items():
        want = {"chords": QUALITY_STEPS if system == "buff" else 0, "fwd": 0, "bwd": 0}
        if entry["steps"] != QUALITY_STEPS or entry["launches"] != want:
            raise AssertionError(f"blobs {system}: launches {entry['launches']}, expected {want}")
        if not entry["loss_last_100"] < entry["loss_first_100"]:
            raise AssertionError(f"blobs {system} loss did not fall: {entry['loss_first_100']} "
                                 f"-> {entry['loss_last_100']}")
        for name in ("psnr", "coarse_psnr"):
            if name in entry and not (math.isfinite(entry[name])
                                      and entry[name] > entry["untrained"][name]):
                raise AssertionError(f"blobs {system} {name} {entry['untrained'][name]} -> "
                                     f"{entry[name]}")
    hold_new_quality_runs(ff, q8)
    print(f"quality_phase ({QUALITY_STEPS} steps, seed {QUALITY_SEED}, {seconds:.2f} s): "
          "kernel width fine / coarse dB " + ", ".join(
              f"step {k} {r['validation']['validation/fine_psnr']:.4f} / "
              f"{r['validation']['validation/coarse_psnr']:.4f}" for k, r in kw["reads"].items())
          + f", {kw['train_s']:.2f} s of training; blobs hier "
          f"{blobs['hier']['untrained']['psnr']:.4f} -> {blobs['hier']['psnr']:.4f} dB (coarse "
          f"{blobs['hier']['coarse_psnr']:.4f}), BuFF {blobs['buff']['untrained']['psnr']:.4f} -> "
          f"{blobs['buff']['psnr']:.4f} dB; launches fwd {kw['launches']['fwd']}, bwd "
          f"{kw['launches']['bwd']}, chords {blobs['buff']['launches']['chords']} [{card}]")
    last = ff["validations"][str(QUALITY_STEPS)]
    print(f"quality_phase new protocols ({QUALITY_STEPS} steps, seed {QUALITY_SEED}, "
          f"{new_seconds:.2f} s): forward-facing validation fine / coarse "
          f"{ff['untrained']['validation/fine_psnr']:.4f} / "
          f"{ff['untrained']['validation/coarse_psnr']:.4f} -> "
          f"{last['validation/fine_psnr']:.4f} / {last['validation/coarse_psnr']:.4f} dB, test "
          f"view 0 {ff['test']['psnr']:.4f} dB / SSIM {ff['test']['ssim']:.4f}, "
          f"{ff['train_s']:.2f} s of training, launches fwd {ff['launches']['fwd']} (+ "
          f"{ff['untrained_launches']} untrained, {ff['validate_launches']['fwd']} validation, "
          f"{ff['eval_launches']} eval), bwd {ff['launches']['bwd']}; quality_800 "
          f"{QUALITY_800_VIEW}^2 {q8['untrained']['psnr']:.4f} -> {q8['held_out']['psnr']:.4f} dB"
          f" / SSIM {q8['held_out']['ssim']:.4f}, {QUALITY_800_MESH}^3 mesh "
          f"{q8['mesh_vertices']} vertices at iso {q8['iso_effective']:.6g}, chamfer "
          f"{q8['chamfer_sq']:.6e} (RMS {q8['chamfer_rms']:.6f}), {q8['train_s']:.2f} s of "
          f"training, launches fwd {q8['launches']['fwd']} (+ {q8['eval_launches']} eval), bwd "
          f"{q8['launches']['bwd']}, sigma {q8['sigma_launches']} [{card}]")
    return {"kernel_width": kw, "blobs": blobs, "forward_facing": ff, "quality_800": q8,
            "seconds": seconds + new_seconds}


def hold_new_quality_runs(ff: dict, q8: dict) -> None:
    """The forward-facing and quality_800 cuts of quality_phase: exact
    launches (2 + 2 a train step; every forward-facing read the same
    forward launches a view: 3 views untrained, num_samples 2 at the one
    validation, 1 in the eval; one sigma launch a grid tile), falling
    losses, every PSNR finite and above the untrained read, a finite
    chamfer distance on a non-empty mesh."""
    steps = QUALITY_STEPS
    want = {"fwd": 2 * steps, "bwd": 2 * steps}
    for name, entry in (("forward-facing", ff), ("quality_800", q8)):
        if entry["steps"] != steps or entry["launches"] != want:
            raise AssertionError(f"{name}: {entry['steps']} steps, launches "
                                 f"{entry['launches']}; expected 2 + 2 a step")
    per_view = ff["eval_launches"]
    if not (per_view > 0 and ff["untrained_launches"] == 3 * per_view
            and ff["validate_launches"] == {"fwd": 2 * per_view, "bwd": 0}):
        raise AssertionError(f"forward-facing reads: untrained {ff['untrained_launches']}, "
                             f"validation {ff['validate_launches']}, eval {per_view} launches; "
                             "expected 3 : 2 : 1 views of forward launches")
    first, last = ff["untrained"], ff["validations"][str(steps)]
    if not last["validation/loss"] < first["validation/loss"]:
        raise AssertionError(f"forward-facing validation loss did not fall: "
                             f"{first['validation/loss']} -> {last['validation/loss']}")
    reads = [(f"validation {k}", first[f"validation/{k}_psnr"], last[f"validation/{k}_psnr"])
             for k in ("fine", "coarse")]
    reads.append(("test", first["validation/fine_psnr"], ff["test"]["psnr"]))
    reads += [(f"quality_800 view {i}", a, b) for i, (a, b) in enumerate(
        zip(q8["untrained"]["psnr_per_view"], q8["held_out"]["psnr_per_view"]))]
    for name, a, b in reads:
        if not (math.isfinite(b) and b > a):
            raise AssertionError(f"{name} PSNR {a} -> {b}")
    tiles = math.ceil(QUALITY_800_MESH ** 3 / GRID_TILE)
    if q8["sigma_launches"] != tiles:
        raise AssertionError(f"quality_800: {q8['sigma_launches']} sigma launches for {tiles} "
                             "grid tiles")
    if not (q8["mesh_vertices"] > 0 and math.isfinite(q8["chamfer_sq"])):
        raise AssertionError(f"quality_800: {q8['mesh_vertices']} vertices, chamfer "
                             f"{q8['chamfer_sq']}")


def jpeg_phase(card: str) -> dict:
    """The port's JPEG decoder (host C++, built with this host's g++) on
    every colour frame of data/hard_scannet/scene.sens: 1296x968 baseline
    4:2:0, as ScanNet stores its frames. Each frame's pixels must hash to
    digests.json's sha256 (PIL's decode where the stream was written; this
    host has no other decoder). Times are host times: ms per frame (median
    of 5 decodes of each frame) and MB/s of JPEG read."""
    import hashlib

    from nerfmeshes_tpu_torch.data.jpeg import decode_jpeg
    from nerfmeshes_tpu_torch.data.loaders.scannet import SensorData

    sens = SensorData(str(SCANNET / "scene.sens"))
    digests = json.loads((SCANNET / "digests.json").read_text())["frames"]
    if len(digests) != len(sens.frames):
        raise AssertionError(f"jpeg: {len(sens.frames)} frames, {len(digests)} digests")
    ms, nbytes = [], 0
    for frame, want in zip(sens.frames, digests):
        runs = []
        for _ in range(5):
            t0 = time.perf_counter()
            pixels = decode_jpeg(frame.color_data, f"frame {want['frame']}")
            runs.append(time.perf_counter() - t0)
        digest = hashlib.sha256(pixels.tobytes()).hexdigest()
        if list(pixels.shape) != want["shape"] or digest != want["sha256"]:
            raise AssertionError(f"jpeg: frame {want['frame']} {pixels.shape} sha256 {digest}, "
                                 f"digests.json {want['shape']} {want['sha256']}")
        ms.append(1e3 * statistics.median(runs))
        nbytes += len(frame.color_data)
    per_frame = statistics.median(ms)
    rate = nbytes / (sum(ms) / 1e3) / 1e6
    H, W = sens.color_height, sens.color_width
    print(f"jpeg: {len(ms)} frames {W}x{H} 4:2:0, digests equal digests.json; host decode "
          f"{per_frame:.4f} ms per frame (median; range {min(ms):.4f}-{max(ms):.4f}), "
          f"{rate:.4f} MB/s of JPEG, {H * W / per_frame / 1e3:.4f} Mpixel/s [{card}]")
    return {"frames": len(ms), "ms_per_frame": per_frame, "mb_per_s": rate,
            **jpeg_fixtures_phase(card)}


JPEG_FIXTURES = REPO / "tests" / "data" / "jpeg"


def jpeg_fixtures_phase(card: str) -> dict:
    """The decoder on the committed progressive (SOF2: PIL's and cv2's,
    4:2:0, 4:4:4, grey, restart intervals) and 4:1:1 (cv2's, baseline and
    progressive) fixtures of tests/data/jpeg/: each decode's pixels hash to
    digests.json's SHA-256 of imageio's (written where the fixtures were
    made). Then the 1296x968 progressive fixture's decode time beside the
    same pixels' baseline 4:2:0 file (the port's encoder's), median of 5
    each: host times."""
    import hashlib

    from nerfmeshes_tpu_torch.data.jpeg import decode_jpeg, encode_jpeg

    digests = json.loads((JPEG_FIXTURES / "digests.json").read_text())
    for name, want in sorted(digests.items()):
        pixels = decode_jpeg((JPEG_FIXTURES / name).read_bytes(), name)
        digest = hashlib.sha256(pixels.tobytes()).hexdigest()
        if list(pixels.shape) != want["shape"] or digest != want["sha256"]:
            raise AssertionError(f"jpeg fixture {name} ({want['frame']} {want['sampling']}): "
                                 f"{pixels.shape} sha256 {digest}, digests.json {want}")
    kinds = sorted({f"{d['frame']} {d['sampling'].split(',')[0]}" for d in digests.values()})
    print(f"jpeg fixtures: {len(digests)} files ({', '.join(kinds)}) hash to digests.json "
          f"[{card}]")

    def decode_ms(data: bytes) -> float:
        runs = []
        for _ in range(5):
            t0 = time.perf_counter()
            decode_jpeg(data)
            runs.append(time.perf_counter() - t0)
        return 1e3 * statistics.median(runs)

    progressive = (JPEG_FIXTURES / "prog_1296x968_pil.jpg").read_bytes()
    baseline = encode_jpeg(decode_jpeg(progressive))
    prog_ms, base_ms = decode_ms(progressive), decode_ms(baseline)
    print(f"jpeg decode 1296x968: progressive {prog_ms:.4f} ms ({len(progressive)} B), "
          f"baseline {base_ms:.4f} ms ({len(baseline)} B), host times [{card}]")
    return {"fixtures": len(digests), "progressive_ms": prog_ms, "baseline_ms": base_ms}


def export_color_phase(card: str) -> dict:
    """SensorData.export_color_images of data/hard_scannet/scene.sens: one
    `{f}.jpg` per frame, re-encoded by the port's g++-built encoder (the
    bytes imageio's writer gives, held to PIL's in the CPU tests). Each
    file decodes (the port's decoder) to its source frame within 30 dB
    PSNR at least; the seconds of the export and ms per 1296x968 encode
    (median of 5) are host times."""
    import os
    import tempfile

    from nerfmeshes_tpu_torch.data.jpeg import decode_jpeg, encode_jpeg
    from nerfmeshes_tpu_torch.data.loaders.scannet import SensorData

    sens = SensorData(str(SCANNET / "scene.sens"))
    n = len(sens.frames)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        sens.export_color_images(tmp)
        seconds = time.perf_counter() - t0
        names = sorted(os.listdir(tmp), key=lambda f: int(f.split(".")[0]))
        if names != [f"{f}.jpg" for f in range(n)]:
            raise AssertionError(f"export_color_images wrote {names}")
        psnrs, nbytes = [], 0
        for f in range(n):
            data = (Path(tmp) / f"{f}.jpg").read_bytes()
            nbytes += len(data)
            err = decode_jpeg(data).astype(np.float64) - sens.color_image(f)
            psnrs.append(10 * math.log10(255.0 ** 2 / max(float(np.mean(err ** 2)), 1e-12)))
    frame = sens.color_image(0)
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        encode_jpeg(frame)
        runs.append(time.perf_counter() - t0)
    ms = 1e3 * statistics.median(runs)
    H, W = frame.shape[:2]
    print(f"export_color_images: {n} frames {W}x{H} in {seconds:.4f} s ({nbytes / 1e6:.4f} MB); "
          f"PSNR against the source frames {min(psnrs):.4f}-{max(psnrs):.4f} dB; host encode "
          f"{ms:.4f} ms per frame (median of 5) [{card}]")
    if min(psnrs) < 30.0:
        raise AssertionError(f"export_color_images: PSNR {min(psnrs):.4f} dB below 30")
    return {"frames": n, "seconds": seconds, "encode_ms": ms, "min_psnr": min(psnrs)}


NORMALS_STEPS = 200
NORMALS_REDUCED = 3  # 400^2 -> 133^2: cv2 INTER_AREA at a fractional scale
NORMALS_RUN = ["experiment.validate_every", "100",
               "dataset.reduced_resolution", str(NORMALS_REDUCED)]


def normals_chain(card: str) -> dict:
    """configs/hard-blender.yml (2 x 8x256 fields through the kernels) at
    reduced_resolution 3 on a copy of data/hard_blender with an RGB
    `*_normal.png` beside every frame (written with the port's PNG writer:
    a smooth field of unit normals stored as (n + 1) / 2 * 255), with the
    split cache on: the three splits' build (PNG decode, the fractional
    INTER_AREA of targets and normals, the npz), 200 train steps through
    train_nerf validating every 100, then eval_nerf on the test split.
    Each leg's launches equal the code's prediction; the normals are in
    every bundle and in every split's npz at 133 x 133; the validation
    loss falls."""
    import tempfile

    from nerfmeshes_tpu_torch.cli import eval_nerf, train_nerf
    from nerfmeshes_tpu_torch.config import load_config
    from nerfmeshes_tpu_torch.data.blender import write_png
    from nerfmeshes_tpu_torch.data.blender_poses import png_size
    from nerfmeshes_tpu_torch.data.datasets import DatasetType, build_dataset

    out = {"legs": {}}
    leg = _checked_legs("normals", out, card)

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        scene = tmp / "hard_blender"
        t0 = time.perf_counter()
        shutil.copytree(REPO / "data" / "hard_blender", scene)
        counts = {}
        for split in ("train", "val", "test"):
            frames = json.loads((scene / f"transforms_{split}.json").read_text())["frames"]
            counts[split] = len(frames)
            for i, frame in enumerate(frames):
                stem = scene / frame["file_path"]
                H, W = png_size(stem.with_suffix(".png"))
                yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
                n = np.stack([np.sin(xx / 57.0 + i), np.cos(yy / 43.0), np.ones_like(xx)], -1)
                n /= np.linalg.norm(n, axis=-1, keepdims=True)
                write_png(Path(f"{stem}_normal.png"), ((n + 1) * 127.5).astype(np.uint8))
        print(f"normals: {sum(counts.values())} normal maps written in "
              f"{time.perf_counter() - t0:.4f} s [{card}]")
        cache = tmp / "cache"
        opts = ["experiment.logdir", str(tmp / "logs"), "dataset.basedir", str(scene),
                "dataset.caching.use_caching", "true", "dataset.caching.cache_dir", str(cache),
                *NORMALS_RUN]
        cfg = load_config(str(REPO / "configs" / "hard-blender.yml"), opts)
        splits = leg("splits", lambda: {t: build_dataset(cfg, t) for t in DatasetType}, {})
        side = 400 // NORMALS_REDUCED
        for t, ds in splits.items():
            shape = tuple(ds.bundle.target_normals.shape)
            with np.load(cache / f"{t.value}.npz") as data:
                cached = tuple(data["target_normals"].shape)
            print(f"normals {t.value}: bundle target_normals {shape}, npz {cached}, targets "
                  f"{tuple(ds.bundle.ray_targets.shape)} [{card}]")
            if not (shape == cached == (counts[t.value], side, side, 3)):
                raise AssertionError(f"normals {t.value}: {shape} in the bundle, {cached} cached")
        del splits

        chunk = int(cfg.nerf.validation.chunksize)
        view = 2 * math.ceil(side * side / chunk)
        vals = _validations(cfg, 0, NORMALS_STEPS) * int(cfg.nerf.validation.num_samples)
        argv = ["--config", str(REPO / "configs" / "hard-blender.yml"), "--override",
                "experiment.train_iters", str(NORMALS_STEPS), *opts]
        system = leg("train", lambda: train_nerf.main(argv),
                     {"fwd": 2 * NORMALS_STEPS + vals * view, "bwd": 2 * NORMALS_STEPS})
        run = system.paths.log_dir
        del system
        records = [json.loads(line) for line in (run / "events" / "metrics.jsonl").open()]
        val = {r["step"]: r["validation/loss"] for r in records if "validation/loss" in r}
        train_loss = {r["step"]: r["train/loss"] for r in records if "train/loss" in r}
        print(f"normals train: train/loss by step {train_loss}; validation/loss by step {val} "
              f"[{card}]")
        if not (all(math.isfinite(v) for v in val.values()) and val[max(val)] < val[min(val)]):
            raise AssertionError(f"normals: validation loss not finite and falling: {val}")
        result = leg("eval", lambda: eval_nerf.main(["--log-checkpoint", str(run)]),
                     {"fwd": counts["test"] * view})
        print(f"normals eval: {counts['test']} test views {side}x{side}: psnr "
              f"{result['psnr']:.4f} ssim {result['ssim']:.4f} mse {result['mse']:.6f} [{card}]")
    out.update(val_losses=val, eval=result)
    return out


def _surface_ray_leg(name: str, run: Path, tmp: Path, leg, card: str) -> int:
    """surface_ray's CLI on the chain's run: the default 8 x 4 orbit of
    SURFACE_SIZE^2 views at the run's own focal, 2 forward launches per
    validation chunk of every view. The PLY reads back with the CLI's
    points, which are finite, at least one, with unit normals and colours
    in [0, 1]. Returns the point count."""
    from nerfmeshes_tpu_torch.cli import surface_ray
    from nerfmeshes_tpu_torch.config.paths import load_hparams
    from nerfmeshes_tpu_torch.mesh.export import read_ply_binary

    chunk = int(load_hparams(run).nerf.validation.chunksize)
    path = tmp / "surface" / "points.ply"
    points, normals, colors = leg(
        "surface_ray",
        lambda: surface_ray.main(["--log-checkpoint", str(run), "--img-size", str(SURFACE_SIZE),
                                  "--focal", "0", "--save-path", str(path)]),
        {"fwd": 2 * SURFACE_VIEWS * math.ceil(SURFACE_SIZE ** 2 / chunk)})
    back, _, back_normals, back_colors = read_ply_binary(str(path))
    lengths = np.linalg.norm(back_normals, axis=1) if len(back) else np.ones(1)
    print(f"{name} surface_ray: {len(points)} points from {SURFACE_VIEWS} views "
          f"{SURFACE_SIZE}x{SURFACE_SIZE}; normal lengths in [{lengths.min():.6f}, "
          f"{lengths.max():.6f}] [{card}]")
    if len(points) == 0 or not np.array_equal(back, points):
        raise AssertionError(f"{name} surface_ray: {len(points)} points, the PLY holds "
                             f"{len(back)}")
    if not (np.isfinite(back).all() and np.abs(lengths - 1.0).max() < 1e-3):
        raise AssertionError(f"{name} surface_ray: non-finite points or normals off unit length")
    if not np.array_equal(back_colors, np.round(colors * 255.0).astype(np.uint8)):
        raise AssertionError(f"{name} surface_ray: the PLY's colours differ from the CLI's")
    return len(points)


SYNTHESIS_VIEWS = 120  # the orbit of data/helpers.py:synthesis_poses


def _synthesis_leg(name: str, run: Path, tmp: Path, leg, want: dict, hw, card: str) -> dict:
    """eval_nerf --synthesis-video on the chain's run: the 120 orbit views
    at the test split's size, each through the forward kernel as a test
    view is (`want`: 120 x the per-view count), written as one GIF by the
    port's g++-built writer. The file's blocks are walked without a
    decoder (the card host has none): the header at the view size, 120
    image descriptors over the whole screen, a delay of 4 hundredths on
    each (imageio reads 42 ms as 40), the NETSCAPE loop count 0, the
    trailer. Returns the render and writer seconds and the file's MB."""
    from nerfmeshes_tpu_torch.cli import eval_nerf
    from nerfmeshes_tpu_torch.data import gif

    path = tmp / "synthesis" / "orbit.gif"
    with _CallTimer(gif, ("write_gif",)) as writer:
        leg("synthesis", lambda: eval_nerf.main(["--log-checkpoint", str(run),
                                                 "--synthesis-video", str(path)]), want)
    summary = gif.gif_summary(path.read_bytes())
    H, W = hw
    ok = (summary["width"], summary["height"]) == (W, H) and summary["trailer"] \
        and summary["frames"] == [(0, 0, W, H)] * SYNTHESIS_VIEWS \
        and summary["delays"] == [4] * SYNTHESIS_VIEWS and summary["loop"] == 0
    mb = path.stat().st_size / 1e6
    print(f"{name} synthesis: {len(summary['frames'])} frames {W}x{H}, delays "
          f"{sorted(set(summary['delays']))} cs, loop {summary['loop']}, trailer "
          f"{summary['trailer']}; GIF writer {writer.seconds:.4f} s ({writer.calls} call), "
          f"{mb:.4f} MB [{card}]")
    if not ok or writer.calls != 1:
        raise AssertionError(f"{name} synthesis: the GIF's blocks are not the orbit's: "
                             f"{ {k: v for k, v in summary.items() if k != 'frames'} }, "
                             f"{len(summary['frames'])} frames, {writer.calls} writes")
    return {"writer_s": writer.seconds, "mb": mb}


# -- data parallelism (parallel/mesh.py) ------------------------------------------

DIST_STEPS = 30  # timed steps a run on the forced one-rank group
DIST_ROUNDS = 3  # rounds of unforced, forced, forced, unforced runs
DIST_WORLD = 2  # gloo ranks sharing the card
DIST_BAR = 1e-4  # reduced grads against one process's: of max |grad|
DIST_MEMM_BAR = 1e-5  # memm against one process's


def _dist_cfg(buff: bool):
    """The train settings of the dist phase, made deterministic (perturb
    off, sigma noise 0) so that sharded and one-process steps sample the
    same depths; BuFF integrates from step 0."""
    cfg = buff_hard_cfg() if buff else hard_blender_cfg()
    cfg.nerf.train.perturb = False
    cfg.nerf.train.radiance_field_noise_std = 0.0
    if buff:
        cfg.tree.step_size_integration_offset = 0
    return cfg


def _dist_batch(cfg, device):
    """The injected batch: num_random_rays camera rays of the lego scene
    and random targets, made from SEED (the same on every rank)."""
    rng = np.random.default_rng(SEED)
    o, d, _ = _rays(int(cfg.nerf.train.num_random_rays), 1, rng, device)
    t = torch.from_numpy(rng.uniform(0.0, 1.0, (o.shape[0], 3)).astype(np.float32))
    return o, d, t.to(device)


def _dist_state(cfg, device):
    """Models, optimizer and train state from SEED, as NeRFSystem makes them."""
    from nerfmeshes_tpu_torch.train.optim import build_optimizer
    from nerfmeshes_tpu_torch.train.step import init_train_state
    from nerfmeshes_tpu_torch.train.system import create_models, init_params

    coarse, fine = create_models(cfg)
    init_params(coarse, fine, torch.Generator().manual_seed(SEED))
    models = [m for m in (coarse, fine) if m is not None]
    for m in models:
        m.to(device)
    opt = build_optimizer([p for m in models for p in m.parameters()], cfg)
    return init_train_state(coarse, fine, opt, SEED, device)


def _dist_step_fn(cfg, group, buff: bool):
    from nerfmeshes_tpu_torch.buff.system import make_buff_train_step
    from nerfmeshes_tpu_torch.train.step import make_train_step

    make = make_buff_train_step if buff else make_train_step
    return make(cfg, H=1, W=1, focal=1.0, steps_per_call=1, group=group)


def _dist_step(cfg, batch, group, buff: bool, rows=slice(None)):
    """One train step on `batch`'s `rows`: (the grads the optimizer got,
    one flat f32 tensor; memm after the step, or None)."""
    from nerfmeshes_tpu_torch.buff.tree import TreeSampling

    state = _dist_state(cfg, batch[0].device)
    seen = []
    step = state.optimizer.step

    def spying():
        seen.append(torch.cat([p.grad.reshape(-1) for p in state.optimizer.params]).clone())
        step()

    state.optimizer.step = spying
    fn = _dist_step_fn(cfg, group, buff)
    rays = (*(a[rows] for a in batch), 2.0, 6.0, None)
    if buff:
        tree_state = TreeSampling(cfg).device_state(batch[0].device)
        _, tree_state, _ = fn(state, tree_state, None, rays=rays)
        return seen[0], tree_state.memm.clone()
    fn(state, None, rays=rays)
    return seen[0], None


def _dist_steps_ms(cfg, batch, group, buff: bool, steps: int = DIST_STEPS) -> float:
    """Host ms per train step over `steps` calls on the injected batch
    after 3 warm-ups, synchronised (the settings' own draws and all)."""
    from nerfmeshes_tpu_torch.buff.tree import TreeSampling

    state = _dist_state(cfg, batch[0].device)
    fn = _dist_step_fn(cfg, group, buff)
    rays = (*batch, 2.0, 6.0, None)
    tree = [TreeSampling(cfg).device_state(batch[0].device)] if buff else None

    def call():
        if buff:
            _, tree[0], _ = fn(state, tree[0], None, rays=rays)
        else:
            fn(state, None, rays=rays)

    for _ in range(3):
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        call()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / want.abs().max())


def dist_forced_phase(card: str, device) -> dict:
    """World size 1 under NCCL, forced: the sharded step bodies and their
    collectives on a one-rank group. The hierarchical and the BuFF step on
    an injected batch give grads and memm bitwise equal to the unforced
    steps'; runs of DIST_STEPS steps are timed in DIST_ROUNDS rounds of
    unforced, forced, forced, unforced; the flat grad all-reduce is timed
    alone, a call and back to back."""
    import torch.distributed as dist

    from nerfmeshes_tpu_torch.parallel import mesh as pm
    from nerfmeshes_tpu_torch.train.step import all_mean_grads

    group = pm.forced(device)
    out = {}
    for name, buff in (("train", False), ("buff_train", True)):
        cfg = _dist_cfg(buff)
        batch = _dist_batch(cfg, device)
        # index_add_ (integrate) sums with float atomics unless asked not to.
        torch.use_deterministic_algorithms(True, warn_only=True)
        g_un, m_un = _dist_step(cfg, batch, None, buff)
        g_fo, m_fo = _dist_step(cfg, batch, group, buff)
        torch.use_deterministic_algorithms(False)
        same = torch.equal(g_un, g_fo) and (m_un is None or torch.equal(m_un, m_fo))
        print(f"dist forced {name}: NCCL one-rank group vs no group on one injected batch of "
              f"{batch[0].shape[0]} rays: {g_un.numel()} grads bitwise equal "
              f"{torch.equal(g_un, g_fo)}"
              + ("" if m_un is None else f", memm bitwise equal {torch.equal(m_un, m_fo)}"))
        if not same:
            raise AssertionError(f"the forced {name} step differs from the unforced one")
        timed = buff_hard_cfg() if buff else hard_blender_cfg()
        ms = {"unforced": [], "forced": []}
        for _ in range(DIST_ROUNDS):
            for label in ("unforced", "forced", "forced", "unforced"):
                ms[label].append(_dist_steps_ms(timed, batch,
                                                group if label == "forced" else None, buff))
        un, fo = statistics.median(ms["unforced"]), statistics.median(ms["forced"])
        print(f"dist forced {name}: {DIST_ROUNDS} rounds of unforced, forced, forced, unforced "
              f"runs of {DIST_STEPS} steps; ms a step, median (min-max): unforced {un:.4f} "
              f"({min(ms['unforced']):.4f}-{max(ms['unforced']):.4f}), forced {fo:.4f} "
              f"({min(ms['forced']):.4f}-{max(ms['forced']):.4f}) (NCCL one-rank group); "
              f"the collective path {fo - un:+.4f} ms a step ({100.0 * (fo - un) / un:+.2f}%) "
              f"[{card}]")
        out[name] = dict(unforced_ms=un, forced_ms=fo, grads=g_un.numel())

    # The flat grad bucket of the hierarchical step: all_reduce alone, and
    # all_mean_grads (concatenation, all_reduce, views) as the step runs it.
    state = _dist_state(hard_blender_cfg(), device)
    params = state.optimizer.params
    for p in params:
        p.grad = torch.randn_like(p)
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    reduce_ms = _median_ms(lambda: pm.all_mean_(flat, group), runs=21)
    bucket_ms = _median_ms(lambda: all_mean_grads(params, group), runs=21)
    reduce_b2b = _back_to_back_ms(lambda: pm.all_mean_(flat, group))
    bucket_b2b = _back_to_back_ms(lambda: all_mean_grads(params, group))
    nbytes = flat.numel() * 4
    print(f"dist grad all-reduce (NCCL, one rank): {flat.numel()} f32 grads, {nbytes} bytes; "
          f"all_reduce + div {reduce_ms:.4f} ms a call (CUDA events, median of 21), "
          f"{reduce_b2b:.4f} ms back to back; all_mean_grads (cat + all_reduce + div + views) "
          f"{bucket_ms:.4f} ms a call, {bucket_b2b:.4f} ms back to back [{card}]")
    out["allreduce"] = dict(bytes=nbytes, ms=reduce_ms, bucket_ms=bucket_ms,
                            b2b_ms=reduce_b2b, bucket_b2b_ms=bucket_b2b)
    dist.destroy_process_group()
    return out


def _dist_rank(group, out_dir: str) -> None:
    """One of the ranks sharing the card under gloo: the checks of
    dist_phase, each sharded run between launch counters set to 0 and
    read, beside this rank's one-process reference; writes
    rank<r>.json."""
    from nerfmeshes_tpu_torch.data.blender_poses import read_blender_poses
    from nerfmeshes_tpu_torch.mesh.extract import _grid_tiles
    from nerfmeshes_tpu_torch.ops.kernels import build
    from nerfmeshes_tpu_torch.ops.kernels import chords as ch
    from nerfmeshes_tpu_torch.ops.kernels import fused_mlp as fm
    from nerfmeshes_tpu_torch.parallel.mesh import gather_rows
    from nerfmeshes_tpu_torch.train.step import make_pose_rays
    from nerfmeshes_tpu_torch.train.system import NeRFSystem

    torch.backends.cuda.matmul.allow_tf32 = False
    build.load_library()  # built by the parent
    device = group.device
    out = {"rank": group.rank, "world": group.world, "backend": group.backend}

    def counts():
        return {"fwd": fm.launches, "bwd": fm.bwd_launches, "sigma": fm.sigma_launches,
                "chords": ch.launches}

    def reset():
        fm.launches = fm.bwd_launches = fm.sigma_launches = ch.launches = 0

    # gloo on CUDA tensors: the zero-buffer all_reduce is the gather.
    mine = torch.arange(6, dtype=torch.float32, device=device).reshape(3, 2) + 100 * group.rank
    got = gather_rows([mine], group)[0]
    want = torch.cat([torch.arange(6, dtype=torch.float32, device=device).reshape(3, 2)
                      + 100 * r for r in range(group.world)])
    out["gather_exact"] = bool(torch.equal(got, want))

    for name, buff in (("train", False), ("buff_train", True)):
        cfg = _dist_cfg(buff)
        batch = _dist_batch(cfg, device)
        rows = group.local_rows(batch[0].shape[0])
        reset()
        g_sh, m_sh = _dist_step(cfg, batch, group, buff, rows)
        torch.cuda.synchronize()
        out[f"{name}_launches"] = counts()
        g_one, m_one = _dist_step(cfg, batch, None, buff)
        out[f"{name}_grad_err"] = _rel_err(g_sh, g_one)
        out[f"{name}_local_rays"] = rows.stop - rows.start
        if m_sh is not None:
            out[f"{name}_memm_err"] = float((m_sh - m_one).abs().max())
            out[f"{name}_memm_max"] = float(m_one.abs().max())

    # A 400x400 view of data/hard_blender through the sharded render.
    cfg = _lego_bf16_cfg()
    sharded = NeRFSystem(cfg, group=group).setup_eval()
    single = NeRFSystem(cfg, device=device).setup_eval()
    poses, H, W, focal = read_blender_poses(REPO / "data" / "hard_blender", "test")
    o, d = make_pose_rays(H, W, focal, device=device)(poses[0])
    fields = ("rgb_map", "depth_map", "acc_map")
    near, far = float(cfg.dataset.near), float(cfg.dataset.far)
    sharded.query_rays(o[:2048], d[:2048], near, far, fields=fields, as_numpy=False)
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    view = sharded.query_rays(o, d, near, far, fields=fields, as_numpy=False)
    torch.cuda.synchronize()
    out["render_s"] = time.perf_counter() - t0
    out["render_launches"] = counts()
    ref = single.query_rays(o, d, near, far, fields=fields, as_numpy=False)
    out["render_bitwise"] = all(torch.equal(getattr(view, f), getattr(ref, f)) for f in fields)
    out["render_max_diff"] = max(float((getattr(view, f) - getattr(ref, f)).abs().max())
                                 for f in fields)
    out["render_rays"] = H * W
    out["render_chunk"] = int(cfg.nerf.validation.chunksize)

    # The 480^3 sigma grid of the same field, sharded, against one rank's.
    reset()
    t0 = time.perf_counter()
    grid = _grid_tiles(sharded.density_points, MESH_LIMIT, (MESH_RES,) * 3, GRID_TILE, device,
                       torch.float32, group=group)
    torch.cuda.synchronize()
    out["grid_s"] = time.perf_counter() - t0
    out["grid_launches"] = counts()
    ref = _grid_tiles(single.density_points, MESH_LIMIT, (MESH_RES,) * 3, GRID_TILE, device,
                      torch.float32)
    out["grid_bitwise"] = bool(torch.equal(grid, ref))
    out["grid_max_diff"] = float((grid - ref).abs().max())
    Path(out_dir, f"rank{group.rank}.json").write_text(json.dumps(out))


def per_rank_chords_ms(device) -> float:
    """The chord kernel's device ms (torch.profiler, _kernel_device_ms) at
    the shape one of DIST_WORLD ranks gives it: 2048 // DIST_WORLD BuFF
    rays of _chord_inputs on the initial tree, K = 64."""
    from nerfmeshes_tpu_torch.ops.kernels import chords as ch

    inputs = _chord_inputs(device)
    initial = inputs["initial"]
    R = 2048 // DIST_WORLD
    o1, d1 = inputs["o"][:R].contiguous(), inputs["d"][:R].contiguous()
    return _kernel_device_ms(lambda: ch.compact_chords_cuda(initial.voxels, initial.active, o1,
                                                            d1, 2.0, 6.0, K=64), "chords")


def _per_rank_kernel_rows(card: str, device, rows_2048: dict, chords_ms: float) -> dict:
    """Each kernel alone on the card at the shape one of DIST_WORLD ranks
    gives it (1024 x 64 and 1024 x 192 forward, 1024 x 192 backward, 1024
    BuFF rays of chords, 131,072 grid points of sigma), timed by CUDA
    events (median of 7; chords: `chords_ms`, per_rank_chords_ms in the
    breakdowns' process), beside its bound, its library yardstick (the
    nn.Module under bf16 autocast, as the one-rank rows time it; none for
    chords) and the one-rank row of this call at 2048 rays or 262,144
    points."""
    from nerfmeshes_tpu_torch.models import build_model
    from nerfmeshes_tpu_torch.ops.kernels import fused_mlp as fm
    from nerfmeshes_tpu_torch.train.system import init_params

    cfg = _lego_bf16_cfg()
    model = build_model(cfg.models.fine_type, dict(cfg.models.fine), compute_dtype=torch.bfloat16)
    init_params(model, None, torch.Generator().manual_seed(SEED))
    model.to(device).eval()
    packed = fm.pack_weights(model)
    rng = np.random.default_rng(SEED)
    R = 2048 // DIST_WORLD
    rows = {}

    def points(o, d, z):
        S = z.shape[1]
        pts = (o[:, None, :] + d[:, None, :] * z[..., None]).reshape(-1, 3)
        return pts, d[:, None, :].expand(len(o), S, 3).reshape(-1, 3)

    # Library yardsticks as the one-rank rows time them: the nn.Module under
    # bf16 autocast at the same points (forward, sigma), and with autograd
    # for the same cotangent (backward).
    for S in (64, 192):
        o, d, z = _rays(R, S, rng, device)
        ms = _median_ms(lambda: fm.fused_mlp_cuda(packed, o, d, z))
        pts, dirs = points(o, d, z)
        with torch.inference_mode():
            library = _median_ms(_autocast(lambda: model(pts, dirs)))
        rows[f"fused_mlp_fwd {R}x{S}"] = (ms, *_fwd_bound(model, packed, R, S), library)
    cot = torch.from_numpy(rng.standard_normal((4, R, 192)).astype(np.float32)).to(device)
    ms = _median_ms(lambda: fm.fused_mlp_bwd_cuda(packed, o, d, z, cot))
    pts, dirs = points(o, d, z)
    cot_points = cot.reshape(4, -1).t().contiguous()

    def module_grads():
        for p in model.parameters():
            p.grad = None
        model(pts, dirs).float().backward(cot_points)

    library = _median_ms(_autocast(module_grads))
    for p in model.parameters():
        p.grad = None
    rows[f"fused_mlp_bwd {R}x192"] = (ms, *_bwd_bound(model, packed, R, 192), library)
    n = GRID_TILE // DIST_WORLD
    pts = torch.from_numpy(rng.uniform(-MESH_LIMIT, MESH_LIMIT, (n, 3)).astype(np.float32))
    pts = pts.to(device)
    ms = _median_ms(lambda: fm.fused_sigma_cuda(packed, pts))
    nbytes = n * 16 + packed.weights.numel() * 2 + packed.biases.numel() * 4
    zeros = torch.zeros_like(pts)
    with torch.inference_mode():
        library = _median_ms(_autocast(lambda: model(pts, zeros)))
    rows[f"fused_sigma {n}"] = (ms, *_bound_ms(_field_flops(model, heads=False) * n, nbytes,
                                               PEAK_BF16), library)
    initial = _chord_inputs(device)["initial"]
    rows[f"fused_chords {R} rays"] = (chords_ms, *_chord_bound(
        R, initial.voxels.shape[0], int(initial.active.sum()), 64), None)
    for name, (ms, bound, by, library) in rows.items():
        kernel = name.split()[0]
        whole = rows_2048.get(kernel)
        beside = ("" if whole is None else
                  f"; one rank's row: {whole['ms']:.4f} ms, bound {whole['bound_ms']:.4f} ms")
        lib = "" if library is None else f", library (nn.Module, bf16 autocast) {library:.4f} ms"
        print(f"dist per-rank {name}: {ms:.4f} ms, bound {bound:.4f} ms ({by}), "
              f"{100.0 * bound / ms:.1f}% of the bound{lib}{beside} [{card}]")
    return {k: dict(ms=v[0], bound_ms=v[1], bound_by=v[2], library_ms=v[3])
            for k, v in rows.items()}


def _lego_bf16_cfg():
    """get_default_cfg()'s lego field in bf16 through the fused kernels."""
    from nerfmeshes_tpu_torch.config import get_default_cfg

    cfg = get_default_cfg()
    cfg.experiment.compute_dtype = "bfloat16"
    cfg.experiment.use_fused_kernel = True
    return cfg


def check_dist_ranks(ranks: list, card: str, device) -> dict:
    """Print and hold each rank's record of _dist_rank to dist_phase's bars
    and to the launches the code makes per rank; returns those counts by
    path."""
    chunks = math.ceil(ranks[0]["render_rays"] / ranks[0]["render_chunk"])
    tiles = math.ceil(MESH_RES ** 3 / GRID_TILE)
    want = {"train": {"fwd": 2, "bwd": 2, "sigma": 0, "chords": 0},
            "buff_train": {"fwd": 1, "bwd": 1, "sigma": 0, "chords": 1},
            "render": {"fwd": 2 * chunks, "bwd": 0, "sigma": 0, "chords": 0},
            "grid": {"fwd": 0, "bwd": 0, "sigma": tiles, "chords": 0}}
    for r in ranks:
        tag = f"dist rank {r['rank']} of {r['world']} ({r['backend']}, {device})"
        print(f"{tag}: gather exact {r['gather_exact']}; train grads worst rel err "
              f"{r['train_grad_err']:.3e}, BuFF grads {r['buff_train_grad_err']:.3e} (bar "
              f"{DIST_BAR}), BuFF memm max abs diff {r['buff_train_memm_err']:.3e} of max "
              f"{r['buff_train_memm_max']:.3e} (bar {DIST_MEMM_BAR}); {r['train_local_rays']} "
              f"rays a rank; 400x400 view bitwise {r['render_bitwise']} (max diff "
              f"{r['render_max_diff']:.3e}) in {r['render_s']:.4f} s; 480^3 grid bitwise "
              f"{r['grid_bitwise']} (max diff {r['grid_max_diff']:.3e}) in {r['grid_s']:.4f} s; "
              f"launches " + ", ".join(f"{p} {r[p + '_launches']}" for p in want) + f" [{card}]")
        if not r["gather_exact"]:
            raise AssertionError("gloo's zero-buffer all_reduce is not the gather")
        for path in ("train", "buff_train"):
            if not r[f"{path}_grad_err"] <= DIST_BAR:
                raise AssertionError(f"rank {r['rank']}: {path} grads off by "
                                     f"{r[f'{path}_grad_err']}")
        if not r["buff_train_memm_err"] <= DIST_MEMM_BAR:
            raise AssertionError(f"rank {r['rank']}: BuFF memm off by {r['buff_train_memm_err']}")
        if not (r["render_bitwise"] and r["grid_bitwise"]):
            raise AssertionError(f"rank {r['rank']}: sharded render or grid not bit-equal")
        for path, counts in want.items():
            if r[f"{path}_launches"] != counts:
                raise AssertionError(f"rank {r['rank']}: {path} launches "
                                     f"{r[f'{path}_launches']}, expected {counts}")
    return want


def dist_phase(card: str, device, rows_2048: dict, chords_ms: float) -> dict:
    """Data parallelism on the card (parallel/mesh.py): the forced NCCL
    one-rank phase (dist_forced_phase), then DIST_WORLD ranks sharing the
    card under gloo (_dist_rank), each on its half of the same injected
    batch: the reduced grads of a hierarchical and a BuFF step against
    one process's on the whole batch (within DIST_BAR of max |grad|), the
    BuFF memm (within DIST_MEMM_BAR), a 400x400 view through the sharded
    render and the 480^3 sharded sigma grid against one rank's (bit for
    bit), each rank's launches against the code's count; then the kernels
    alone at the per-rank shapes (the chord kernel's time `chords_ms`,
    traced in the breakdowns' process). Returns rank 0's launches by path and
    the numbers printed."""
    from nerfmeshes_tpu_torch.parallel.mesh import launch

    forced = dist_forced_phase(card, device)
    # The ranks share the card with this process: hand back what the
    # earlier phases left in the caching allocator.
    gc.collect()
    torch.cuda.empty_cache()
    print(f"dist: this process holds {torch.cuda.memory_reserved() / 2**30:.2f} GiB of the "
          f"card ({torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated) before the ranks "
          f"start [{card}]")
    out_dir = REPO / "build" / "dist_phase"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    t0 = time.perf_counter()
    launch(_dist_rank, DIST_WORLD, torch.device("cuda", torch.cuda.current_device()),
           backend="gloo", args=(str(out_dir),))
    seconds = time.perf_counter() - t0
    ranks = [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(DIST_WORLD)]
    want = check_dist_ranks(ranks, card, device)
    print(f"dist: {DIST_WORLD} gloo ranks on one card, spawned, checked and joined in "
          f"{seconds:.2f} s [{card}]")
    per_rank = _per_rank_kernel_rows(card, device, rows_2048, chords_ms)
    launches = {k: {f"dist_{path}": ranks[0][f"{path}_launches"][k] for path in want
                    if ranks[0][f"{path}_launches"][k]} for k in KERNELS}
    return dict(forced=forced, per_rank=per_rank, launches=launches, seconds=seconds)


def profile_buff(card: str, device, steps: int = 5) -> None:
    """The BuFF train step breakdown of PERF.md section 5 (--profile-buff):
    buff_hard_cfg() trained past its first consolidation (integration on),
    then `steps` steps under torch.profiler (_profile_steps)."""
    from nerfmeshes_tpu_torch.data.blender import train_arrays

    cfg = buff_hard_cfg()
    system = _buff_system(device).setup(train_arrays(cfg, device))
    system.fit(BUFF_CONSOLIDATIONS[0] + 5)
    _profile_steps(system, "profile buff", card, steps)


def profile_train(card: str, device, steps: int = 5) -> None:
    """The hierarchical train step breakdown of PERF.md section 5
    (--profile-train): the hard-blender system after its warm-up steps,
    then `steps` steps under torch.profiler (_profile_steps)."""
    from nerfmeshes_tpu_torch.data.blender import train_arrays
    from nerfmeshes_tpu_torch.train.system import NeRFSystem

    cfg = hard_blender_cfg()
    system = NeRFSystem(cfg, device=device).setup(train_arrays(cfg, device))
    system.fit(WARMUP_STEPS)
    _profile_steps(system, "profile train", card, steps)


def _profile_steps(system, label: str, card: str, steps: int) -> None:
    """`steps` train steps of `system` under torch.profiler: device time by
    kernel, the device's idle share over the steps' span, the host's time
    to enqueue the steps against the device's, and the host's CUDA calls."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

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
    print(f"{label}: {steps} steps, {span / steps:.3f} ms per step of device span, "
          f"kernels {total:.3f} ms in {len(kernels)} launches, device idle "
          f"{100.0 * (1.0 - busy / span):.2f}%, host enqueue {enqueued * 1e3:.3f} ms "
          f"({100.0 * enqueued * 1e3 / span:.1f}% of the device span), wall "
          f"{wall * 1e3:.3f} ms; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB [{card}]")
    shares = {group: sum(t for n, t in by_name.items() if any(k in n for k in keys))
              for group, keys in PROFILE_GROUPS.items()}
    shares["everything else"] = total - sum(shares.values())
    for group, t in shares.items():
        print(f"{label}: {group} {t:.3f} ms, {100.0 * t / total:.2f}% of kernel time")
    for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"{label} kernel: {t / steps:.4f} ms per step  {name[:110]}")
    # Where the host's time goes: the CUDA runtime and driver calls (a
    # synchronising call shows as one long wait per step).
    calls: dict = {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            n, t = calls.get(e["name"], (0, 0.0))
            calls[e["name"]] = (n + 1, t + e.get("dur", 0) / 1e3)
    for name, (n, t) in sorted(calls.items(), key=lambda kv: -kv[1][1])[:8]:
        print(f"{label} host call: {name} x{n}, {t:.3f} ms")
    ops = sum(1 for e in events if e.get("cat") == "cpu_op")
    print(f"{label}: {ops / steps:.0f} torch ops dispatched per step")


def profile_render(card: str, device, views: int = 2) -> None:
    """The hierarchical render breakdown of PERF.md section 5
    (--profile-render): the render phase's system renders `views` 400x400
    views through query_rays under torch.profiler, after one warm-up chunk:
    the host's time to enqueue them against the device's span, the
    device's idle share, and device time by kernel."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from nerfmeshes_tpu_torch.config import get_default_cfg
    from nerfmeshes_tpu_torch.data.blender_poses import read_blender_poses
    from nerfmeshes_tpu_torch.train.step import make_pose_rays
    from nerfmeshes_tpu_torch.train.system import NeRFSystem

    cfg = get_default_cfg()
    cfg.experiment.compute_dtype = "bfloat16"
    cfg.experiment.use_fused_kernel = True
    system = NeRFSystem(cfg, device=device).setup_eval()
    poses, H, W, focal = read_blender_poses(REPO / "data" / "hard_blender", "test")
    pose_rays = make_pose_rays(H, W, focal, device=device)
    near, far = float(cfg.dataset.near), float(cfg.dataset.far)
    fields = ("rgb_map", "depth_map", "acc_map")
    rays = [pose_rays(poses[v]) for v in range(views)]
    chunk = int(cfg.nerf.validation.chunksize)
    system.query_rays(rays[0][0][:chunk], rays[0][1][:chunk], near, far, fields=fields,
                      as_numpy=False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for o, d in rays:
            system.query_rays(o, d, near, far, fields=fields, as_numpy=False)
        enqueued = time.perf_counter() - t0
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        trace = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text())["traceEvents"]
    kernels = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
               if e.get("cat") == "kernel"]
    span = (max(e for _, _, e in kernels) - min(s for _, s, _ in kernels)) / 1e3
    busy = _busy_ms([(s, e) for _, s, e in kernels])
    fwd = sum(e - s for n, s, e in kernels if "fused_mlp_fwd_kernel" in n) / 1e3
    total = sum(e - s for _, s, e in kernels) / 1e3
    print(f"profile render: {views} views, {len(kernels)} kernel launches, device span "
          f"{span:.3f} ms, kernels {total:.3f} ms (forward kernel {fwd:.3f} ms, "
          f"{100.0 * fwd / total:.2f}%), device idle {100.0 * (1.0 - busy / span):.2f}%; host "
          f"enqueue {enqueued * 1e3:.3f} ms ({100.0 * enqueued * 1e3 / span:.1f}% of the device "
          f"span), wall {wall * 1e3:.3f} ms [{card}]")


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


def _kernel_entry(name, source, replaces, phase, by_path, **extra) -> dict:
    """A kernel's entry of the kernels line: its launches by path and
    summed, and the phase's error, times, bound and library time."""
    return {"name": name, "route": "cuda", "source": f"nerfmeshes_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path, "max_abs_err": phase["max_abs_err"],
            "ms": phase["ms"], "plain_ms": phase["plain_ms"], "bound_ms": phase["bound_ms"],
            "bound_by": phase["bound_by"], "library_ms": phase["library_ms"], **extra}


def wide_and_layer_rows(wide: dict, layers: dict) -> tuple[list, dict, list]:
    """The kernels line's entries of wide_phase and layers_phase: (the
    fused rows at the widths whose chain takes the fused route, the fused
    instantiations called directly off the path by kernel ("fwd", "bwd",
    "sigma"), the layer route's rows: its calls, its product kernel, its
    backward heads kernel, bias-grad reduction and dW leg, its PE
    kernel)."""
    # The wide rows (wide_phase): at 384, on the fused route, each
    # instantiation with its launches on its width's path, every train step
    # and appearance chunk one coarse (S = 64) and one fine (S = 192)
    # launch. From 512 on the chains take the layer route (its rows below)
    # and the fused instantiations, called directly and held against plain,
    # go into the lego rows' "direct" (no launch on a path).
    wide_rows = []
    direct = {"fwd": {}, "bwd": {}, "sigma": {}}
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    for H, w in wide.items():
        if w["route"] != "fused":
            for S, row in w["fwd"].items():
                direct["fwd"][f"H={H} S={S}"] = {k: row[k] for k in keys}
            direct["bwd"][f"H={H}"] = dict({k: w["bwd"][k] for k in keys},
                                           max_rel_err=w["bwd"]["max_rel_err"],
                                           **({"legs": w["bwd"]["legs"]}
                                              if "legs" in w["bwd"] else {}))
            direct["sigma"][f"H={H}"] = {k: w["sigma"][k] for k in keys if k in w["sigma"]}
            continue
        views = {} if w["render"] is None else {"render": w["render"]["launches"]}
        for S, row in w["fwd"].items():
            wide_rows.append(_kernel_entry(
                f"fused_mlp_fwd H={H} S={S}", "fused_mlp_fwd.cu",
                "nerfmeshes_tpu/ops/pallas/fused_mlp.py:387", row,
                {k: v // 2 for k, v in {"train": w["train"]["fwd_launches"], **views,
                                        "mesh": w["mesh"]["fwd_launches"]}.items()},
                shape=row["shape"], hidden=H))
        wide_rows.append(_kernel_entry(
            f"fused_mlp_bwd H={H}", "fused_mlp_bwd.cu",
            "nerfmeshes_tpu/ops/pallas/fused_mlp.py:397", w["bwd"],
            {"train": w["train"]["bwd_launches"]}, shape=w["bwd"]["shape"], hidden=H,
            max_rel_err=w["bwd"]["max_rel_err"], **({"legs": w["bwd"]["legs"]}
                                                     if "legs" in w["bwd"] else {})))
        wide_rows.append(_kernel_entry(
            f"fused_sigma H={H}", "fused_sigma.cu", "nerfmeshes_tpu/ops/pallas/fused_mlp.py:675",
            w["sigma"], {"mesh": w["mesh"]["sigma_launches"]}, shape=f"{GRID_TILE} points",
            hidden=H))

    # The layer route's rows (layers_phase): 8x2048's shapes in the row
    # itself, every case's in "cases"; launches on the chains' paths (its
    # own and wide_phase's from 512 on), and each of its kernels' in their
    # train legs, as the kernels' counters read them.
    chains = dict(layers["chains"])
    chains.update({f"w{H}": w for H, w in wide.items() if w["route"] == "layers"})
    by_path = {"fwd": {}, "bwd": {}, "sigma": {}}
    kernel_launches = {}
    for case, chain in chains.items():
        by_path["fwd"][f"{case} train"] = chain["train"]["fwd_launches"]
        by_path["bwd"][f"{case} train"] = chain["train"]["bwd_launches"]
        if chain["render"] is not None:
            by_path["fwd"][f"{case} render"] = chain["render"]["launches"]
        by_path["fwd"][f"{case} mesh"] = chain["mesh"]["fwd_launches"]
        by_path["sigma"][f"{case} mesh"] = chain["mesh"]["sigma_launches"]
        kernel_launches[f"{case} train"] = chain["train"]["kernel_launches"]
    cases = layers["cases"]
    head = cases["w2048"]

    def case_rows(what):
        rows = {}
        for case, c in cases.items():
            got = c[what]
            for S, row in (got.items() if what == "fwd" else [(None, got)]):
                rows[case if S is None else f"{case} S={S}"] = {
                    k: row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                        "library_ms") if k in row}
        return rows

    layer_rows = [
        _kernel_entry("field_layers_fwd", "field_layers.cu",
              "nerfmeshes_tpu/ops/pallas/fused_mlp.py:387", head["fwd"][192], by_path["fwd"],
              shape="2048x192", hidden=2048, cases=case_rows("fwd"),
              kernel_launches=kernel_launches, legs=head["legs"].get("fwd"),
              vs_pair=layers["vs_pair"]["fwd"]),
        _kernel_entry("field_layers_bwd", "field_layers.cu",
              "nerfmeshes_tpu/ops/pallas/fused_mlp.py:397", head["bwd"], by_path["bwd"],
              shape=head["bwd"]["shape"], hidden=2048, max_rel_err=head["bwd"]["max_rel_err"],
              cases=case_rows("bwd"), legs=head["legs"].get("bwd"),
              vs_pair=layers["vs_pair"]["bwd"]),
        _kernel_entry("field_layers_sigma", "field_layers.cu",
              "nerfmeshes_tpu/ops/pallas/fused_mlp.py:675", head["sigma"], by_path["sigma"],
              shape=f"{GRID_TILE} points", hidden=2048, cases=case_rows("sigma")),
    ]
    # The product kernel alone (product_phase): the forward's shape at
    # 8x1024 in the row, every timed shape in "shapes"; its launches those
    # of the chains' train legs.
    products = layers["products"]
    if not all(counts["product"] for counts in kernel_launches.values()):
        raise AssertionError(f"a layer chain launched no product kernel: {kernel_launches}")
    product_row = _kernel_entry(
        "field_layers_product", "field_layers.cu", "nerfmeshes_tpu/ops/pallas/fused_mlp.py:387",
        products[f"M={PRODUCT_SHAPES[0][0]} K={PRODUCT_SHAPES[0][1]} N={PRODUCT_SHAPES[0][2]} "
                 "NN 0"],
        {path: counts["product"] for path, counts in kernel_launches.items()},
        shape="M=393216 K=1024 N=1024 NN 0", shapes=products,
        also_replaces=["nerfmeshes_tpu/ops/pallas/fused_mlp.py:397",
                       "nerfmeshes_tpu/ops/pallas/fused_mlp.py:675"])
    # The backward's heads kernel and the bias-grad reduction alone
    # (leg_kernel_phase): an 8x2048 slab's shapes in the row, 8x1024's in
    # "shapes"; their launches those their counters read in the chains'
    # train legs (only the backward launches them).
    # The dW leg (an 8x2048 trunk matrix's in the row) and the PE kernel
    # (lego L 10/4 at 2048 x 192) alike, their launches their counters'.
    legs_alone = layers["leg_kernels"]
    if not all(c["heads_bwd"] and c["bias"] and c["dw"] and c["pe"]
               for c in kernel_launches.values()):
        raise AssertionError(f"a layer chain's backward launched no heads, bias, dW or PE "
                             f"kernel: {kernel_launches}")
    leg_rows = []
    for name, key, counter, line in (("field_layers_heads_bwd", "heads", "heads_bwd", 397),
                                     ("field_layers_bias", "bias", "bias", 397),
                                     ("field_layers_dw", "dw", "dw", 397),
                                     ("field_layers_pe", "pe ", "pe", 387)):
        shapes = {k: v for k, v in legs_alone.items() if k.startswith(key)}
        first = next(k for k in shapes if "w2048" in k or key == "pe ")
        leg_rows.append(_kernel_entry(
            name, "field_layers.cu", f"nerfmeshes_tpu/ops/pallas/fused_mlp.py:{line}",
            shapes[first], {path: c[counter] for path, c in kernel_launches.items()},
            shape=first, shapes=shapes))
    return wide_rows, direct, [*layer_rows, product_row, *leg_rows]


def _print_ptxas(log: str) -> None:
    """nvcc's build log as the smoke prints it: each kernel's ptxas lines
    (registers, spills) under its entry's name, each nvcc's finish, and
    every C7519 note (ptxas serialising a kernel's wgmma) with its count
    per kernel."""
    from nerfmeshes_tpu_torch.ops.kernels import build

    shown = set()
    for line in log.splitlines():
        if "C7519" in line:  # before "registers": the note's text names them
            name = line.rsplit("function", 1)[-1].strip(" '")
            if name not in shown:
                shown.add(name)
                print("  ptxas:", line.strip())
        elif "Compiling entry function" in line:
            print("  ptxas: entry", line.split("'")[1] if "'" in line else line)
        elif "registers" in line or "spill" in line or line.startswith("nvcc "):
            print("  ptxas:", line.strip())
    notes = {k: u["c7519"] for k, u in build.ptxas_usage(log).items() if u["c7519"]}
    print("  ptxas C7519 notes per kernel: "
          + (", ".join(f"{k} {v}" for k, v in notes.items()) or "none"))


def tile_kernel_usage(log: str) -> dict:
    """ptxas's report (build.ptxas_usage) of each instantiation of the
    fused backward's tile kernel, bwd_tile_kernel<H>, in an nvcc log, by
    H."""
    from nerfmeshes_tpu_torch.ops.kernels import build

    out = {}
    for name, usage in build.ptxas_usage(log).items():
        m = re.search(r"bwd_tile_kernelILi(\d+)E", name)
        if m:
            out[int(m.group(1))] = usage
    return dict(sorted(out.items()))


def field_kernel_usage(log: str, widths=(128, 256)) -> list:
    """ptxas's report (build.ptxas_usage) of the forward's and the sigma
    kernel's instantiations at `widths` in an nvcc log: [(H, kernel name,
    usage)], kernel name fused_mlp_fwd_kernel or fused_sigma_kernel."""
    from nerfmeshes_tpu_torch.ops.kernels import build

    out = []
    for name, usage in build.ptxas_usage(log).items():
        m = re.search(r"(fused_mlp_fwd_kernel|fused_sigma_kernel)ILi(\d+)E", name)
        if m and int(m.group(2)) in widths:
            out.append((int(m.group(2)), m.group(1), usage))
    return sorted(out)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile-mesh", type=int, nargs="*", metavar="STEPS",
                        help="instead of the smoke, profile the mesh phase after training "
                             f"to each STEPS (default {MESH_TRAIN_STEPS})")
    parser.add_argument("--profile-train", action="store_true",
                        help="instead of the smoke, profile 5 hierarchical train steps")
    parser.add_argument("--profile-render", action="store_true",
                        help="instead of the smoke, profile 2 hierarchical 400x400 views")
    parser.add_argument("--breakdowns", action="store_true",
                        help="instead of the smoke, the device time per call of each kernel of "
                             "the fused backward (lego, 512, 1024 wide) and of the layer route "
                             "(LAYER_LEG_CASES), as one JSON line last (breakdowns)")
    parser.add_argument("--profile-buff", action="store_true",
                        help="instead of the smoke, profile 5 BuFF train steps past the first "
                             "consolidation")
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    from nerfmeshes_tpu_torch.data import gif, jpeg
    from nerfmeshes_tpu_torch.mesh import native
    from nerfmeshes_tpu_torch.ops.kernels import build

    t_start = time.perf_counter()
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
    _print_ptxas(log)
    tile_ptxas = {f"H={H}": u for H, u in tile_kernel_usage(log).items()}
    for H, u in tile_ptxas.items():
        print(f"bwd_tile_kernel {H}: {u['registers']} registers, {u['spill_stores']} B spill "
              f"stores, {u['spill_loads']} B spill loads, {u['stack']} B stack, {u['c7519']} "
              "C7519 notes (ptxas, this run's build)")
    if log and not tile_ptxas:
        raise AssertionError("the build log has no ptxas report of bwd_tile_kernel")
    field_ptxas = {"fused_mlp_fwd_kernel": {}, "fused_sigma_kernel": {}}
    for H, kernel, u in field_kernel_usage(log, (128, 256, 384)):
        field_ptxas[kernel][f"H={H}"] = u
        print(f"{kernel} H={H}: {u['registers']} registers, {u['spill_stores']} B spill "
              f"stores, {u['spill_loads']} B spill loads, {u['stack']} B stack, {u['c7519']} "
              "C7519 notes (ptxas, this run's build)")
    if log and not all(field_ptxas.values()):
        raise AssertionError("the build log has no ptxas report of the forward or sigma kernel")
    if opts.breakdowns:
        print(json.dumps(breakdowns(card, device)))
        return 0
    t0 = time.perf_counter()
    native.get_lib()
    print(f"native mesh library (g++): {time.perf_counter() - t0:.2f} s -> "
          f"{native.library_path().name}")
    t0 = time.perf_counter()
    jpeg.get_lib()
    print(f"JPEG decoder (g++): {time.perf_counter() - t0:.2f} s -> {jpeg.library_path().name}")
    for label, build_codec in (("JPEG encoder", jpeg.build_encoder), ("GIF encoder",
                                                                       gif.build_library)):
        t0 = time.perf_counter()
        path = build_codec()
        print(f"{label} (g++): {time.perf_counter() - t0:.2f} s -> {path.name}")
    if opts.profile_mesh is not None:
        profile_mesh(card, device, opts.profile_mesh or [MESH_TRAIN_STEPS])
        return 0
    if opts.profile_buff:
        profile_buff(card, device)
        return 0
    if opts.profile_train:
        profile_train(card, device)
        return 0
    if opts.profile_render:
        profile_render(card, device)
        return 0

    cfg = _lego_bf16_cfg()
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
    del buff_system
    legs = breakdowns_process(card)
    bkern["legs"] = legs["fused"]["lego"]
    bkern["legs_coarse"] = legs["fused"]["lego_coarse"]
    h128 = h128_kernel_phase(card, device)
    dist = dist_phase(card, device, {"fused_mlp_fwd": kern, "fused_mlp_bwd": bkern,
                                     "fused_sigma": skern, "fused_chords": ckern},
                      legs["per_rank_chords"])
    jpeg_phase(card)
    chains = {name: cli_chain(name, card) for name in CLI_RUNS}
    chains["normals"] = normals_chain(card)
    colour = export_color_phase(card)
    chains["tb_phase"] = tb_phase(card)
    crc = crc_phase(card)
    depth_sampling_phase(card, device)
    zoo_phase(card, device)
    buff_random = buff_random_phase(card, device)
    quality = quality_phase(card, device)
    t0 = time.perf_counter()
    wide = wide_phase(card, device, legs["fused"])  # last: its wide runs take the most memory
    layers = layers_phase(card, device, legs["layers"])
    wide_s = time.perf_counter() - t0
    new_legs = {f"{name} {leg}": chains[name]["legs"][leg]["seconds"]
                for name in IMPORT_CHAINS for leg in ("import", "import_eval", "import_mesh")}
    new_legs["tb_phase train"] = chains["tb_phase"]["legs"]["train"]["seconds"]
    new_legs["cli synthesis"] = chains["cli"]["legs"]["synthesis"]["seconds"]
    new_legs.update({f"normals {k}": v["seconds"] for k, v in chains["normals"]["legs"].items()})
    new_legs["export_color_images"] = colour["seconds"]
    print("new legs (s): " + ", ".join(f"{k} {v:.4f}" for k, v in new_legs.items())
          + "; event writing inside the chains (s): "
          + ", ".join(f"{k} {v['event_s']:.4f}" for k, v in chains.items() if "event_s" in v)
          + f"; _log_tree {chains['buff_cli']['log_tree_s_per_consolidation']:.4f} s a "
          f"consolidation; a projection {chains['tb_phase']['projection_s']:.4f} s; crc32c "
          f"{crc['mb_per_s']:.4f} MB/s [{card}]")
    cli = {k: {f"{name}_{leg}": info["launches"][k] for name, chain in chains.items()
               for leg, info in chain["legs"].items() if info["launches"][k]}
           for k in KERNELS}

    rank_kernels(kern, bkern, skern, ckern, render, train, mesh, buff, buff_render, buff_mesh,
                 card)

    entry = _kernel_entry

    # The H = 128 rows: the same kernels at hard-llff.yml's width; their
    # launches are the llff chain's and the forward-facing quality run's,
    # every train step and render chunk one coarse (S = 64) and one fine
    # (S = 128) launch.
    ff = quality["forward_facing"]
    llff_fwd = {k: v for k, v in cli["fwd"].items() if k.startswith("llff_cli_")}
    llff_fwd.update(quality_forward_facing_train=ff["launches"]["fwd"],
                    quality_forward_facing_reads=ff["untrained_launches"]
                    + ff["validate_launches"]["fwd"] + ff["projection_launches"]["fwd"]
                    + ff["eval_launches"])
    llff_bwd = {k: v for k, v in cli["bwd"].items() if k.startswith("llff_cli_")}
    llff_bwd["quality_forward_facing_train"] = ff["launches"]["bwd"]
    coarse, fine = sorted(h128["fwd"])
    h128_rows = [
        entry(f"fused_mlp_fwd H=128 S={S}", "fused_mlp_fwd.cu",
              "nerfmeshes_tpu/ops/pallas/fused_mlp.py:387", h128["fwd"][S],
              {k: v // 2 for k, v in llff_fwd.items()}, shape=h128["fwd"][S]["shape"],
              hidden=128)
        for S in (coarse, fine)]
    h128_rows.append(entry("fused_mlp_bwd H=128", "fused_mlp_bwd.cu",
                           "nerfmeshes_tpu/ops/pallas/fused_mlp.py:397", h128["bwd"], llff_bwd,
                           shape=h128["bwd"]["shape"], hidden=128,
                           max_rel_err=h128["bwd"]["max_rel_err"]))
    # sigma at 128 is on no chain's path (hard-llff.yml meshes nothing)
    h128_rows.append(entry("fused_sigma H=128", "fused_sigma.cu",
                           "nerfmeshes_tpu/ops/pallas/fused_mlp.py:675", h128["sigma"], {},
                           shape=h128["sigma"]["shape"], hidden=128,
                           bitwise_fwd_channel3=h128["sigma"]["bitwise"],
                           ptxas=field_ptxas["fused_sigma_kernel"].get("H=128")))

    wide_rows, direct, layer_rows = wide_and_layer_rows(wide, layers)
    print(f"smoke total: {time.perf_counter() - t_start:.2f} s, the wide phase and the "
          f"layer route {wide_s:.2f} s of it [{card}]")
    print(json.dumps({"kernels": [
        entry("fused_mlp_fwd", "fused_mlp_fwd.cu", "nerfmeshes_tpu/ops/pallas/fused_mlp.py:387", kern,
              {"render": render["launches"], "train": train["fwd_launches"],
               "mesh": mesh["fwd_launches"], "buff_train": buff["fwd_launches"],
               "buff_render": buff_render["fwd_launches"], "buff_mesh": buff_mesh["fwd_launches"],
               **cli["fwd"], "buff_random_train": buff_random["train"]["fwd"],
               "buff_random_view": buff_random["view"]["fwd"],
               "quality_kernel_width_train": quality["kernel_width"]["launches"]["fwd"],
               "quality_800_train": quality["quality_800"]["launches"]["fwd"],
               "quality_800_eval": quality["quality_800"]["eval_launches"],
               **dist["launches"]["fwd"]},
              chunk_ms=kern["chunk_ms"], chunk_bound_ms=kern["chunk_bound_ms"],
              chunk_library_ms=kern["chunk_library_ms"], chunk_plain_ms=kern["chunk_plain_ms"],
              shape="2048x192", hidden=256, direct=direct["fwd"], per_rank={
                  k: v for k, v in dist["per_rank"].items() if k.startswith("fused_mlp_fwd")},
              ptxas=field_ptxas["fused_mlp_fwd_kernel"]),
        entry("fused_mlp_bwd", "fused_mlp_bwd.cu", "nerfmeshes_tpu/ops/pallas/fused_mlp.py:397", bkern,
              {"train": train["bwd_launches"], "buff_train": buff["bwd_launches"], **cli["bwd"],
               "buff_random_train": buff_random["train"]["bwd"],
               "quality_kernel_width_train": quality["kernel_width"]["launches"]["bwd"],
               "quality_800_train": quality["quality_800"]["launches"]["bwd"],
               **dist["launches"]["bwd"]},
              max_rel_err=bkern["max_rel_err"], legs=bkern["legs"],
              legs_2048x64=bkern["legs_coarse"], tile_ptxas=tile_ptxas, shape="2048x192",
              hidden=256, direct=direct["bwd"], per_rank={
                  k: v for k, v in dist["per_rank"].items() if k.startswith("fused_mlp_bwd")}),
        entry("fused_sigma", "fused_sigma.cu", "nerfmeshes_tpu/ops/pallas/fused_mlp.py:675", skern,
              {"mesh": mesh["sigma_launches"], "buff_mesh": buff_mesh["sigma_launches"],
               **cli["sigma"], "quality_800_mesh": quality["quality_800"]["sigma_launches"],
               **dist["launches"]["sigma"]},
              direct=direct["sigma"], per_rank={k: v for k, v in dist["per_rank"].items()
                                                if k.startswith("fused_sigma")},
              ptxas=field_ptxas["fused_sigma_kernel"]),
        entry("fused_chords", "chords.cu", "nerfmeshes_tpu/ops/pallas/chords.py:98",
              dict(ckern, library_ms=None),
              {"train": buff["chords_launches"], "render": buff_render["chords_launches"],
               "mesh": buff_mesh["chords_launches"], **cli["chords"],
               "quality_blobs_buff_train": quality["blobs"]["buff"]["launches"]["chords"],
               **dist["launches"]["chords"]},
              per_rank={k: v for k, v in dist["per_rank"].items()
                        if k.startswith("fused_chords")},
              bitwise_equal=ckern["bitwise_equal"], bound_us=ckern["bound_ms"] * 1e3,
              call_ms=ckern["call_ms"], b2b_ms=ckern["b2b_ms"],
              chunk_ms=ckern["chunk_ms"], chunk_b2b_ms=ckern["chunk_b2b_ms"],
              chunk_plain_ms=ckern["chunk_plain_ms"],
              chunk_bound_ms=ckern["chunk_bound_ms"]),
        *h128_rows,
        *wide_rows,
        *layer_rows,
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
