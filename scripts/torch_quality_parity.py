#!/usr/bin/env python3
"""Trained quality of the PyTorch/CUDA port under four protocols whose JAX
records are in the repo, run on the CUDA card.

    python3 scripts/torch_quality_parity.py                      # every run
    python3 scripts/torch_quality_parity.py --protocol kernel_width --seeds 42
    python3 scripts/torch_quality_parity.py --protocol blobs --system buff
    python3 scripts/torch_quality_parity.py --protocol forward_facing
    python3 scripts/torch_quality_parity.py --protocol quality_800
    python3 scripts/torch_quality_parity.py --summarize          # the table
    python3 scripts/torch_quality_parity.py --device cpu --steps 20 --out /tmp/q.json

Protocols (the JAX package's, ported; the script imports torch and the
port, nothing of the JAX package):
- kernel_width (scripts/r5_conv_diag.py:38-70, records r5_conv_diag.json):
  configs/nerf-synthetic-lego.yml as shipped (2 x 8x256 FlexibleNeRF,
  64+128 samples, 2048 rays, perturb on, sigma noise 0.2, bf16) with
  dataset.type synthetic, 12 train and 2 validation views at 64^2,
  optimizer.lr 1e-3, steps_per_call 50, trained by NeRFSystem.fit. Reads:
  validate(max_images=-1, log_images=False) and the train-view metrics
  (validate on the train views, max_images=3) at steps 2000, 6000 and
  12000 of one run (a read draws nothing from the train stream), and the
  untrained read at step 0. Kernel "on": use_fused_kernel (the forward and
  backward CUDA kernels); "off": the nn.Module path at the config's compute
  dtype, read at 2000 only.
- blobs (scripts/r5_blobs_attribution.py:1-40, 60-154, records
  r5_blobs_attribution.json): procedural blobs, 16 train views at 64^2,
  512 rays a step drawn with np.random.default_rng(1000 + seed), 3000
  steps, Adam lr 5e-4, perturb on, sigma noise 0.2; hierarchical 2 x 4x64
  with 16+32 samples, or BuFF 4x64 with 48 samples and the tree of `TREE`
  (ticks at 1000, 1750, 2500); eval on 4096 rays of 2 held-out views drawn
  with default_rng(11). Width 64 is outside the field kernels: the field is
  the nn.Module; BuFF's chords go through the chord kernel.
- forward_facing (BASELINE.md, "Forward-facing NDC at scale"): configs/
  hard-llff.yml as shipped (data/hard_llff, 24 views at 400^2, NDC, hold
  step 8, 2 x 8x128, 64+64 samples, bf16, lr 5e-4, 20k steps, validation
  every 5000) with only experiment.randomseed and experiment.logdir set,
  through the user's chain: cli/train_nerf.py, then cli/eval_nerf.py on
  the test split (views 0, 8 and 16). Reads: eval_nerf's dataset PSNR
  (of the mean MSE) and SSIM, its per-view lines, each validation of the
  run and the untrained validation before fit trains. Train seconds and
  launches leave out the validations and the depth projections fit logs
  (each counted apart).
- quality_800 (scripts/quality_800.py, record quality_800.json): the
  lego workload of get_default_cfg() (2 x 8x256, 64+128 samples, 2048
  rays, bf16, steps_per_call 25, perturb on, lr 5e-4) on the procedural
  hard scene, 20 train and 2 validation views at 800^2 rendered with 512
  samples, NeRFSystem.fit for 20k steps. Reads: per validation view PSNR
  and SSIM through query_rays (the mean of the views' PSNRs, as the
  record's); the 480^3 mesh at iso 10 (limit 1.2, the adaptive clamp on)
  through the sparse path (the sigma kernel); its chamfer distance
  (squared, and RMS = sqrt(chamfer / 2)) to 20,000 points of the analytic
  surface: 131,072 uniform points of [-1.2, 1.2]^3 drawn with numpy
  (default_rng(0); the record drew jax.random.key(0)), 5 Newton steps on
  data/synthetic.py:hard_sdf with torch autograd's gradient, kept where
  |sdf| < 1e-3, 20,000 chosen with default_rng(0); 20,000 mesh points
  from mesh/metrics.py:sample_points_from_mesh.

Each finished run is appended to torch_quality_parity.json (or --out),
keyed "{protocol}_{system}_{kernel}_{seed}"; a key already there is
skipped, so a call that is cut loses at most the run it was in. An entry
holds the reads, train seconds and steps, the card's name and power limit
(nvidia-smi), the kernel launch counts of its training and any cut. A
forward-facing run's logs go under --logdir (build/quality_runs).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from nerfmeshes_tpu_torch.buff.tree import TreeSampling, integrate  # noqa: E402
from nerfmeshes_tpu_torch.config import get_default_cfg, load_config  # noqa: E402
from nerfmeshes_tpu_torch.ops.kernels import chords as tc  # noqa: E402
from nerfmeshes_tpu_torch.ops.kernels import fused_mlp as fm  # noqa: E402

OUT = ROOT / "torch_quality_parity.json"
LEGO = ROOT / "configs" / "nerf-synthetic-lego.yml"

# kernel_width (r5_conv_diag.py)
KW_LR = 1e-3
KW_TRAIN_VIEWS, KW_VAL_VIEWS, KW_SIZE = 12, 2, 64
KW_READS = {"on": (2000, 6000, 12000), "off": (2000,)}

# blobs (r5_blobs_attribution.py)
ARCH = dict(num_layers=4, hidden_size=64, skip_step=4, num_encoding_fn_xyz=6,
            num_encoding_fn_dir=4, use_viewdirs=True)
HIER_COARSE, HIER_FINE = 16, 32
BUFF_SAMPLES = 48
RAYS = 512
STEPS = 3000
IMAGE_SIZE = 64
NUM_TRAIN_IMAGES = 16
EVAL_RAYS = 4096
NEAR, FAR = 2.0, 6.0
LR = 5e-4
NOISE = 0.2
TREE = dict(subdivision_outer_count=12, subdivision_inner_count=2, max_depth=4, eps=1e-4,
            use_random_sampling=False, max_voxel_count=1536,
            step_size_integration_offset=250, step_size_tree=750)

# forward_facing (configs/hard-llff.yml; JAX's eval CLI read, BASELINE.md)
FF_CONFIG = ROOT / "configs" / "hard-llff.yml"
LLFF_DIR = ROOT / "data" / "hard_llff"
RUN_DIR = ROOT / "build" / "quality_runs"
FF_JAX = {"psnr": 30.52, "ssim": 0.9552, "val_fine_psnr": 32.41}
EVAL_LINE = re.compile(r"^\[(\d+)\] mse=(\S+) psnr=(\S+) ssim=(\S+)$")

# quality_800 (scripts/quality_800.py)
Q800_TRAIN_VIEWS, Q800_VAL_VIEWS, Q800_SIZE, Q800_GT_SAMPLES = 20, 2, 800, 512
Q800_STEPS, Q800_LR, Q800_STEPS_PER_CALL = 20000, 5e-4, 25
MESH_RES, MESH_LIMIT, MESH_ISO = 480, 1.2, 10.0
SURFACE_DRAW, SURFACE_LIMIT, NEWTON_STEPS, SURFACE_TOL = 131072, 1.2, 5, 1e-3
BOX_CENTER, BOX_HALF = (0.45, -0.38, -0.3), 0.22  # hard_sdf's rounded box, before rounding
CHAMFER_POINTS = 20000

SEEDS = (42, 0, 1)
RUNS = [("kernel_width", "hier", "on"), ("kernel_width", "hier", "off"),
        ("blobs", "hier", "module"), ("blobs", "buff", "module"),
        ("forward_facing", "hier", "on"), ("quality_800", "hier", "on")]


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout
        return out.splitlines()[0].strip() if out.strip() else "not measured"
    except (OSError, subprocess.SubprocessError):
        return "not measured"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _psnr(mse: float) -> float:
    return -10.0 * math.log10(mse)


# ---------------------------------------------------------------------------
# kernel_width
# ---------------------------------------------------------------------------

def kernel_width_cfg(kernel: str, seed: int, rays: int | None = None):
    cfg = load_config(str(LEGO))
    cfg.experiment.randomseed = seed
    cfg.experiment.validate_every = 0  # the reads are taken by hand
    cfg.experiment.print_every = 250
    cfg.experiment.steps_per_call = 50
    cfg.experiment.use_fused_kernel = kernel == "on"
    cfg.optimizer.lr = KW_LR
    cfg.dataset.type = "synthetic"
    if rays:
        cfg.nerf.train.num_random_rays = rays
    return cfg


def _read(system) -> dict:
    """validate() on all validation views and on 3 train views (r5_conv_diag
    takes both), as host floats."""
    out = {"validation": system.validate(max_images=-1, log_images=False)}
    val = system.val_dataset
    system.val_dataset = system.train_dataset
    try:
        out["train_views"] = system.validate(max_images=3, log_images=False)
    finally:
        system.val_dataset = val
    return out


def run_kernel_width(kernel: str, seed: int, device, reads=None, image_size=KW_SIZE,
                     rays=None) -> dict:
    """One run of the kernel-width protocol; the reads at step 0 and at each
    of `reads` (default KW_READS[kernel])."""
    from nerfmeshes_tpu_torch.data.datasets import DatasetType, SyntheticDataset
    from nerfmeshes_tpu_torch.train.system import NeRFSystem

    reads = tuple(reads or KW_READS[kernel])
    cfg = kernel_width_cfg(kernel, seed, rays)
    cfg.experiment.train_iters = reads[-1]
    # fit runs whole calls: a cut read off the 50-step grid takes smaller calls.
    cfg.experiment.steps_per_call = math.gcd(cfg.experiment.steps_per_call, *reads)
    # A validation chunk is padded to chunksize rays: smaller views, smaller
    # chunks (the maps are the same).
    cfg.nerf.validation.chunksize = min(int(cfg.nerf.validation.chunksize), image_size ** 2)
    system = NeRFSystem(cfg, device=device)
    system.setup(SyntheticDataset(cfg, DatasetType.TRAIN, num_images=KW_TRAIN_VIEWS,
                                  image_size=image_size, device=device),
                 SyntheticDataset(cfg, DatasetType.VALIDATION, num_images=KW_VAL_VIEWS,
                                  image_size=image_size, device=device))
    out = {"reads": {"0": _read(system)}, "losses": {}}
    train_s, launches = 0.0, {"fwd": 0, "bwd": 0}
    for step in reads:
        fwd, bwd = fm.launches, fm.bwd_launches
        _sync(system.device)
        t0 = time.perf_counter()
        metrics = system.fit(step)
        _sync(system.device)
        train_s += time.perf_counter() - t0
        launches["fwd"] += fm.launches - fwd
        launches["bwd"] += fm.bwd_launches - bwd
        out["losses"][str(step)] = metrics["train/loss"]
        out["reads"][str(step)] = _read(system)
    out.update(train_s=train_s, steps=system.state.step, launches=launches)
    return out


# ---------------------------------------------------------------------------
# blobs
# ---------------------------------------------------------------------------

def make_data(seed: int, num_steps: int = STEPS, rays: int = RAYS):
    """The protocol's train batches (num_steps, rays, 3) x 3 and eval set
    (EVAL_RAYS, 3) x 3 as numpy f32, made on the host as
    r5_blobs_attribution.py:make_data makes them."""
    from nerfmeshes_tpu_torch.data.synthetic import make_synthetic_dataset
    from nerfmeshes_tpu_torch.ops.rays import get_ray_bundle

    host = torch.device("cpu")
    bundle = make_synthetic_dataset(num_images=NUM_TRAIN_IMAGES, image_size=IMAGE_SIZE,
                                    near=NEAR, far=FAR, seed=0, scene="blobs", device=host)
    H, W, focal = int(bundle.hwf[0]), int(bundle.hwf[1]), float(bundle.hwf[2])
    origins, dirs = get_ray_bundle(H, W, focal, torch.as_tensor(bundle.poses))
    origins = origins[:, None, None, :].expand(dirs.shape).reshape(
        NUM_TRAIN_IMAGES, H * W, 3).numpy()
    dirs = dirs.reshape(NUM_TRAIN_IMAGES, H * W, 3).numpy()
    targets = np.asarray(bundle.ray_targets).reshape(NUM_TRAIN_IMAGES, H * W, 3)

    rng = np.random.default_rng(1000 + seed)
    o = np.empty((num_steps, rays, 3), np.float32)
    d = np.empty((num_steps, rays, 3), np.float32)
    t = np.empty((num_steps, rays, 3), np.float32)
    for s in range(num_steps):
        img = int(rng.integers(NUM_TRAIN_IMAGES))
        pix = rng.integers(0, H * W, size=rays)
        o[s], d[s], t[s] = origins[img, pix], dirs[img, pix], targets[img, pix]

    ev = make_synthetic_dataset(num_images=2, image_size=IMAGE_SIZE, near=NEAR, far=FAR,
                                seed=1, scene="blobs", device=host)
    eo, ed = get_ray_bundle(H, W, focal, torch.as_tensor(ev.poses))
    eo = eo[:, None, None, :].expand(ed.shape).reshape(-1, 3).numpy()
    ed = ed.reshape(-1, 3).numpy()
    et = np.asarray(ev.ray_targets).reshape(-1, 3)
    pix = np.random.default_rng(11).integers(0, ed.shape[0], size=EVAL_RAYS)
    return (o, d, t), (eo[pix].astype(np.float32), ed[pix].astype(np.float32),
                       et[pix].astype(np.float32))


def blobs_cfg(system: str):
    """The port's config for a blobs run: ARCH fields, Adam at LR without
    decay, the protocol's train samples and noise, TREE for BuFF."""
    cfg = get_default_cfg()
    for node in (cfg.models.coarse, cfg.models.fine):
        node.update(ARCH)
    cfg.models.use_fine = system == "hier"
    cfg.experiment.compute_dtype = "float32"
    cfg.experiment.use_fused_kernel = False
    cfg.optimizer.lr = LR
    cfg.scheduler.type = "ConstantLR"
    cfg.dataset.near, cfg.dataset.far = NEAR, FAR
    cfg.dataset.white_background = False
    train = cfg.nerf.train  # the eval renders take these too (run_blobs)
    train.num_coarse = HIER_COARSE if system == "hier" else BUFF_SAMPLES
    train.num_fine = HIER_FINE if system == "hier" else 0
    train.perturb, train.radiance_field_noise_std, train.lindisp = True, NOISE, False
    cfg.tree.update(TREE)
    return cfg


def ticks(steps: int = STEPS) -> list:
    """Consolidation steps, r5_blobs_attribution.py:_ticks: after step s
    where s > offset and (s - offset) % step_size_tree == 0."""
    offset, size = TREE["step_size_integration_offset"], TREE["step_size_tree"]
    return [s for s in range(steps) if s > offset and (s - offset) % size == 0]


def run_blobs(system: str, seed: int, device, steps: int = STEPS) -> dict:
    """One blobs run: train `steps` steps from the port's own init drawn
    from `seed`, then the eval PSNR (fine and coarse; BuFF: its one field)."""
    from nerfmeshes_tpu_torch.buff.system import buff_render_rays, buff_train_loss
    from nerfmeshes_tpu_torch.train.optim import build_optimizer
    from nerfmeshes_tpu_torch.train.render import RenderSettings, render_rays
    from nerfmeshes_tpu_torch.train.step import train_loss
    from nerfmeshes_tpu_torch.train.system import create_models, init_params

    cfg = blobs_cfg(system)
    (bo, bd, bt), (eo, ed, et) = make_data(seed, steps)
    coarse, fine = create_models(cfg)
    init_params(coarse, fine, torch.Generator().manual_seed(seed))
    models = [m for m in (coarse, fine) if m is not None]
    for m in models:
        m.to(device)
    opt = build_optimizer([p for m in models for p in m.parameters()], cfg)
    gen = torch.Generator(device).manual_seed(seed)
    settings = RenderSettings.from_cfg(cfg, train=True)
    tree = TreeSampling(cfg) if system == "buff" else None
    tree_state = tree.device_state(device) if tree else None
    offset, tick = TREE["step_size_integration_offset"], set(ticks(steps))
    voxel_counts, losses, dropped = [], [], torch.zeros((), device=device)

    def on(a):
        return torch.from_numpy(a).to(device)

    # The eval renders take the train settings with train=False, as the
    # protocol's runners do: BuFF's fallback jitter and the sigma noise are
    # off, the hierarchical render keeps perturb (JAX's render_rays passes
    # settings.perturb as it is; without a generator a seed-0 stream).
    def evaluate() -> dict:
        sq = {"fine": [], "coarse": []}
        with torch.no_grad():
            for i in range(0, ed.shape[0], 1024):
                o, d, t = on(eo[i:i + 1024]), on(ed[i:i + 1024]), on(et[i:i + 1024])
                if tree is None:
                    c, f = render_rays(coarse, fine, o, d, NEAR, FAR, settings, train=False)
                    sq["fine"].append(((f.rgb_map - t) ** 2).double().sum())
                    sq["coarse"].append(((c.rgb_map - t) ** 2).double().sum())
                else:
                    b = buff_render_rays(coarse, tree_state, o, d, NEAR, FAR, settings,
                                         train=False)[0]
                    sq["fine"].append(((b.rgb_map - t) ** 2).double().sum())
        n = ed.shape[0] * 3
        out = {"psnr": _psnr(float(torch.stack(sq["fine"]).sum()) / n)}
        if sq["coarse"]:
            out["coarse_psnr"] = _psnr(float(torch.stack(sq["coarse"]).sum()) / n)
        return out

    untrained = evaluate()
    chords, fwd, bwd = tc.launches, fm.launches, fm.bwd_launches
    _sync(device)
    t0 = time.perf_counter()
    for s in range(steps):
        o, d, t = on(bo[s]), on(bd[s]), on(bt[s])
        if tree is None:
            loss, _ = train_loss(cfg, coarse, fine, o, d, t, NEAR, FAR, generator=gen,
                                 settings=settings)
        else:
            loss, metrics, aux = buff_train_loss(cfg, coarse, tree_state, o, d, t, NEAR, FAR,
                                                 generator=gen, settings=settings)
            dropped += metrics["train/dropped_chords"]
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        if tree is not None:
            if s >= offset:
                tree_state = integrate(tree_state, aux["voxel_idx"], aux["weights"],
                                       aux["mask_weights"], aux["ray_mask"])
            if s in tick:
                tree_state = tree.consolidate(tree_state.memm.cpu().numpy(), device)
                voxel_counts.append([s, len(tree.leaves)])
        if s % 500 == 0:
            print(f"  blobs {system} seed {seed} step {s} loss {float(loss.detach()):.5f}"
                  + (f" V {len(tree.leaves)}" if tree else ""), flush=True)
    _sync(device)
    train_s = time.perf_counter() - t0
    launches = {"chords": tc.launches - chords, "fwd": fm.launches - fwd,
                "bwd": fm.bwd_launches - bwd}
    out = evaluate()
    out["untrained"] = untrained
    curve = torch.stack(losses).cpu().numpy()
    out.update(train_s=train_s, steps=steps, launches=launches,
               loss_first_100=float(curve[:100].mean()), loss_last_100=float(curve[-100:].mean()))
    if tree is not None:
        out.update(voxel_counts=voxel_counts, dropped_chords=float(dropped))
    return out


# ---------------------------------------------------------------------------
# forward_facing
# ---------------------------------------------------------------------------

def forward_facing_overrides(seed: int, logdir, llff_dir=LLFF_DIR, steps=None, rays=None,
                             llff_factor=None) -> list:
    """train_nerf's --override pairs: the seed and the log directory, the
    scene's directory (data/hard_llff, the config's own, by its absolute
    path), and any cut: steps (steps_per_call the largest divisor of 50
    that divides them), rays a step, a downsample factor (the validation
    chunk then a view's pixels: a chunk is padded to its size)."""
    opts = ["experiment.randomseed", str(seed), "experiment.logdir", str(logdir),
            "dataset.basedir", str(llff_dir)]
    if steps:
        opts += ["experiment.train_iters", str(steps),
                 "experiment.steps_per_call", str(math.gcd(50, steps))]
    if rays:
        opts += ["nerf.train.num_random_rays", str(rays)]
    if llff_factor:
        from nerfmeshes_tpu_torch.data.blender_poses import png_size

        H, W = png_size(sorted((Path(llff_dir) / "images").iterdir())[0])
        opts += ["dataset.llff_downsample_factor", str(llff_factor),
                 "nerf.validation.chunksize",
                 str(min(65536, math.ceil(H / llff_factor) * math.ceil(W / llff_factor)))]
    return opts


def forward_facing_cfg(seed: int, logdir=RUN_DIR, **cut):
    """The port's config of a forward-facing run (what train_nerf reads)."""
    return load_config(str(FF_CONFIG), forward_facing_overrides(seed, logdir, **cut))


class Probe:
    """A CLI run's NeRFSystem watched from outside while it runs: before fit
    trains, the untrained read (validate on every validation view, which
    draws nothing from the train stream); fit's seconds; each validation
    of the run (its read by step) and each depth projection it logs, with
    their seconds and kernel launches, which the train launches exclude."""

    WATCHED = {"validate": "validate", "projection": "_log_depth_projection"}

    def __init__(self):
        self.untrained = self.untrained_launches = None
        self.fit_s, self.reads = 0.0, {}
        self.seconds = {name: 0.0 for name in self.WATCHED}
        self.launches = {name: {"fwd": 0, "bwd": 0} for name in self.WATCHED}

    @contextlib.contextmanager
    def watching(self):
        from nerfmeshes_tpu_torch.train.system import NeRFSystem

        originals = {name: getattr(NeRFSystem, attr) for name, attr in self.WATCHED.items()}
        fit, probe = NeRFSystem.fit, self

        def counted(name):
            method = originals[name]

            def wrapper(system, *args, **kw):
                fwd, bwd = fm.launches, fm.bwd_launches
                _sync(system.device)
                t0 = time.perf_counter()
                out = method(system, *args, **kw)
                _sync(system.device)
                probe.seconds[name] += time.perf_counter() - t0
                probe.launches[name]["fwd"] += fm.launches - fwd
                probe.launches[name]["bwd"] += fm.bwd_launches - bwd
                if name == "validate":
                    probe.reads[str(kw.get("step", system.state.step))] = out
                return out

            return wrapper

        def timed_fit(system, *args, **kw):
            fwd = fm.launches
            probe.untrained = originals["validate"](system, max_images=-1, log_images=False)
            probe.untrained_launches = fm.launches - fwd
            _sync(system.device)
            t0 = time.perf_counter()
            out = fit(system, *args, **kw)
            _sync(system.device)
            probe.fit_s += time.perf_counter() - t0
            return out

        NeRFSystem.fit = timed_fit
        for name, attr in self.WATCHED.items():
            setattr(NeRFSystem, attr, counted(name))
        try:
            yield self
        finally:
            NeRFSystem.fit = fit
            for name, attr in self.WATCHED.items():
                setattr(NeRFSystem, attr, originals[name])


class _Tee(io.TextIOBase):
    """stdout that is also kept."""

    def __init__(self, stream):
        self.stream, self.parts = stream, []

    def write(self, text):
        self.parts.append(text)
        return self.stream.write(text)

    def flush(self):
        self.stream.flush()


@contextlib.contextmanager
def _first_views(views):
    """build_dataset with its test split cut to its first `views` views
    (None: as it is)."""
    from nerfmeshes_tpu_torch.data import datasets

    build = datasets.build_dataset

    def cut(cfg, type, device=None):
        dataset = build(cfg, type, device)
        if views and type == datasets.DatasetType.TEST:
            dataset.bundle = dataset.bundle[:views]
        return dataset

    datasets.build_dataset = cut
    try:
        yield
    finally:
        datasets.build_dataset = build


def run_forward_facing(seed: int, device, logdir=RUN_DIR, llff_dir=LLFF_DIR, steps=None,
                       rays=None, llff_factor=None, eval_views=None) -> dict:
    """One forward-facing run through the CLIs: train_nerf on hard-llff.yml
    (the seed and log directory set), eval_nerf on its test split. On the
    card the CLIs take one rank on `device`."""
    from nerfmeshes_tpu_torch.cli import eval_nerf, train_nerf

    dev = f"cuda:{device.index or 0}" if device.type == "cuda" else str(device)
    opts = forward_facing_overrides(seed, Path(logdir) / f"forward_facing_{seed}", llff_dir,
                                    steps, rays, llff_factor)
    probe = Probe()
    fwd, bwd = fm.launches, fm.bwd_launches
    t0 = time.perf_counter()
    with probe.watching():
        system = train_nerf.main(["--config", str(FF_CONFIG), "--device", dev,
                                  "--override", *opts])
    cli_s = time.perf_counter() - t0
    fwd = fm.launches - fwd - probe.untrained_launches - sum(
        v["fwd"] for v in probe.launches.values())
    bwd = fm.bwd_launches - bwd - sum(v["bwd"] for v in probe.launches.values())
    run_dir = system.paths.log_dir
    steps_done = system.state.step
    del system
    records = [json.loads(line) for line in (run_dir / "events" / "metrics.jsonl").open()]
    train_losses = {str(r["step"]): r["train/loss"] for r in records if "train/loss" in r}

    tee = _Tee(sys.stdout)
    eval_fwd = fm.launches
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee), _first_views(eval_views):
        test = eval_nerf.main(["--log-checkpoint", str(run_dir), "--device", dev])
    eval_s = time.perf_counter() - t0
    per_view = [dict(view=int(m[1]), mse=float(m[2]), psnr=float(m[3]), ssim=float(m[4]))
                for m in (EVAL_LINE.match(line) for line in "".join(tee.parts).splitlines())
                if m]
    return dict(test=test, per_view=per_view, untrained=probe.untrained,
                validations=probe.reads, train_losses=train_losses,
                train_s=probe.fit_s - sum(probe.seconds.values()), fit_s=probe.fit_s,
                validate_s=probe.seconds["validate"], projection_s=probe.seconds["projection"],
                cli_train_s=cli_s, eval_s=eval_s, steps=steps_done,
                launches={"fwd": fwd, "bwd": bwd},
                validate_launches=probe.launches["validate"],
                projection_launches=probe.launches["projection"],
                untrained_launches=probe.untrained_launches,
                eval_launches=fm.launches - eval_fwd, run_dir=str(run_dir))


# ---------------------------------------------------------------------------
# quality_800
# ---------------------------------------------------------------------------

def quality_800_cfg(seed: int, steps: int = Q800_STEPS, rays=None, image_size=Q800_SIZE):
    """scripts/quality_800.py's config: get_default_cfg() (the lego
    workload) with bf16, perturb on, lr 5e-4, the hard synthetic scene;
    validation only by hand. A cut takes steps_per_call to the largest
    divisor of 25 that divides its steps; a validation chunk is at most a
    view's pixels."""
    cfg = get_default_cfg()
    cfg.experiment.randomseed = seed
    cfg.experiment.compute_dtype = "bfloat16"
    cfg.experiment.steps_per_call = math.gcd(Q800_STEPS_PER_CALL, steps)
    cfg.experiment.train_iters = steps
    cfg.experiment.validate_every = 0
    cfg.experiment.print_every = 500
    cfg.dataset.type = "synthetic"
    cfg.dataset.scene = "hard"
    cfg.nerf.train.perturb = True
    cfg.optimizer.lr = Q800_LR
    if rays:
        cfg.nerf.train.num_random_rays = rays
    cfg.nerf.validation.chunksize = min(int(cfg.nerf.validation.chunksize), image_size ** 2)
    return cfg


def surface_draw(count: int = SURFACE_DRAW) -> np.ndarray:
    """The uniform points of [-1.2, 1.2]^3 that are projected onto the
    surface, (count, 3) f32."""
    return np.random.default_rng(0).uniform(-SURFACE_LIMIT, SURFACE_LIMIT,
                                            (count, 3)).astype(np.float32)


def newton_project(points: np.ndarray, device, steps: int = NEWTON_STEPS):
    """`steps` steps p - sdf(p) grad / max(|grad|^2, 1e-8) on the hard
    scene's SDF, the gradient by autograd -> (points, sdf) as host f32.

    A point that a step finds inside the box's core (|p - c| <= 0.22 on
    every axis) ends as NaN, as in the record: there the JAX package's
    gradient of norm(max(qb, 0)) at the zero vector is NaN (0 / 0), so
    its projection lost those points of its draw, where torch's clamp
    passes a zero gradient and the step lands on a face of the box."""
    from nerfmeshes_tpu_torch.data.synthetic import hard_sdf

    p = torch.as_tensor(points, dtype=torch.float32, device=device)
    center = torch.tensor(BOX_CENTER, dtype=torch.float32, device=device)
    core = torch.zeros(p.shape[:-1], dtype=torch.bool, device=device)
    with torch.enable_grad():
        for _ in range(steps):
            core |= (torch.abs(p - center) - BOX_HALF <= 0.0).all(dim=-1)
            q = p.detach().requires_grad_(True)
            sdf = hard_sdf(q)
            (grad,) = torch.autograd.grad(sdf.sum(), q)
            denom = torch.clamp(torch.sum(grad * grad, dim=-1, keepdim=True), min=1e-8)
            p = (q - sdf.detach()[..., None] * grad / denom).detach()
    p = torch.where(core[..., None], torch.nan, p)
    with torch.no_grad():
        sdf = hard_sdf(p)
    return p.cpu().numpy(), sdf.cpu().numpy()


def surface_points(device) -> tuple:
    """CHAMFER_POINTS points of the analytic surface, and how many of the
    draw were kept (within SURFACE_TOL of it)."""
    pts, sdf = newton_project(surface_draw(), device)
    surf = pts[np.abs(sdf) < SURFACE_TOL]
    pick = np.random.default_rng(0).choice(len(surf), size=CHAMFER_POINTS,
                                           replace=len(surf) < CHAMFER_POINTS)
    return surf[pick], len(surf)


def _held_out(system, dataset) -> dict:
    """Per view PSNR and SSIM of the finest render at validation settings
    (query_rays), and their means, as quality_800.py reads them."""
    from nerfmeshes_tpu_torch.ops.math import ssim

    H, W = (int(v) for v in dataset.hwf[:2])
    near, far = float(system.cfg.dataset.near), float(system.cfg.dataset.far)
    psnrs, ssims = [], []
    for i in range(len(dataset)):
        o, d = dataset.image_rays(i)
        rgb = system.query_rays(o, d, near, far, fields=("rgb_map",), as_numpy=False).rgb_map
        target = dataset.image_targets(i)
        mse, s_val = torch.stack([torch.mean((rgb - target) ** 2),
                                  ssim(rgb.reshape(H, W, 3), target.reshape(H, W, 3))]).tolist()
        psnrs.append(_psnr(mse))
        ssims.append(s_val)
    return dict(psnr=float(np.mean(psnrs)), ssim=float(np.mean(ssims)), psnr_per_view=psnrs,
                ssim_per_view=ssims)


def run_quality_800(seed: int, device, steps: int = Q800_STEPS, image_size: int = Q800_SIZE,
                    rays=None, mesh_res: int = MESH_RES) -> dict:
    """One quality_800 run: the GT views, fit, the held-out reads before
    and after, the mesh and its chamfer distance to the analytic surface."""
    from nerfmeshes_tpu_torch.data.datasets import DatasetType, SyntheticDataset
    from nerfmeshes_tpu_torch.mesh.extract import LAST_TIMINGS, MeshArgs, extract_geometry
    from nerfmeshes_tpu_torch.mesh.metrics import chamfer_distance, sample_points_from_mesh
    from nerfmeshes_tpu_torch.train.system import NeRFSystem

    cfg = quality_800_cfg(seed, steps, rays, image_size)
    _sync(device)
    t0 = time.perf_counter()
    train_ds, val_ds = (SyntheticDataset(cfg, kind, num_images=n, image_size=image_size,
                                         keep_on_device=True, gt_samples=Q800_GT_SAMPLES,
                                         device=device)
                        for kind, n in ((DatasetType.TRAIN, Q800_TRAIN_VIEWS),
                                        (DatasetType.VALIDATION, Q800_VAL_VIEWS)))
    _sync(device)
    gt_render_s = time.perf_counter() - t0
    system = NeRFSystem(cfg, device=device).setup(train_ds, val_ds)
    untrained = _held_out(system, val_ds)

    fwd, bwd = fm.launches, fm.bwd_launches
    _sync(device)
    t0 = time.perf_counter()
    metrics = system.fit()
    _sync(device)
    train_s = time.perf_counter() - t0
    launches = {"fwd": fm.launches - fwd, "bwd": fm.bwd_launches - bwd}

    fwd = fm.launches
    t0 = time.perf_counter()
    held = _held_out(system, val_ds)
    eval_s = time.perf_counter() - t0
    eval_launches = fm.launches - fwd

    sigma = fm.sigma_launches
    LAST_TIMINGS.clear()
    t0 = time.perf_counter()
    verts, faces, _, _ = extract_geometry(
        system.sample_points, MeshArgs(res=mesh_res, limit=MESH_LIMIT, iso_level=MESH_ISO),
        density_fn=system.density_points, device=system.device)
    mesh_s = time.perf_counter() - t0
    sigma = fm.sigma_launches - sigma
    timings = dict(LAST_TIMINGS)

    t0 = time.perf_counter()
    surf, kept = surface_points(device)
    mesh_pts = sample_points_from_mesh(verts, faces, CHAMFER_POINTS)
    chamfer = chamfer_distance(torch.as_tensor(surf, device=device), mesh_pts, block=1024)
    chamfer_s = time.perf_counter() - t0
    steps_done = system.state.step
    return dict(held_out=held, untrained=untrained, final_train_metrics=metrics,
                gt_render_s=gt_render_s, train_s=train_s, eval_s=eval_s, mesh_s=mesh_s,
                chamfer_s=chamfer_s, steps=steps_done, launches=launches,
                eval_launches=eval_launches, sigma_launches=sigma,
                train_rays_per_s=steps_done * int(cfg.nerf.train.num_random_rays) / train_s,
                mesh_res=mesh_res, mesh_vertices=int(len(verts)), mesh_triangles=int(len(faces)),
                iso_effective=timings.get("iso_effective"), mesh_timings=timings,
                surface_kept=kept, chamfer_sq=chamfer, chamfer_rms=math.sqrt(chamfer / 2.0))


# ---------------------------------------------------------------------------
# runs and records
# ---------------------------------------------------------------------------

def key_of(protocol: str, system: str, kernel: str, seed: int) -> str:
    return f"{protocol}_{system}_{kernel}_{seed}"


def load(path: Path) -> dict:
    return json.loads(path.read_text()) if path.exists() else {}


def record(path: Path, key: str, entry: dict) -> None:
    data = load(path)
    data[key] = entry
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(data, indent=1))
    print(f"recorded {key} in {path}: {json.dumps(entry)[:300]}", flush=True)


def run(protocol: str, system: str, kernel: str, seed: int, device, out: Path,
        steps=None, reads=None, image_size=None, rays=None, llff_factor=None,
        eval_views=None, mesh_res=None, logdir=RUN_DIR, llff_dir=LLFF_DIR) -> dict | None:
    """Run one protocol run and record it, unless its key is in `out`.
    Cuts: `steps` (blobs, forward_facing, quality_800), `reads`
    (kernel_width), `image_size` (kernel_width, quality_800), `rays` (all
    but blobs), `llff_factor` and `eval_views` (forward_facing), `mesh_res`
    (quality_800); a cut is recorded in the entry. A forward-facing run
    logs under `logdir` and reads its scene from `llff_dir`."""
    key = key_of(protocol, system, kernel, seed)
    if key in load(out):
        print(f"skip {key} (in {out})", flush=True)
        return None
    print(f"=== {key} on {device} ({time.strftime('%H:%M:%S')})", flush=True)
    cut = {k: v for k, v in (("steps", steps), ("reads", reads), ("image_size", image_size),
                              ("rays", rays), ("llff_factor", llff_factor),
                              ("eval_views", eval_views), ("mesh_res", mesh_res)) if v}
    if protocol == "kernel_width":
        entry = run_kernel_width(kernel, seed, device, reads=reads,
                                 image_size=image_size or KW_SIZE, rays=rays)
    elif protocol == "blobs":
        entry = run_blobs(system, seed, device, steps=steps or STEPS)
    elif protocol == "forward_facing":
        entry = run_forward_facing(seed, device, logdir=logdir, llff_dir=llff_dir, steps=steps,
                                   rays=rays, llff_factor=llff_factor, eval_views=eval_views)
    else:
        entry = run_quality_800(seed, device, steps=steps or Q800_STEPS,
                                image_size=image_size or Q800_SIZE, rays=rays,
                                mesh_res=mesh_res or MESH_RES)
    entry.update(card=card_line() if device.type == "cuda" else "cpu",
                 device=torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                 torch=torch.__version__, cut=cut)
    record(out, key, entry)
    return entry


def summarize(path: Path) -> None:
    """The runs beside the JAX package's records (TPU v5e, seed 42 for the
    kernel width; three seeds for blobs) and the decision rule's verdicts."""
    data = load(path)
    conv = load(ROOT / "r5_conv_diag.json")
    blobs = load(ROOT / "r5_blobs_attribution.json")
    print("kernel_width: fine / coarse dB at each read (JAX's TPU v5e quality records, seed 42)")
    jax_kw = {(k.split("_")[0], k.split("_")[-1]): v["metrics"] for k, v in conv.items()
              if isinstance(v, dict) and "metrics" in v}
    means = {}
    for kernel in ("on", "off"):
        for step in KW_READS[kernel]:
            j = jax_kw.get((f"{step // 1000}k", kernel))
            row = []
            for seed in SEEDS:
                e = data.get(key_of("kernel_width", "hier", kernel, seed))
                if e and str(step) in e["reads"]:
                    v = e["reads"][str(step)]["validation"]
                    row.append((seed, v["validation/fine_psnr"], v["validation/coarse_psnr"]))
            if row:
                means[(kernel, step)] = (np.mean([r[1] for r in row]),
                                         np.mean([r[2] for r in row]))
            jtxt = (f"JAX {j['validation/fine_psnr']:.2f} / {j['validation/coarse_psnr']:.2f}"
                    if j else "JAX none")
            print(f"  kernel {kernel} step {step}: " + ", ".join(
                f"seed {s} {f:.2f} / {c:.2f}" for s, f, c in row) + f"; {jtxt}")
    j12 = jax_kw.get(("12k", "on"))
    if ("on", 12000) in means and j12:
        f, c = means[("on", 12000)]
        cand = (f < j12["validation/fine_psnr"] - 3.0) or (c < j12["validation/coarse_psnr"] - 3.0)
        print(f"  rule: 3-seed mean at 12k {f:.2f} / {c:.2f} vs JAX {j12['validation/fine_psnr']:.2f}"
              f" / {j12['validation/coarse_psnr']:.2f} - 3 dB: "
              + ("FAULT CANDIDATE" if cand else "no fault candidate"))
    print("blobs: eval PSNR dB (JAX's TPU v5e quality records)")
    port, jax_ = {}, {}
    for system in ("hier", "buff"):
        port[system] = [data[k]["psnr"] for k in
                        (key_of("blobs", system, "module", s) for s in SEEDS) if k in data]
        jax_[system] = [blobs[f"jax_{system}_{s}"]["psnr"] for s in SEEDS
                        if f"jax_{system}_{s}" in blobs]
        vox = [data[k].get("voxel_counts") for k in
               (key_of("blobs", system, "module", s) for s in SEEDS) if k in data]
        print(f"  {system}: port {[round(p, 2) for p in port[system]]}"
              + (f" mean {np.mean(port[system]):.2f}" if port[system] else "")
              + f"; JAX {[round(p, 2) for p in jax_[system]]} mean {np.mean(jax_[system]):.2f}"
              + (f"; voxel counts {vox}" if system == "buff" else ""))
        if len(port[system]) == 3:
            spread = max(port[system]) - min(port[system])
            low = min(jax_[system])
            cand = np.mean(port[system]) < low - spread
            print(f"  rule {system}: port mean {np.mean(port[system]):.2f} vs JAX lowest {low:.2f}"
                  f" - port spread {spread:.2f}: "
                  + ("FAULT CANDIDATE" if cand else "no fault candidate"))
    if len(port["hier"]) == 3 and len(port["buff"]) == 3:
        order = np.mean(port["hier"]) > np.mean(port["buff"])
        print(f"  rule ordering: hierarchical {'above' if order else 'NOT above'} BuFF"
              + ("" if order else ": FAULT CANDIDATE"))
    summarize_forward_facing(data)
    summarize_quality_800(data)


def _full_runs(data: dict, protocol: str) -> list:
    """(seed, entry) of the protocol's uncut runs."""
    return [(s, data[k]) for s in SEEDS
            if (k := key_of(protocol, "hier", "on", s)) in data and not data[k]["cut"]]


def summarize_forward_facing(data: dict) -> None:
    """The forward-facing runs and the rule: a fault candidate is a 3-seed
    mean test PSNR more than 3 dB below JAX's 30.52, or a mean SSIM more
    than 0.02 below its 0.9552."""
    print(f"forward_facing: eval_nerf on the 3 test views, PSNR / SSIM (JAX's TPU v5e record "
          f"{FF_JAX['psnr']} / {FF_JAX['ssim']}, last validation fine {FF_JAX['val_fine_psnr']})")
    runs = _full_runs(data, "forward_facing")
    for seed, e in runs:
        last = e["validations"][max(e["validations"], key=int)]
        print(f"  seed {seed}: {e['test']['psnr']:.2f} / {e['test']['ssim']:.4f} (views "
              + ", ".join(f"{v['psnr']:.2f}" for v in e["per_view"])
              + f"); last validation fine / coarse {last['validation/fine_psnr']:.2f} / "
              f"{last['validation/coarse_psnr']:.2f}; train {e['train_s']:.1f} s "
              f"({e['steps']} steps), launches {e['launches']} [{e['card']}]")
    if len(runs) == 3:
        psnr = np.mean([e["test"]["psnr"] for _, e in runs])
        ssim = np.mean([e["test"]["ssim"] for _, e in runs])
        cand = psnr < FF_JAX["psnr"] - 3.0 or ssim < FF_JAX["ssim"] - 0.02
        print(f"  rule: mean {psnr:.2f} dB / {ssim:.4f} vs {FF_JAX['psnr']} - 3 / "
              f"{FF_JAX['ssim']} - 0.02: " + ("FAULT CANDIDATE" if cand else "no fault candidate"))


def summarize_quality_800(data: dict) -> None:
    """The quality_800 runs and the rule: a fault candidate is a 3-seed mean
    held-out PSNR more than 3 dB below the record's, a mean SSIM more than
    0.02 below it, or a mean chamfer RMS above the record's by more than
    the port's own spread (max - min of its 3 reads)."""
    record = load(ROOT / "quality_800.json")
    print(f"quality_800: held-out PSNR / SSIM, 480^3 mesh, chamfer RMS (JAX's TPU v5e record "
          f"{record['val_psnr_db']:.2f} / {record['val_ssim']:.4f}, "
          f"{record['mesh_vertices']} vertices, RMS {record['chamfer_rms']:.4f})")
    runs = _full_runs(data, "quality_800")
    for seed, e in runs:
        h = e["held_out"]
        print(f"  seed {seed}: {h['psnr']:.2f} / {h['ssim']:.4f} (views "
              + ", ".join(f"{p:.2f}" for p in h["psnr_per_view"])
              + f"); {e['mesh_vertices']} vertices at iso {e['iso_effective']:.4g}; chamfer "
              f"{e['chamfer_sq']:.4e} (RMS {e['chamfer_rms']:.4f}); train {e['train_s']:.1f} s "
              f"({e['steps']} steps), mesh {e['mesh_s']:.1f} s, launches {e['launches']}, "
              f"sigma {e['sigma_launches']} [{e['card']}]")
    if len(runs) == 3:
        psnr = np.mean([e["held_out"]["psnr"] for _, e in runs])
        ssim = np.mean([e["held_out"]["ssim"] for _, e in runs])
        rms = [e["chamfer_rms"] for _, e in runs]
        spread = max(rms) - min(rms)
        cand = (psnr < record["val_psnr_db"] - 3.0 or ssim < record["val_ssim"] - 0.02
                or np.mean(rms) > record["chamfer_rms"] + spread)
        print(f"  rule: mean {psnr:.2f} dB / {ssim:.4f} vs {record['val_psnr_db']:.2f} - 3 / "
              f"{record['val_ssim']:.4f} - 0.02; chamfer RMS {np.mean(rms):.4f} vs "
              f"{record['chamfer_rms']:.4f} + port spread {spread:.4f}: "
              + ("FAULT CANDIDATE" if cand else "no fault candidate"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--protocol", choices=["kernel_width", "blobs", "forward_facing",
                                           "quality_800"], action="append")
    ap.add_argument("--system", choices=["hier", "buff"], action="append")
    ap.add_argument("--kernel", choices=["on", "off", "module"], action="append")
    ap.add_argument("--seeds", type=int, nargs="+", default=list(SEEDS))
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; without a card and without --device cpu "
                         "the script raises")
    ap.add_argument("--out", type=Path, default=OUT)
    ap.add_argument("--steps", type=int,
                    help="cut: blobs, forward_facing and quality_800 steps")
    ap.add_argument("--reads", type=int, nargs="+", help="cut: kernel_width read steps")
    ap.add_argument("--image-size", type=int, help="cut: kernel_width and quality_800 view size")
    ap.add_argument("--rays", type=int, help="cut: rays a step (all but blobs)")
    ap.add_argument("--llff-factor", type=int, help="cut: forward_facing downsample factor")
    ap.add_argument("--eval-views", type=int, help="cut: forward_facing test views evaluated")
    ap.add_argument("--mesh-res", type=int, help="cut: quality_800 mesh resolution")
    ap.add_argument("--logdir", type=Path, default=RUN_DIR,
                    help="where forward_facing runs write their logs and checkpoints")
    ap.add_argument("--llff-dir", type=Path, default=LLFF_DIR,
                    help="forward_facing's scene (data/hard_llff; a copy minifies there)")
    ap.add_argument("--summarize", action="store_true")
    opts = ap.parse_args(argv)
    if opts.summarize:
        summarize(opts.out)
        return 0
    if opts.device is None and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the protocols run on the card; pass --device cpu "
                         "to run them on the host")
    device = torch.device(opts.device or "cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if opts.steps:
        opts.reads = opts.reads or [opts.steps]
    for protocol, system, kernel in RUNS:
        if opts.protocol and protocol not in opts.protocol:
            continue
        if opts.system and system not in opts.system:
            continue
        if opts.kernel and kernel not in opts.kernel:
            continue
        seeds = opts.seeds if (protocol, kernel) != ("kernel_width", "off") else [
            s for s in opts.seeds if s == 42]
        if protocol == "forward_facing":
            cut = dict(steps=opts.steps, rays=opts.rays, llff_factor=opts.llff_factor,
                       eval_views=opts.eval_views)
        elif protocol == "quality_800":
            cut = dict(steps=opts.steps, image_size=opts.image_size, rays=opts.rays,
                       mesh_res=opts.mesh_res)
        else:
            cut = dict(steps=opts.steps, image_size=opts.image_size, rays=opts.rays,
                       reads=opts.reads if protocol == "kernel_width" else None)
        for seed in seeds:
            run(protocol, system, kernel, seed, device, opts.out, logdir=opts.logdir,
                llff_dir=opts.llff_dir, **cut)
    return 0


if __name__ == "__main__":
    sys.exit(main())
