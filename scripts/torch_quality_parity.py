#!/usr/bin/env python3
"""Trained quality of the PyTorch/CUDA port under two protocols whose JAX
records are in the repo, run on the CUDA card.

    python3 scripts/torch_quality_parity.py                      # every run
    python3 scripts/torch_quality_parity.py --protocol kernel_width --seeds 42
    python3 scripts/torch_quality_parity.py --protocol blobs --system buff
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

Each finished run is appended to torch_quality_parity.json (or --out),
keyed "{protocol}_{system}_{kernel}_{seed}"; a key already there is
skipped, so a call that is cut loses at most the run it was in. An entry
holds the reads, train seconds and steps, the card's name and power limit
(nvidia-smi), the kernel launch counts of its training and any cut.
"""

from __future__ import annotations

import argparse
import json
import math
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

SEEDS = (42, 0, 1)
RUNS = [("kernel_width", "hier", "on"), ("kernel_width", "hier", "off"),
        ("blobs", "hier", "module"), ("blobs", "buff", "module")]


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
        steps=None, reads=None, image_size=None, rays=None) -> dict | None:
    """Run one protocol run and record it, unless its key is in `out`.
    `steps` (blobs) / `reads` (kernel_width), `image_size` and `rays`
    (kernel_width) cut the run; a cut is recorded in the entry."""
    key = key_of(protocol, system, kernel, seed)
    if key in load(out):
        print(f"skip {key} (in {out})", flush=True)
        return None
    print(f"=== {key} on {device} ({time.strftime('%H:%M:%S')})", flush=True)
    cut = {k: v for k, v in (("steps", steps), ("reads", reads), ("image_size", image_size),
                              ("rays", rays)) if v}
    if protocol == "kernel_width":
        entry = run_kernel_width(kernel, seed, device, reads=reads,
                                 image_size=image_size or KW_SIZE, rays=rays)
    else:
        entry = run_blobs(system, seed, device, steps=steps or STEPS)
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--protocol", choices=["kernel_width", "blobs"], action="append")
    ap.add_argument("--system", choices=["hier", "buff"], action="append")
    ap.add_argument("--kernel", choices=["on", "off", "module"], action="append")
    ap.add_argument("--seeds", type=int, nargs="+", default=list(SEEDS))
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; without a card and without --device cpu "
                         "the script raises")
    ap.add_argument("--out", type=Path, default=OUT)
    ap.add_argument("--steps", type=int, help="cut: blobs steps")
    ap.add_argument("--reads", type=int, nargs="+", help="cut: kernel_width read steps")
    ap.add_argument("--image-size", type=int, help="cut: kernel_width view size")
    ap.add_argument("--rays", type=int, help="cut: kernel_width rays a step")
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
        for seed in seeds:
            run(protocol, system, kernel, seed, device, opts.out, steps=opts.steps,
                reads=opts.reads if protocol == "kernel_width" else None,
                image_size=opts.image_size, rays=opts.rays)
    return 0


if __name__ == "__main__":
    sys.exit(main())
