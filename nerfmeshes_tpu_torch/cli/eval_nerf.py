"""Evaluation CLI (counterpart of nerfmeshes_tpu/cli/eval_nerf.py, the same
flags plus --device): renders the test split (or 120 synthesized views:
the Blender orbit, or a COLMAP scene's own render path), prints per-view
and dataset MSE/PSNR/SSIM, and optionally saves rgb, target and disparity
PNGs (disparity only beside the rgb ones, as JAX writes them), or with
--synthesis-video the orbit as an animated GIF (data/gif.py). The metrics
are computed on the device; two scalars come to the host per view.

    python -m nerfmeshes_tpu_torch.cli.eval_nerf --log-checkpoint logs/.../version_0

Every view's rays are split over every visible card (parallel/mesh.py),
or over the ranks torchrun started; rank 0 prints and writes the images.
"""

from __future__ import annotations

import argparse
import math
import os
from pathlib import Path

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Render + evaluate a checkpoint")
    parser.add_argument("--log-checkpoint", type=str, required=True,
                        help="Run log dir containing hparams.yaml + checkpoints.")
    parser.add_argument("--checkpoint", type=str, default="last",
                        help="'last' or a step number.")
    parser.add_argument("--save-dir", type=str, default=None,
                        help="Save images to this directory.")
    parser.add_argument("--save-images", action="store_true", default=False)
    parser.add_argument("--save-disparity", action="store_true", default=False)
    parser.add_argument("--synthesis-images", action="store_true", default=False,
                        help="Render 120 synthesized orbit poses instead of the test split.")
    parser.add_argument("--synthesis-video", type=str, default=None,
                        help="Also assemble the rendered frames into an animated GIF at this "
                             "path (implies --synthesis-images).")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device to run on (default: the CUDA card; 'cpu' to run "
                             "on the host).")
    return parser


def _psnr(mse: float) -> float:
    return -10.0 * math.log10(mse if mse > 0 else 1e-5)


def main(argv=None) -> dict:
    """Evaluate a run; returns the dataset's mse, psnr and ssim (empty for
    synthesized views, which have no targets)."""
    args = build_parser().parse_args(argv)
    if args.synthesis_video and not args.synthesis_video.endswith(".gif"):
        # Before anything is built: JAX's check and message.
        raise SystemExit("--synthesis-video: only .gif is supported in this environment "
                         "(no ffmpeg); got " + args.synthesis_video)

    from nerfmeshes_tpu_torch.parallel.mesh import cli_world, run_cli

    return run_cli(evaluate, args, cli_world(args.device))


def evaluate(args, group) -> dict:
    """The CLI's body on one rank of `group` (every rank returns the
    metrics; rank 0 prints and writes)."""
    import torch

    from nerfmeshes_tpu_torch.config.paths import resolve_paths
    from nerfmeshes_tpu_torch.data.blender import write_png
    from nerfmeshes_tpu_torch.data.datasets import DatasetType, build_dataset
    from nerfmeshes_tpu_torch.data.gif import write_gif
    from nerfmeshes_tpu_torch.ops.math import ssim
    from nerfmeshes_tpu_torch.train.factory import build_system
    from nerfmeshes_tpu_torch.utils.images import cast_to_disparity_image

    cfg, paths = resolve_paths(log_checkpoint=args.log_checkpoint)
    system = build_system(cfg, paths, group=group)
    dataset = build_dataset(cfg, DatasetType.TEST, system.device)
    if args.synthesis_images or args.synthesis_video:
        dataset.synthesis()
    system.setup_eval(dataset)
    system.restore(step=None if args.checkpoint == "last" else int(args.checkpoint),
                   last=args.checkpoint == "last")

    main = group.is_main
    save_dir = Path(args.save_dir) if args.save_dir and main else None
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
    save_rgb = bool(save_dir and (args.save_images or args.synthesis_images))
    # Rank 0 keeps the orbit's uint8 frames for the GIF, fetched once with
    # the PNGs'.
    video_frames = [] if args.synthesis_video and main else None
    H, W = (int(v) for v in dataset.hwf[:2])
    mses, ssims = [], []
    for idx in range(len(dataset)):
        origins, directions = dataset.image_rays(idx)
        near, far = np.asarray(dataset._bounds_for(idx)).reshape(-1)[:2]
        out = system.query_rays(origins, directions, float(near), float(far),
                                fields=("rgb_map", "disp_map") if args.save_disparity
                                else ("rgb_map",), as_numpy=False)
        line = f"[{idx:03d}]"
        target = None
        if dataset.synthetic_poses is None:
            target = dataset.image_targets(idx)
            pair = torch.stack([torch.mean((out.rgb_map - target) ** 2),
                                ssim(out.rgb_map.reshape(H, W, 3), target.reshape(H, W, 3))])
            mse, s_val = pair.tolist()  # the view's one fetch
            mses.append(mse)
            ssims.append(s_val)
            line += f" mse={mse:.5f} psnr={_psnr(mse):.2f} ssim={s_val:.4f}"
        if main:
            print(line, flush=True)

        rgb = None
        if save_rgb or video_frames is not None:
            rgb = (out.rgb_map.reshape(H, W, 3).clamp(0.0, 1.0) * 255.0).to(torch.uint8)
            rgb = rgb.cpu().numpy()
        if video_frames is not None:
            video_frames.append(rgb)
        if save_rgb:
            write_png(save_dir / f"{idx:04d}_rgb.png", rgb)
            if target is not None:
                tgt = (target.reshape(H, W, 3).clamp(0.0, 1.0) * 255).to(torch.uint8)
                write_png(save_dir / f"{idx:04d}_target.png", tgt.cpu().numpy())
            # Disparity rides with the rgb PNGs, as in JAX: --save-disparity
            # alone writes nothing.
            if args.save_disparity:
                disp = out.disp_map.reshape(H, W).cpu().numpy()
                write_png(save_dir / f"{idx:04d}_disparity.png",
                          cast_to_disparity_image(disp, cfg.dataset.white_background))

    if video_frames:
        path = Path(args.synthesis_video)
        os.makedirs(path.resolve().parent, exist_ok=True)
        # JAX's imageio.mimwrite(path, frames, duration=42, loop=0).
        write_gif(path, video_frames, duration_ms=42, loop=0)
        print(f"wrote {len(video_frames)}-frame animation -> {args.synthesis_video}")

    if not mses:
        return {}
    result = {"mse": float(np.mean(mses)), "ssim": float(np.mean(ssims))}
    result["psnr"] = _psnr(result["mse"])
    if main:
        print(f"dataset: mse={result['mse']:.5f} psnr={result['psnr']:.2f} "
              f"ssim={result['ssim']:.4f}")
    return result


if __name__ == "__main__":
    main()
