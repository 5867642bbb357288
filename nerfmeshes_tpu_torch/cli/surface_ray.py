"""Surface-ray point-cloud CLI (counterpart of nerfmeshes_tpu/cli/surface_ray.py,
the same flags and defaults plus --device): ray-cast an orbit of views
through a trained checkpoint and write the neighbourhood-consistent
surface points, with normals and colours, to PLY.

    python -m nerfmeshes_tpu_torch.cli.surface_ray --log-checkpoint logs/.../version_0 \
        --img-size 400 --focal 0 --save-path points.ply

Every view's rays are split over every visible card (parallel/mesh.py),
or over the ranks torchrun started; rank 0 prints and writes the file.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Export a masked surface point cloud by ray casting")
    parser.add_argument("--log-checkpoint", type=str, required=True,
                        help="Run log dir containing hparams.yaml + checkpoints.")
    parser.add_argument("--checkpoint", type=str, default="last",
                        help="'last' or a step number.")
    parser.add_argument("--save-path", type=str, default="surface_points.ply",
                        help="Output PLY path.")
    parser.add_argument("--img-size", type=int, default=800,
                        help="Render resolution per view (ref: 800).")
    parser.add_argument("--focal", type=float, default=1111.1111,
                        help="Focal length in pixels (ref: 1111.1111); pass 0 to take it "
                             "from the dataset.")
    parser.add_argument("--poses-y", type=int, default=8,
                        help="Azimuth samples over [-180, 180) (ref: 8).")
    parser.add_argument("--poses-x", type=int, default=4,
                        help="Elevation samples over [-90, 90] (ref: 4).")
    parser.add_argument("--radius", type=float, default=4.0,
                        help="Orbit radius (ref: plane_far = 4.0).")
    parser.add_argument("--step-size", type=int, default=2,
                        help="Neighborhood half-width s (ref: 2).")
    parser.add_argument("--dist-threshold", type=float, default=0.002,
                        help="Max squared neighbor distance (ref: 0.002).")
    parser.add_argument("--prob-threshold", type=float, default=0.6,
                        help="Fraction of neighbors that must agree (ref: 0.6).")
    parser.add_argument("--ascii", action="store_true", default=False,
                        help="Write ASCII PLY instead of binary.")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device to run on (default: the CUDA card; 'cpu' to run "
                             "on the host).")
    return parser


def main(argv=None):
    """Export a run's surface points; returns (points, normals, colors)
    (None when it spawned its ranks)."""
    args = build_parser().parse_args(argv)

    from nerfmeshes_tpu_torch.parallel.mesh import cli_world, run_cli

    return run_cli(surface_ray, args, cli_world(args.device))


def surface_ray(args, group):
    """The CLI's body on one rank of `group`."""
    from nerfmeshes_tpu_torch.config.paths import resolve_paths
    from nerfmeshes_tpu_torch.mesh.surface_ray import export_surface_ray
    from nerfmeshes_tpu_torch.train.factory import build_system

    cfg, paths = resolve_paths(log_checkpoint=args.log_checkpoint)
    system = build_system(cfg, paths, group=group)
    system.setup_eval(None)
    system.restore(step=None if args.checkpoint == "last" else int(args.checkpoint),
                   last=args.checkpoint == "last")

    focal = args.focal
    if not focal:
        from nerfmeshes_tpu_torch.data.datasets import DatasetType, build_dataset

        focal = float(build_dataset(cfg, DatasetType.VALIDATION, system.device).hwf[2])

    out = Path(args.save_path)
    if group.is_main:
        out.parent.mkdir(parents=True, exist_ok=True)
    result = export_surface_ray(
        system, str(out), hwf=(args.img_size, args.img_size, focal), poses_y=args.poses_y,
        poses_x=args.poses_x, radius=args.radius, step_size=args.step_size,
        dist_threshold=args.dist_threshold, prob_threshold=args.prob_threshold,
        binary=not args.ascii)
    if group.is_main:
        print(f"wrote {len(result[0])} surface points -> {out}", flush=True)
    return result


if __name__ == "__main__":
    main()
