"""Mesh-extraction CLI (counterpart of nerfmeshes_tpu/cli/mesh_nerf.py, the
same flags plus --device): dense sigma grid -> iso-surface ->
inverse-normal appearance -> OBJ (or binary PLY for a .ply name).

    python -m nerfmeshes_tpu_torch.cli.mesh_nerf --log-checkpoint logs/.../version_0 --res 480

The grid and the appearance rays are split over every visible card
(parallel/mesh.py), or over the ranks torchrun started; rank 0 marches,
prints and writes the mesh.
"""

from __future__ import annotations

import argparse
import time


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Extract a textured mesh from a checkpoint")
    parser.add_argument("--log-checkpoint", type=str, required=True)
    parser.add_argument("--checkpoint", type=str, default="last")
    parser.add_argument("--save-dir", type=str, default=".")
    parser.add_argument("--mesh-name", type=str, default="mesh.obj")
    parser.add_argument("--iso-level", type=float, default=32,
                        help="Iso-level value for triangulation")
    parser.add_argument("--limit", type=float, default=1.2,
                        help="Grid extent (-limit, limit) per axis")
    parser.add_argument("--res", type=int, default=128, help="Grid resolution per axis")
    parser.add_argument("--super-sampling", type=int, default=0,
                        help="Axis-wise super-sampling factor")
    parser.add_argument("--batch-size", type=int, default=65536,
                        help="Rays per appearance chunk (at least)")
    parser.add_argument("--no-view-dependence", action="store_true", default=False)
    parser.add_argument("--no-tree-mask", action="store_true", default=False,
                        help="(BuFF runs) keep geometry outside the tree's active voxels too; "
                             "by default extraction is masked to the tree's support.")
    parser.add_argument("--view-disparity", type=float, default=1e-2)
    parser.add_argument("--view-disparity-max-bound", type=float, default=4.0)
    parser.add_argument("--use-cached-mesh", action="store_true", default=False)
    parser.add_argument("--override-cache-mesh", action="store_true", default=False)
    parser.add_argument("--cache-name", type=str, default="mesh_cache.npz")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device to run on (default: the CUDA card; 'cpu' to run "
                             "on the host).")
    return parser


def main(argv=None):
    """Mesh a run; returns (vertices, triangles, diffuse, normals) (None
    when it spawned its ranks)."""
    args = build_parser().parse_args(argv)

    from nerfmeshes_tpu_torch.parallel.mesh import cli_world, run_cli

    return run_cli(mesh, args, cli_world(args.device))


def mesh(args, group):
    """The CLI's body on one rank of `group`."""
    from nerfmeshes_tpu_torch.config.paths import resolve_paths
    from nerfmeshes_tpu_torch.mesh import MeshArgs, export_marching_cubes
    from nerfmeshes_tpu_torch.mesh.extract import LAST_TIMINGS
    from nerfmeshes_tpu_torch.train.factory import build_system

    cfg, paths = resolve_paths(log_checkpoint=args.log_checkpoint)
    system = build_system(cfg, paths, group=group)
    system.setup_eval()
    system.restore(step=None if args.checkpoint == "last" else int(args.checkpoint),
                   last=args.checkpoint == "last")
    mesh_args = MeshArgs(
        iso_level=args.iso_level, limit=args.limit, res=args.res,
        super_sampling=args.super_sampling, batch_size=args.batch_size,
        no_view_dependence=args.no_view_dependence, tree_mask=not args.no_tree_mask,
        view_disparity=args.view_disparity,
        view_disparity_max_bound=args.view_disparity_max_bound,
        use_cached_mesh=args.use_cached_mesh, override_cache_mesh=args.override_cache_mesh,
        cache_name=args.cache_name, save_dir=args.save_dir, mesh_name=args.mesh_name)
    t0 = time.time()
    out = export_marching_cubes(system, mesh_args)
    if not group.is_main:
        return out
    vertices, triangles = out[0], out[1]
    print(f"Extracted {len(vertices)} vertices / {len(triangles)} triangles "
          f"in {time.time() - t0:.1f}s -> {args.save_dir}/{args.mesh_name}")
    if LAST_TIMINGS:
        print("phases: " + " ".join(
            f"{k}={v:.1f}s" if k.endswith("_s") else f"{k}={int(v)}"
            for k, v in LAST_TIMINGS.items()))
    return out


if __name__ == "__main__":
    main()
