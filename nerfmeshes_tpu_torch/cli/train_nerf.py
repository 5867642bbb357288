"""Training CLI (counterpart of nerfmeshes_tpu/cli/train_nerf.py, the same
flags plus --device).

    python -m nerfmeshes_tpu_torch.cli.train_nerf --config configs/tiny.yml
    python -m nerfmeshes_tpu_torch.cli.train_nerf --log-checkpoint logs/.../version_0
    python -m nerfmeshes_tpu_torch.cli.train_nerf --config configs/tiny.yml --gpus 2
    torchrun --nproc-per-node 2 -m nerfmeshes_tpu_torch.cli.train_nerf --config ...

The rays of every step are split over the ranks (parallel/mesh.py): by
default one per visible card, `--gpus N` of them, or with `--device cpu`
N gloo ranks on the host; under torchrun, the ranks it started.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Train a NeRF / BuFF model on the card")
    parser.add_argument("--config", type=str, default=None,
                        help="Path to (.yml) config file (new run).")
    parser.add_argument("--log-checkpoint", type=str, default=None,
                        help="Existing run log dir to resume from (reads its hparams.yaml).")
    parser.add_argument("--checkpoint", type=str, default="last",
                        help="Checkpoint to resume: 'last' or a step number.")
    parser.add_argument("--run-name", type=str, default=None,
                        help="Name of the run (log subdir).")
    parser.add_argument("--gpus", type=int, default=None,
                        help="Cards to split the rays over (default: every visible card; "
                             "with --device cpu, gloo ranks on the host, default 1).")
    parser.add_argument("--precision", type=str, default=None, choices=["32", "16", "bf16"],
                        help="Compute precision override (16 maps to bf16).")
    parser.add_argument("--deterministic", action="store_true", default=True,
                        help="Seeded, reproducible run (always on: every generator is seeded).")
    parser.add_argument("--use-profiler", action="store_true", default=False,
                        help="Write a torch.profiler trace of the first 3 train calls to "
                             "<run>/profile.")
    parser.add_argument("--override", nargs="*", default=None, metavar="KEY VALUE",
                        help="Config overrides as dotted key/value pairs, e.g. "
                             "--override optimizer.lr 1e-3 nerf.train.num_random_rays 4096")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device to run on (default: the CUDA card; 'cpu' to run "
                             "on the host).")
    return parser


def main(argv=None):
    """Train (or resume) a run; returns the trained system (None when it
    spawned its ranks)."""
    args = build_parser().parse_args(argv)

    from nerfmeshes_tpu_torch.parallel.mesh import cli_world, run_cli

    return run_cli(train, args, cli_world(args.device, args.gpus))


def train(args, group):
    """The CLI's body on one rank of `group`: rank 0 resolves the run
    directory (and writes hparams.yaml), the other ranks read it back."""
    import torch

    from nerfmeshes_tpu_torch.config.paths import resolve_paths
    from nerfmeshes_tpu_torch.parallel.mesh import broadcast_text
    from nerfmeshes_tpu_torch.train.factory import build_system

    # --precision is folded into the overrides so that it lands in
    # hparams.yaml, where a resume, eval or mesh reads it back.
    overrides = list(args.override or [])
    if args.precision:
        overrides += ["experiment.compute_dtype",
                      {"32": "float32", "16": "bfloat16", "bf16": "bfloat16"}[args.precision]]
    if group.is_main:
        cfg, paths = resolve_paths(config_path=args.config, log_checkpoint=args.log_checkpoint,
                                   run_name=args.run_name, overrides=overrides)
    log_dir = broadcast_text(str(paths.log_dir) if group.is_main else None, group)
    if not group.is_main:
        cfg, paths = resolve_paths(log_checkpoint=log_dir)
    system = build_system(cfg, paths, group=group)
    system.setup()
    if args.log_checkpoint is not None:
        system.restore(step=None if args.checkpoint == "last" else int(args.checkpoint),
                       last=args.checkpoint == "last")
        if group.is_main:
            print(f"Resumed from step {system.state.step}")
    if system.logger is not None:
        system.logger.log_text("description", str(cfg.experiment.description))
        system.logger.log_text("config", cfg.dump())

    if args.use_profiler:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if system.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        trace_dir = paths.log_dir / "profile"
        trace_dir.mkdir(exist_ok=True)
        with profile(activities=activities) as prof:
            system.fit(max_steps=system.state.step + 3 * int(cfg.experiment.steps_per_call))
            if system.device.type == "cuda":
                torch.cuda.synchronize(system.device)
        if group.is_main:
            prof.export_chrome_trace(str(trace_dir / "trace.json"))
            print(f"Profile trace written to {trace_dir}")

    system.fit()
    if group.is_main:
        print("Training complete.")
    return system


if __name__ == "__main__":
    main()
