"""Import a reference (qway/nerfmeshes) Lightning checkpoint into a run of
the port (counterpart of nerfmeshes_tpu/cli/import_checkpoint.py, the same
flags plus --device).

The reference saves Lightning `.ckpt` files (src/train_nerf.py:65-66)
whose `state_dict` holds the FlexibleNeRF weights under
`model_coarse.` / `model_fine.` (NeRFModel, src/models/model_nerf.py:28)
or `model.` (BuFFModel, src/models/model_buff.py:17), and, for BuFF, the
voxel tree under `checkpoint['tree']` (src/models/model_buff.py:166-170).
The port's FlexibleNeRFModel has the reference's submodule names and
holds each weight as (out, in), so the weights load by name once the
prefix is stripped, each name and shape checked first. The BuFF tree is
converted to the port's padded serialization. The result is a fresh run
directory with a checkpoint of the port, to evaluate, mesh or fine-tune:

    python -m nerfmeshes_tpu_torch.cli.import_checkpoint \\
        --ckpt <run>/checkpoints/model_last.ckpt
    python -m nerfmeshes_tpu_torch.cli.eval_nerf --log-checkpoint <printed dir>

The config defaults to the `hparams.yaml` Lightning writes beside the
checkpoints directory; `--config` takes another YAML, a nested experiment
config or a flat dot-keyed hparams file. Only FlexibleNeRFModel weights
import (the model of every shipped reference config). Optimizer moments
are not imported: the optimizer restarts from zero.
"""

from __future__ import annotations

import argparse
import sys
import types
from pathlib import Path

import numpy as np
import torch


def load_reference_checkpoint(path: str) -> dict:
    """torch.load a Lightning ckpt on the CPU, tolerating the pickled
    `nerf.tree.Node` a BuFF checkpoint carries (never used: the tree's
    geometry comes from its `voxels` tensor). Unpickling runs code: load
    only checkpoints you trust."""
    try:
        import nerf.tree  # noqa: F401  (present where the reference is importable)
    except ImportError:
        pkg = types.ModuleType("nerf")
        mod = types.ModuleType("nerf.tree")

        class Node:  # an unpickling target; pickle sets its attribute dict
            pass

        mod.Node = Node
        pkg.tree = mod
        sys.modules.setdefault("nerf", pkg)
        sys.modules.setdefault("nerf.tree", mod)
    return torch.load(path, map_location="cpu", weights_only=False)


def _torch_linear_order(num_layers: int, use_viewdirs: bool) -> list:
    """The reference FlexibleNeRFModel's submodule names in call order
    (src/nerf/models.py:4-80)."""
    names = ["layer1"] + [f"layers_xyz.{i}" for i in range(num_layers - 1)]
    if use_viewdirs:
        names += ["fc_feat", "fc_alpha", "layers_dir.0", "fc_rgb"]
    else:
        names += ["fc_out"]
    return names


def transplant_state_dict(model: torch.nn.Module, sd: dict, prefix: str, model_cfg: dict) -> None:
    """Load the `{prefix}layer1.weight`-style tensors of `sd` into `model`,
    in place, after checking every name and shape; SystemExit on a model
    that is not a FlexibleNeRFModel, a missing key or a wrong shape."""
    num_layers = int(model_cfg.get("num_layers", 4))
    use_viewdirs = bool(model_cfg.get("use_viewdirs", True))
    names = _torch_linear_order(num_layers, use_viewdirs)
    own = model.state_dict()
    expected = sorted(f"{name}.{part}" for name in names for part in ("weight", "bias"))
    if type(model).__name__ != "FlexibleNeRFModel" or sorted(own) != expected:
        raise SystemExit(
            f"ERROR: param tree {sorted(own)} does not match the FlexibleNeRFModel layout "
            f"{expected} — only FlexibleNeRFModel checkpoints are importable.")
    loaded = {}
    for name in names:
        for part in ("weight", "bias"):
            key = f"{prefix}{name}.{part}"
            if key not in sd:
                raise SystemExit(
                    f"ERROR: checkpoint is missing {key!r}; its model does not match the "
                    f"config (num_layers={num_layers}, use_viewdirs={use_viewdirs}).")
            value = sd[key].detach()
            mine = own[f"{name}.{part}"]
            if tuple(value.shape) != tuple(mine.shape):
                raise SystemExit(
                    f"ERROR: {key} has shape {tuple(value.shape)} but the config builds "
                    f"{tuple(mine.shape)} — check models.* (hidden_size/num_layers/encoding "
                    "dims).")
            loaded[f"{name}.{part}"] = value.to(dtype=mine.dtype)
    model.load_state_dict(loaded)


def convert_reference_tree(tree_ckpt: dict, tree) -> dict:
    """The reference's `TreeSampling.serialize()` (voxels (V, 2, 3), memm,
    counter; src/nerf/tree.py:345-358) as the port's padded serialization
    (buff/tree.py:TreeSampling.serialize). A leaf's depth comes from its
    edge: a depth-d cell's edge is root_edge / (outer * inner^(d - 1))."""
    from nerfmeshes_tpu_torch.buff.tree import _PAD_HI, _PAD_LO

    voxels = np.asarray(tree_ckpt["voxels"].detach().cpu().numpy(), np.float32)
    memm = np.asarray(tree_ckpt["memm"].detach().cpu().numpy(), np.float32)
    counter = int(tree_ckpt["counter"])
    V = voxels.shape[0]
    if V > tree.capacity:
        raise SystemExit(
            f"ERROR: reference tree has {V} voxels; capacity here is {tree.capacity} "
            "(max(tree.max_voxel_count, outer^3)). Raise tree.max_voxel_count in the config.")
    # leaves[0] is a depth-1 cell of the initial grid: root edge = its edge * outer.
    root_edge = float((tree.leaves[0].hi[0] - tree.leaves[0].lo[0]) * tree.outer_count)
    edges = (voxels[:, 1] - voxels[:, 0]).mean(axis=1)
    ratio = root_edge / (tree.outer_count * np.maximum(edges, 1e-12))
    depth = 1 + np.round(np.log(ratio) / np.log(tree.inner_count)).astype(np.int32)
    depth = np.clip(depth, 1, tree.max_depth)

    lo = np.full((tree.capacity, 3), _PAD_LO, np.float32)
    hi = np.full((tree.capacity, 3), _PAD_HI, np.float32)
    dep = np.zeros((tree.capacity,), np.int32)
    mem = np.zeros((tree.capacity,), np.float32)
    lo[:V], hi[:V], dep[:V], mem[:V] = voxels[:, 0], voxels[:, 1], depth, memm
    return {"leaf_lo": lo, "leaf_hi": hi, "leaf_depth": dep, "memm": mem,
            "counter": np.asarray(counter), "num_leaves": np.asarray(V, np.int32)}


def load_any_config(path: str):
    """A nested experiment YAML, or a flat dot-keyed hparams.yaml."""
    from nerfmeshes_tpu_torch.config import yaml_lite
    from nerfmeshes_tpu_torch.config.cfgnode import CfgNode, nest_dict
    from nerfmeshes_tpu_torch.config.schema import get_default_cfg, load_config

    raw = yaml_lite.load(path)
    if any("." in str(k) for k in raw):
        cfg = get_default_cfg()
        cfg.merge_from_other_cfg(CfgNode(nest_dict(raw)))
        return cfg
    return load_config(path)


def new_run_paths(cfg, run_name: str):
    """A fresh version_k run directory under <logdir>/<id>/<run_name>, its
    hparams.yaml written."""
    from nerfmeshes_tpu_torch.config.paths import ExperimentPaths, save_hparams

    base = Path(cfg.experiment.logdir) / cfg.experiment.id / run_name
    version = 0
    while (base / f"version_{version}").exists():
        version += 1
    paths = ExperimentPaths(base / f"version_{version}").create()
    save_hparams(cfg, paths)
    return paths


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Import a reference Lightning .ckpt into a run of the port")
    parser.add_argument("--ckpt", type=str, required=True,
                        help="Path to the reference model_*.ckpt file.")
    parser.add_argument("--config", type=str, default=None,
                        help="Experiment YAML or flat hparams.yaml (default: the hparams.yaml "
                             "next to the checkpoint's parent dir).")
    parser.add_argument("--run-name", type=str, default="imported",
                        help="Run subdirectory name for the new log dir.")
    parser.add_argument("--override", nargs="*", default=None, metavar="KEY VALUE",
                        help="Config overrides as dotted key/value pairs.")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device to build the run on (default: the CUDA card; 'cpu' "
                             "to run on the host).")
    return parser


def main(argv=None):
    """Import the checkpoint into a new run; returns the run's system."""
    args = build_parser().parse_args(argv)
    ckpt_path = Path(args.ckpt)
    if not ckpt_path.exists():
        raise SystemExit(f"ERROR: checkpoint {ckpt_path} does not exist")
    config_path = args.config or str(ckpt_path.parent.parent / "hparams.yaml")
    if not Path(config_path).exists():
        raise SystemExit(
            f"ERROR: no config found at {config_path}; pass --config (the reference writes "
            "hparams.yaml next to its checkpoints dir).")

    cfg = load_any_config(config_path)
    if args.override:
        cfg.merge_from_list(list(args.override))
    ckpt = load_reference_checkpoint(str(ckpt_path))
    sd = ckpt.get("state_dict", ckpt)
    step = int(ckpt.get("global_step", 0))
    paths = new_run_paths(cfg, args.run_name)

    from nerfmeshes_tpu_torch.train.factory import build_system

    system = build_system(cfg, paths, args.device)
    if str(cfg.experiment.model) == "BuFFModel":
        transplant_state_dict(system.coarse, sd, "model.", dict(cfg.models.coarse))
        if "tree" in ckpt:
            data = convert_reference_tree(ckpt["tree"], system.tree)
            system.tree_state = system.tree.deserialize(data, system.device)
            print(f"imported BuFF tree: {int(data['num_leaves'])} voxels")
        else:
            print("WARNING: no 'tree' entry in the checkpoint; starting from the initial root "
                  "subdivision.")
    else:
        transplant_state_dict(system.coarse, sd, "model_coarse.", dict(cfg.models.coarse))
        if any(k.startswith("model_fine.") for k in sd):
            if system.fine is None:
                raise SystemExit(
                    "ERROR: the checkpoint has a fine network (model_fine.*) but the config "
                    "sets models.use_fine: False — import with the run's own hparams.yaml or "
                    "override models.use_fine True.")
            transplant_state_dict(system.fine, sd, "model_fine.", dict(cfg.models.fine))
    system.state.step = step
    system.save(val_loss=None)
    print(f"imported step {step} -> {paths.log_dir}")
    print("note: optimizer moments reset (weights-only import)")
    print(f"eval: python -m nerfmeshes_tpu_torch.cli.eval_nerf --log-checkpoint {paths.log_dir}")
    return system


if __name__ == "__main__":
    main()
