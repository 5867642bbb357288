"""Experiment path resolution (counterpart of nerfmeshes_tpu/config/paths.py).

Layout: <logdir>/<experiment.id>/<run_name>/version_<k>/
           hparams.yaml          (flat dot-keyed config, resume source)
           checkpoints/          (train/checkpoint.py: <step>/ and last/)
           events/               (metrics.jsonl, images/, events.out.tfevents.*)

A new run picks the next free version_k; `--log-checkpoint` resumes by
re-nesting the flat hparams.yaml into a CfgNode. hparams.yaml is written
and read by config/yaml_lite.py, and yaml.safe_load reads it back equal,
so the JAX package's load_hparams reads a port run's config too.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

from nerfmeshes_tpu_torch.config import yaml_lite
from nerfmeshes_tpu_torch.config.cfgnode import CfgNode, flatten_dict, nest_dict
from nerfmeshes_tpu_torch.config.schema import get_default_cfg, load_config


@dataclass
class ExperimentPaths:
    log_dir: Path
    checkpoint_dir: Path = field(init=False)
    hparams_path: Path = field(init=False)
    events_dir: Path = field(init=False)

    def __post_init__(self):
        self.log_dir = Path(self.log_dir)
        self.checkpoint_dir = self.log_dir / "checkpoints"
        self.hparams_path = self.log_dir / "hparams.yaml"
        self.events_dir = self.log_dir / "events"

    def create(self) -> "ExperimentPaths":
        for d in (self.log_dir, self.checkpoint_dir, self.events_dir):
            os.makedirs(d, exist_ok=True)
        return self


def save_hparams(cfg, paths: ExperimentPaths) -> None:
    """The run's flat hparams.yaml, written whole: into a file of its own
    in the run directory, then moved over the old one (os.replace), so
    that a reader beside it (an eval or mesh CLI on a run that resumes)
    sees the old file or the new one, never an empty or partial one."""
    path = Path(paths.hparams_path)
    tmp = path.with_name(f".{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        with open(tmp, "w") as fh:
            fh.write(yaml_lite.dump(flatten_dict(cfg.to_dict())))
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)


def load_hparams(log_dir) -> CfgNode:
    """Recover the full config from a run's flat hparams.yaml."""
    flat = yaml_lite.load(Path(log_dir) / "hparams.yaml")
    cfg = get_default_cfg()
    cfg.merge_from_other_cfg(CfgNode(nest_dict(flat)))
    return cfg


def resolve_paths(
    config_path: Optional[str] = None,
    log_checkpoint: Optional[str] = None,
    run_name: Optional[str] = None,
    overrides: Optional[list] = None,
) -> tuple[CfgNode, ExperimentPaths]:
    """New run from a config YAML, or resume from an existing log dir.

    Exactly one of config_path / log_checkpoint must be given. `overrides`
    (dotted KEY VALUE pairs, the --override flag) merge into the config
    BEFORE the run directory is derived and hparams.yaml is written, so
    experiment.id / experiment.logdir overrides place the run, and a later
    resume keeps every override. Resume-time overrides are written back to
    hparams.yaml too: the next resume, eval or mesh reads them from there.
    """
    if (config_path is None) == (log_checkpoint is None):
        raise ValueError("Provide exactly one of config_path or log_checkpoint")

    if log_checkpoint is not None:
        cfg = load_hparams(log_checkpoint)
        paths = ExperimentPaths(Path(log_checkpoint)).create()
        if overrides:
            cfg.merge_from_list(list(overrides))
            save_hparams(cfg, paths)
        return cfg, paths

    cfg = load_config(config_path)
    if overrides:
        cfg.merge_from_list(list(overrides))
    run = run_name or "default"
    base = Path(cfg.experiment.logdir) / cfg.experiment.id / run
    version = 0
    while (base / f"version_{version}").exists():
        version += 1
    paths = ExperimentPaths(base / f"version_{version}").create()
    save_hparams(cfg, paths)
    return cfg, paths
