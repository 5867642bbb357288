"""System by config name (counterpart of nerfmeshes_tpu/train/factory.py)."""

from __future__ import annotations


def build_system(cfg, paths=None, device=None, group=None):
    """NeRFSystem for cfg.experiment.model 'NeRFModel', BuFFSystem for
    'BuFFModel', logging and checkpointing to `paths` (None: neither), on
    `device` (None: the CUDA card), as a rank of `group` (a DataGroup;
    None: one rank)."""
    name = cfg.experiment.model
    if name == "NeRFModel":
        from nerfmeshes_tpu_torch.train.system import NeRFSystem

        return NeRFSystem(cfg, paths, device, group)
    if name == "BuFFModel":
        from nerfmeshes_tpu_torch.buff.system import BuFFSystem

        return BuFFSystem(cfg, paths, device, group)
    raise ValueError(f"Unknown experiment model {name!r}")
