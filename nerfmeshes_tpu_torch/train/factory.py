"""System by config name (counterpart of nerfmeshes_tpu/train/factory.py)."""

from __future__ import annotations


def build_system(cfg, device=None):
    """NeRFSystem for cfg.experiment.model 'NeRFModel', BuFFSystem for
    'BuFFModel', on `device` (None: the CUDA card)."""
    name = cfg.experiment.model
    if name == "NeRFModel":
        from nerfmeshes_tpu_torch.train.system import NeRFSystem

        return NeRFSystem(cfg, device)
    if name == "BuFFModel":
        from nerfmeshes_tpu_torch.buff.system import BuFFSystem

        return BuFFSystem(cfg, device)
    raise ValueError(f"Unknown experiment model {name!r}")
