"""NeRFSystem, serving half (counterpart of nerfmeshes_tpu/train/system.py).

Builds the coarse/fine models from a config, initialises them from the
config's seed, and renders rays at validation settings. Training
(`fit`, `validate`), checkpoints and the optimizer come with slice 2.
"""

from __future__ import annotations

from typing import Optional

import torch

from nerfmeshes_tpu_torch.models import build_model
from nerfmeshes_tpu_torch.models.layers import TorchLinear
from nerfmeshes_tpu_torch.ops.kernels.fused_mlp import fused_flexible_apply, supports_fused
from nerfmeshes_tpu_torch.train.step import make_render_chunk, render_image, round_chunk


def compute_dtype_from_cfg(cfg) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}[
        str(cfg.experiment.compute_dtype)
    ]


def create_models(cfg, device: Optional[torch.device] = None):
    """(coarse, fine | None) from cfg.models.*."""
    dtype = compute_dtype_from_cfg(cfg)
    coarse = build_model(cfg.models.coarse_type, dict(cfg.models.coarse),
                         compute_dtype=dtype, device=device)
    fine = None
    if "fine" in cfg.models and cfg.models.use_fine:
        fine = build_model(cfg.models.fine_type, dict(cfg.models.fine),
                           compute_dtype=dtype, device=device)
    return coarse, fine


def init_params(coarse, fine, generator: torch.Generator) -> None:
    """Redraw every layer of the coarse, then the fine model from
    `generator` (torch's default init), in place. The generator and the
    models must be on one device."""
    for model in (coarse, fine):
        if model is None:
            continue
        for module in model.modules():
            if isinstance(module, TorchLinear):
                module.reset_parameters(generator)


class NeRFSystem:
    """Owns the coarse/fine models and serves renders and point queries."""

    def __init__(self, cfg, device: Optional[torch.device] = None):
        self.cfg = cfg
        self.device = torch.device("cpu") if device is None else torch.device(device)
        # Drawn on the CPU so a seed gives the same weights on every device.
        self.coarse, self.fine = create_models(cfg)
        generator = torch.Generator().manual_seed(int(cfg.experiment.randomseed))
        init_params(self.coarse, self.fine, generator)
        for model in (self.coarse, self.fine):
            if model is not None:
                model.to(self.device).eval()
        self._render_chunk = None

    def setup_eval(self) -> "NeRFSystem":
        """Build the chunk renderer at validation settings."""
        self._render_chunk = make_render_chunk(self.cfg, self.coarse, self.fine)
        return self

    def query_rays(self, origins, directions, near, far, chunk: Optional[int] = None,
                   fields: Optional[tuple] = None, as_numpy: bool = True):
        """Render rays with the finest model at validation settings; see
        render_image for `fields` and `as_numpy`."""
        if self._render_chunk is None:
            raise RuntimeError("call setup_eval() before query_rays()")
        chunk = round_chunk(chunk or self.cfg.nerf.validation.chunksize)
        coarse, fine = render_image(
            self._render_chunk, origins, directions, float(near), float(far),
            chunk_size=chunk, fields=fields, as_numpy=as_numpy,
        )
        return fine if fine is not None else coarse

    @torch.inference_mode()
    def sample_points(self, points: torch.Tensor,
                      directions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Point query of the finest field -> (..., 4)."""
        model = self.fine if self.fine is not None else self.coarse
        if (bool(self.cfg.experiment.get("use_fused_kernel", True))
                and directions is not None and supports_fused(model)):
            return fused_flexible_apply(model, points, directions)
        return model(points, directions)
