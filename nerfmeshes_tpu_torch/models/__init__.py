"""Radiance-field models of the port."""

from nerfmeshes_tpu_torch.models.layers import PositionalEncoding, TorchLinear
from nerfmeshes_tpu_torch.models.nerf_models import FlexibleNeRFModel, build_model

__all__ = ["FlexibleNeRFModel", "PositionalEncoding", "TorchLinear", "build_model"]
