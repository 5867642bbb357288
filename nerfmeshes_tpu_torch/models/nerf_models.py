"""Radiance-field models (counterpart of nerfmeshes_tpu/models/nerf_models.py).

Only FlexibleNeRFModel, the canonical NeRF MLP of every shipped reference
config, is ported so far; the rest of the zoo is queued in ROADMAP.md.
Submodule names are the reference's (`layer1`, `layers_xyz.{i}`,
`fc_feat`, `fc_alpha`, `layers_dir.0`, `fc_rgb`), the names that
nerfmeshes_tpu/cli/import_checkpoint.py:70-79 maps, so a reference state
dict loads as it is.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from nerfmeshes_tpu_torch.models.layers import PositionalEncoding, TorchLinear


class FlexibleNeRFModel(nn.Module):
    """PE(xyz) -> `num_layers-1` ReLU layers with a PE-concat skip every
    `skip_step` -> view-conditioned sigmoid rgb head and a raw sigma head.
    Maps points (..., 3) and directions (..., 3) to (..., 4) f32."""

    def __init__(
        self,
        num_layers: int = 4,
        hidden_size: int = 128,
        skip_step: int = 4,
        num_encoding_fn_xyz: int = 6,
        num_encoding_fn_dir: int = 4,
        include_input_xyz: bool = True,
        include_input_dir: bool = True,
        log_sampling_xyz: bool = True,
        log_sampling_dir: bool = True,
        use_viewdirs: bool = True,
        *,
        compute_dtype: torch.dtype = torch.float32,
        device: Optional[torch.device] = None,
    ):
        super().__init__()
        self.num_layers = num_layers
        self.hidden_size = hidden_size
        self.skip_step = skip_step
        self.num_encoding_fn_xyz = num_encoding_fn_xyz
        self.num_encoding_fn_dir = num_encoding_fn_dir
        self.include_input_xyz = include_input_xyz
        self.include_input_dir = include_input_dir
        self.log_sampling_xyz = log_sampling_xyz
        self.log_sampling_dir = log_sampling_dir
        self.use_viewdirs = use_viewdirs
        self.compute_dtype = compute_dtype

        def linear(i, o):
            return TorchLinear(i, o, compute_dtype=compute_dtype, device=device)

        self.encode_xyz = PositionalEncoding(
            num_encoding_fn_xyz, include_input_xyz, log_sampling_xyz
        )
        dim_xyz = self.encode_xyz.output_size()
        self.layer1 = linear(dim_xyz, hidden_size)
        self.layers_xyz = nn.ModuleList(
            linear(hidden_size + (dim_xyz if self.is_skip(i) else 0), hidden_size)
            for i in range(num_layers - 1)
        )
        if use_viewdirs:
            self.encode_dir = PositionalEncoding(
                num_encoding_fn_dir, include_input_dir, log_sampling_dir
            )
            dim_dir = self.encode_dir.output_size()
            self.fc_feat = linear(hidden_size, hidden_size)
            self.fc_alpha = linear(hidden_size, 1)
            self.layers_dir = nn.ModuleList([linear(hidden_size + dim_dir, hidden_size // 2)])
            self.fc_rgb = linear(hidden_size // 2, 3)
        else:
            self.fc_out = linear(hidden_size, 4)

    def is_skip(self, i: int) -> bool:
        """Whether trunk layer i takes [x, PE(xyz)] (nerf_models.py:66)."""
        return i % self.skip_step == 0 and i > 0 and i != self.num_layers - 1

    def forward(self, ray_points: torch.Tensor,
                ray_directions: Optional[torch.Tensor] = None) -> torch.Tensor:
        relu = torch.relu
        xyz = self.encode_xyz(ray_points)
        x = self.layer1(xyz)
        for i, layer in enumerate(self.layers_xyz):
            if self.is_skip(i):
                x = torch.cat([x.float(), xyz], dim=-1)  # x first, then PE
            x = relu(layer(x))
        if self.use_viewdirs:
            view = self.encode_dir(ray_directions)
            feat = relu(self.fc_feat(x))
            alpha = self.fc_alpha(x)  # off the trunk, not off feat
            x = relu(self.layers_dir[0](torch.cat([feat.float(), view], dim=-1)))
            rgb = torch.sigmoid(self.fc_rgb(x))
            return torch.cat([rgb.float(), alpha.float()], dim=-1)
        out = self.fc_out(x).float()
        return torch.cat([torch.sigmoid(out[..., :3]), out[..., 3:]], dim=-1)


def build_model(type_name: str, model_cfg: dict, *,
                compute_dtype: torch.dtype = torch.float32,
                device: Optional[torch.device] = None) -> nn.Module:
    """Instantiate a model by config name, ignoring cfg keys the
    architecture does not take (as the JAX build_model does)."""
    if type_name != "FlexibleNeRFModel":
        raise NotImplementedError(
            f"{type_name} is not ported to nerfmeshes_tpu_torch yet; only "
            "FlexibleNeRFModel is (the rest of the zoo is queued in ROADMAP.md)."
        )
    fields = (
        "num_layers", "hidden_size", "skip_step", "num_encoding_fn_xyz",
        "num_encoding_fn_dir", "include_input_xyz", "include_input_dir",
        "log_sampling_xyz", "log_sampling_dir", "use_viewdirs",
    )
    kwargs = {k: v for k, v in dict(model_cfg).items() if k in fields}
    return FlexibleNeRFModel(**kwargs, compute_dtype=compute_dtype, device=device)
