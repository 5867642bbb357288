"""Volume rendering: alpha compositing of a sampled radiance field
(counterpart of nerfmeshes_tpu/ops/render.py).

Keeps the reference's metric-affecting quirks, as the JAX package does:
sigma noise only in training, eval-only depth zeroing where acc < 1,
disp NaN -> 0, the white background, and the `mask_weights`
transmittance mask of BuFF integration.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from nerfmeshes_tpu_torch.ops.math import cumprod_exclusive_positive


class RenderOutput(NamedTuple):
    rgb_map: torch.Tensor  # (..., 3)
    depth_map: torch.Tensor  # (...)
    weights: torch.Tensor  # (..., S)
    mask_weights: torch.Tensor  # (..., S)
    acc_map: torch.Tensor  # (...)
    disp_map: torch.Tensor  # (...)


def _distances(depth_values: torch.Tensor, ray_directions: torch.Tensor) -> torch.Tensor:
    one_e_10 = torch.full_like(depth_values[..., :1], 1e10)
    dists = torch.cat([depth_values[..., 1:] - depth_values[..., :-1], one_e_10], dim=-1)
    return dists * torch.linalg.norm(ray_directions, dim=-1)[..., None]


def volume_render(
    radiance_field: torch.Tensor,
    depth_values: torch.Tensor,
    ray_directions: torch.Tensor,
    *,
    train: bool,
    radiance_field_noise_std: float = 0.0,
    white_background: bool = False,
    attenuation_threshold: float = 1e-5,
    generator: Optional[torch.Generator] = None,
    channels_first: bool = False,
) -> RenderOutput:
    """Composite per-sample (rgb, sigma) into per-ray maps.

    radiance_field: (..., S, 4) — rgb in [0,1] plus raw sigma — or, with
    `channels_first`, (4, ..., S), the fused kernel's output layout.
    depth_values: (..., S); ray_directions: (..., 3)."""
    dists = _distances(depth_values, ray_directions)
    if channels_first:
        rgb, sigma = radiance_field[:3], radiance_field[3]
    else:
        rgb, sigma = radiance_field[..., :3], radiance_field[..., 3]
    if radiance_field_noise_std > 0.0:
        noise = torch.randn(sigma.shape, dtype=sigma.dtype, device=sigma.device,
                            generator=generator)
        sigma = sigma + noise * radiance_field_noise_std

    alpha = 1.0 - torch.exp(-torch.relu(sigma) * dists)
    transmittance = cumprod_exclusive_positive(1.0 - alpha + 1e-10)
    mask_weights = (transmittance > attenuation_threshold).to(alpha.dtype)
    weights = alpha * transmittance

    if channels_first:
        rgb_map = torch.sum(weights[None] * rgb, dim=-1).movedim(0, -1)
    else:
        rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    acc_map = torch.sum(weights, dim=-1)
    depth_map = torch.sum(weights * depth_values, dim=-1)

    disp_map = 1.0 / torch.maximum(torch.full_like(depth_map, 1e-10), depth_map / acc_map)
    disp_map = torch.where(torch.isnan(disp_map), torch.zeros_like(disp_map), disp_map)

    if not train:
        depth_map = torch.where(acc_map < 1.0, torch.zeros_like(depth_map), depth_map)
    if white_background:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])

    return RenderOutput(
        rgb_map=rgb_map,
        depth_map=depth_map,
        weights=weights,
        mask_weights=mask_weights,
        acc_map=acc_map,
        disp_map=disp_map,
    )


def density_weights(sigma: torch.Tensor, depth_values: torch.Tensor,
                    ray_directions: torch.Tensor) -> torch.Tensor:
    """Per-sample compositing weights from raw sigma (..., S) alone: the
    geometry half of `volume_render`."""
    dists = _distances(depth_values, ray_directions)
    alpha = 1.0 - torch.exp(-torch.relu(sigma) * dists)
    return alpha * cumprod_exclusive_positive(1.0 - alpha + 1e-10)
