"""Hierarchical NeRF renderer (counterpart of nerfmeshes_tpu/train/render.py):
coarse samples -> field -> composite -> PDF samples -> fine field ->
composite, for one batch of rays."""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from nerfmeshes_tpu_torch.models.nerf_models import DropModel, field_of
from nerfmeshes_tpu_torch.ops.kernels.fused_mlp import (
    fused_flexible_apply_rays,
    supports_fused,
)
from nerfmeshes_tpu_torch.ops.rays import intervals_to_ray_points
from nerfmeshes_tpu_torch.ops.render import RenderOutput, volume_render
from nerfmeshes_tpu_torch.ops.sampling import hierarchical_intervals, ray_sample_interval


class RenderSettings(NamedTuple):
    """Static per-mode settings (from cfg.nerf.train / cfg.nerf.validation)."""

    num_coarse: int
    num_fine: int
    perturb: bool
    lindisp: bool
    radiance_field_noise_std: float
    white_background: bool
    use_fine: bool
    attenuation_threshold: float = 1e-5
    use_fused_kernel: bool = True

    @classmethod
    def from_cfg(cls, cfg, train: bool) -> "RenderSettings":
        mode = cfg.nerf.train if train else cfg.nerf.validation
        return cls(
            num_coarse=mode.num_coarse,
            num_fine=mode.num_fine,
            perturb=bool(mode.perturb),
            lindisp=bool(mode.lindisp),
            radiance_field_noise_std=float(mode.radiance_field_noise_std),
            white_background=bool(cfg.dataset.white_background),
            use_fine=bool(cfg.models.use_fine),
            use_fused_kernel=bool(cfg.experiment.get("use_fused_kernel", True)),
        )


def draws_in_training(model) -> bool:
    """Whether `model`'s training forward takes random numbers (DropModel's
    dropout)."""
    return isinstance(model, DropModel)


def _apply_field(model, origins: torch.Tensor, ray_directions: torch.Tensor,
                 intervals: torch.Tensor, use_fused: bool = False,
                 inference: bool = False,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The field of `model` over rays o, d (R, 3) at depths (R, S), returned
    CHANNELS-FIRST (4, R, S). With `use_fused`, eligible models run through
    the fused MLP kernels straight from the rays: the forward kernel alone
    with `inference`, else the training Function (forward and backward
    kernels). Others expand the points and call the nn.Module: a DropModel
    drops from `generator` unless `inference` (nerfmeshes_tpu/train/
    render.py:74-87), and a (field, aux) output gives its field."""
    if use_fused and supports_fused(model):
        return fused_flexible_apply_rays(model, origins, ray_directions, intervals,
                                         inference=inference)
    points = intervals_to_ray_points(intervals, ray_directions, origins)
    dirs = ray_directions[..., None, :].expand(points.shape)
    if draws_in_training(model) and not inference:
        out = model(points, dirs, deterministic=False, generator=generator)
    else:
        out = model(points, dirs)
    return field_of(out).movedim(-1, 0)


def render_rays(
    coarse_model,
    fine_model,
    ray_origins: torch.Tensor,
    ray_directions: torch.Tensor,
    near,
    far,
    settings: RenderSettings,
    *,
    train: bool,
    generator: Optional[torch.Generator] = None,
) -> Tuple[RenderOutput, Optional[RenderOutput]]:
    """Hierarchical render of a ray batch.

    ray_origins: (R, 3) or (3,); ray_directions: (R, 3); near/far: scalars
    or (R,). `generator` (on the rays' device) feeds the stochastic
    branches: perturbed samples whenever settings.perturb, sigma noise and
    a DropModel's dropout in training. A training render that needs random
    numbers for perturb or noise and has no generator raises, as JAX's does
    without a key (train/render.py:110-114); any other render without one
    draws from a generator seeded 0, as JAX falls back to key(0)."""
    R = ray_directions.shape[0]
    device = ray_directions.device
    needs_rng = train and (settings.perturb or settings.radiance_field_noise_std > 0.0)
    if needs_rng and generator is None:
        raise ValueError("training render with perturb/noise requires a generator")
    if generator is None and (settings.perturb or (train and any(
            draws_in_training(m) for m in (coarse_model, fine_model)))):
        generator = torch.Generator(device).manual_seed(0)
    origins = torch.reshape(ray_origins, (-1, 3)).expand(R, 3)
    noise_std = settings.radiance_field_noise_std if train else 0.0
    perturb = settings.perturb

    def composite(field, depths):
        return volume_render(
            field, depths, ray_directions,
            train=train,
            radiance_field_noise_std=noise_std,
            white_background=settings.white_background,
            attenuation_threshold=settings.attenuation_threshold,
            generator=generator,
            channels_first=True,
        )

    intervals = ray_sample_interval(
        settings.num_coarse, R, near, far,
        lindisp=settings.lindisp, perturb=perturb, generator=generator,
        dtype=ray_directions.dtype, device=device,
    )
    coarse_field = _apply_field(coarse_model, origins, ray_directions, intervals,
                                use_fused=settings.use_fused_kernel, inference=not train,
                                generator=generator)
    coarse_bundle = composite(coarse_field, intervals)

    fine_bundle = None
    if settings.use_fine and fine_model is not None:
        fine_intervals = hierarchical_intervals(
            intervals, coarse_bundle.weights, settings.num_fine,
            perturb=perturb, generator=generator,
        )
        fine_field = _apply_field(fine_model, origins, ray_directions, fine_intervals,
                                  use_fused=settings.use_fused_kernel, inference=not train,
                                  generator=generator)
        fine_bundle = composite(fine_field, fine_intervals)
    return coarse_bundle, fine_bundle
