"""Depth-informed depth samplers (counterpart of
nerfmeshes_tpu/ops/depth_sampling.py).

Working rebuilds of the reference's depth-guided sampling drafts
(src/models/model_helpers.py:38-127, which no live reference model
calls), selectable through `depth_guided_intervals(strategy=...)`. Every
per-ray branch is a `torch.where` over static shapes, and every sorted
random draw is `sorted_uniforms` (ops/sampling.py), as in the JAX package.

The JAX package's deliberate deviations from the drafts, kept here:
- `random_intervals`: the draft scales `rand * (far - near) + near` by the
  FIRST ray's bounds only (`near[0]`); here per-ray bounds broadcast.
- `depth_informed_intervals`: the draft fills unknown-depth rays with
  `rand * far + near` (range [near, near + far]); here the fill is uniform
  in [near, far].
- `surface_band_intervals`: the draft jitters a linspace by +-1/(2 fc1)
  and re-sorts; here the jitter is stratified within mid-point bins (the
  same band, sorted by construction).

Random strategies draw from a torch.Generator where JAX takes a PRNG key:
the two stacks' streams differ, their laws do not.
"""

from __future__ import annotations

from typing import Optional

import torch

from nerfmeshes_tpu_torch.ops.sampling import merge_sorted, ray_sample_interval, sorted_uniforms


def _per_ray(x, ray_count: int, dtype, device) -> torch.Tensor:
    """A scalar or (R,) bound as (R, 1)."""
    x = torch.as_tensor(x, dtype=dtype, device=device)
    if x.dim() == 0:
        x = x.expand(ray_count)
    return x[:, None]


def random_intervals(generator: torch.Generator, near, far, ray_count: int, num_samples: int,
                     *, dtype: torch.dtype = torch.float32,
                     device: Optional[torch.device] = None) -> torch.Tensor:
    """Sorted uniform depths in [near, far] per ray (reference
    get_random_samples, model_helpers.py:50-56), on the generator's device
    unless `device` says."""
    if device is None:
        device = generator.device
    near = _per_ray(near, ray_count, dtype, device)
    far = _per_ray(far, ray_count, dtype, device)
    u = sorted_uniforms(generator, (ray_count, num_samples), dtype=dtype, device=device)
    return near + u * (far - near)


def depth_informed_intervals(generator: torch.Generator, depth: torch.Tensor, near, far,
                             num_samples: int, *, empty: float, threshold: float = 0.5,
                             lindisp: bool = False,
                             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Samples up to just past the known surface: rays with a ground-truth
    depth (`depth != empty`) sample linearly in [near, depth + threshold],
    the others take sorted uniforms over [near, far] (reference
    get_info_samples, model_helpers.py:59-71). depth: (R,)."""
    depth = torch.as_tensor(depth, dtype=dtype)
    ray_count = depth.shape[0]
    has_depth = depth != empty
    far_arr = torch.as_tensor(far, dtype=dtype, device=depth.device).expand(depth.shape)
    far_t = torch.where(has_depth, depth + threshold, far_arr)
    guided = ray_sample_interval(num_samples, ray_count, near, far_t, lindisp=lindisp,
                                 dtype=dtype, device=depth.device)
    fallback = random_intervals(generator, near, far, ray_count, num_samples, dtype=dtype,
                                device=depth.device)
    return torch.where(has_depth[:, None], guided, fallback)


def surface_band_intervals(generator: torch.Generator, depth: torch.Tensor, near, far,
                           num_samples: int, *, empty: float, fc1: float = 10.0,
                           fc2: float = 2.0, off: float = 0.5, lindisp: bool = False,
                           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A jittered fixed band [(0 - off)/fc2, (1 - off)/fc2] for rays with a
    known depth, plain linear [near, far] elsewhere (reference
    get_ln_samples_sm, model_helpers.py:74-89: its commented-out lines
    centre the band on `depth`; the live draft keeps it fixed, and so does
    this). `fc1` is the draft's jitter scale, unused by the stratified
    jitter."""
    depth = torch.as_tensor(depth, dtype=dtype)
    ray_count = depth.shape[0]
    has_depth = depth != empty
    band = ray_sample_interval(num_samples, ray_count, (0.0 - off) / fc2, (1.0 - off) / fc2,
                               perturb=True, generator=generator, dtype=dtype,
                               device=depth.device)
    base = ray_sample_interval(num_samples, ray_count, near, far, lindisp=lindisp, dtype=dtype,
                               device=depth.device)
    return torch.where(has_depth[:, None], band, base)


def proximal_intervals(depth: torch.Tensor, near, far, num_samples: int, *, empty: float,
                       off: float = 0.4, lindisp: bool = False,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Linear samples in [depth - off, far] where the depth is known, linear
    [near, far] elsewhere (reference get_ln_samples_prox,
    model_helpers.py:92-103). Deterministic."""
    depth = torch.as_tensor(depth, dtype=dtype)
    ray_count = depth.shape[0]
    has_depth = depth != empty
    near_arr = torch.as_tensor(near, dtype=dtype, device=depth.device).expand(depth.shape)
    near_t = torch.where(has_depth, depth - off, near_arr)
    # One lerp serves both branches: only the near bound differs.
    return ray_sample_interval(num_samples, ray_count, near_t, far, lindisp=lindisp, dtype=dtype,
                               device=depth.device)


STRATEGIES = ("linear", "random", "depth_informed", "surface_band", "proximal")


def depth_guided_intervals(strategy: str, near, far, ray_count: int, num_samples: int, *,
                           generator: Optional[torch.Generator] = None,
                           depth: Optional[torch.Tensor] = None, empty: float = 0.0,
                           extra_intervals: Optional[torch.Tensor] = None,
                           lindisp: bool = False, dtype: torch.dtype = torch.float32,
                           device: Optional[torch.device] = None) -> torch.Tensor:
    """(ray_count, num_samples) depths by `strategy` (reference sample_sm,
    model_helpers.py:106-127, whose live branch always degenerates to
    get_ln_samples; here each is selectable), merged in order with the
    row-sorted `extra_intervals` when given (the draft's concatenate and
    sort). On the depth's device, else the generator's, else `device`."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; one of {STRATEGIES}")
    if strategy in ("depth_informed", "surface_band", "proximal") and depth is None:
        raise ValueError(f"strategy {strategy!r} requires per-ray depth")
    if strategy in ("random", "depth_informed", "surface_band") and generator is None:
        raise ValueError(f"strategy {strategy!r} requires a generator")
    if depth is not None:
        device = torch.as_tensor(depth).device
    elif generator is not None:
        device = generator.device

    if strategy == "linear":
        z = ray_sample_interval(num_samples, ray_count, near, far, lindisp=lindisp, dtype=dtype,
                                device=device)
    elif strategy == "random":
        z = random_intervals(generator, near, far, ray_count, num_samples, dtype=dtype,
                             device=device)
    elif strategy == "depth_informed":
        z = depth_informed_intervals(generator, depth, near, far, num_samples, empty=empty,
                                     lindisp=lindisp, dtype=dtype)
    elif strategy == "surface_band":
        z = surface_band_intervals(generator, depth, near, far, num_samples, empty=empty,
                                   lindisp=lindisp, dtype=dtype)
    else:
        z = proximal_intervals(depth, near, far, num_samples, empty=empty, lindisp=lindisp,
                               dtype=dtype)
    if extra_intervals is not None:
        z = merge_sorted(z, extra_intervals.to(dtype=z.dtype, device=z.device))
    return z
