"""Depth samples along rays: stratified and hierarchical (counterpart of
nerfmeshes_tpu/ops/sampling.py).

The JAX package replaces searchsorted, gathers and the sort of the merged
samples with masked reductions that suit the TPU; here torch.searchsorted,
gather and torch.sort do the same work. The edge semantics are the JAX
package's: +1e-5 on the weights, the clamp to the last bin when
u >= cdf[-1], and a denominator below 1e-5 taken as 1.
"""

from __future__ import annotations

from typing import Optional

import torch


def ray_sample_interval(
    num_samples: int,
    ray_count: int,
    near,
    far,
    *,
    lindisp: bool = False,
    perturb: bool = False,
    generator: Optional[torch.Generator] = None,
    dtype: torch.dtype = torch.float32,
    device: Optional[torch.device] = None,
) -> torch.Tensor:
    """Stratified depths (ray_count, num_samples) between near and far,
    each a scalar or per-ray (ray_count,); linear in disparity with
    `lindisp`, jittered inside each mid-point bin with `perturb`."""
    t = torch.linspace(0.0, 1.0, num_samples, dtype=dtype, device=device)[None, :]

    def bound(x):
        # A scalar bound stays a 0-dim CPU tensor, which combines with
        # device tensors as a scalar: copying it to the device would be a
        # blocking host-to-device copy, a stream sync per render chunk.
        x = torch.as_tensor(x, dtype=dtype)
        return x if x.dim() == 0 else x.to(device)[:, None]

    near, far = bound(near), bound(far)

    if not lindisp:
        intervals = near * (1.0 - t) + far * t
    else:
        intervals = 1.0 / (1.0 / near * (1.0 - t) + 1.0 / far * t)
    intervals = intervals.expand(ray_count, num_samples)

    if perturb:
        mids = 0.5 * (intervals[..., 1:] + intervals[..., :-1])
        upper = torch.cat([mids, intervals[..., -1:]], dim=-1)
        lower = torch.cat([intervals[..., :1], mids], dim=-1)
        t_rand = torch.rand(intervals.shape, dtype=dtype, device=intervals.device,
                            generator=generator)
        intervals = lower + (upper - lower) * t_rand
    return intervals.contiguous()


def sorted_uniforms(generator: Optional[torch.Generator], shape, *,
                    dtype: torch.dtype = torch.float32,
                    device: Optional[torch.device] = None) -> torch.Tensor:
    """Order statistics of n iid U(0, 1) along the last axis of `shape`:
    the normalised cumulative sums of n + 1 exponential spacings, which are
    jointly distributed as sorted uniforms (the JAX package's sort-free
    construction). On the generator's device unless `device` says."""
    *batch, n = shape
    if device is None:
        device = generator.device if generator is not None else None
    e = torch.empty((*batch, n + 1), dtype=dtype, device=device).exponential_(
        generator=generator)
    cums = torch.cumsum(e, dim=-1)
    return cums[..., :-1] / cums[..., -1:]


def merge_sorted(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Merge two row-sorted arrays (..., n) + (..., m) -> (..., n + m),
    ties `a` first: a stable sort of the concatenation (JAX builds the same
    values from rank sums, which suit its TPU)."""
    return torch.sort(torch.cat([a, b], dim=-1), dim=-1, stable=True).values


def sample_pdf(
    bins: torch.Tensor,
    weights: torch.Tensor,
    num_samples: int,
    *,
    deterministic: bool = True,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Inverse-CDF sampling of `num_samples` depths from bin weights.

    bins: (..., B) sorted positions; weights: (..., B-1), one per bin
    interval. Gradients are stopped. Stochastic draws are sorted, so the
    output is depth-sorted in both modes."""
    if weights.shape[-1] != bins.shape[-1] - 1:
        raise ValueError(
            f"sample_pdf expects weights.shape[-1] == bins.shape[-1]-1, got "
            f"{weights.shape[-1]} vs {bins.shape[-1]}"
        )
    weights = weights.detach() + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1).contiguous()  # (..., B)

    shape = (*cdf.shape[:-1], num_samples)
    if deterministic:
        u = torch.linspace(0.0, 1.0, num_samples, dtype=cdf.dtype, device=cdf.device)
        u = u.expand(shape).contiguous()
    else:
        u = torch.rand(shape, dtype=cdf.dtype, device=cdf.device, generator=generator)
        u = torch.sort(u, dim=-1).values

    # inds = number of cdf entries <= u; below/above clamp to the last bin
    # when u >= cdf[-1] (then denom == 0 -> 1 and the sample is bins[-1]).
    last = cdf.shape[-1] - 1
    inds = torch.searchsorted(cdf, u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=last)
    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    bins = bins.detach()
    bins_below = torch.gather(bins, -1, below)
    bins_above = torch.gather(bins, -1, above)

    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


def hierarchical_intervals(
    intervals: torch.Tensor,
    weights: torch.Tensor,
    num_fine: int,
    *,
    perturb: bool = False,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Fine-pass depths: PDF samples between the coarse mid-points, merged
    with the coarse depths in ascending order.
    intervals (..., Sc), weights (..., Sc) -> (..., Sc + num_fine)."""
    mids = 0.5 * (intervals[..., 1:] + intervals[..., :-1])
    samples = sample_pdf(
        mids, weights[..., 1:-1], num_fine, deterministic=not perturb, generator=generator
    )
    merged = torch.cat([intervals.detach(), samples], dim=-1)
    return torch.sort(merged, dim=-1).values
