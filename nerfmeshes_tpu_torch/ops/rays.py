"""Camera-ray generation and coordinate transforms (counterpart of
nerfmeshes_tpu/ops/rays.py)."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class CameraIntrinsics(NamedTuple):
    """Pinhole intrinsics + axis convention for ray generation.

    Blender/LLFF scenes: camera looks down -z, y up, centered principal
    point, normalized directions. RGB-D streams like ScanNet: +z,
    image-down y, explicit principal point, unnormalized directions."""

    fx: float
    fy: float
    cx: float
    cy: float
    z_sign: float = -1.0
    flip_y: bool = True
    normalize: bool = True

    @classmethod
    def from_hwf(cls, H: int, W: int, focal: float) -> "CameraIntrinsics":
        return cls(fx=float(focal), fy=float(focal), cx=W * 0.5, cy=H * 0.5)


def pixel_directions(x: torch.Tensor, y: torch.Tensor,
                     intr: CameraIntrinsics) -> torch.Tensor:
    """Camera-space direction for pixel coords x, y (any shape) -> (..., 3)."""
    ydir = (y - intr.cy) / intr.fy
    if intr.flip_y:
        ydir = -ydir
    dirs = torch.stack([(x - intr.cx) / intr.fx, ydir, torch.full_like(x, intr.z_sign)], dim=-1)
    if intr.normalize:
        dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    return dirs


def get_ray_bundle(height: int, width: int, focal_length,
                   cam2world: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pinhole ray bundle, one ray per pixel: cam2world (..., 4, 4) ->
    origins (..., 3), world-space unit directions (..., H, W, 3)."""
    intr = CameraIntrinsics.from_hwf(height, width, focal_length)
    return get_ray_bundle_intrinsics(height, width, intr, cam2world)


def get_ray_bundle_intrinsics(height: int, width: int, intr: CameraIntrinsics,
                              cam2world: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ray bundle under arbitrary pinhole intrinsics/conventions."""
    cam2world = torch.as_tensor(cam2world)
    kw = dict(dtype=cam2world.dtype, device=cam2world.device)
    xs = torch.arange(width, **kw)
    ys = torch.arange(height, **kw)
    ii, jj = torch.meshgrid(xs, ys, indexing="xy")  # each (H, W)
    directions = pixel_directions(ii, jj, intr)
    rot = cam2world[..., :3, :3]
    world_dirs = torch.einsum("...ij,hwj->...hwi", rot, directions)
    return cam2world[..., :3, -1], world_dirs


def ndc_rays(height: int, width: int, focal: float, near: float,
             rays_o: torch.Tensor, rays_d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shift rays to the near plane and warp to normalized device coords
    (forward-facing LLFF scenes)."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    ox, oy, oz = rays_o[..., 0], rays_o[..., 1], rays_o[..., 2]
    dx, dy, dz = rays_d[..., 0], rays_d[..., 1], rays_d[..., 2]

    o0 = -1.0 / (width / (2.0 * focal)) * ox / oz
    o1 = -1.0 / (height / (2.0 * focal)) * oy / oz
    o2 = 1.0 + 2.0 * near / oz

    d0 = -1.0 / (width / (2.0 * focal)) * (dx / dz - ox / oz)
    d1 = -1.0 / (height / (2.0 * focal)) * (dy / dz - oy / oz)
    d2 = -2.0 * near / oz

    return torch.stack([o0, o1, o2], dim=-1), torch.stack([d0, d1, d2], dim=-1)


def intervals_to_ray_points(intervals: torch.Tensor, directions: torch.Tensor,
                            origins: torch.Tensor) -> torch.Tensor:
    """points = o + d * t: intervals (..., S), directions (..., 3),
    origins (..., 3) or (3,) -> (..., S, 3)."""
    return origins[..., None, :] + directions[..., None, :] * intervals[..., :, None]
