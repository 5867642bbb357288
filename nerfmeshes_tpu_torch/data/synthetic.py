"""Procedural ground-truth scenes (counterpart of
nerfmeshes_tpu/data/synthetic.py).

Analytic radiance fields rendered with dense quadrature give pixel-exact
targets and poses without any files: `blobs`, three smooth coloured
Gaussian blobs, and `hard`, crisp SDF surfaces (a torus, a sphere, a
rounded box and three thin rods) under a high-frequency procedural
albedo. Rendering runs on the device in chunks of at most 2**24 sample
points, through the port's own sampling, ray and compositing ops; at
800^2 x 512 samples an unchunked image would need gigabytes of
intermediates. `write_blender_style_dataset` writes a scene to disk in
the Blender layout, for the file loaders.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np
import torch

from nerfmeshes_tpu_torch.data.bundle import DataBundle
from nerfmeshes_tpu_torch.data.helpers import pose_spherical
from nerfmeshes_tpu_torch.device import resolve_device
from nerfmeshes_tpu_torch.ops.rays import get_ray_bundle, intervals_to_ray_points
from nerfmeshes_tpu_torch.ops.render import volume_render
from nerfmeshes_tpu_torch.ops.sampling import ray_sample_interval

# Three gaussian blobs: (center, radius, color, peak density)
_BLOBS = (
    ((0.0, 0.0, 0.0), 0.6, (0.9, 0.3, 0.2), 18.0),
    ((0.5, 0.4, -0.2), 0.35, (0.2, 0.8, 0.3), 25.0),
    ((-0.5, -0.3, 0.3), 0.4, (0.25, 0.35, 0.9), 22.0),
)
_ROD_ENDPOINTS = (
    ((-0.85, -0.85, -0.6), (0.85, 0.6, 0.85)),
    ((-0.8, 0.75, -0.4), (0.8, -0.55, 0.35)),
    ((0.7, -0.75, 0.8), (-0.6, 0.8, -0.75)),
)
_FREQ_A = ((13.0, 7.0, 3.0), (2.0, 17.0, 5.0), (7.0, 3.0, 19.0))
_FREQ_B = ((5.0, 11.0, 2.0), (15.0, 2.0, 7.0), (3.0, 13.0, 11.0))


def _const(values, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(values, dtype=like.dtype, device=like.device)


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1))


def analytic_field(points: torch.Tensor) -> torch.Tensor:
    """The blobs scene: (..., 3) -> (..., 4), rgb in [0, 1] + sigma >= 0."""
    sigma = torch.zeros(points.shape[:-1], dtype=points.dtype, device=points.device)
    rgb_acc = torch.zeros((*points.shape[:-1], 3), dtype=points.dtype, device=points.device)
    for c, r, color, peak in _BLOBS:
        d2 = torch.sum((points - _const(c, points)) ** 2, dim=-1)
        w = peak * torch.exp(-d2 / (2.0 * r * r / 4.0))
        sigma = sigma + w
        rgb_acc = rgb_acc + w[..., None] * _const(color, points)
    rgb = rgb_acc / torch.clamp(sigma[..., None], min=1e-8)
    return torch.cat([torch.clamp(rgb, 0.0, 1.0), sigma[..., None]], dim=-1)


def hard_sdf(points: torch.Tensor) -> torch.Tensor:
    """Signed distance of the hard scene's union surface, (..., 3) -> (...):
    a torus (R 0.55, r 0.16, axis +y), a sphere (r 0.28), a rounded box
    (half-extent 0.22, rounding 0.04) and three rods (capsules, r 0.04)."""
    p = points
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    q = torch.sqrt(x * x + z * z) - 0.55
    d_torus = torch.sqrt(q * q + y * y) - 0.16
    d_sphere = _norm(p - _const((-0.45, 0.35, 0.25), p)) - 0.28
    qb = torch.abs(p - _const((0.45, -0.38, -0.3), p)) - 0.22
    d_box = (_norm(torch.clamp(qb, min=0.0))
             + torch.clamp(torch.amax(qb, dim=-1), max=0.0) - 0.04)
    d = torch.minimum(torch.minimum(d_torus, d_sphere), d_box)
    for a, b in _ROD_ENDPOINTS:
        a, b = _const(a, p), _const(b, p)
        pa, ba = p - a, b - a
        h = torch.clamp(torch.sum(pa * ba, dim=-1) / torch.sum(ba * ba), 0.0, 1.0)
        d = torch.minimum(d, _norm(pa - h[..., None] * ba) - 0.04)
    return d


def _project(p: torch.Tensor, freq) -> torch.Tensor:
    """p @ freq.T in f32 elementwise products (no TF32 on any device)."""
    f = _const(freq, p)
    return p[..., 0:1] * f[:, 0] + p[..., 1:2] * f[:, 1] + p[..., 2:3] * f[:, 2]


def hard_albedo(points: torch.Tensor) -> torch.Tensor:
    """High-frequency albedo (..., 3) in [0, 1]: a 3-D checker (period
    0.25) gating two sine-product colour fields."""
    checker = torch.remainder(torch.sum(torch.floor(points * 8.0), dim=-1), 2.0)
    base_a = 0.5 + 0.5 * torch.sin(_project(points, _FREQ_A))
    base_b = 0.5 + 0.5 * torch.sin(_project(points, _FREQ_B) + 1.3)
    return torch.where(checker[..., None] > 0.5, base_a, base_b)


def hard_field(points: torch.Tensor) -> torch.Tensor:
    """The hard scene (..., 3) -> (..., 4): sigma = 60 sigmoid(-sdf / 0.015)."""
    sigma = 60.0 * torch.sigmoid(-hard_sdf(points) / 0.015)
    return torch.cat([hard_albedo(points), sigma[..., None]], dim=-1)


_FIELDS = {"blobs": analytic_field, "hard": hard_field}


def render_ground_truth(origins: torch.Tensor, directions: torch.Tensor, near: float,
                        far: float, num_samples: int = 256, white_background: bool = False,
                        with_depth: bool = False, scene: str = "blobs"):
    """Dense-quadrature render of a scene -> rgb (..., 3), and with
    `with_depth` the depth (...), 0 where the ray's opacity is at most 0.5
    (the Blender EXR convention for empty rays)."""
    flat_dirs = directions.reshape(-1, 3)
    flat_origins = origins.reshape(-1, 3).expand(flat_dirs.shape)
    z = ray_sample_interval(num_samples, flat_dirs.shape[0], near, far,
                            device=flat_dirs.device)
    field = _FIELDS[scene](intervals_to_ray_points(z, flat_dirs, flat_origins))
    out = volume_render(field, z, flat_dirs, train=True, white_background=white_background)
    rgb = out.rgb_map.reshape(*directions.shape[:-1], 3)
    if not with_depth:
        return rgb
    depth = torch.where(out.acc_map > 0.5,
                        out.depth_map / torch.clamp(out.acc_map, min=1e-6),
                        torch.zeros_like(out.depth_map))
    return rgb, depth.reshape(directions.shape[:-1])


def make_synthetic_dataset(num_images: int = 8, image_size: int = 32, near: float = 2.0,
                           far: float = 6.0, radius: float = 4.0,
                           white_background: bool = False, seed: int = 0,
                           with_depth: bool = False, scene: str = "blobs",
                           num_samples: int = 256, keep_on_device: bool = False,
                           device=None) -> DataBundle:
    """`num_images` orbit views of a scene (seeded poses, a lego-like field
    of view), rendered on `device` (None: the CUDA card) in chunks of
    max(4096, 2**24 // num_samples) rays. With `keep_on_device` the
    targets (and depth) stay there as tensors, else they come to the host
    as numpy."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    thetas = np.linspace(-180, 180, num_images, endpoint=False)
    phis = -30.0 + rng.uniform(-10, 10, size=num_images)
    poses = np.stack([pose_spherical(t, p, radius) for t, p in zip(thetas, phis)])

    H = W = image_size
    focal = 0.5 * W / np.tan(0.5 * 0.6911)
    origins, dirs = get_ray_bundle(H, W, focal, torch.as_tensor(poses, device=device))
    total = num_images * H * W
    chunk = min(max(4096, (1 << 24) // num_samples), total)
    flat_o = origins[:, None, None, :].expand(dirs.shape).reshape(-1, 3)
    flat_d = dirs.reshape(-1, 3)
    rgb = torch.empty((total, 3), dtype=torch.float32, device=device)
    depth = torch.empty((total,), dtype=torch.float32, device=device) if with_depth else None
    with torch.no_grad():
        for start in range(0, total, chunk):
            rows = slice(start, start + chunk)
            out = render_ground_truth(flat_o[rows], flat_d[rows], near, far,
                                      num_samples=num_samples,
                                      white_background=white_background,
                                      with_depth=with_depth, scene=scene)
            if with_depth:
                rgb[rows], depth[rows] = out
            else:
                rgb[rows] = out
    fetch = (lambda t: t) if keep_on_device else (lambda t: t.cpu().numpy())
    return DataBundle(
        ray_targets=fetch(rgb.reshape(num_images, H, W, 3)),
        poses=poses.astype(np.float32),
        hwf=np.array([H, W, focal], dtype=np.float32),
        ray_bounds=np.array([near, far], dtype=np.float32),
        target_depth=None if depth is None else fetch(depth.reshape(num_images, H, W)),
    )


def write_blender_style_dataset(root: str, splits=("train", "val", "test"), num_images: int = 6,
                                image_size: int = 24, scene: str = "blobs",
                                num_samples: int = 256, device=None) -> None:
    """Write a procedural scene as a Blender-format dataset under `root`:
    transforms_{split}.json and {split}/r_{i}.png per split (split k drawn
    with seed k), to drive the real loader path. `num_images` is one count
    for every split or a dict of counts by split name; the scenes render
    on `device` (None: the CUDA card)."""
    from nerfmeshes_tpu_torch.data.blender import write_png

    camera_angle_x = 0.6911
    for si, split in enumerate(splits):
        n = num_images[split] if isinstance(num_images, dict) else num_images
        bundle = make_synthetic_dataset(num_images=n, image_size=image_size, seed=si,
                                        scene=scene, num_samples=num_samples, device=device)
        split_dir = Path(root) / split
        os.makedirs(split_dir, exist_ok=True)
        frames = []
        for i in range(n):
            name = f"./{split}/r_{i}"
            img = (np.clip(bundle.ray_targets[i], 0, 1) * 255).astype(np.uint8)
            write_png(Path(root) / f"{name}.png", img)
            frames.append({"file_path": name, "transform_matrix": bundle.poses[i].tolist()})
        with open(Path(root) / f"transforms_{split}.json", "w") as fh:
            json.dump({"camera_angle_x": camera_angle_x, "frames": frames}, fh)
