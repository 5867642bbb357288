"""Surface point clouds by ray casting: coloured, oriented points
(counterpart of nerfmeshes_tpu/mesh/surface_ray.py).

- Render an orbit of views (`pose_spherical`, 8 azimuths x 4 elevations
  by default) through the system's render path: the forward kernel on
  the card.
- Lift each pixel's expected depth to a world point `o + d * depth`.
- Keep the pixels whose point agrees with its (2s+1)^2 pixel neighbourhood
  and whose depth is positive (the eval render zeroes the depth of a ray
  that never saturates).
- Write the points, their normals `-d` and the rendered colours to PLY.

The neighbourhood test is (2s+1)^2 shifted views of one edge-padded map,
where JAX jits 25 static slices; the lift, the mask and the colour
quantization run on the system's device, and only the points, the mask
and uint8 colours of each view come to the host, after every view has
been enqueued.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


def neighborhood_consistency_mask(
    surface_points: torch.Tensor,
    step_size: int = 2,
    dist_threshold: float = 0.002,
    prob_threshold: float = 0.6,
) -> torch.Tensor:
    """Per-pixel surface-consistency mask.

    For every pixel, count the (2s+1)^2 window entries (border-clamped,
    self included) whose point lies within squared distance
    `dist_threshold`; keep pixels where the count exceeds `prob_threshold`
    of the (2s+1)^2 - 1 true neighbours.

    Args:
        surface_points: (H, W, 3) f32 world-space expected-depth points.
        step_size: neighbourhood half-width s.
        dist_threshold: max squared distance for a neighbour to agree.
        prob_threshold: fraction of the (2s+1)^2 - 1 neighbours that must
            agree.

    Returns:
        (H, W) bool mask, on the points' device.
    """
    s = int(step_size)
    h, w = surface_points.shape[:2]
    device = surface_points.device
    # Edge padding as clamped indices: row/column i of the padded map is
    # row/column clamp(i - s) of the map.
    rows = torch.arange(-s, h + s, device=device).clamp(0, h - 1)
    cols = torch.arange(-s, w + s, device=device).clamp(0, w - 1)
    padded = surface_points[rows][:, cols]
    count = torch.zeros((h, w), dtype=torch.int32, device=device)
    for a in range(2 * s + 1):
        for b in range(2 * s + 1):
            nb = padded[a:a + h, b:b + w, :]
            d2 = torch.sum((nb - surface_points) ** 2, dim=-1)
            count += (d2 < dist_threshold).to(torch.int32)
    size_samples = (2 * s + 1) ** 2 - 1
    return count > size_samples * prob_threshold


def orbit_poses(poses_y: int = 8, poses_x: int = 4, radius: float = 4.0) -> np.ndarray:
    """The spherical pose grid: `poses_y` azimuths over [-180, 180) x
    `poses_x` elevations over [-90, 90]; (poses_y * poses_x, 4, 4) f32."""
    from nerfmeshes_tpu_torch.data.helpers import pose_spherical

    return np.stack([
        pose_spherical(float(ay), float(ax), float(radius))
        for ay in np.linspace(-180.0, 180.0, poses_y, endpoint=False)
        for ax in np.linspace(-90.0, 90.0, poses_x, endpoint=True)
    ])


def _pixel_dirs_cam(h: int, w: int, focal: float) -> np.ndarray:
    """Host-side camera-space unit pixel directions, the numpy mirror of
    `ops.rays.pixel_directions` under `CameraIntrinsics.from_hwf` (-z
    forward, y up, centred principal point). Normals are these rotated by
    each pose, so no (H, W, 3) direction map is fetched per view."""
    ii, jj = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32),
                         indexing="xy")
    dirs = np.stack([(ii - w * 0.5) / focal, -(jj - h * 0.5) / focal, -np.ones_like(ii)],
                    axis=-1)
    return dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)


def _mask_pack(origin, dirs, depth, rgb, dist_threshold, prob_threshold, *,
               step_size: int = 2):
    """The device pass after a view's render: its depths lifted to points,
    the consistency mask, the colours quantized to uint8."""
    h, w = dirs.shape[:2]
    depth = depth.reshape(h, w)
    points = origin.reshape(1, 1, 3) + dirs * depth[..., None]
    mask = neighborhood_consistency_mask(
        points, step_size=step_size, dist_threshold=dist_threshold,
        prob_threshold=prob_threshold) & (depth > 0)
    rgb_u8 = torch.clamp(rgb.reshape(h, w, 3) * 255.0, 0, 255).to(torch.uint8)
    return points, mask, rgb_u8


def surface_points_from_views(
    system,
    poses: Sequence[np.ndarray],
    hwf,
    near: float,
    far: float,
    step_size: int = 2,
    dist_threshold: float = 0.002,
    prob_threshold: float = 0.6,
    log_every: int = 0,
):
    """Ray-cast `poses` through `system` and collect the masked surface
    points.

    `system` needs `device` and `query_rays(o, d, near, far, fields=...,
    as_numpy=False)` returning maps with `rgb_map` and `depth_map`
    (NeRFSystem and BuFFSystem both qualify). Every view is enqueued before
    any is fetched.

    Returns:
        (points, normals, colors): f32 (N, 3) host arrays. Normals are the
        negated view directions; colours in [0, 1], uint8-quantized (what
        the PLY stores).
    """
    from nerfmeshes_tpu_torch.ops.rays import get_ray_bundle

    h, w, focal = int(hwf[0]), int(hwf[1]), float(hwf[2])
    device = system.device
    dirs_cam = _pixel_dirs_cam(h, w, focal)

    pending = []
    with torch.inference_mode():
        for pose in poses:
            origin, dirs = get_ray_bundle(
                h, w, focal, torch.as_tensor(pose, dtype=torch.float32, device=device))
            out = system.query_rays(origin.reshape(1, 3), dirs.reshape(-1, 3), float(near),
                                    float(far), fields=("rgb_map", "depth_map"),
                                    as_numpy=False)
            depth = torch.as_tensor(out.depth_map, dtype=torch.float32, device=device)
            rgb = torch.as_tensor(out.rgb_map, dtype=torch.float32, device=device)
            pending.append((pose, _mask_pack(origin, dirs, depth, rgb, dist_threshold,
                                             prob_threshold, step_size=int(step_size))))

    if not getattr(getattr(system, "group", None), "is_main", True):
        log_every = 0  # rank 0 alone prints
    pts_all, nrm_all, rgb_all = [], [], []
    for i, (pose, packed) in enumerate(pending):
        points, mask, rgb = (t.cpu().numpy() for t in packed)
        rot = np.asarray(pose, np.float32)[:3, :3]
        world_dirs = dirs_cam @ rot.T
        pts_all.append(points[mask])
        nrm_all.append(-world_dirs[mask])
        rgb_all.append(rgb[mask].astype(np.float32) / 255.0)
        if log_every and (i + 1) % log_every == 0:
            kept = sum(len(p) for p in pts_all)
            print(f"[surface-ray] view {i + 1}/{len(pending)}: {kept} points kept", flush=True)

    def cat(xs):
        return np.concatenate(xs, axis=0) if xs else np.zeros((0, 3), np.float32)

    return cat(pts_all), cat(nrm_all), cat(rgb_all)


def export_surface_ray(
    system,
    filename: str,
    hwf=None,
    near: Optional[float] = None,
    far: Optional[float] = None,
    poses_y: int = 8,
    poses_x: int = 4,
    radius: float = 4.0,
    step_size: int = 2,
    dist_threshold: float = 0.002,
    prob_threshold: float = 0.6,
    binary: bool = True,
    log_every: int = 4,
):
    """Orbit poses -> masked surface points -> PLY file (binary, or ASCII
    with `binary=False`). Defaults: 8 x 4 poses at radius 4, 800^2 views at
    focal 1111.1111, s = 2, squared distance 0.002, fraction 0.6; near and
    far from the system's config. Returns (points, normals, colors). A
    system with a sharded `group` renders each view over its group; every
    rank returns the points, rank 0 alone prints and writes the file."""
    from nerfmeshes_tpu_torch.mesh.export import export_ply, export_ply_binary

    if hwf is None:
        hwf = (800, 800, 1111.1111)
    if near is None:
        near = float(system.cfg.dataset.near)
    if far is None:
        far = float(system.cfg.dataset.far)
    poses = orbit_poses(poses_y, poses_x, radius)
    points, normals, colors = surface_points_from_views(
        system, poses, hwf, near, far, step_size=step_size, dist_threshold=dist_threshold,
        prob_threshold=prob_threshold, log_every=log_every)
    group = getattr(system, "group", None)
    if group is None or group.is_main:
        writer = export_ply_binary if binary else export_ply
        writer(points, triangles=None, colors=colors, normals=normals, filename=filename)
    if group is not None:
        group.barrier()
    return points, normals, colors
