"""LLFF forward-facing scenes: poses_bounds.npy + images/ (counterpart of
nerfmeshes_tpu/data/loaders/llff.py, numpy on the host as there).

The pose algebra is JAX's line for line, so poses, bounds and render
paths come out bit for bit the same. Images are read as JAX reads them:
uint8 / 255.0 in float64, then cast to f32. Two changes of infrastructure:
images are decoded by the port's own readers (`data/blender.py:read_images`:
PNG, and baseline JPEG through `data/jpeg.py`, bit for bit what imageio
reads), and `minify` writes its
`images_{factor}/` cache with the integer box mean of
`data/helpers.py:resize_image`, rounded as cv2 INTER_AREA rounds, where
JAX calls cv2. The cache's directory and PNG names are JAX's, so either
stack reads the other's.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Tuple

import numpy as np

from nerfmeshes_tpu_torch.data.blender import read_images, write_png
from nerfmeshes_tpu_torch.data.helpers import resize_image

_IMG_EXTS = (".jpg", ".jpeg", ".png", ".JPG", ".JPEG", ".PNG")


def _list_images(d: Path):
    return sorted(p for p in d.iterdir() if p.suffix in _IMG_EXTS)


def minify(basedir: str, factor: int) -> Path:
    """Create images_{factor}/ with 1/factor-size PNGs if absent."""
    basedir = Path(basedir)
    out_dir = basedir / f"images_{factor}"
    if out_dir.exists():
        return out_dir
    src = _list_images(basedir / "images")
    small = []
    for p, img in zip(src, read_images(src)):
        h, w = img.shape[:2]
        small.append((p, resize_image(img, (h // factor, w // factor))))
    os.makedirs(out_dir, exist_ok=True)
    for p, img in small:
        write_png(out_dir / (p.stem + ".png"), img)
    return out_dir


def _normalize(v):
    return v / np.linalg.norm(v)


def view_matrix(z, up, pos) -> np.ndarray:
    """Camera-to-world basis from forward/up/position (3x4)."""
    vec2 = _normalize(z)
    vec0 = _normalize(np.cross(up, vec2))
    vec1 = _normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], 1)


def poses_avg(poses: np.ndarray) -> np.ndarray:
    """Average camera pose (3x5 incl. hwf column)."""
    hwf = poses[0, :3, -1:]
    center = poses[:, :3, 3].mean(0)
    forward = _normalize(poses[:, :3, 2].sum(0))
    up = poses[:, :3, 1].sum(0)
    return np.concatenate([view_matrix(forward, up, center), hwf], 1)


def recenter_poses(poses: np.ndarray) -> np.ndarray:
    """Transform all poses so the average pose is the identity."""
    out = poses.copy()
    bottom = np.array([[0, 0, 0, 1.0]])
    avg = np.concatenate([poses_avg(poses)[:3, :4], bottom], 0)
    homog = np.concatenate(
        [poses[:, :3, :4], np.tile(bottom[None], (poses.shape[0], 1, 1))], 1)
    out[:, :3, :4] = (np.linalg.inv(avg) @ homog)[:, :3, :4]
    return out


def render_path_spiral(c2w, up, rads, focal, zrate, rots, N) -> list:
    """Spiral of N camera poses around the average pose."""
    poses = []
    rads = np.asarray(list(rads) + [1.0])
    hwf = c2w[:, 4:5]
    for theta in np.linspace(0.0, 2.0 * np.pi * rots, N + 1)[:-1]:
        c = c2w[:3, :4] @ (
            np.array([np.cos(theta), -np.sin(theta), -np.sin(theta * zrate), 1.0]) * rads)
        z = _normalize(c - c2w[:3, :4] @ np.array([0, 0, -focal, 1.0]))
        poses.append(np.concatenate([view_matrix(z, up, c), hwf], 1))
    return poses


def spherify_poses(poses: np.ndarray, bds: np.ndarray):
    """Recenter onto the point closest to all camera axes, scale to unit
    radius, and build a 120-pose circular render path."""

    def homog(p):
        bottom = np.tile(np.eye(4)[-1:].reshape(1, 1, 4), (p.shape[0], 1, 1))
        return np.concatenate([p, bottom], 1)

    rays_d = poses[:, :3, 2:3]
    rays_o = poses[:, :3, 3:4]

    # Least-squares point minimizing distance to all camera rays.
    proj = np.eye(3) - rays_d * np.transpose(rays_d, (0, 2, 1))
    b = -proj @ rays_o
    center = np.squeeze(
        -np.linalg.inv((np.transpose(proj, (0, 2, 1)) @ proj).mean(0)) @ b.mean(0))

    up = (poses[:, :3, 3] - center).mean(0)
    vec0 = _normalize(up)
    vec1 = _normalize(np.cross([0.1, 0.2, 0.3], vec0))
    vec2 = _normalize(np.cross(vec0, vec1))
    c2w = np.stack([vec1, vec2, vec0, center], 1)

    poses_reset = np.linalg.inv(homog(c2w[None])) @ homog(poses[:, :3, :4])
    rad = np.sqrt(np.mean(np.sum(poses_reset[:, :3, 3] ** 2, -1)))

    sc = 1.0 / rad
    poses_reset[:, :3, 3] *= sc
    bds = bds * sc
    rad *= sc

    new_poses = render_path_from_poses(poses_reset, bds, spherify=True)[:, :3, :4]

    hwf = np.broadcast_to(poses[0, :3, -1:], new_poses[:, :3, -1:].shape)
    new_poses = np.concatenate([new_poses, hwf], -1)
    poses_reset = np.concatenate(
        [poses_reset[:, :3, :4],
         np.broadcast_to(poses[0, :3, -1:], poses_reset[:, :3, -1:].shape)], -1)
    return poses_reset, new_poses, bds


def render_path_from_poses(poses: np.ndarray, bds: np.ndarray,
                           spherify: bool = False) -> np.ndarray:
    """The 120-pose novel-view path of load_llff_data, from loaded c2w
    poses and bounds alone: the spiral around the average camera
    (forward-facing), or the circle of a spherified scene (whose poses must
    already be spherified). Takes (N,3,4), (N,4,4) or (N,3,5) poses;
    returns (120, 4, 4) f32 homogeneous c2w."""
    poses = np.asarray(poses, np.float64)
    if poses.shape[-2] == 4:
        poses = poses[:, :3, :]
    if poses.shape[-1] == 4:
        # Dummy hwf column: only rotation/translation feed the path.
        poses = np.concatenate([poses, np.zeros_like(poses[:, :, :1])], -1)
    bds = np.asarray(bds, np.float64).reshape(-1, 2)
    if spherify:
        rad = np.sqrt(np.mean(np.sum(poses[:, :3, 3] ** 2, -1)))
        centroid = poses[:, :3, 3].mean(0)
        zh = centroid[2]
        radcircle = np.sqrt(max(rad**2 - zh**2, 1e-12))
        out = []
        for th in np.linspace(0.0, 2.0 * np.pi, 120):
            camorigin = np.array([radcircle * np.cos(th), radcircle * np.sin(th), zh])
            up_c = np.array([0, 0, -1.0])
            vec2 = _normalize(camorigin)
            vec0 = _normalize(np.cross(vec2, up_c))
            vec1 = _normalize(np.cross(vec2, vec0))
            out.append(np.stack([vec0, vec1, vec2, camorigin], 1))
        path = np.stack(out, 0)
    else:
        c2w = poses_avg(poses)
        up = _normalize(poses[:, :3, 1].sum(0))
        close_depth, inf_depth = bds.min() * 0.9, bds.max() * 5.0
        dt = 0.75
        focal = 1.0 / ((1.0 - dt) / close_depth + dt / inf_depth)
        rads = np.percentile(np.abs(poses[:, :3, 3]), 90, 0)
        path = np.asarray(
            render_path_spiral(c2w, up, rads, focal, zrate=0.5, rots=2, N=120))[:, :3, :4]
    bottom = np.broadcast_to(np.array([0, 0, 0, 1.0]), (path.shape[0], 1, 4))
    return np.concatenate([path[:, :3, :4], bottom], 1).astype(np.float32)


def load_llff_data(
    basedir: str,
    factor: int = 8,
    recenter: bool = True,
    bd_factor: float = 0.75,
    spherify: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, int]:
    """Returns (images (N,H,W,3) f32, poses (N,3,5) f32, bds (N,2) f32,
    render_poses (120,3,5) f32, i_test): the view nearest the average pose."""
    basedir = Path(basedir)
    poses_arr = np.load(basedir / "poses_bounds.npy")
    poses = poses_arr[:, :-2].reshape(-1, 3, 5)  # (N, 3, 5)
    bds = poses_arr[:, -2:]  # (N, 2)

    if factor is not None and factor > 1:
        imgdir = minify(str(basedir), factor)
    else:
        factor = 1
        imgdir = basedir / "images"

    imgfiles = _list_images(imgdir)
    if poses.shape[0] != len(imgfiles):
        raise ValueError(f"Mismatch between imgs {len(imgfiles)} and poses {poses.shape[0]}")

    imgs = np.stack([img[..., :3] / 255.0 for img in read_images(imgfiles)]).astype(np.float32)
    sh = imgs[0].shape

    poses = poses.astype(np.float64)
    poses[:, :2, 4] = np.array(sh[:2])
    poses[:, 2, 4] = poses[:, 2, 4] / factor

    # LLFF's [down, right, back] -> NeRF's [right, up, back] axis order.
    poses = np.concatenate(
        [poses[:, :, 1:2], -poses[:, :, 0:1], poses[:, :, 2:]], axis=2).astype(np.float32)
    bds = bds.astype(np.float32)

    sc = 1.0 if bd_factor is None else 1.0 / (bds.min() * bd_factor)
    poses[:, :3, 3] *= sc
    bds = bds * sc

    if recenter:
        poses = recenter_poses(poses)

    if spherify:
        poses, render_poses, bds = spherify_poses(poses, bds)
    else:
        path44 = render_path_from_poses(poses, bds, spherify=False)
        hwf = np.broadcast_to(poses[0, :3, -1:], (path44.shape[0], 3, 1)).astype(np.float32)
        render_poses = np.concatenate([path44[:, :3, :4], hwf], -1)

    render_poses = np.asarray(render_poses, dtype=np.float32)

    c2w = poses_avg(poses)
    dists = np.sum((c2w[:3, 3] - poses[:, :3, 3]) ** 2, -1)
    i_test = int(np.argmin(dists))

    return imgs, poses.astype(np.float32), bds, render_poses, i_test
