"""Mesh metrics: normalization, surface point sampling, chamfer distance
(counterpart of nerfmeshes_tpu/mesh/metrics.py).

Sampling is numpy with the JAX package's seed semantics, so a seed gives
the same points in both. The chamfer distance is plain torch on the
points' device (JAX's is a jitted plain function, not a kernel), taken in
blocks of rows so that the distance matrix of large samplings never
exists whole.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def normalize_mesh(vertices: np.ndarray) -> np.ndarray:
    """Center at the origin and scale into a unit sphere (the reference's
    create_mesh, src/mesh_nerf.py:14-24)."""
    v = np.asarray(vertices, np.float32)
    v = v - v.mean(0)
    scale = np.abs(v).max()
    return v / (scale if scale > 0 else 1.0)


def sample_points_from_mesh(vertices: np.ndarray, triangles: np.ndarray,
                            num_samples: int, seed: int = 0) -> np.ndarray:
    """Area-weighted uniform surface sampling (the reference uses
    pytorch3d.ops.sample_points_from_meshes)."""
    v = np.asarray(vertices, np.float32)
    t = np.asarray(triangles, np.int64)
    a, b, c = v[t[:, 0]], v[t[:, 1]], v[t[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=-1)
    total = areas.sum()
    if total <= 0:
        raise ValueError("mesh has zero surface area")
    probs = areas / total

    rng = np.random.default_rng(seed)
    face_idx = rng.choice(len(t), size=num_samples, p=probs)
    u = rng.uniform(size=(num_samples, 1))
    w = rng.uniform(size=(num_samples, 1))
    flip = (u + w) > 1.0
    u = np.where(flip, 1.0 - u, u)
    w = np.where(flip, 1.0 - w, w)
    return (
        a[face_idx] + u * (b[face_idx] - a[face_idx]) + w * (c[face_idx] - a[face_idx])
    ).astype(np.float32)


def chamfer_distance(points_a, points_b, *, block: int = 4096) -> float:
    """Symmetric mean squared chamfer distance (pytorch3d convention: mean
    over both directions of the squared distance to the nearest point,
    summed). Arrays or tensors; computed on points_a's device (the CPU for
    arrays), `block` rows of the distance matrix at a time."""
    x = torch.as_tensor(points_a, dtype=torch.float32)
    y = torch.as_tensor(points_b, dtype=torch.float32, device=x.device)
    to_y = []
    to_x = torch.full((y.shape[0],), float("inf"), device=x.device)
    for start in range(0, x.shape[0], block):
        d2 = ((x[start:start + block, None, :] - y[None, :, :]) ** 2).sum(-1)
        to_y.append(d2.min(dim=1).values)
        to_x = torch.minimum(to_x, d2.min(dim=0).values)
    return float(torch.cat(to_y).mean() + to_x.mean())


def chamfer_between_meshes(mesh_a: Tuple[np.ndarray, np.ndarray],
                           mesh_b: Tuple[np.ndarray, np.ndarray],
                           num_samples: int = 2400, seed: int = 0) -> float:
    pa = sample_points_from_mesh(*mesh_a, num_samples, seed)
    pb = sample_points_from_mesh(*mesh_b, num_samples, seed + 1)
    return chamfer_distance(pa, pb)
