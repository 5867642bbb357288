"""Periodic loggers (counterpart of nerfmeshes_tpu/utils/loggers.py, the
reference's src/nerf/loggers.py), writing to a utils/tb_events.py
EventWriter:

- DepthProjectionLogger: predicted-vs-target depth point clouds as a mesh
  every `step_size` steps;
- TreeWeightsLogger: the sorted memm curve as an image;
- TreeLogger: the BuFF voxel boxes as a mesh;
- DepthLossLogger: the masked surface/void rgb and depth loss terms when a
  ground-truth depth exists.

Everything here is numpy on the host: the callers fetch what they log.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

# Point-cloud colour codes (reference: src/nerf/nerf_helpers.py:7-10).
POINT_GROUND_TRUTH = np.array([0.0, 0.0, 255.0])
POINT_OUT_TRUE = np.array([0.0, 255.0, 0.0])
POINT_OUT_FALSE_VOID = np.array([0.0, 0.0, 0.0])
POINT_OUT_FALSE_SURFACE = np.array([255.0, 0.0, 0.0])

# Unit-cube triangulation for voxel meshes (8 corners, 12 triangles).
_CUBE_CORNERS = np.array(
    [[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1],
     [1, 1, 0], [0, 1, 1], [1, 0, 1], [1, 1, 1]],
    np.float32,
)
_CUBE_FACES = np.array(
    [0, 2, 1, 2, 4, 1, 0, 3, 2, 2, 3, 5, 0, 1, 6, 6, 3, 0,
     1, 4, 7, 7, 6, 1, 3, 6, 7, 7, 5, 3, 2, 7, 4, 7, 2, 5],
    np.int32,
).reshape(-1, 3)


def create_point_cloud(ray_origins, ray_directions, depth, color, mask=None):
    """(vertices, colors, normals) of the depth-projected ray endpoints
    (reference: src/nerf/nerf_helpers.py:56-64)."""
    d = np.asarray(ray_directions)
    ray_origins = np.broadcast_to(np.asarray(ray_origins).reshape(-1, 3), d.shape)
    z = np.asarray(depth)
    if mask is not None:
        ray_origins, d, z = ray_origins[mask], d[mask], z[mask]
    vertices = (ray_origins + d * z[..., None]).reshape(-1, 3)
    colors = np.broadcast_to(color, vertices.shape)
    normals = -d.reshape(-1, 3)
    return vertices, colors, normals


def depth_point_clouds(ray_origins, ray_directions, depth_output, depth_target=None,
                       threshold: float = 0.2, empty: float = 0.0):
    """Colour-coded depth point cloud (reference:
    src/nerf/nerf_helpers.py:26-53): without a target the prediction in
    blue; with one, the target in blue, then the prediction in green where
    within `threshold` of it, black where the target is empty and red
    where it is a surface."""
    if depth_target is None:
        return create_point_cloud(ray_origins, ray_directions, depth_output, POINT_GROUND_TRUTH)
    out, tgt = np.asarray(depth_output), np.asarray(depth_target)
    target = create_point_cloud(ray_origins, ray_directions, tgt, POINT_GROUND_TRUTH)
    ok = np.abs(out - tgt) < threshold
    surface = (tgt != empty) & ~ok
    void = (tgt == empty) & ~ok
    parts = [
        target,
        create_point_cloud(ray_origins, ray_directions, out, POINT_OUT_TRUE, ok),
        create_point_cloud(ray_origins, ray_directions, out, POINT_OUT_FALSE_VOID, void),
        create_point_cloud(ray_origins, ray_directions, out, POINT_OUT_FALSE_SURFACE, surface),
    ]
    return tuple(np.concatenate(xs, 0) for xs in zip(*parts))


def comp_depth(depth_output, depth_target, empty_value: float = 0.0):
    """(total, empty-space, surface, signed-l1) depth-loss decomposition
    (reference: src/nerf/nerf_helpers.py:67-83)."""
    out = np.asarray(depth_output)
    tgt = np.asarray(depth_target)
    mask = tgt > empty_value
    depth_loss = float(np.mean((out - tgt) ** 2))
    depth_empty = float(np.mean((out[~mask] - tgt[~mask]) ** 2)) if (~mask).any() else 0.0
    depth_space = float(np.mean((out[mask] - tgt[mask]) ** 2)) if mask.any() else 0.0
    depth_l1 = float(np.mean(out[mask] - tgt[mask])) if mask.any() else 0.0
    return depth_loss, depth_empty, depth_space, depth_l1


def voxel_mesh(voxels: np.ndarray):
    """(vertices, faces, colors) cube mesh of (V, 2, 3) boxes (reference:
    TreeSampling.flatten, src/nerf/tree.py:104-125): 8 corners and 12
    triangles a box, its lower face's corners black, the upper grey."""
    voxels = np.asarray(voxels)
    V = voxels.shape[0]
    lo, hi = voxels[:, 0, :], voxels[:, 1, :]
    verts = lo[:, None, :] + _CUBE_CORNERS[None] * (hi - lo)[:, None, :]
    faces = _CUBE_FACES[None] + (np.arange(V) * 8)[:, None, None]
    colors = np.tile(np.array([[0, 0, 0], [128, 128, 128]], np.int32).repeat(4, 0)[None],
                     (V, 1, 1))
    return verts.reshape(-1, 3), faces.reshape(-1, 3), colors.reshape(-1, 3)


class DepthProjectionLogger:
    """Logs the depth point cloud as a mesh when `step` enters a new
    multiple of `step_size` (reference: src/nerf/loggers.py:7-31)."""

    def __init__(self, step_size: int, tag: str = "Point Cloud"):
        self.step_size = max(1, int(step_size))
        self.tag = tag
        self._last = -1

    def tick(self, tb_writer, step, ray_origins, ray_directions, depth_output,
             depth_target=None) -> None:
        if tb_writer is None or step // self.step_size == self._last // self.step_size:
            self._last = step
            return
        self._last = step
        verts, colors, _ = depth_point_clouds(
            ray_origins, ray_directions, np.asarray(depth_output),
            None if depth_target is None else np.asarray(depth_target))
        tb_writer.add_mesh(self.tag, vertices=np.asarray(verts, np.float32)[None],
                           colors=np.asarray(colors, np.uint8).astype(np.int32)[None],
                           global_step=step)


# The memm plot: the figure size of matplotlib's default (640 x 480), the
# plot box inside a frame, the curve in matplotlib's first line colour.
CURVE_SIZE = (480, 640)
CURVE_BOX = (60, 620, 20, 440)  # x0, x1, y0, y1: the frame's columns and rows
CURVE_COLOR = np.array([31, 119, 180], np.uint8)


def curve_image(values: np.ndarray) -> np.ndarray:
    """(480, 640, 3) uint8: `values` as a polyline on white inside a black
    frame, the first value at the frame's left column, the last at its
    right, the smallest value on its bottom row and the largest on its top
    row (a flat curve on the middle row); tick marks every quarter."""
    H, W = CURVE_SIZE
    x0, x1, y0, y1 = CURVE_BOX
    img = np.full((H, W, 3), 255, np.uint8)
    img[y0:y1 + 1, (x0, x1)] = 0
    img[(y0, y1), x0:x1 + 1] = 0
    for q in range(5):
        img[y1 + 1:y1 + 6, x0 + (x1 - x0) * q // 4] = 0
        img[y1 - (y1 - y0) * q // 4, x0 - 5:x0] = 0
    v = np.asarray(values, np.float64).reshape(-1)
    if v.size == 0:
        return img
    cols = np.arange(x0 + 1, x1)
    t = (cols - x0) / (x1 - x0) * (v.size - 1)
    y = np.interp(t, np.arange(v.size), v)
    lo, hi = float(v.min()), float(v.max())
    if hi > lo:
        rows = y1 - (y - lo) / (hi - lo) * (y1 - y0)
    else:
        rows = np.full_like(y, (y0 + y1) / 2.0)
    rows = np.clip(np.rint(rows).astype(np.int64), y0 + 1, y1 - 1)
    # Each column's segment spans the rows to its right neighbour's, so the
    # polyline has no gaps on a steep stretch.
    nxt = np.append(rows[1:], rows[-1])
    for c, a, b in zip(cols, np.minimum(rows, nxt), np.maximum(rows, nxt)):
        img[a:b + 1, c] = CURVE_COLOR
    return img


class TreeWeightsLogger:
    """The active voxels' memm, sorted from the largest, as an image
    (reference: loggers.py:34-54, a matplotlib figure). The GPU host has no
    matplotlib, so curve_image draws it with numpy: the pixels are not
    matplotlib's (no tick labels, another frame), the curve is the same
    data."""

    def __init__(self, tag: str = "Tree Memm"):
        self.tag = tag

    def tick(self, tb_writer, step: int, memm: np.ndarray,
             active: Optional[np.ndarray] = None) -> None:
        if tb_writer is None:
            return
        memm = np.asarray(memm)
        if active is not None:
            memm = memm[np.asarray(active)]
        tb_writer.add_image(self.tag, curve_image(np.sort(memm)[::-1]), step)


class TreeLogger:
    """The BuFF voxel boxes as a mesh (reference: loggers.py:57-72)."""

    def __init__(self, tag: str = "Tree"):
        self.tag = tag

    def tick(self, tb_writer, step: int, voxels: np.ndarray,
             active: Optional[np.ndarray] = None) -> None:
        if tb_writer is None:
            return
        voxels = np.asarray(voxels)
        if active is not None:
            voxels = voxels[np.asarray(active)]
        verts, faces, colors = voxel_mesh(voxels)
        tb_writer.add_mesh(self.tag, vertices=verts.astype(np.float32)[None],
                           colors=colors[None], faces=faces[None], global_step=step)


class DepthLossLogger:
    """Folds the depth decomposition into a metric dict when a ground-truth
    depth exists (reference: loggers.py:75-108)."""

    def __init__(self, scope: str = "train", empty: float = 0.0):
        self.scope = scope
        self.empty = empty

    def tick(self, log_vals: Dict, rgb_output, rgb_target, depth_output,
             depth_target) -> Dict:
        if depth_target is None:
            return log_vals
        total, empty, space, l1 = comp_depth(depth_output, depth_target, self.empty)
        log_vals = dict(log_vals)
        log_vals[f"{self.scope}/depth_loss"] = total
        log_vals[f"{self.scope}/depth_empty"] = empty
        log_vals[f"{self.scope}/depth_space"] = space
        log_vals[f"{self.scope}/depth_l1"] = l1
        mask = np.asarray(depth_target) > self.empty
        rgb_output, rgb_target = np.asarray(rgb_output), np.asarray(rgb_target)
        if mask.any():
            log_vals[f"{self.scope}/rgb_surface_loss"] = float(
                np.mean((rgb_output[mask] - rgb_target[mask]) ** 2))
        if (~mask).any():
            log_vals[f"{self.scope}/rgb_void_loss"] = float(
                np.mean((rgb_output[~mask] - rgb_target[~mask]) ** 2))
        return log_vals
