"""Host-side batching and image casts (counterpart of
nerfmeshes_tpu/utils/images.py): batchify, cast_to_image,
cast_to_pil_image, cast_to_disparity_image and export_point_cloud."""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np


def batchify(*data, batch_size: int = 1024, progress: bool = False) -> Iterator:
    """Aligned chunks of `batch_size` rows of arrays that share their first
    axis (None entries pass through as None). With `progress`, wrapped in a
    tqdm bar when tqdm is importable (the GPU host has none)."""
    if not all(sample is None or sample.shape[0] == data[0].shape[0] for sample in data):
        raise ValueError("Sizes of tensors must match for dimension 0.")

    def gen():
        for start in range(0, data[0].shape[0], batch_size):
            sl = slice(start, start + batch_size)
            yield [s[sl] if s is not None else None for s in data]

    it = gen()
    if progress:
        try:
            from tqdm import tqdm
        except ImportError:
            return it
        return tqdm(it, total=(data[0].shape[0] - 1) // batch_size + 1)
    return it


def cast_to_pil_image(tensor) -> np.ndarray:
    """(H, W, 3) float in [0, 1] -> (H, W, 3) uint8, clipped and truncated."""
    return (np.clip(np.asarray(tensor), 0.0, 1.0) * 255).astype(np.uint8)


def cast_to_image(tensor) -> np.ndarray:
    """(H, W, 3) float in [0, 1] -> (3, H, W) uint8 (channels first)."""
    return np.moveaxis(cast_to_pil_image(tensor), -1, 0)


def cast_to_disparity_image(tensor, white_background: bool = False) -> np.ndarray:
    """(H, W) disparity -> min-max normalised uint8, holes white on a white
    background."""
    disp = np.asarray(tensor)
    span = max(float(disp.max() - disp.min()), 1e-10)
    img = (np.clip((disp - disp.min()) / span, 0.0, 1.0) * 255).astype(np.uint8)
    if white_background:
        img[img == 0] = 255
    return img


def export_point_cloud(iteration: int, ray_origins, ray_directions, depth_output, depth_target,
                       save_dir: str = ".") -> str:
    """The predicted (red) and target (blue) depth points of a batch of
    rays as `{save_dir}/{iteration:04d}.obj`, normals facing the camera;
    returns the path."""
    from nerfmeshes_tpu_torch.mesh.export import export_obj

    dirs = np.asarray(ray_directions).reshape(-1, 3)
    origins = np.broadcast_to(np.asarray(ray_origins).reshape(-1, 3),
                              np.asarray(ray_directions).shape).reshape(-1, 3)
    v_out = origins + dirs * np.asarray(depth_output).reshape(-1, 1)
    v_tgt = origins + dirs * np.asarray(depth_target).reshape(-1, 1)
    colors = np.concatenate([np.tile([1.0, 0.0, 0.0], (len(v_out), 1)),
                             np.tile([0.0, 0.0, 1.0], (len(v_tgt), 1))], 0)
    path = os.path.join(save_dir, f"{iteration:04d}.obj")
    export_obj(np.concatenate([v_out, v_tgt], 0), [], colors, np.concatenate([-dirs, -dirs], 0),
               path)
    return path
