"""COLMAP / LLFF datasets (counterpart of nerfmeshes_tpu/data/colmap_dataset.py).

- ColmapDataset: LLFF scenes (poses_bounds.npy, as colmap_convert writes
  it) with per-image near/far bounds and the `llff_hold_step` stride
  holdout; its synthesis() path is the scene's own spiral (or spherified
  circle).
- GeneralColmapDataset: rays straight from a COLMAP sparse/0 model, its
  focal from the first camera's first parameter.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from nerfmeshes_tpu_torch.data.bundle import DataBundle
from nerfmeshes_tpu_torch.data.datasets import DatasetType, RayDataset
from nerfmeshes_tpu_torch.data.loaders.llff import load_llff_data, render_path_from_poses


class ColmapDataset(RayDataset):
    """LLFF-format scenes (poses_bounds.npy from colmap_convert)."""

    def __init__(self, cfg, type: DatasetType = DatasetType.TRAIN, device=None):
        self.downscale_factor = cfg.dataset.llff_downsample_factor
        self.spherify = bool(cfg.dataset.get("spherify", True))
        super().__init__(cfg, type, device)

    def load_dataset(self) -> DataBundle:
        images, pose_mats, bounds, _, i_test = load_llff_data(
            self.cfg.dataset.basedir, factor=self.downscale_factor, spherify=self.spherify)

        hold = int(self.cfg.dataset.llff_hold_step)
        if hold > 0:
            val_indices = np.arange(images.shape[0])[::hold]
        else:
            val_indices = np.array([i_test])
        held = set(val_indices.tolist())
        train_indices = np.array([i for i in range(images.shape[0]) if i not in held])
        # TEST follows validation (the reference defines only two splits).
        target = train_indices if self.type == DatasetType.TRAIN else val_indices

        pose_mats = pose_mats[target]
        hwf = pose_mats[0, :3, -1]
        poses34 = pose_mats[:, :3, :4]
        pad = np.broadcast_to(np.array([0, 0, 0, 1], np.float32), (poses34.shape[0], 1, 4))
        return DataBundle(
            ray_targets=images[target].astype(np.float32),
            ray_bounds=bounds[target].astype(np.float32),
            poses=np.concatenate([poses34, pad], axis=1).astype(np.float32),
            hwf=np.array([hwf[0], hwf[1], hwf[2]], np.float32),
        )

    def synthesis(self) -> "ColmapDataset":
        """Swap the split's cameras for the scene's 120-pose render path
        (the spiral around the average camera, or the spherified circle),
        rebuilt from this split's poses and bounds, so it works on a cached
        bundle too; not the Blender orbit of the base class, which circles
        the world origin at radius 4."""
        self.synthetic_poses = render_path_from_poses(
            np.asarray(self.bundle.poses), np.asarray(self.bundle.ray_bounds),
            spherify=self.spherify)
        return self


class GeneralColmapDataset(RayDataset):
    """Rays straight from a COLMAP sparse reconstruction (sparse/0); its
    images are read from images/ by name (PNG or JPEG), and images without a
    file are skipped."""

    def __init__(self, cfg, type: DatasetType = DatasetType.TRAIN, resolution: float = 1.0,
                 device=None):
        self.resolution = resolution
        super().__init__(cfg, type, device)

    def load_dataset(self) -> DataBundle:
        from nerfmeshes_tpu_torch.data.blender import read_images
        from nerfmeshes_tpu_torch.data.loaders.colmap import read_model

        base = Path(self.cfg.dataset.basedir)
        cameras, images_meta, _ = read_model(base / "sparse" / "0", ".bin")
        cam = next(iter(cameras.values()))
        found = [im for im in sorted(images_meta.values(), key=lambda i: i.name)
                 if (base / "images" / im.name).exists()]
        poses = []
        for im in found:
            # world-to-camera -> camera-to-world
            R = im.qvec2rotmat()
            c2w = np.eye(4, dtype=np.float32)
            c2w[:3, :3] = R.T
            c2w[:3, 3] = -R.T @ im.tvec
            poses.append(c2w)
        imgs = np.stack([
            (img[..., :3] / 255.0).astype(np.float32)
            for img in read_images([base / "images" / im.name for im in found])])
        H, W = imgs.shape[1:3]
        focal = float(cam.params[0]) * self.resolution
        return DataBundle(ray_targets=imgs, poses=np.stack(poses),
                          hwf=np.array([H, W, focal], np.float32))
