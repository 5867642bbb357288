"""Datasets: one split's images parsed on the host and handed to the
device (counterpart of nerfmeshes_tpu/data/datasets.py).

The whole split lives on the device: the train step samples its rays from
`device_arrays()`, and validation and eval render one image at a time from
rays made on the device (`image_rays`) against targets taken there
(`image_targets`), so no image's rays cross the host.

With `dataset.caching.use_caching` a split's bundle is kept in
`{cache_dir}/{split}.npz` under JAX's keys, so either stack reads a cache
the other wrote; `override_caching` reloads and rewrites it.
"""

from __future__ import annotations

import os
from enum import Enum
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from nerfmeshes_tpu_torch.data.bundle import DataBundle
from nerfmeshes_tpu_torch.data.helpers import synthesis_poses
from nerfmeshes_tpu_torch.device import resolve_device
from nerfmeshes_tpu_torch.ops.rays import (
    CameraIntrinsics,
    get_ray_bundle,
    get_ray_bundle_intrinsics,
    ndc_rays,
)


class DatasetType(Enum):
    TRAIN = "train"
    TEST = "test"
    VALIDATION = "val"


def convert_poses_to_rays(poses: np.ndarray, H: int, W: int, focal: float):
    """Every pose's rays at once, on the host: origins (N, 3) and unit
    directions (N, H, W, 3) as numpy f32 (the datasets make their rays on
    the device instead, one image at a time)."""
    origins, directions = get_ray_bundle(int(H), int(W), float(focal),
                                         torch.as_tensor(np.asarray(poses, np.float32)))
    return origins.numpy(), directions.numpy()


class RayDataset:
    """Base dataset: one item is one image. Subclasses implement
    `load_dataset() -> DataBundle` with ray_targets (N, H, W, 3), poses
    (N, 4, 4), hwf, and optionally per-image ray_bounds. `device` (None:
    the CUDA card) is where its rays, targets and train arrays go."""

    def __init__(self, cfg, type: DatasetType = DatasetType.TRAIN, device=None):
        self.cfg = cfg
        self.type = type
        self.device = resolve_device(device)
        self.synthetic_poses: Optional[np.ndarray] = None
        cache_cfg = cfg.dataset.caching
        cache_path = Path(cache_cfg.cache_dir) / f"{type.value}.npz"
        if cache_cfg.use_caching and cache_path.exists() and not cache_cfg.override_caching:
            with np.load(cache_path, allow_pickle=False) as data:
                bundle = DataBundle.deserialize(data)
        else:
            bundle = self.load_dataset()
            if cache_cfg.use_caching:
                os.makedirs(cache_path.parent, exist_ok=True)
                np.savez(cache_path, **bundle.serialize())
        if bundle.ray_bounds is None:
            bundle.ray_bounds = np.array([cfg.dataset.near, cfg.dataset.far], dtype=np.float32)
        self.bundle = bundle

    # -- basic accessors --------------------------------------------------------------
    @property
    def hwf(self) -> np.ndarray:
        return np.asarray(self.bundle.hwf)

    @property
    def num_images(self) -> int:
        if self.synthetic_poses is not None:
            return self.synthetic_poses.shape[0]
        return self.bundle.ray_targets.shape[0]

    def __len__(self) -> int:
        return self.num_images

    @property
    def poses(self) -> np.ndarray:
        if self.synthetic_poses is not None:
            return self.synthetic_poses
        return np.asarray(self.bundle.poses)

    def intrinsics(self) -> CameraIntrinsics:
        H, W, focal = self.hwf
        return CameraIntrinsics.from_hwf(int(H), int(W), float(focal))

    def image_rays(self, idx: int):
        """One image's rays as flat (H*W, 3) tensors on the device, NDC
        under dataset.use_ndc (focal from hwf, near 1)."""
        H, W, focal = self.hwf
        pose = torch.as_tensor(self.poses[idx], dtype=torch.float32, device=self.device)
        origins, directions = get_ray_bundle_intrinsics(int(H), int(W), self.intrinsics(), pose)
        directions = directions.reshape(-1, 3)
        origins = origins.reshape(-1, 3).expand(directions.shape)
        if self.cfg.dataset.use_ndc:
            origins, directions = ndc_rays(int(H), int(W), float(focal), 1.0, origins,
                                           directions)
        return origins, directions

    def image_targets(self, idx: int) -> torch.Tensor:
        """One image's targets as (H*W, 3) f32 on the device."""
        target = torch.as_tensor(self.bundle.ray_targets[idx], dtype=torch.float32)
        return target.to(self.device).reshape(-1, 3)

    def _bounds_for(self, idx: int) -> np.ndarray:
        if self.cfg.dataset.use_ndc:
            # NDC maps the frustum from the near plane to infinity onto t in
            # [0, 1]; scene-depth bounds mean nothing along NDC rays.
            return np.array([0.0, 1.0], np.float32)
        b = np.asarray(self.bundle.ray_bounds)
        if b.ndim != 2:
            return b
        if self.synthetic_poses is not None:
            # Orbit poses have no per-image bounds: the scene's whole range.
            return np.array([b[:, 0].min(), b[:, 1].max()], b.dtype)
        return b[idx]

    def synthesis(self) -> "RayDataset":
        """Swap the split's cameras for 120 synthesized orbit poses (novel
        views; no targets)."""
        self.synthetic_poses = synthesis_poses()
        return self

    # -- device handover -----------------------------------------------------------------
    def device_arrays(self, device=None) -> dict:
        """Everything the train step samples from, on `device` (default:
        the dataset's): targets (N, H, W, 3), poses (N, 4, 4), bounds (2,)
        or (N, 2), target_depth when there is one, and hwf = (H, W, focal)
        on the host."""
        device = self.device if device is None else torch.device(device)

        def put(a):
            return torch.as_tensor(a, dtype=torch.float32).to(device)

        bounds = [0.0, 1.0] if self.cfg.dataset.use_ndc else self.bundle.ray_bounds
        H, W, focal = self.hwf
        out = {"targets": put(self.bundle.ray_targets), "poses": put(self.poses),
               "bounds": put(bounds), "hwf": (int(H), int(W), float(focal))}
        if self.bundle.target_depth is not None:
            out["target_depth"] = put(self.bundle.target_depth)
        return out

    def load_dataset(self) -> DataBundle:
        raise NotImplementedError


class BlenderDataset(RayDataset):
    """Blender scenes (transforms_{split}.json); `testskip` strides the
    val/test frames."""

    @property
    def dataset_path(self) -> Path:
        return Path(self.cfg.dataset.basedir) / f"transforms_{self.type.value}.json"

    def load_dataset(self) -> DataBundle:
        from nerfmeshes_tpu_torch.data.blender import load_blender_data

        bundle = load_blender_data(self.cfg, self.type.value)
        skip = int(self.cfg.dataset.testskip or 1)
        if skip > 1 and self.type != DatasetType.TRAIN:
            bundle = bundle[::skip]
        return bundle


class SyntheticDataset(RayDataset):
    """A procedural scene of data/synthetic.py, rendered on the device."""

    def __init__(self, cfg, type: DatasetType = DatasetType.TRAIN, num_images=None,
                 image_size=None, with_depth=None, keep_on_device=None, gt_samples=None,
                 device=None):
        # Explicit arguments win, then cfg.dataset.synthetic.*.
        syn = cfg.dataset.get("synthetic", {})

        def pick(arg, key, default):
            return arg if arg is not None else syn.get(key, default)

        self._num_images = int(pick(num_images, "num_images", 8))
        self._image_size = int(pick(image_size, "image_size", 32))
        self._with_depth = bool(pick(with_depth, "with_depth", False))
        self._keep_on_device = bool(pick(keep_on_device, "keep_on_device", False))
        self._gt_samples = int(pick(gt_samples, "gt_samples", 256))
        if type != DatasetType.TRAIN and num_images is None:
            # Held-out views: a quarter of the train count, at least 2.
            self._num_images = max(2, self._num_images // 4)
        super().__init__(cfg, type, device)

    def load_dataset(self) -> DataBundle:
        from nerfmeshes_tpu_torch.data.synthetic import make_synthetic_dataset

        return make_synthetic_dataset(
            num_images=self._num_images,
            image_size=self._image_size,
            near=self.cfg.dataset.near,
            far=self.cfg.dataset.far,
            white_background=self.cfg.dataset.white_background,
            seed={"train": 0, "val": 1, "test": 2}[self.type.value],
            with_depth=self._with_depth,
            scene=str(self.cfg.dataset.get("scene", "blobs")),
            num_samples=self._gt_samples,
            keep_on_device=self._keep_on_device,
            device=self.device,
        )


def build_dataset(cfg, type: DatasetType, device=None) -> RayDataset:
    """Dataset by cfg.dataset.type, its arrays bound for `device` (None:
    the CUDA card)."""
    kind = cfg.dataset.type
    if kind == "blender":
        return BlenderDataset(cfg, type, device)
    if kind == "synthetic":
        return SyntheticDataset(cfg, type, device=device)
    if kind == "colmap":
        from nerfmeshes_tpu_torch.data.colmap_dataset import ColmapDataset

        return ColmapDataset(cfg, type, device)
    if kind == "scannet":
        from nerfmeshes_tpu_torch.data.scannet_dataset import ScanNetDataset

        return ScanNetDataset(cfg, type, device=device)
    raise ValueError(f"Unknown dataset type {kind!r}")
