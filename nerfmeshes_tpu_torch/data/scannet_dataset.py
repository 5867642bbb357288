"""ScanNet RGB-D dataset over a .sens stream (counterpart of
nerfmeshes_tpu/data/scannet_dataset.py).

Frames decode to colour targets and depth (the depth resized to the colour
size by cv2's nearest rule, `data/helpers.py:resize_nearest`); poses come
from the stream, and frames whose pose is not finite (tracking lost: real
streams carry -inf there) are dropped. Train, val and test stagger by
offset 0 / 1 / 2, the train split striding `frame_skip` frames and the
held-out ones 8 * frame_skip. Rays use ScanNet's convention: +z forward,
image-down y, the real principal point and unnormalised directions
(`intrinsics()`), in the train steps as in validation and eval.
"""

from __future__ import annotations

import numpy as np

from nerfmeshes_tpu_torch.data.bundle import DataBundle
from nerfmeshes_tpu_torch.data.datasets import DatasetType, RayDataset
from nerfmeshes_tpu_torch.data.helpers import resize_nearest
from nerfmeshes_tpu_torch.data.loaders.scannet import SensorData
from nerfmeshes_tpu_torch.ops.rays import CameraIntrinsics


class ScanNetDataset(RayDataset):
    def __init__(self, cfg, type: DatasetType = DatasetType.TRAIN, frame_skip: int = 1,
                 device=None):
        self.frame_skip = max(1, int(frame_skip))
        super().__init__(cfg, type, device)

    def load_dataset(self) -> DataBundle:
        sens = SensorData(self.cfg.dataset.basedir)
        self._intrinsic = np.asarray(sens.intrinsic_color)
        offset = {"train": 0, "val": 1, "test": 2}[self.type.value]
        skip = self.frame_skip if self.type == DatasetType.TRAIN else self.frame_skip * 8
        indices = [i for i in range(offset, len(sens.frames), skip)
                   if np.isfinite(sens.frames[i].camera_to_world).all()]
        imgs, poses, depths = [], [], []
        for i in indices:
            color = sens.color_image(i)
            depth = sens.depth_image(i)
            if depth.shape != color.shape[:2]:
                depth = resize_nearest(depth, color.shape[:2])
            imgs.append(color[..., :3].astype(np.float32) / 255.0)
            depths.append(depth.astype(np.float32))
            poses.append(sens.frames[i].camera_to_world.astype(np.float32))
        return DataBundle(
            ray_targets=np.stack(imgs), target_depth=np.stack(depths), poses=np.stack(poses),
            hwf=np.array([imgs[0].shape[0], imgs[0].shape[1], self._intrinsic[0, 0]],
                         np.float32))

    def intrinsics(self) -> CameraIntrinsics:
        # On a split-cache hit load_dataset never runs: read the matrix from
        # the .sens header alone (no frame is decoded).
        if not hasattr(self, "_intrinsic"):
            sens = SensorData(self.cfg.dataset.basedir, header_only=True)
            self._intrinsic = np.asarray(sens.intrinsic_color)
        K = self._intrinsic
        return CameraIntrinsics(fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
                                cy=float(K[1, 2]), z_sign=1.0, flip_y=False, normalize=False)
