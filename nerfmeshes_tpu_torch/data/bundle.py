"""DataBundle: one split's images, cameras and targets (counterpart of
nerfmeshes_tpu/data/bundle.py).

Arrays are numpy on the host, or torch tensors where a dataset renders
its targets on the device and keeps them there (the synthetic scenes'
`keep_on_device`); RayDataset.device_arrays hands either to the card.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import numpy as np

Array = Any  # np.ndarray | torch.Tensor


@dataclasses.dataclass
class DataBundle:
    """Shapes (N images of H x W):
        ray_targets:    (N, H, W, 3)
        ray_bounds:     (2,) or (N, 2) near/far
        target_depth:   optional (N, H, W)
        target_normals: optional (N, H, W, 3) f32 in [0, 1], the Blender
                        loader's `*_normal.png` / 255 (nothing trains on it)
        poses:          (N, 4, 4)
        hwf:            (3,) f32 = [H, W, focal]
    """

    ray_targets: Optional[Array] = None
    ray_bounds: Optional[Array] = None
    target_depth: Optional[Array] = None
    target_normals: Optional[Array] = None
    poses: Optional[Array] = None
    hwf: Optional[Array] = None

    def __getitem__(self, index) -> "DataBundle":
        """Select image(s) along the leading axis; bounds and hwf pass
        through."""
        return DataBundle(**{
            f.name: getattr(self, f.name) if f.name in ("ray_bounds", "hwf")
            or getattr(self, f.name) is None else getattr(self, f.name)[index]
            for f in dataclasses.fields(self)})

    # -- the split cache's npz ----------------------------------------------------
    def serialize(self) -> dict:
        """The fields that are set, as host arrays under JAX's npz keys."""
        return {f.name: np.asarray(v.cpu() if hasattr(v, "cpu") else v)
                for f in dataclasses.fields(self)
                if (v := getattr(self, f.name)) is not None}

    @classmethod
    def deserialize(cls, data: Mapping) -> "DataBundle":
        """A bundle from serialize()'s keys (an npz either stack wrote)."""
        return cls(**{f.name: np.asarray(data[f.name]) if f.name in data else None
                      for f in dataclasses.fields(cls)})
