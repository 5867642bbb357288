"""Dataset readers of the port (jax-free), exporting what
nerfmeshes_tpu/data/__init__.py exports but `read_depth_from_exr`: no EXR
decoder is on the GPU host."""

from nerfmeshes_tpu_torch.data.bundle import DataBundle
from nerfmeshes_tpu_torch.data.datasets import (
    BlenderDataset,
    DatasetType,
    RayDataset,
    SyntheticDataset,
    build_dataset,
    convert_poses_to_rays,
)
from nerfmeshes_tpu_torch.data.helpers import (
    batch_random_sampling,
    pose_spherical,
    synthesis_poses,
)

__all__ = [
    "DataBundle",
    "BlenderDataset",
    "DatasetType",
    "RayDataset",
    "SyntheticDataset",
    "build_dataset",
    "convert_poses_to_rays",
    "batch_random_sampling",
    "pose_spherical",
    "synthesis_poses",
]
