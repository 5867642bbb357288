"""Scene loaders (counterpart of nerfmeshes_tpu/data/loaders/): Blender
(`data/blender.py`), LLFF, the COLMAP model and ScanNet's .sens streams."""

from nerfmeshes_tpu_torch.data.blender import load_blender_data
from nerfmeshes_tpu_torch.data.loaders.colmap import (
    Camera,
    Image,
    Point3D,
    qvec2rotmat,
    read_cameras_binary,
    read_images_binary,
    read_model,
    read_points3d_binary,
    rotmat2qvec,
    write_model,
)
from nerfmeshes_tpu_torch.data.loaders.llff import load_llff_data, minify
from nerfmeshes_tpu_torch.data.loaders.scannet import RGBDFrame, SensorData, write_sens

__all__ = [
    "load_blender_data",
    "load_llff_data",
    "minify",
    "read_model",
    "write_model",
    "read_cameras_binary",
    "read_images_binary",
    "read_points3d_binary",
    "Camera",
    "Image",
    "Point3D",
    "qvec2rotmat",
    "rotmat2qvec",
    "RGBDFrame",
    "SensorData",
    "write_sens",
]
