"""Camera poses and intrinsics of a Blender scene, without its pixels.

Reads `transforms_{split}.json` as nerfmeshes_tpu/data/loaders/blender.py
does (3x4 poses padded to 4x4, focal from camera_angle_x, integer
downscale), and each image's size from its PNG header alone: no image
decoder is needed. The images themselves: data/blender.py.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Tuple

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def png_size(path) -> Tuple[int, int]:
    """(height, width) from a PNG's IHDR chunk."""
    with open(path, "rb") as fp:
        head = fp.read(24)
    if len(head) < 24 or head[:8] != _PNG_SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"{path} is not a PNG file")
    width, height = struct.unpack(">II", head[16:24])
    return height, width


def read_blender_poses(basedir, split: str, reduced: int = 1):
    """-> (poses (N, 4, 4) float32, H, W, focal) of one split.

    `reduced` is cfg.dataset.reduced_resolution: H, W and focal shrink by
    that integer factor. Every frame must have the same size."""
    basedir = Path(basedir)
    with (basedir / f"transforms_{split}.json").open("r") as fp:
        metadata = json.load(fp)
    frames = metadata["frames"]
    if not frames:
        raise ValueError(f"{basedir}/transforms_{split}.json lists no frames")

    sizes = {png_size((basedir / frame["file_path"]).with_suffix(".png")) for frame in frames}
    if len(sizes) != 1:
        raise ValueError(f"frames of split {split!r} differ in size: {sorted(sizes)}")
    (H, W), = sizes

    poses = np.stack([np.asarray(f["transform_matrix"], dtype=np.float32) for f in frames])
    if poses.shape[-2] == 3:  # pad 3x4 -> 4x4
        bottom = np.broadcast_to(np.array([0, 0, 0, 1], dtype=np.float32), (len(poses), 1, 4))
        poses = np.concatenate([poses, bottom], axis=-2)

    focal = 0.5 * W / np.tan(0.5 * float(metadata["camera_angle_x"]))
    if reduced is not None and reduced > 1:
        H, W, focal = H // reduced, W // reduced, focal / reduced
    return poses, int(H), int(W), float(focal)
