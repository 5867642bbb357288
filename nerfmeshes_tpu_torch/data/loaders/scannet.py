"""ScanNet .sens RGB-D streams (counterpart of
nerfmeshes_tpu/data/loaders/scannet.py).

The .sens v4 layout: a header with the sensor name, the colour and depth
intrinsics and extrinsics, the compression types and sizes, then per frame
camera_to_world, timestamps and the compressed colour (JPEG) and depth
(zlib'd uint16) payloads. The parser, the writer and the exporters are
JAX's; what JAX reads through imageio and cv2 goes through the port's own
code: colour through `data/jpeg.py` (PNG colour through
`data/blender.py:decode_png`), the exporters' resize through
`data/helpers.py:resize_nearest` (cv2's INTER_NEAREST), the depth PNGs
(16-bit) through `data/blender.py:write_png` and the colour JPEGs through
`data/jpeg.py:write_jpeg` (the bytes imageio's JPEG writer gives).

    python -m nerfmeshes_tpu_torch.data.loaders.scannet --filename scene.sens \\
        --output_path out --export_depth_images --export_color_images --export_poses \\
        --export_intrinsics
"""

from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

COMPRESSION_TYPE_COLOR = {-1: "unknown", 0: "raw", 1: "png", 2: "jpeg"}
COMPRESSION_TYPE_DEPTH = {-1: "unknown", 0: "raw_ushort", 1: "zlib_ushort", 2: "occi_ushort"}


def _unpack(fh, fmt: str):
    return struct.unpack(fmt, fh.read(struct.calcsize(fmt)))


def _read_mat4(fh) -> np.ndarray:
    return np.array(_unpack(fh, "<16f"), np.float32).reshape(4, 4)


@dataclass
class RGBDFrame:
    camera_to_world: np.ndarray
    timestamp_color: int
    timestamp_depth: int
    color_data: bytes
    depth_data: bytes

    @classmethod
    def parse(cls, fh) -> "RGBDFrame":
        c2w = _read_mat4(fh)
        ts_c, ts_d, color_bytes, depth_bytes = _unpack(fh, "<QQQQ")
        return cls(c2w, ts_c, ts_d, fh.read(color_bytes), fh.read(depth_bytes))

    def decompress_depth(self, compression_type: str) -> bytes:
        if compression_type == "zlib_ushort":
            return zlib.decompress(self.depth_data)
        if compression_type == "raw_ushort":
            return self.depth_data
        raise ValueError(f"unsupported depth compression {compression_type!r}")

    def decompress_color(self, compression_type: str) -> np.ndarray:
        """The colour frame as (H, W, 3) uint8 (what imageio reads)."""
        if compression_type == "jpeg":
            from nerfmeshes_tpu_torch.data.jpeg import decode_jpeg

            return decode_jpeg(self.color_data, f"colour frame ({self.timestamp_color})")
        if compression_type == "png":
            from nerfmeshes_tpu_torch.data.blender import decode_png

            return decode_png(self.color_data, f"colour frame ({self.timestamp_color})")
        raise ValueError(f"unsupported color compression {compression_type!r}")


class SensorData:
    """Parsed .sens stream (version 4); `header_only` skips the frames."""

    VERSION = 4

    def __init__(self, filename: str, header_only: bool = False):
        with open(filename, "rb") as fh:
            (version,) = _unpack(fh, "<I")
            if version != self.VERSION:
                raise ValueError(f".sens version {version}, expected {self.VERSION}")
            (strlen,) = _unpack(fh, "<Q")
            self.sensor_name = fh.read(strlen).decode("utf-8", "replace")
            self.intrinsic_color = _read_mat4(fh)
            self.extrinsic_color = _read_mat4(fh)
            self.intrinsic_depth = _read_mat4(fh)
            self.extrinsic_depth = _read_mat4(fh)
            self.color_compression_type = COMPRESSION_TYPE_COLOR[_unpack(fh, "<i")[0]]
            self.depth_compression_type = COMPRESSION_TYPE_DEPTH[_unpack(fh, "<i")[0]]
            (self.color_width, self.color_height) = _unpack(fh, "<II")
            (self.depth_width, self.depth_height) = _unpack(fh, "<II")
            (self.depth_shift,) = _unpack(fh, "<f")
            (num_frames,) = _unpack(fh, "<Q")
            self.frames: List[RGBDFrame] = (
                [] if header_only else [RGBDFrame.parse(fh) for _ in range(num_frames)])

    # -- decoded accessors -------------------------------------------------------------
    def _depth_raw(self, idx: int) -> np.ndarray:
        raw = self.frames[idx].decompress_depth(self.depth_compression_type)
        return np.frombuffer(raw, np.uint16).reshape(self.depth_height, self.depth_width)

    def depth_image(self, idx: int) -> np.ndarray:
        """(H, W) float32 depth in meters (raw ushort / depth_shift)."""
        return self._depth_raw(idx).astype(np.float32) / self.depth_shift

    def color_image(self, idx: int) -> np.ndarray:
        return self.frames[idx].decompress_color(self.color_compression_type)

    # -- exporters (the reference tool's layout) ------------------------------------------
    def export_depth_images(self, output_path, image_size=None, frame_skip=1):
        """Every frame_skip-th depth frame as `{f}.png`, 16-bit grey, resized
        to image_size (H, W) by cv2's nearest rule when given."""
        from nerfmeshes_tpu_torch.data.blender import write_png
        from nerfmeshes_tpu_torch.data.helpers import resize_nearest

        os.makedirs(output_path, exist_ok=True)
        for f in range(0, len(self.frames), frame_skip):
            depth = self._depth_raw(f)
            if image_size is not None:
                depth = resize_nearest(depth, (image_size[0], image_size[1]))
            write_png(os.path.join(output_path, f"{f}.png"), depth)

    def export_color_images(self, output_path, image_size=None, frame_skip=1):
        """Every frame_skip-th colour frame as `{f}.jpg`, resized to
        image_size (H, W) by cv2's nearest rule when given, re-encoded as
        imageio's JPEG writer encodes it (data/jpeg.py:write_jpeg)."""
        from nerfmeshes_tpu_torch.data.helpers import resize_nearest
        from nerfmeshes_tpu_torch.data.jpeg import write_jpeg

        os.makedirs(output_path, exist_ok=True)
        for f in range(0, len(self.frames), frame_skip):
            color = self.color_image(f)
            if image_size is not None:
                color = resize_nearest(color, (image_size[0], image_size[1]))
            write_jpeg(os.path.join(output_path, f"{f}.jpg"), color)

    def export_poses(self, output_path, frame_skip=1):
        os.makedirs(output_path, exist_ok=True)
        for f in range(0, len(self.frames), frame_skip):
            np.savetxt(os.path.join(output_path, f"{f}.txt"), self.frames[f].camera_to_world,
                       fmt="%f")

    def export_intrinsics(self, output_path):
        os.makedirs(output_path, exist_ok=True)
        for name, mat in [("intrinsic_color", self.intrinsic_color),
                          ("extrinsic_color", self.extrinsic_color),
                          ("intrinsic_depth", self.intrinsic_depth),
                          ("extrinsic_depth", self.extrinsic_depth)]:
            np.savetxt(os.path.join(output_path, f"{name}.txt"), mat, fmt="%f")


def write_sens(
    filename: str,
    frames: List[RGBDFrame],
    *,
    sensor_name: str = "synthetic",
    intrinsic_color: Optional[np.ndarray] = None,
    intrinsic_depth: Optional[np.ndarray] = None,
    color_size: Tuple[int, int] = (640, 480),
    depth_size: Tuple[int, int] = (640, 480),
    depth_shift: float = 1000.0,
) -> None:
    """Write a .sens v4 stream of frames whose colour is already JPEG bytes
    and whose depth is already zlib'd uint16 (color_size, depth_size:
    (width, height))."""
    eye = np.eye(4, dtype=np.float32)
    with open(filename, "wb") as fh:
        fh.write(struct.pack("<I", SensorData.VERSION))
        name = sensor_name.encode("utf-8")
        fh.write(struct.pack("<Q", len(name)) + name)
        for mat in [intrinsic_color if intrinsic_color is not None else eye, eye,
                    intrinsic_depth if intrinsic_depth is not None else eye, eye]:
            fh.write(struct.pack("<16f", *np.asarray(mat, np.float32).reshape(-1)))
        fh.write(struct.pack("<i", 2))  # jpeg color
        fh.write(struct.pack("<i", 1))  # zlib_ushort depth
        fh.write(struct.pack("<II", *color_size))
        fh.write(struct.pack("<II", *depth_size))
        fh.write(struct.pack("<f", depth_shift))
        fh.write(struct.pack("<Q", len(frames)))
        for fr in frames:
            fh.write(struct.pack("<16f", *np.asarray(fr.camera_to_world, np.float32).reshape(-1)))
            fh.write(struct.pack("<QQQQ", fr.timestamp_color, fr.timestamp_depth,
                                 len(fr.color_data), len(fr.depth_data)))
            fh.write(fr.color_data)
            fh.write(fr.depth_data)


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description="Decode a ScanNet .sens file")
    parser.add_argument("--filename", required=True)
    parser.add_argument("--output_path", required=True)
    parser.add_argument("--export_depth_images", action="store_true")
    parser.add_argument("--export_color_images", action="store_true")
    parser.add_argument("--export_poses", action="store_true")
    parser.add_argument("--export_intrinsics", action="store_true")
    opt = parser.parse_args(argv)

    os.makedirs(opt.output_path, exist_ok=True)
    sd = SensorData(opt.filename)
    if opt.export_depth_images:
        sd.export_depth_images(os.path.join(opt.output_path, "depth"))
    if opt.export_color_images:
        sd.export_color_images(os.path.join(opt.output_path, "color"))
    if opt.export_poses:
        sd.export_poses(os.path.join(opt.output_path, "pose"))
    if opt.export_intrinsics:
        sd.export_intrinsics(os.path.join(opt.output_path, "intrinsic"))


if __name__ == "__main__":
    main()
