"""COLMAP sparse-model I/O: cameras, images and points3D in .bin and .txt,
and the quaternion helpers (counterpart of
nerfmeshes_tpu/data/loaders/colmap.py, the same functions on `struct` and
numpy alone, so models written by either stack read in the other).
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Dict

import numpy as np

# (model_id, name, num_params): COLMAP's camera model table.
CAMERA_MODELS = [
    (0, "SIMPLE_PINHOLE", 3),
    (1, "PINHOLE", 4),
    (2, "SIMPLE_RADIAL", 4),
    (3, "RADIAL", 5),
    (4, "OPENCV", 8),
    (5, "OPENCV_FISHEYE", 8),
    (6, "FULL_OPENCV", 12),
    (7, "FOV", 5),
    (8, "SIMPLE_RADIAL_FISHEYE", 4),
    (9, "RADIAL_FISHEYE", 5),
    (10, "THIN_PRISM_FISHEYE", 12),
]
CAMERA_MODEL_IDS = {m[0]: m for m in CAMERA_MODELS}
CAMERA_MODEL_NAMES = {m[1]: m for m in CAMERA_MODELS}


@dataclass
class Camera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class Image:
    id: int
    qvec: np.ndarray  # (4,) w, x, y, z
    tvec: np.ndarray  # (3,)
    camera_id: int
    name: str
    xys: np.ndarray  # (P, 2)
    point3D_ids: np.ndarray  # (P,)

    def qvec2rotmat(self) -> np.ndarray:
        return qvec2rotmat(self.qvec)


@dataclass
class Point3D:
    id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float
    image_ids: np.ndarray
    point2D_idxs: np.ndarray


def qvec2rotmat(q) -> np.ndarray:
    """Unit quaternion (w,x,y,z) -> 3x3 rotation matrix."""
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def rotmat2qvec(R) -> np.ndarray:
    """3x3 rotation matrix -> quaternion (w,x,y,z) via the eigen method."""
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = np.asarray(R).flat
    K = (
        np.array(
            [
                [Rxx - Ryy - Rzz, 0, 0, 0],
                [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
                [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
                [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz],
            ]
        )
        / 3.0
    )
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return -q if q[0] < 0 else q


# -- binary helpers -----------------------------------------------------------


def _read(fh, fmt: str):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, fh.read(size))


def _write(fh, fmt: str, *vals):
    fh.write(struct.pack(fmt, *vals))


# -- cameras -----------------------------------------------------------------


def read_cameras_binary(path) -> Dict[int, Camera]:
    cams = {}
    with open(path, "rb") as fh:
        (n,) = _read(fh, "<Q")
        for _ in range(n):
            cam_id, model_id, width, height = _read(fh, "<iiQQ")
            _, name, num_params = CAMERA_MODEL_IDS[model_id]
            params = np.array(_read(fh, f"<{num_params}d"))
            cams[cam_id] = Camera(cam_id, name, int(width), int(height), params)
    return cams


def write_cameras_binary(cams: Dict[int, Camera], path) -> None:
    with open(path, "wb") as fh:
        _write(fh, "<Q", len(cams))
        for cam in cams.values():
            model_id, _, num_params = CAMERA_MODEL_NAMES[cam.model]
            _write(fh, "<iiQQ", cam.id, model_id, cam.width, cam.height)
            _write(fh, f"<{num_params}d", *np.asarray(cam.params, float))


def read_cameras_text(path) -> Dict[int, Camera]:
    cams = {}
    for line in open(path):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        cams[int(parts[0])] = Camera(
            int(parts[0]), parts[1], int(parts[2]), int(parts[3]),
            np.array([float(p) for p in parts[4:]]),
        )
    return cams


def write_cameras_text(cams: Dict[int, Camera], path) -> None:
    with open(path, "w") as fh:
        fh.write("# Camera list: CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        for cam in cams.values():
            params = " ".join(str(p) for p in cam.params)
            fh.write(f"{cam.id} {cam.model} {cam.width} {cam.height} {params}\n")


# -- images ------------------------------------------------------------------


def read_images_binary(path) -> Dict[int, Image]:
    images = {}
    with open(path, "rb") as fh:
        (n,) = _read(fh, "<Q")
        for _ in range(n):
            img_id = _read(fh, "<i")[0]
            qvec = np.array(_read(fh, "<4d"))
            tvec = np.array(_read(fh, "<3d"))
            cam_id = _read(fh, "<i")[0]
            name = b""
            while True:
                c = fh.read(1)
                if c == b"\x00":
                    break
                name += c
            (num_pts,) = _read(fh, "<Q")
            # Per-point record is (x double, y double, POINT3D_ID int64):
            # 'ddq', not three doubles.
            raw = fh.read(24 * num_pts)
            rec = np.frombuffer(raw, dtype=np.dtype("<f8,<f8,<i8"), count=num_pts)
            xys = np.stack([rec["f0"], rec["f1"]], axis=-1) if num_pts else (
                np.zeros((0, 2))
            )
            images[img_id] = Image(
                img_id, qvec, tvec, cam_id, name.decode("utf-8"),
                xys, rec["f2"].astype(np.int64),
            )
    return images


def write_images_binary(images: Dict[int, Image], path) -> None:
    with open(path, "wb") as fh:
        _write(fh, "<Q", len(images))
        for im in images.values():
            _write(fh, "<i", im.id)
            _write(fh, "<4d", *im.qvec)
            _write(fh, "<3d", *im.tvec)
            _write(fh, "<i", im.camera_id)
            fh.write(im.name.encode("utf-8") + b"\x00")
            _write(fh, "<Q", len(im.xys))
            rec = np.empty(len(im.xys), dtype=np.dtype("<f8,<f8,<i8"))
            if len(im.xys):
                rec["f0"] = im.xys[:, 0]
                rec["f1"] = im.xys[:, 1]
                rec["f2"] = np.asarray(im.point3D_ids, np.int64)
            fh.write(rec.tobytes())


def read_images_text(path) -> Dict[int, Image]:
    """Two lines an image: its metadata, then its POINTS2D, which is empty
    for an image that sees no point (JAX's reader drops empty lines, and so
    pairs the next image's metadata with this one's points)."""
    images = {}
    lines = [l.strip() for l in open(path) if not l.strip().startswith("#")]
    pairs, i = [], 0
    while i < len(lines):
        if lines[i]:
            pairs.append((lines[i], lines[i + 1] if i + 1 < len(lines) else ""))
            i += 2
        else:
            i += 1
    for meta, pts in pairs:
        parts = meta.split()
        img_id = int(parts[0])
        qvec = np.array([float(p) for p in parts[1:5]])
        tvec = np.array([float(p) for p in parts[5:8]])
        cam_id = int(parts[8])
        name = parts[9]
        pp = pts.split()
        data = np.array([float(x) for x in pp]).reshape(-1, 3) if pp else np.zeros((0, 3))
        images[img_id] = Image(
            img_id, qvec, tvec, cam_id, name,
            data[:, :2].copy(), data[:, 2].astype(np.int64),
        )
    return images


def write_images_text(images: Dict[int, Image], path) -> None:
    with open(path, "w") as fh:
        fh.write(
            "# Image list: IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n"
            "#   POINTS2D[] as (X, Y, POINT3D_ID)\n"
        )
        for im in images.values():
            q = " ".join(str(v) for v in im.qvec)
            t = " ".join(str(v) for v in im.tvec)
            fh.write(f"{im.id} {q} {t} {im.camera_id} {im.name}\n")
            pts = " ".join(
                f"{x} {y} {int(pid)}"
                for (x, y), pid in zip(im.xys, im.point3D_ids)
            )
            fh.write(pts + "\n")


# -- points3D ----------------------------------------------------------------


def read_points3d_binary(path) -> Dict[int, Point3D]:
    pts = {}
    with open(path, "rb") as fh:
        (n,) = _read(fh, "<Q")
        for _ in range(n):
            (pid,) = _read(fh, "<Q")
            xyz = np.array(_read(fh, "<3d"))
            rgb = np.array(_read(fh, "<3B"))
            (error,) = _read(fh, "<d")
            (track_len,) = _read(fh, "<Q")
            track = np.array(_read(fh, f"<{2 * track_len}i")).reshape(-1, 2)
            pts[pid] = Point3D(
                pid, xyz, rgb, error, track[:, 0].copy(), track[:, 1].copy()
            )
    return pts


def write_points3d_binary(pts: Dict[int, Point3D], path) -> None:
    with open(path, "wb") as fh:
        _write(fh, "<Q", len(pts))
        for p in pts.values():
            _write(fh, "<Q", p.id)
            _write(fh, "<3d", *p.xyz)
            _write(fh, "<3B", *np.asarray(p.rgb, np.uint8))
            _write(fh, "<d", p.error)
            _write(fh, "<Q", len(p.image_ids))
            track = np.stack([p.image_ids, p.point2D_idxs], 1).reshape(-1)
            if len(track):
                _write(fh, f"<{len(track)}i", *track.astype(int))


def read_points3d_text(path) -> Dict[int, Point3D]:
    pts = {}
    for line in open(path):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        pid = int(parts[0])
        xyz = np.array([float(p) for p in parts[1:4]])
        rgb = np.array([int(p) for p in parts[4:7]])
        error = float(parts[7])
        track = np.array([int(p) for p in parts[8:]]).reshape(-1, 2)
        pts[pid] = Point3D(
            pid, xyz, rgb, error, track[:, 0].copy(), track[:, 1].copy()
        )
    return pts


def write_points3d_text(pts: Dict[int, Point3D], path) -> None:
    with open(path, "w") as fh:
        fh.write("# 3D point list: POINT3D_ID, X, Y, Z, R, G, B, ERROR, TRACK[]\n")
        for p in pts.values():
            xyz = " ".join(str(v) for v in p.xyz)
            rgb = " ".join(str(int(v)) for v in p.rgb)
            track = " ".join(
                f"{int(i)} {int(j)}" for i, j in zip(p.image_ids, p.point2D_idxs)
            )
            fh.write(f"{p.id} {xyz} {rgb} {p.error} {track}\n")


# -- model-level API -----------------------------------------------------------


def read_model(path, ext: str = ".bin"):
    path = Path(path)
    if ext == ".bin":
        cameras = read_cameras_binary(path / "cameras.bin")
        images = read_images_binary(path / "images.bin")
        points3D = read_points3d_binary(path / "points3D.bin")
    else:
        cameras = read_cameras_text(path / "cameras.txt")
        images = read_images_text(path / "images.txt")
        points3D = read_points3d_text(path / "points3D.txt")
    return cameras, images, points3D


def write_model(cameras, images, points3D, path, ext: str = ".bin"):
    path = Path(path)
    os.makedirs(path, exist_ok=True)
    if ext == ".bin":
        write_cameras_binary(cameras, path / "cameras.bin")
        write_images_binary(images, path / "images.bin")
        write_points3d_binary(points3D, path / "points3D.bin")
    else:
        write_cameras_text(cameras, path / "cameras.txt")
        write_images_text(images, path / "images.txt")
        write_points3d_text(points3D, path / "points3D.txt")
