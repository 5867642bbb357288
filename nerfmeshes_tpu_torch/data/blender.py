"""Blender scenes (counterpart of nerfmeshes_tpu/data/loaders/blender.py),
and the PNG reader and writer of the port.

The GPU host has neither imageio nor PIL, so PNGs are decoded here with
numpy and zlib: 8-bit RGB or RGBA, non-interlaced, all five row filters.
The filters chain each byte to its left, upper and upper-left neighbours
(Sub, Average and Paeth run along a row), so the decoder walks the image
by anti-diagonals: every byte of one diagonal depends only on earlier
diagonals, and all images of one size, all channels and all bytes of a
diagonal decode in one vectorised step.

`read_images` is what the LLFF and COLMAP loaders read through: PNGs
here, JPEGs (`.jpg` / `.jpeg`, any case) through the port's baseline
decoder, `data/jpeg.py`. `encode_png` (and `write_png`, its file)
encodes 8-bit grey, RGB or RGBA (filter 0 on every row), for the logger's
validation images and event files, the eval CLI's renders and the LLFF
`images_{factor}/` cache, and 16-bit grey, for ScanNet's depth exporter.

Targets are f32 / 255, downscaled by `reduced_resolution` (the JAX
loader's cv2 INTER_AREA, data/helpers.py:resize_image) and then
composited on a white background with their alpha when the config asks
for it, as the JAX loader does. Per-frame `*_normal.png` files become
`target_normals` (RGB / 255, resized as the targets are) when every frame
has one, as in JAX; nothing trains on them. Per-frame `*_depth.exr`
targets raise NotImplementedError: no EXR decoder is on the GPU host.
"""

from __future__ import annotations

import json
import struct
import zlib
from pathlib import Path

import numpy as np

from nerfmeshes_tpu_torch.data.blender_poses import _PNG_SIGNATURE, read_blender_poses
from nerfmeshes_tpu_torch.data.bundle import DataBundle
from nerfmeshes_tpu_torch.data.helpers import resize_image
from nerfmeshes_tpu_torch.data.jpeg import JPEG_SUFFIXES, read_jpeg

_CHANNELS = {2: 3, 6: 4}  # PNG colour type -> channels (RGB, RGBA)


def _png_chunks(data: bytes, path) -> tuple[tuple[int, int, int], bytes]:
    """((height, width, channels), concatenated IDAT payload)."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path} is not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            width, height, depth, colour, _, _, interlace = struct.unpack(">IIBBBBB", body)
            if depth != 8 or colour not in _CHANNELS or interlace != 0:
                raise ValueError(
                    f"{path}: only 8-bit non-interlaced RGB/RGBA PNGs are read "
                    f"(bit depth {depth}, colour type {colour}, interlace {interlace})")
            header = (height, width, _CHANNELS[colour])
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: no IHDR or IDAT chunk")
    return header, b"".join(idat)


def _unfilter(filters: np.ndarray, raw: np.ndarray) -> np.ndarray:
    """Undo the PNG row filters of a stack of same-sized images.

    filters: (N, H) uint8 filter type of each row; raw: (N, H, W, C) uint8
    filtered bytes. Returns (N, H, W, C) uint8 pixels."""
    if filters.size and int(filters.max()) > 4:
        raise ValueError(f"unknown PNG filter type {int(filters.max())}")
    N, H, W, C = raw.shape
    # One zero row above and one zero column left: PNG's out-of-image bytes.
    x = np.zeros((N, H + 1, W + 1, C), np.int16)
    raw = raw.astype(np.int16)
    for k in range(H + W - 1):
        r = np.arange(max(0, k - W + 1), min(H - 1, k) + 1)
        i = k - r
        a = x[:, r + 1, i]   # left
        b = x[:, r, i + 1]   # up
        c = x[:, r, i]       # up-left
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        ft = filters[:, r][..., None]
        pred = np.select([ft == 1, ft == 2, ft == 3, ft == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        x[:, r + 1, i + 1] = (raw[:, r, i] + pred) & 0xFF
    return x[:, 1:, 1:].astype(np.uint8)


def _png_rows(data: bytes, name) -> tuple[tuple[int, int, int], np.ndarray]:
    """((H, W, C), the (H, 1 + W * C) filtered rows) of one PNG."""
    header, payload = _png_chunks(data, name)
    H, W, C = header
    rows = np.frombuffer(zlib.decompress(payload), np.uint8)
    if rows.size != H * (1 + W * C):
        raise ValueError(f"{name}: {rows.size} bytes of image data for {H}x{W}x{C}")
    return header, rows.reshape(H, 1 + W * C)


def decode_png(data: bytes, name: str = "bytes") -> np.ndarray:
    """One PNG's bytes -> (H, W, C) uint8, as read_pngs decodes a file."""
    (H, W, C), rows = _png_rows(data, name)
    return _unfilter(rows[None, :, 0], rows[None, :, 1:].reshape(1, H, W, C))[0]


def read_pngs(paths) -> list[np.ndarray]:
    """Decode PNGs to (H, W, C) uint8 arrays, C = 3 (RGB) or 4 (RGBA).
    Images of one size and channel count decode together."""
    parsed = [_png_rows(Path(path).read_bytes(), path) for path in paths]
    out: list = [None] * len(parsed)
    for header in {h for h, _ in parsed}:
        idx = [n for n, (h, _) in enumerate(parsed) if h == header]
        H, W, C = header
        rows = np.stack([parsed[n][1] for n in idx])
        pixels = _unfilter(rows[:, :, 0], rows[:, :, 1:].reshape(len(idx), H, W, C))
        for n, img in zip(idx, pixels):
            out[n] = img
    return out


def read_images(paths) -> list[np.ndarray]:
    """The images at `paths` as (H, W, C) uint8 arrays (a grey JPEG as
    (H, W)): JPEGs through data/jpeg.py:read_jpeg, the rest through
    read_pngs."""
    paths = [Path(p) for p in paths]
    is_jpeg = [p.suffix.lower() in JPEG_SUFFIXES for p in paths]
    pngs = iter(read_pngs([p for p, j in zip(paths, is_jpeg) if not j]))
    return [read_jpeg(p) if j else next(pngs) for p, j in zip(paths, is_jpeg)]


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def write_png(path, image: np.ndarray) -> None:
    """Write encode_png(image) to `path`."""
    Path(path).write_bytes(encode_png(image))


def encode_png(image: np.ndarray) -> bytes:
    """The PNG file of a (H, W) grey, (H, W, 3) RGB or (H, W, 4) RGBA uint8
    image, or a (H, W) uint16 one as 16-bit grey (big-endian samples, as
    imageio writes a uint16 array)."""
    img = np.asarray(image)
    if not (img.dtype == np.uint8 or (img.dtype == np.uint16 and img.ndim == 2)):
        raise ValueError(f"encode_png takes uint8 pixels or (H, W) uint16, got {img.dtype} "
                         f"{img.shape}")
    if img.ndim == 2:
        img = img[..., None]
    H, W, C = img.shape
    colour = {1: 0, 3: 2, 4: 6}[C]
    samples = img.astype(">u2").view(np.uint8) if img.dtype == np.uint16 else img
    rows = np.concatenate([np.zeros((H, 1), np.uint8), samples.reshape(H, -1)], axis=1)
    return (_PNG_SIGNATURE
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8 * img.itemsize, colour, 0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


def load_blender_data(cfg, split: str) -> DataBundle:
    """One split's targets and cameras as a host DataBundle: targets
    (N, H, W, 3) f32 in [0, 1], poses (N, 4, 4) f32, hwf f32 [H, W, focal],
    and target_normals (N, H, W, 3) f32 in [0, 1] or None."""
    ds = cfg.dataset
    basedir = Path(ds.basedir)
    with (basedir / f"transforms_{split}.json").open("r") as fp:
        frames = json.load(fp)["frames"]
    stems = [basedir / frame["file_path"] for frame in frames]
    for stem in stems:
        depth = Path(f"{stem}_depth.exr")
        if depth.exists():
            raise NotImplementedError(
                f"{depth.name}: depth targets are not ported: no EXR decoder is on the GPU "
                "host (ROADMAP.md)")
    imgs = np.stack(read_pngs([stem.with_suffix(".png") for stem in stems]))
    imgs = imgs.astype(np.float32) / 255.0
    # JAX's rule: normals only when every frame has its own.
    normal_paths = [Path(f"{stem}_normal.png") for stem in stems]
    normals = None
    if all(p.exists() for p in normal_paths):
        normals = np.stack(read_pngs(normal_paths)).astype(np.float32)[..., :3] / 255.0
    poses, H, W, focal = read_blender_poses(basedir, split, ds.reduced_resolution)
    if ds.reduced_resolution is not None and ds.reduced_resolution > 1:
        imgs = np.stack([resize_image(im, (H, W)) for im in imgs])
        if normals is not None:
            normals = np.stack([resize_image(n, (H, W)) for n in normals])
    if imgs.shape[1:3] != (H, W):
        raise ValueError(f"images are {imgs.shape[1:3]}, the PNG headers say {(H, W)}")
    if ds.white_background and imgs.shape[-1] == 4:
        alpha = imgs[..., -1:]
        imgs = imgs[..., :3] * alpha + (1.0 - alpha)
    else:
        imgs = imgs[..., :3]
    return DataBundle(ray_targets=np.ascontiguousarray(imgs), target_normals=normals,
                      poses=poses, hwf=np.array([H, W, focal], dtype=np.float32))


def load_blender_targets(basedir, split: str, *, white_background: bool,
                         reduced_resolution: int = 1):
    """One split's targets and cameras: (targets (N, H, W, 3) f32 in [0, 1],
    poses (N, 4, 4) f32, (H, W, focal))."""
    from nerfmeshes_tpu_torch.config import get_default_cfg

    cfg = get_default_cfg()
    cfg.dataset.update(basedir=str(basedir), white_background=white_background,
                       reduced_resolution=reduced_resolution)
    bundle = load_blender_data(cfg, split)
    H, W, focal = bundle.hwf
    return bundle.ray_targets, bundle.poses, (int(H), int(W), float(focal))


def train_arrays(cfg, device=None, split: str = "train") -> dict:
    """Everything the train step samples from, on `device` (None means the
    CUDA card): BlenderDataset(cfg, split).device_arrays()."""
    from nerfmeshes_tpu_torch.data.datasets import BlenderDataset, DatasetType

    return BlenderDataset(cfg, DatasetType(split), device=device).device_arrays()
