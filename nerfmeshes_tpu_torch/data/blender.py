"""Blender scene targets for training (counterpart of
nerfmeshes_tpu/data/loaders/blender.py and the device handover of
nerfmeshes_tpu/data/datasets.py:187-203).

The GPU host has neither imageio nor PIL, so PNGs are decoded here with
numpy and zlib: 8-bit RGB or RGBA, non-interlaced, all five row filters.
The filters chain each byte to its left, upper and upper-left neighbours
(Sub, Average and Paeth run along a row), so the decoder walks the image
by anti-diagonals: every byte of one diagonal depends only on earlier
diagonals, and all images of one size, all channels and all bytes of a
diagonal decode in one vectorised step.

Targets are f32 / 255, composited on a white background with their alpha
when the config asks for it, as the JAX loader does (:113-117). Not ported
yet (ROADMAP.md): `reduced_resolution > 1` and per-frame `*_depth.exr` /
`*_normal.png` targets; both raise NotImplementedError.
"""

from __future__ import annotations

import json
import struct
import zlib
from pathlib import Path

import numpy as np
import torch

from nerfmeshes_tpu_torch.data.blender_poses import _PNG_SIGNATURE, read_blender_poses
from nerfmeshes_tpu_torch.device import resolve_device

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


def read_pngs(paths) -> list[np.ndarray]:
    """Decode PNGs to (H, W, C) uint8 arrays, C = 3 (RGB) or 4 (RGBA).
    Images of one size and channel count decode together."""
    parsed = []
    for path in paths:
        header, payload = _png_chunks(Path(path).read_bytes(), path)
        H, W, C = header
        rows = np.frombuffer(zlib.decompress(payload), np.uint8)
        if rows.size != H * (1 + W * C):
            raise ValueError(f"{path}: {rows.size} bytes of image data for {H}x{W}x{C}")
        parsed.append((header, rows.reshape(H, 1 + W * C)))
    out: list = [None] * len(parsed)
    for header in {h for h, _ in parsed}:
        idx = [n for n, (h, _) in enumerate(parsed) if h == header]
        H, W, C = header
        rows = np.stack([parsed[n][1] for n in idx])
        pixels = _unfilter(rows[:, :, 0], rows[:, :, 1:].reshape(len(idx), H, W, C))
        for n, img in zip(idx, pixels):
            out[n] = img
    return out


def load_blender_targets(basedir, split: str, *, white_background: bool,
                         reduced_resolution: int = 1):
    """One split's targets and cameras: (targets (N, H, W, 3) f32 in [0, 1],
    poses (N, 4, 4) f32, (H, W, focal))."""
    if reduced_resolution is not None and reduced_resolution > 1:
        raise NotImplementedError(
            "reduced_resolution > 1 is not ported yet (queued in ROADMAP.md)")
    basedir = Path(basedir)
    with (basedir / f"transforms_{split}.json").open("r") as fp:
        frames = json.load(fp)["frames"]
    stems = [basedir / frame["file_path"] for frame in frames]
    for stem in stems:
        for extra in (Path(f"{stem}_depth.exr"), Path(f"{stem}_normal.png")):
            if extra.exists():
                raise NotImplementedError(
                    f"{extra.name}: depth and normal targets are not ported yet "
                    "(queued in ROADMAP.md)")
    imgs = np.stack(read_pngs([stem.with_suffix(".png") for stem in stems]))
    imgs = imgs.astype(np.float32) / 255.0
    if white_background and imgs.shape[-1] == 4:
        alpha = imgs[..., -1:]
        imgs = imgs[..., :3] * alpha + (1.0 - alpha)
    else:
        imgs = imgs[..., :3]
    poses, H, W, focal = read_blender_poses(basedir, split)
    if imgs.shape[1:3] != (H, W):
        raise ValueError(f"images are {imgs.shape[1:3]}, the PNG headers say {(H, W)}")
    return np.ascontiguousarray(imgs), poses, (H, W, focal)


def train_arrays(cfg, device=None, split: str = "train") -> dict:
    """Everything the train step samples from, on `device` (None means
    the CUDA card): targets
    (N, H, W, 3) f32, poses (N, 4, 4) f32, bounds (2,) f32 ([near, far],
    or [0, 1] under NDC as nerfmeshes_tpu/data/datasets.py:159-169 sets
    it), and hwf = (H, W, focal) on the host."""
    device = resolve_device(device)
    ds = cfg.dataset
    targets, poses, hwf = load_blender_targets(
        ds.basedir, split, white_background=bool(ds.white_background),
        reduced_resolution=ds.reduced_resolution)
    bounds = [0.0, 1.0] if ds.use_ndc else [float(ds.near), float(ds.far)]
    return {
        "targets": torch.from_numpy(targets).to(device),
        "poses": torch.from_numpy(poses).to(device),
        "bounds": torch.tensor(bounds, dtype=torch.float32, device=device),
        "hwf": hwf,
    }
