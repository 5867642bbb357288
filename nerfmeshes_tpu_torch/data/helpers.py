"""Host-side data helpers: orbit poses, the image downscale and the
nearest-neighbour resize (counterpart of nerfmeshes_tpu/data/helpers.py)."""

from __future__ import annotations

import numpy as np


def _trans_t(t):
    m = np.eye(4, dtype=np.float32)
    m[2, 3] = t
    return m


def _rot_phi(phi):
    m = np.eye(4, dtype=np.float32)
    c, s = np.cos(phi), np.sin(phi)
    m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, -s, s, c
    return m


def _rot_theta(th):
    m = np.eye(4, dtype=np.float32)
    c, s = np.cos(th), np.sin(th)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, -s, s, c
    return m


def pose_spherical(theta: float, phi: float, radius: float) -> np.ndarray:
    """Orbit camera pose (angles in degrees), the standard NeRF convention."""
    c2w = _trans_t(radius)
    c2w = _rot_phi(phi / 180.0 * np.pi) @ c2w
    c2w = _rot_theta(theta / 180.0 * np.pi) @ c2w
    flip = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
                    dtype=np.float32)
    return flip @ c2w


def synthesis_poses(step: float = 3.0, phi: float = -30.0, radius: float = 4.0) -> np.ndarray:
    """120 orbit poses for novel-view synthesis: 360 degrees in 3-degree
    steps at phi -30, radius 4."""
    thetas = np.arange(-180.0, 180.0, step)
    return np.stack([pose_spherical(t, phi, radius) for t in thetas])


def resize_image(img: np.ndarray, new_hw: tuple[int, int]) -> np.ndarray:
    """(H, W, ...) -> new_hw by the mean of each factor x factor box: what
    the JAX loaders' cv2 INTER_AREA resize computes at an integer factor
    (the GPU host has no cv2). Other sizes raise. A float image gives its
    f32 mean; a uint8 image its integer mean rounded as cv2 rounds uint8:
    half up at factor 2 (its vector path), half to even otherwise."""
    H, W = img.shape[:2]
    h, w = new_hw
    if h == 0 or w == 0 or H % h or W % w or H // h != W // w:
        raise NotImplementedError(
            f"resize {H}x{W} -> {h}x{w}: only an integer downscale of both sides by one "
            "factor is ported (fractional INTER_AREA is queued in ROADMAP.md)")
    f = H // h
    boxes = img.reshape(h, f, w, f, *img.shape[2:])
    if img.dtype != np.uint8:
        return boxes.mean(axis=(1, 3), dtype=np.float32)
    total = boxes.sum(axis=(1, 3), dtype=np.int64)
    area = f * f
    mean = (total + area // 2) // area if f == 2 else np.rint(total / area)
    return mean.astype(np.uint8)


def resize_nearest(img: np.ndarray, new_hw: tuple[int, int]) -> np.ndarray:
    """(H, W, ...) -> new_hw by cv2.resize's INTER_NEAREST, which the JAX
    ScanNet loaders call (nerfmeshes_tpu/data/loaders/scannet.py:119-124,
    scannet_dataset.py:42-46): output column x reads source column
    floor(x * (1 / (w / W))) in double, clamped to W - 1, and rows alike.
    The reciprocal of the scale, as cv2 computes it, not W / w: the two
    differ in the last bit for some sizes, and so in the column read."""
    H, W = img.shape[:2]
    h, w = new_hw

    def source(n_src: int, n_dst: int) -> np.ndarray:
        idx = np.floor(np.arange(n_dst) * (1.0 / (n_dst / n_src))).astype(np.int64)
        return np.minimum(idx, n_src - 1)

    return img[source(H, h)][:, source(W, w)]
