"""Host-side data helpers: orbit poses, the image downscale, the
nearest-neighbour resize and the host's random pixel draw (counterpart of
nerfmeshes_tpu/data/helpers.py)."""

from __future__ import annotations

import math

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


def _area_fast_factor(n_src: int, n_dst: int) -> int:
    """The integer factor cv2's INTER_AREA takes its fast path at, or 0:
    the scale as cv2 computes it, 1 / (dst / src), within DBL_EPSILON of
    an integer."""
    scale = 1.0 / (n_dst / n_src)
    k = int(round(scale))
    return k if abs(scale - k) < np.finfo(np.float64).eps else 0


def _area_table(n_src: int, n_dst: int) -> tuple[np.ndarray, np.ndarray]:
    """cv2's computeResizeAreaTab along one axis, as (n_dst, K) source
    indices and f32 weights in cv2's order, padded with weight 0: each
    destination cell covers `scale` source cells, the partial cells at its
    ends weighted by the share they cover, all over the cell's width."""
    scale = 1.0 / (n_dst / n_src)
    rows = []
    for d in range(n_dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, n_src - f1)
        s2 = min(math.floor(f2), n_src - 1)
        s1 = min(math.ceil(f1), s2)
        taps = []
        if s1 - f1 > 1e-3:
            taps.append((s1 - 1, (s1 - f1) / cell))
        taps += [(s, 1.0 / cell) for s in range(s1, s2)]
        if f2 - s2 > 1e-3:
            taps.append((s2, min(f2 - s2, 1.0, cell) / cell))
        rows.append(taps)
    K = max(len(t) for t in rows)
    index = np.zeros((n_dst, K), np.int64)
    weight = np.zeros((n_dst, K), np.float32)
    for d, taps in enumerate(rows):
        for k, (s, a) in enumerate(taps):
            index[d, k], weight[d, k] = s, np.float32(a)
    return index, weight


def _resize_area_fractional(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """cv2's ResizeArea_Invoker: each row's weighted sum over the source
    columns, then over the rows, in f32 and in cv2's order of terms."""
    H, W = img.shape[:2]
    x = img.astype(np.float32)
    trail = (1,) * (img.ndim - 2)
    cols, col_w = _area_table(W, w)
    rows, row_w = _area_table(H, h)
    buf = np.zeros((H, w, *img.shape[2:]), np.float32)
    for k in range(cols.shape[1]):
        buf = buf + x[:, cols[:, k]] * col_w[:, k].reshape(1, w, *trail)
    out = buf[rows[:, 0]] * row_w[:, 0].reshape(h, 1, *trail)
    for k in range(1, rows.shape[1]):
        out = out + buf[rows[:, k]] * row_w[:, k].reshape(h, 1, *trail)
    if img.dtype == np.uint8:  # saturate_cast: round half to even, clamp
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out


def resize_image(img: np.ndarray, new_hw: tuple[int, int]) -> np.ndarray:
    """(H, W, ...) -> new_hw, a downscale as the JAX loaders' cv2
    INTER_AREA resize computes it (the GPU host has no cv2).

    At an integer factor on each axis (cv2's fast path) each pixel is the
    mean of its box: a float image's f32 mean, a uint8 image's integer
    mean rounded as cv2 rounds uint8, half up at 2 x 2 (its vector path),
    half to even otherwise. At any other size each pixel is the
    area-weighted mean of the source cells it covers, with cv2's f32
    weights and order of sums, rounded half to even for uint8. Upscaling
    raises: no loader asks for it."""
    H, W = img.shape[:2]
    h, w = new_hw
    if not (0 < h <= H and 0 < w <= W):
        raise NotImplementedError(
            f"resize {H}x{W} -> {h}x{w}: only a downscale is ported (cv2 INTER_AREA "
            "upscales bilinearly, and no loader asks for it)")
    fy, fx = _area_fast_factor(H, h), _area_fast_factor(W, w)
    if not (fy and fx):
        return _resize_area_fractional(img, h, w)
    boxes = img.reshape(h, fy, w, fx, *img.shape[2:])
    if img.dtype != np.uint8:
        return boxes.mean(axis=(1, 3), dtype=np.float32)
    total = boxes.sum(axis=(1, 3), dtype=np.int64)
    area = fy * fx
    mean = (total + area // 2) // area if fy == fx == 2 else np.rint(total / area)
    return mean.astype(np.uint8)


def batch_random_sampling(rng: np.random.Generator, coords: np.ndarray, num_rays: int):
    """`num_rays` rows of `coords` drawn without replacement by `rng`: the
    first num_rays of a permutation (the train step samples on the device
    instead)."""
    idx = rng.permutation(coords.shape[0])[:num_rays]
    return coords[idx]


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
