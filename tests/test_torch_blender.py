"""The port's Blender targets (nerfmeshes_tpu_torch/data/blender.py)
against imageio and the JAX loader.

- The numpy + zlib PNG reader equals imageio bit for bit on every PNG of
  data/hard_blender, and on RGBA images written here with each of the
  five row filters.
- Targets and poses equal JAX's load_blender_data on the train split, and
  on the val split at reduced_resolution 3 (a fractional INTER_AREA scale)
  within 1e-5.
- `*_normal.png` beside every frame becomes target_normals within 1e-6 of
  JAX's at reduced_resolution 1, 2 and 3; a partial set gives None in both
  stacks; each stack reads the other's split npz, normals included.
- A depth EXR raises: no EXR decoder is on the GPU host.
"""

import json
import shutil
import struct
import zlib
from pathlib import Path

import imageio.v2 as imageio
import numpy as np
import pytest
import torch

from nerfmeshes_tpu.config import get_default_cfg
from nerfmeshes_tpu.data.loaders.blender import load_blender_data
from nerfmeshes_tpu_torch.data.blender import load_blender_data as t_load_blender_data
from nerfmeshes_tpu_torch.data.blender import (
    load_blender_targets,
    read_pngs,
    train_arrays,
)

torch.set_num_threads(1)

SCENE = Path(__file__).resolve().parents[1] / "data" / "hard_blender"


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _write_png(path, img: np.ndarray, filters) -> None:
    """An 8-bit RGB/RGBA PNG whose row r uses filter filters[r]."""
    H, W, C = img.shape
    x = np.zeros((H + 1, W + 1, C), np.int32)
    x[1:, 1:] = img
    rows = []
    for r in range(H):
        cur, up = x[r + 1, 1:], x[r, 1:]
        left, upleft = x[r + 1, :-1], x[r, :-1]
        pred = [np.zeros_like(cur), left, up, (left + up) >> 1, _paeth(left, up, upleft)]
        ft = filters[r]
        rows.append(bytes([ft]) + ((cur - pred[ft]) & 0xFF).astype(np.uint8).tobytes())

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    colour = {3: 2, 4: 6}[C]
    Path(path).write_bytes(
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, colour, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(b"".join(rows)))
        + chunk(b"IEND", b""))


def test_reader_matches_imageio_on_every_scene_png():
    paths = sorted(SCENE.glob("*/*.png"))
    assert len(paths) == 27
    for path, got in zip(paths, read_pngs(paths)):
        want = np.asarray(imageio.imread(path))
        assert got.dtype == np.uint8 and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=str(path))


@pytest.mark.parametrize("channels", [3, 4])
def test_reader_decodes_every_filter(tmp_path, channels):
    rng = np.random.default_rng(channels)
    # Smooth ramps plus noise: every predictor sees carries and wraps.
    img = (np.cumsum(rng.integers(0, 9, (23, 17, channels)), axis=1)
           + rng.integers(0, 40, (23, 17, channels))) % 256
    img = img.astype(np.uint8)
    filters = [r % 5 for r in range(23)]
    _write_png(tmp_path / "a.png", img, filters)
    np.testing.assert_array_equal(np.asarray(imageio.imread(tmp_path / "a.png")), img)
    np.testing.assert_array_equal(read_pngs([tmp_path / "a.png"])[0], img)
    # Mixed sizes in one call decode separately.
    _write_png(tmp_path / "b.png", img[:5, :9], [4, 3, 2, 1, 0])
    got = read_pngs([tmp_path / "a.png", tmp_path / "b.png"])
    np.testing.assert_array_equal(got[1], img[:5, :9])


def test_reader_refuses_what_it_does_not_decode(tmp_path):
    bad = tmp_path / "grey.png"
    imageio.imwrite(bad, np.zeros((4, 4), np.uint8))
    with pytest.raises(ValueError, match="colour type"):
        read_pngs([bad])[0]
    (tmp_path / "not.png").write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="not a PNG"):
        read_pngs([tmp_path / "not.png"])[0]


@pytest.mark.parametrize("white_background", [False, True])
def test_targets_match_jax_loader(white_background):
    cfg = get_default_cfg()
    cfg.dataset.white_background = white_background
    want = load_blender_data(cfg, str(SCENE / "transforms_train.json"))
    targets, poses, (H, W, focal) = load_blender_targets(
        SCENE, "train", white_background=white_background)
    assert targets.dtype == np.float32 and targets.shape == (20, 400, 400, 3)
    np.testing.assert_array_equal(targets, want.ray_targets)
    np.testing.assert_array_equal(poses, want.poses)
    np.testing.assert_allclose([H, W, focal], want.hwf, rtol=1e-6)


def test_white_background_composites_alpha(tmp_path):
    """An RGBA scene: rgb * alpha + (1 - alpha), as the JAX loader."""
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (6, 5, 4)).astype(np.uint8)
    (tmp_path / "train").mkdir()
    imageio.imwrite(tmp_path / "train" / "r_0.png", img)
    frame = {"file_path": "./train/r_0", "transform_matrix": np.eye(4).tolist()}
    (tmp_path / "transforms_train.json").write_text(
        json.dumps({"camera_angle_x": 0.7, "frames": [frame]}))
    cfg = get_default_cfg()
    cfg.dataset.white_background = True
    want = load_blender_data(cfg, str(tmp_path / "transforms_train.json"))
    got, _, _ = load_blender_targets(tmp_path, "train", white_background=True)
    np.testing.assert_array_equal(got, want.ray_targets)


def test_unported_inputs_raise(tmp_path):
    """Depth EXRs are not read: no EXR decoder is on the GPU host."""
    scene = tmp_path / "scene"
    shutil.copytree(SCENE / "val", scene / "val")
    shutil.copy(SCENE / "transforms_val.json", scene)
    (scene / "val" / "r_0_depth.exr").write_bytes(b"")
    with pytest.raises(NotImplementedError, match="depth"):
        load_blender_targets(scene, "val", white_background=False)


def _cfgs(basedir, **dataset):
    """The same dataset settings as a JAX and a port config."""
    from nerfmeshes_tpu_torch.config import get_default_cfg as t_default_cfg

    out = []
    for cfg in (get_default_cfg(), t_default_cfg()):
        cfg.dataset.basedir = str(basedir)
        cfg.dataset.update(dataset)
        out.append(cfg)
    return out


@pytest.mark.parametrize("white_background", [False, True])
def test_reduced_resolution_3_matches_jax(white_background):
    """400^2 -> 133^2: cv2 INTER_AREA at a fractional scale (3.0075)."""
    j_cfg, t_cfg = _cfgs(SCENE, reduced_resolution=3, white_background=white_background)
    want = load_blender_data(j_cfg, str(SCENE / "transforms_val.json"))
    got = t_load_blender_data(t_cfg, "val")
    assert got.ray_targets.shape == (2, 133, 133, 3) and got.ray_targets.dtype == np.float32
    np.testing.assert_allclose(got.ray_targets, want.ray_targets, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.poses, want.poses)
    np.testing.assert_array_equal(got.hwf, want.hwf)


def _scene_with_normals(tmp_path, frames=None) -> Path:
    """A copy of data/hard_blender's val split with an RGB r_i_normal.png
    beside each frame (or beside the frames listed)."""
    scene = tmp_path / "scene"
    shutil.copytree(SCENE / "val", scene / "val")
    shutil.copy(SCENE / "transforms_val.json", scene)
    rng = np.random.default_rng(7)
    n = len(json.loads((SCENE / "transforms_val.json").read_text())["frames"])
    for i in range(n) if frames is None else frames:
        normal = rng.integers(0, 256, (400, 400, 3), dtype=np.uint8)
        imageio.imwrite(scene / "val" / f"r_{i}_normal.png", normal)
    return scene


@pytest.mark.parametrize("reduced", [1, 2, 3])
def test_normals_match_jax_loader(tmp_path, reduced):
    scene = _scene_with_normals(tmp_path)
    j_cfg, t_cfg = _cfgs(scene, reduced_resolution=reduced)
    want = load_blender_data(j_cfg, str(scene / "transforms_val.json"))
    got = t_load_blender_data(t_cfg, "val")
    side = 400 // reduced
    assert got.target_normals.shape == (2, side, side, 3)
    assert got.target_normals.dtype == np.float32
    np.testing.assert_allclose(got.target_normals, want.target_normals, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.ray_targets, want.ray_targets, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.hwf, want.hwf)


def test_a_partial_set_of_normals_gives_none(tmp_path):
    scene = _scene_with_normals(tmp_path, frames=[0])
    j_cfg, t_cfg = _cfgs(scene)
    assert load_blender_data(j_cfg, str(scene / "transforms_val.json")).target_normals is None
    assert t_load_blender_data(t_cfg, "val").target_normals is None


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_normals_cache_read_across_stacks(tmp_path, writer):
    """Each stack reads the other's split npz, normals included, after
    testskip strides them."""
    from nerfmeshes_tpu.data import datasets as j_datasets
    from nerfmeshes_tpu_torch.data import datasets as t_datasets

    scene = _scene_with_normals(tmp_path)
    cfgs = _cfgs(scene, reduced_resolution=2, testskip=2)
    for cfg in cfgs:
        cfg.dataset.caching.update(use_caching=True, cache_dir=str(tmp_path / "cache"))
    j_cfg, t_cfg = cfgs
    cpu = torch.device("cpu")
    if writer == "port":
        first = t_datasets.BlenderDataset(t_cfg, t_datasets.DatasetType.VALIDATION, cpu)
        second = j_datasets.BlenderDataset(j_cfg, j_datasets.DatasetType.VALIDATION)
    else:
        first = j_datasets.BlenderDataset(j_cfg, j_datasets.DatasetType.VALIDATION)
        second = t_datasets.BlenderDataset(t_cfg, t_datasets.DatasetType.VALIDATION, cpu)
    with np.load(tmp_path / "cache" / "val.npz") as data:
        assert data["target_normals"].shape == (1, 200, 200, 3)
    assert second.bundle.target_normals.shape == (1, 200, 200, 3)
    np.testing.assert_allclose(second.bundle.target_normals, first.bundle.target_normals,
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(second.bundle.ray_targets, first.bundle.ray_targets,
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("use_ndc", [False, True])
def test_train_arrays(use_ndc):
    cfg = get_default_cfg()
    cfg.dataset.basedir = str(SCENE)
    cfg.dataset.use_ndc = use_ndc
    data = train_arrays(cfg, torch.device("cpu"), split="val")
    assert data["targets"].shape == (2, 400, 400, 3) and data["targets"].dtype == torch.float32
    assert data["poses"].shape == (2, 4, 4)
    assert data["bounds"].tolist() == ([0.0, 1.0] if use_ndc else [2.0, 6.0])
    H, W, focal = data["hwf"]
    assert (H, W) == (400, 400) and focal == pytest.approx(555.5555, rel=1e-4)
