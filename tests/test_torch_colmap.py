"""The COLMAP model I/O, the converter and GeneralColmapDataset of the port
(nerfmeshes_tpu_torch/data/loaders/colmap.py, cli/colmap_convert.py,
data/colmap_dataset.py) against the JAX package, on the CPU.

- Binary and text models: each stack reads what the other wrote, with
  every field equal (text floats print with repr, so they round-trip
  exactly), and the two writers' files are byte for byte the same.
- qvec2rotmat / rotmat2qvec equal JAX's within 1e-12 (the same
  expressions; eigh may order its sums differently).
- gen_poses on a fabricated sparse model (ids out of name order, one image
  seeing no point): poses_bounds.npy equal to JAX's; with all_images/ only
  the registered images are copied; factors minify.
- Without a `colmap` binary, a scene with no sparse model raises a clear
  FileNotFoundError; with a stand-in binary on PATH, the three COLMAP
  steps run in JAX's order. The CLI refuses an unknown matcher.
- GeneralColmapDataset equals JAX's on a fabricated sparse model, with
  PNG and with JPEG images (targets bit for bit: the port's decoder equals
  imageio's).
"""

import os
import stat
from pathlib import Path

import imageio.v2 as imageio
import numpy as np
import pytest
import torch

from nerfmeshes_tpu.cli import colmap_convert as j_convert
from nerfmeshes_tpu.config import get_default_cfg as j_default_cfg
from nerfmeshes_tpu.data import colmap_dataset as j_colmap_ds
from nerfmeshes_tpu.data.datasets import DatasetType as JDatasetType
from nerfmeshes_tpu.data.loaders import colmap as j_colmap
from nerfmeshes_tpu_torch.cli import colmap_convert as t_convert
from nerfmeshes_tpu_torch.config import get_default_cfg
from nerfmeshes_tpu_torch.data import colmap_dataset as t_colmap_ds
from nerfmeshes_tpu_torch.data.datasets import DatasetType
from nerfmeshes_tpu_torch.data.loaders import colmap as t_colmap

torch.set_num_threads(1)
CPU = torch.device("cpu")
MODELS = {"jax": j_colmap, "port": t_colmap}


def _model(mod, seed=0, empty_image=True):
    """A model of every record kind, built from `mod`'s classes: two
    cameras, images with 2D points (and, with `empty_image`, one without),
    points with tracks."""
    rng = np.random.default_rng(seed)
    cams = {1: mod.Camera(1, "SIMPLE_RADIAL", 64, 48, np.array([60.0, 32.0, 24.0, 0.01])),
            3: mod.Camera(3, "OPENCV", 64, 48, rng.standard_normal(8))}
    images = {}
    for i in (2, 1, 5):
        q = rng.standard_normal(4)
        q /= np.linalg.norm(q)
        q = -q if q[0] < 0 else q
        n_pts = 0 if i == 5 and empty_image else 4
        images[i] = mod.Image(i, q, rng.standard_normal(3), 1 if i < 5 else 3,
                              f"img_{i:03d}.png", rng.uniform(0, 64, (n_pts, 2)),
                              rng.integers(-1, 20, n_pts).astype(np.int64))
    points = {j: mod.Point3D(j, rng.standard_normal(3), rng.integers(0, 256, 3), 0.25 * j,
                             np.array([1, 2, 2]), np.array([0, 3, 1]))
              for j in (10, 11, 13)}
    return cams, images, points


def _assert_models_equal(got, want):
    (gc, gi, gp), (wc, wi, wp) = got, want
    assert list(gc) == list(wc) and list(gi) == list(wi) and list(gp) == list(wp)
    for k in wc:
        assert (gc[k].id, gc[k].model, gc[k].width, gc[k].height) == (
            wc[k].id, wc[k].model, wc[k].width, wc[k].height)
        np.testing.assert_array_equal(gc[k].params, wc[k].params)
    for k in wi:
        assert (gi[k].id, gi[k].camera_id, gi[k].name) == (wi[k].id, wi[k].camera_id,
                                                          wi[k].name)
        for key in ("qvec", "tvec", "xys", "point3D_ids"):
            g, w = getattr(gi[k], key), getattr(wi[k], key)
            assert g.shape == w.shape, key
            np.testing.assert_array_equal(g, w)
    for k in wp:
        assert gp[k].error == wp[k].error
        for key in ("xyz", "rgb", "image_ids", "point2D_idxs"):
            np.testing.assert_array_equal(getattr(gp[k], key), getattr(wp[k], key))


@pytest.mark.parametrize("ext", [".bin", ".txt"])
@pytest.mark.parametrize("writer, reader", [("jax", "port"), ("port", "jax"),
                                            ("port", "port")])
def test_model_round_trips_across_stacks(tmp_path, ext, writer, reader):
    # JAX's text reader cannot read an image without 2D points
    # (test_text_image_without_points); the port's can.
    model = _model(MODELS[writer], empty_image=not (ext == ".txt" and reader == "jax"))
    MODELS[writer].write_model(*model, tmp_path, ext)
    _assert_models_equal(MODELS[reader].read_model(tmp_path, ext), model)


@pytest.mark.parametrize("ext", [".bin", ".txt"])
def test_writers_agree_byte_for_byte(tmp_path, ext):
    for name, mod in MODELS.items():
        mod.write_model(*_model(mod, seed=4), tmp_path / name, ext)
    for part in ("cameras", "images", "points3D"):
        assert ((tmp_path / "port" / f"{part}{ext}").read_bytes()
                == (tmp_path / "jax" / f"{part}{ext}").read_bytes()), part


def test_text_image_without_points(tmp_path):
    """COLMAP writes an empty POINTS2D line for an image that sees no point.
    The port reads it; JAX's reader drops the empty line and mis-pairs the
    rest, a fault of the reference that the port does not copy."""
    model = _model(j_colmap)
    j_colmap.write_model(*model, tmp_path, ".txt")
    _assert_models_equal(t_colmap.read_model(tmp_path, ".txt"), model)
    assert len(j_colmap.read_images_text(tmp_path / "images.txt")) != len(model[1])


def test_quaternions_match_jax():
    rng = np.random.default_rng(1)
    for _ in range(20):
        q = rng.standard_normal(4)
        q /= np.linalg.norm(q)
        R = t_colmap.qvec2rotmat(q)
        np.testing.assert_allclose(R, j_colmap.qvec2rotmat(q), rtol=0, atol=1e-12)
        np.testing.assert_allclose(t_colmap.rotmat2qvec(R), j_colmap.rotmat2qvec(R), rtol=0,
                                   atol=1e-12)


def _sparse_scene(base: Path, mod, images_dir="images", seed=0, ext="png"):
    """A scene with a sparse/0 binary model written by `mod`: 4 PNGs (or
    with ext "JPG" baseline JPEGs written by PIL), image ids out of name
    order, cameras looking along +z at a point cloud, one image that sees
    no point."""
    rng = np.random.default_rng(seed)
    (base / images_dir).mkdir(parents=True)
    H, W = 24, 32
    cams = {1: mod.Camera(1, "SIMPLE_RADIAL", W, H, np.array([30.0, W / 2, H / 2, 0.0]))}
    images, points = {}, {}
    for i, name_idx in ((7, 2), (2, 0), (5, 3), (3, 1)):
        imageio.imwrite(base / images_dir / f"img_{name_idx:03d}.{ext}",
                        (rng.uniform(0, 1, (H, W, 3)) * 255).astype(np.uint8),
                        **({"format": "JPEG"} if ext != "png" else {}))
        q = np.array([1.0, 0.05 * i, -0.03 * i, 0.02])
        images[i] = mod.Image(i, q / np.linalg.norm(q), np.array([0.1 * i, -0.2, float(i)]), 1,
                              f"img_{name_idx:03d}.{ext}", np.zeros((0, 2)),
                              np.zeros(0, np.int64))
    for j in range(30):
        seen = np.array([7, 2, 5]) if j % 2 else np.array([2, 7])
        points[j] = mod.Point3D(j, rng.standard_normal(3) * 0.5 + [0, 0, 8],
                                np.array([100, 100, 100]), 0.1, seen, np.zeros_like(seen))
    mod.write_model(cams, images, points, base / "sparse" / "0", ".bin")
    return base


@pytest.mark.parametrize("all_images", [False, True])
def test_gen_poses_matches_jax(tmp_path, all_images, capsys):
    folder = "all_images" if all_images else "images"
    for name, mod in MODELS.items():
        _sparse_scene(tmp_path / name, mod, folder)
    j_convert.gen_poses(str(tmp_path / "jax"), "exhaustive_matcher")
    t_convert.gen_poses(str(tmp_path / "port"), "exhaustive_matcher", factors=[2])
    assert "Don't need to run COLMAP" in capsys.readouterr().out
    got = np.load(tmp_path / "port" / "poses_bounds.npy")
    want = np.load(tmp_path / "jax" / "poses_bounds.npy")
    assert got.shape == want.shape == (4, 17)
    np.testing.assert_array_equal(got, want)
    assert (got[:, 15] > 0).all() and (got[:, 15] < got[:, 16]).all()
    names = sorted(p.name for p in (tmp_path / "port" / "images").iterdir())
    assert names == [f"img_{i:03d}.png" for i in range(4)]
    assert sorted(p.name for p in (tmp_path / "port" / "images_2").iterdir()) == names


def test_missing_colmap_binary_raises(tmp_path, monkeypatch):
    (tmp_path / "scene" / "images").mkdir(parents=True)
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(FileNotFoundError, match="colmap"):
        t_convert.main([str(tmp_path / "scene")])


def test_run_colmap_calls_the_three_steps(tmp_path, monkeypatch):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    calls = tmp_path / "calls.txt"
    fake = bindir / "colmap"
    fake.write_text(f"#!/bin/sh\necho \"$1\" >> {calls}\necho ran $1\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    base = tmp_path / "scene"
    (base / "images").mkdir(parents=True)
    t_convert.run_colmap(str(base), "sequential_matcher")
    assert calls.read_text().split() == ["feature_extractor", "sequential_matcher", "mapper"]
    assert "ran mapper" in (base / "colmap_output.txt").read_text()
    assert (base / "sparse").is_dir()


def test_cli_refuses_an_unknown_matcher(tmp_path, capsys):
    with pytest.raises(SystemExit) as exit_info:
        t_convert.main([str(tmp_path), "--match_type", "vocab_tree_matcher"])
    assert exit_info.value.code == 1
    assert "not valid" in capsys.readouterr().out


def test_general_colmap_dataset_matches_jax(tmp_path):
    base = _sparse_scene(tmp_path / "scene", t_colmap)
    j_cfg, t_cfg = j_default_cfg(), get_default_cfg()
    for cfg in (j_cfg, t_cfg):
        cfg.dataset.update(type="general_colmap", basedir=str(base))
    (base / "images" / "img_003.png").unlink()  # an image without a file is skipped
    want = j_colmap_ds.GeneralColmapDataset(j_cfg, JDatasetType.TRAIN, resolution=0.5)
    got = t_colmap_ds.GeneralColmapDataset(t_cfg, DatasetType.TRAIN, resolution=0.5,
                                           device=CPU)
    assert len(got) == len(want) == 3
    for key in ("ray_targets", "poses", "hwf"):
        g, w = getattr(got.bundle, key), np.asarray(getattr(want.bundle, key))
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got.image_rays(2), want.image_rays(2)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)


def test_general_colmap_dataset_on_jpeg_matches_jax(tmp_path):
    base = _sparse_scene(tmp_path / "scene", t_colmap, ext="JPG")
    j_cfg, t_cfg = j_default_cfg(), get_default_cfg()
    for cfg in (j_cfg, t_cfg):
        cfg.dataset.update(type="general_colmap", basedir=str(base))
    want = j_colmap_ds.GeneralColmapDataset(j_cfg, JDatasetType.TRAIN)
    got = t_colmap_ds.GeneralColmapDataset(t_cfg, DatasetType.TRAIN, device=CPU)
    assert len(got) == len(want) == 4
    for key in ("ray_targets", "poses", "hwf"):
        g, w = getattr(got.bundle, key), np.asarray(getattr(want.bundle, key))
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
