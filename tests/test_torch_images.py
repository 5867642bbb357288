"""The port's host helpers that mirror the JAX package's public surface,
against the JAX functions on the CPU.

- utils/images.py: batchify (chunks, None entries, the tqdm wrapper),
  cast_to_image, cast_to_pil_image, cast_to_disparity_image (one copy,
  re-exported by utils/logging.py) equal to JAX's bit for bit;
  export_point_cloud's OBJ byte for byte.
- utils/logging.py:progress_bar: JAX's enable rule (TTY or
  NERFMESHES_PROGRESS), an inert stub without tqdm; fit moves the bar at
  the print cadence only, to max_steps.
- data: convert_poses_to_rays within 1e-6 of JAX's; batch_random_sampling
  equal to JAX's under the same generator; the package exports JAX's names
  (but the EXR reader); write_blender_style_dataset's JSON byte for byte
  and its PNGs pixel for pixel (tolerance stated in the test).
"""

import json
import sys
from pathlib import Path

import imageio.v2 as imageio
import numpy as np
import pytest
import torch

import nerfmeshes_tpu.data as j_data
import nerfmeshes_tpu_torch.data as t_data
from nerfmeshes_tpu.data import datasets as j_datasets
from nerfmeshes_tpu.data import helpers as j_helpers
from nerfmeshes_tpu.data.synthetic import write_blender_style_dataset as j_write_blender
from nerfmeshes_tpu.utils import images as j_images
from nerfmeshes_tpu.utils import logging as j_logging
from nerfmeshes_tpu_torch.data import datasets as t_datasets
from nerfmeshes_tpu_torch.data import helpers as t_helpers
from nerfmeshes_tpu_torch.data.synthetic import write_blender_style_dataset as t_write_blender
from nerfmeshes_tpu_torch.utils import images as t_images
from nerfmeshes_tpu_torch.utils import logging as t_logging

torch.set_num_threads(1)
CPU = torch.device("cpu")


@pytest.mark.parametrize("batch_size", [1, 7, 10, 64])
def test_batchify_matches_jax(batch_size):
    rng = np.random.default_rng(batch_size)
    a, b = rng.normal(size=(10, 3)), rng.normal(size=(10, 2, 2))
    got = list(t_images.batchify(a, None, b, batch_size=batch_size))
    want = list(j_images.batchify(a, None, b, batch_size=batch_size))
    assert len(got) == len(want) == -(-10 // batch_size)
    for g, w in zip(got, want):
        assert g[1] is None and w[1] is None
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[2], w[2])
    with pytest.raises(ValueError, match="dimension 0"):  # JAX asserts; the port raises
        t_images.batchify(a, b[:3])


def test_batchify_progress_wraps_in_tqdm_when_importable(monkeypatch):
    from tqdm import tqdm

    a = np.zeros((10, 1))
    bar = t_images.batchify(a, batch_size=4, progress=True)
    assert isinstance(bar, tqdm) and bar.total == 3 and len(list(bar)) == 3
    monkeypatch.setitem(sys.modules, "tqdm", None)
    plain = t_images.batchify(a, batch_size=4, progress=True)
    assert not isinstance(plain, tqdm) and len(list(plain)) == 3


def test_casts_match_jax():
    rng = np.random.default_rng(0)
    img = rng.uniform(-0.2, 1.2, (9, 11, 3)).astype(np.float32)
    for name in ("cast_to_image", "cast_to_pil_image"):
        got, want = getattr(t_images, name)(img), getattr(j_images, name)(img)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    assert t_images.cast_to_image(img).shape == (3, 9, 11)
    disp = rng.uniform(0, 3, (9, 11)).astype(np.float32)
    disp[2:4, 3:5] = disp.min()
    for white in (False, True):
        np.testing.assert_array_equal(t_images.cast_to_disparity_image(disp, white),
                                      j_images.cast_to_disparity_image(disp, white))
    flat = np.full((4, 4), 2.0, np.float32)
    np.testing.assert_array_equal(t_images.cast_to_disparity_image(flat),
                                  j_images.cast_to_disparity_image(flat))
    assert t_logging.cast_to_disparity_image is t_images.cast_to_disparity_image


@pytest.mark.parametrize("shared_origin", [True, False])
def test_export_point_cloud_writes_jax_bytes(tmp_path, shared_origin):
    rng = np.random.default_rng(1)
    dirs = rng.normal(size=(6, 3)).astype(np.float32)
    origins = (rng.normal(size=(1, 3)) if shared_origin else rng.normal(size=(6, 3))).astype(
        np.float32)
    depth, target = rng.uniform(2, 6, 6), rng.uniform(2, 6, 6)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = j_images.export_point_cloud(12, origins, dirs, depth, target, str(tmp_path / "jax"))
    got = t_images.export_point_cloud(12, origins, dirs, depth, target, str(tmp_path / "port"))
    assert Path(got).name == Path(want).name == "0012.obj"
    assert Path(got).read_bytes() == Path(want).read_bytes()


def test_jax_own_cases(tmp_path, monkeypatch):
    """tests/test_utils.py's and tests/test_train.py's cases, on the port."""
    a, b = np.arange(10), np.arange(20).reshape(10, 2)
    chunks = list(t_images.batchify(a, b, None, batch_size=4))
    assert len(chunks) == 3
    assert chunks[0][0].shape == (4,) and chunks[2][0].shape == (2,)
    assert chunks[1][1].shape == (4, 2) and chunks[0][2] is None
    img = np.random.default_rng(0).uniform(size=(5, 7, 3))
    out = t_images.cast_to_image(img)
    assert out.shape == (3, 5, 7) and out.dtype == np.uint8
    assert t_images.cast_to_pil_image(img).shape == (5, 7, 3)
    disp = np.array([[0.0, 1.0], [2.0, 4.0]])
    out = t_images.cast_to_disparity_image(disp)
    assert out.dtype == np.uint8 and out[0, 0] == 0 and out[1, 1] == 255
    assert t_images.cast_to_disparity_image(disp, white_background=True)[0, 0] == 255
    rng = np.random.default_rng(0)
    dirs = rng.standard_normal((6, 3))
    depth, target = rng.uniform(1, 2, 6), rng.uniform(1, 2, 6)
    (tmp_path / "jax").mkdir()
    path = t_images.export_point_cloud(7, np.zeros(3), dirs, depth, target, save_dir=str(tmp_path))
    assert open(path).read().count("v ") == 12 and "0007.obj" in path
    want = j_images.export_point_cloud(7, np.zeros(3), dirs, depth, target,
                                       save_dir=str(tmp_path / "jax"))
    assert Path(path).read_bytes() == Path(want).read_bytes()
    monkeypatch.setenv("NERFMESHES_PROGRESS", "1")
    bar = t_logging.progress_bar(10, "train", initial=2)
    assert type(bar).__name__ == "tqdm"
    bar.update(3)
    bar.set_postfix_str("loss=0.1", refresh=False)
    assert bar.n == 5
    bar.close()


@pytest.mark.parametrize("env,tty,enabled", [(None, False, False), (None, True, True),
                                             ("1", False, True), ("0", True, False),
                                             ("false", True, False)])
def test_progress_bar_follows_jax_rule(monkeypatch, env, tty, enabled):
    from tqdm import tqdm

    if env is None:
        monkeypatch.delenv("NERFMESHES_PROGRESS", raising=False)
    else:
        monkeypatch.setenv("NERFMESHES_PROGRESS", env)
    monkeypatch.setattr(sys.stderr, "isatty", lambda: tty)
    got = t_logging.progress_bar(10, desc="train")
    want = j_logging.progress_bar(10, desc="train")
    assert isinstance(got, tqdm) == isinstance(want, tqdm) == enabled
    for bar in (got, want):
        bar.update(3)
        bar.set_postfix_str("loss=1", refresh=False)
        bar.close()
    assert not isinstance(t_logging.progress_bar(10, desc="train", show=False), tqdm)


def test_progress_bar_is_a_stub_without_tqdm(monkeypatch):
    monkeypatch.setenv("NERFMESHES_PROGRESS", "1")
    monkeypatch.setitem(sys.modules, "tqdm", None)
    bar = t_logging.progress_bar(5, desc="val", position=1)
    bar.update(1)
    bar.set_postfix_str("x")
    bar.close()
    assert type(bar).__name__ == "_NoopBar"


def test_fit_moves_the_bar_at_the_print_cadence(monkeypatch):
    """The bar is updated with the host's step count only when the
    metrics come to the host anyway, and ends at max_steps."""
    from nerfmeshes_tpu_torch.config import get_default_cfg
    from nerfmeshes_tpu_torch.data.blender import train_arrays
    from nerfmeshes_tpu_torch.train import system as t_system

    updates = []

    class Bar:
        def __init__(self, total, desc, initial=0, position=0, show=True):
            self.desc = desc

        def update(self, n=1):
            updates.append((self.desc, n))

        def set_postfix_str(self, s, refresh=True):
            pass

        def close(self):
            updates.append((self.desc, "closed"))

    monkeypatch.setattr(t_system, "progress_bar", Bar)
    cfg = get_default_cfg()
    cfg.dataset.basedir = str(Path(__file__).resolve().parents[1] / "data" / "hard_blender")
    for node in (cfg.models.coarse, cfg.models.fine):
        node.update(num_layers=2, hidden_size=16)
    cfg.nerf.train.update(num_random_rays=64, num_coarse=8, num_fine=8)
    cfg.nerf.validation.update(num_samples=1, chunksize=4096)
    cfg.dataset.reduced_resolution = 8
    cfg.experiment.update(print_every=3, validate_every=7, steps_per_call=1)
    system = t_system.NeRFSystem(cfg, device="cpu").setup(train_arrays(cfg, "cpu", split="val"))
    system.fit(7)
    assert [n for d, n in updates if d == "train"] == [3, 3, 1, 0, "closed"]
    assert ("val", 1) in updates and ("val", "closed") in updates


def test_convert_poses_to_rays_matches_jax():
    poses = t_helpers.synthesis_poses()[:5]
    got_o, got_d = t_datasets.convert_poses_to_rays(poses, 12, 16, 20.5)
    want_o, want_d = j_datasets.convert_poses_to_rays(poses, 12, 16, 20.5)
    assert got_o.shape == want_o.shape == (5, 3) and got_d.shape == want_d.shape == (5, 12, 16, 3)
    np.testing.assert_allclose(got_o, want_o, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_d, want_d, rtol=0, atol=1e-6)


@pytest.mark.parametrize("num_rays", [1, 50, 400])
def test_batch_random_sampling_matches_jax(num_rays):
    coords = np.stack(np.meshgrid(np.arange(20), np.arange(20), indexing="ij"), -1).reshape(-1, 2)
    got = t_helpers.batch_random_sampling(np.random.default_rng(4), coords, num_rays)
    want = j_helpers.batch_random_sampling(np.random.default_rng(4), coords, num_rays)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got, axis=0)) == num_rays


def test_package_exports_what_jax_exports():
    assert set(t_data.__all__) == set(j_data.__all__) - {"read_depth_from_exr"}
    for name in t_data.__all__:
        assert getattr(t_data, name) is not None


def test_write_blender_style_dataset_matches_jax(tmp_path):
    """The JSON files byte for byte; every PNG's pixels as JAX's within 1
    LSB (the two stacks' renders differ in the last f32 bits, which can
    move a truncation to uint8 by one), equal on at least 99% of samples;
    and the port's loader reads the port's files."""
    kw = dict(splits=("train", "val"), num_images={"train": 3, "val": 2}, image_size=16,
              num_samples=32)
    j_write_blender(str(tmp_path / "jax"), **kw)
    t_write_blender(str(tmp_path / "port"), **kw, device=CPU)
    for split in ("train", "val"):
        name = f"transforms_{split}.json"
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
        frames = json.loads((tmp_path / "port" / name).read_text())["frames"]
        for frame in frames:
            png = Path(frame["file_path"]).with_suffix(".png")
            got = imageio.imread(tmp_path / "port" / png)
            want = imageio.imread(tmp_path / "jax" / png)
            assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape == (16, 16, 3)
            diff = np.abs(got.astype(int) - want.astype(int))
            assert diff.max() <= 1 and (diff == 0).mean() >= 0.99
    from nerfmeshes_tpu_torch.data.blender import load_blender_targets

    targets, poses, (H, W, _) = load_blender_targets(tmp_path / "port", "val",
                                                     white_background=False)
    assert targets.shape == (2, 16, 16, 3) and (H, W) == (16, 16)
