"""The port's datasets (nerfmeshes_tpu_torch/data/) against the JAX
package's, on the CPU.

- The procedural scenes (blobs, hard) rendered at 16^2, with and without
  depth, equal JAX's make_synthetic_dataset within atol 1e-5 (the two
  stacks' f32 transcendentals and sums differ in the last bits); poses and
  hwf exactly.
- Orbit poses exactly; one image's device rays (NDC on and off, and the
  synthesized orbit) within 1e-6 of JAX's, bounds exactly; testskip, the
  train arrays and the dataset factory as JAX's (ScanNet builds: its
  parity is tests/test_torch_scannet.py; COLMAP and the split cache:
  tests/test_torch_llff.py).
- The reduced-resolution box mean within 1e-6 of cv2 INTER_AREA, and the
  Blender loader at reduced_resolution 2 within 1e-6 of JAX's loader.
- INTER_AREA at fractional scales (3.0075, 2.5, 8.006, ...; 1-4 channels)
  within 1e-5 (f32) and 1 LSB (uint8) of cv2, the share of differing
  samples printed; unequal integer factors as cv2's box mean; upscaling
  raises.
"""

from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from nerfmeshes_tpu.config import get_default_cfg
from nerfmeshes_tpu.data import datasets as j_datasets
from nerfmeshes_tpu.data import helpers as j_helpers
from nerfmeshes_tpu.data.loaders.blender import load_blender_data as j_load_blender
from nerfmeshes_tpu.data.synthetic import make_synthetic_dataset as j_make_synthetic
from nerfmeshes_tpu_torch.data import datasets as t_datasets
from nerfmeshes_tpu_torch.data import helpers as t_helpers
from nerfmeshes_tpu_torch.data.blender import load_blender_data as t_load_blender
from nerfmeshes_tpu_torch.data.synthetic import make_synthetic_dataset as t_make_synthetic

torch.set_num_threads(1)
CPU = torch.device("cpu")
SCENE = Path(__file__).resolve().parents[1] / "data" / "hard_blender"


@pytest.mark.parametrize("scene", ["blobs", "hard"])
@pytest.mark.parametrize("with_depth", [False, True])
def test_synthetic_scene_matches_jax(scene, with_depth):
    kw = dict(num_images=3, image_size=16, scene=scene, with_depth=with_depth, seed=1,
              num_samples=64, white_background=scene == "blobs")
    want = j_make_synthetic(**kw)
    got = t_make_synthetic(**kw, device=CPU)
    np.testing.assert_allclose(got.ray_targets, want.ray_targets, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.poses, want.poses)
    np.testing.assert_array_equal(got.hwf, want.hwf)
    np.testing.assert_array_equal(got.ray_bounds, want.ray_bounds)
    if with_depth:
        np.testing.assert_allclose(got.target_depth, want.target_depth, rtol=0, atol=1e-5)
    else:
        assert got.target_depth is None


def test_synthetic_targets_stay_on_the_device():
    got = t_make_synthetic(num_images=2, image_size=8, num_samples=16, keep_on_device=True,
                           with_depth=True, device=CPU)
    assert isinstance(got.ray_targets, torch.Tensor) and got.ray_targets.shape == (2, 8, 8, 3)
    assert isinstance(got.target_depth, torch.Tensor)


def test_orbit_poses_match_jax():
    for theta, phi, radius in [(0.0, -30.0, 4.0), (37.5, 12.0, 2.5), (-180.0, 90.0, 1.0)]:
        np.testing.assert_array_equal(t_helpers.pose_spherical(theta, phi, radius),
                                      j_helpers.pose_spherical(theta, phi, radius))
    np.testing.assert_array_equal(t_helpers.synthesis_poses(), j_helpers.synthesis_poses())
    assert t_helpers.synthesis_poses().shape == (120, 4, 4)


def _blender_cfg(**dataset):
    cfg = get_default_cfg()
    cfg.dataset.basedir = str(SCENE)
    cfg.dataset.update(dataset)
    return cfg


@pytest.mark.parametrize("use_ndc", [False, True])
@pytest.mark.parametrize("synthesis", [False, True])
def test_image_rays_and_bounds_match_jax(use_ndc, synthesis):
    cfg = _blender_cfg(use_ndc=use_ndc)
    want = j_datasets.BlenderDataset(cfg, j_datasets.DatasetType.VALIDATION)
    got = t_datasets.BlenderDataset(cfg, t_datasets.DatasetType.VALIDATION, device=CPU)
    if synthesis:
        want.synthesis()
        got.synthesis()
    assert len(got) == len(want) == (120 if synthesis else 2)
    idx = len(got) - 1
    for g, w in zip(got.image_rays(idx), want.image_rays(idx)):
        assert g.shape == w.shape == (400 * 400, 3)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got._bounds_for(idx), want._bounds_for(idx))
    if not synthesis:
        np.testing.assert_array_equal(got.image_targets(idx).numpy(),
                                      want.bundle.ray_targets[idx].reshape(-1, 3))


def test_per_image_bounds_cover_the_scene_for_synthesis():
    cfg = _blender_cfg()
    want = j_datasets.BlenderDataset(cfg, j_datasets.DatasetType.VALIDATION)
    got = t_datasets.BlenderDataset(cfg, t_datasets.DatasetType.VALIDATION, device=CPU)
    bounds = np.array([[2.0, 5.0], [1.5, 6.5]], np.float32)
    want.bundle.ray_bounds = got.bundle.ray_bounds = bounds
    for i in range(2):
        np.testing.assert_array_equal(got._bounds_for(i), want._bounds_for(i))
    got.synthesis()
    want.synthesis()
    np.testing.assert_array_equal(got._bounds_for(7), want._bounds_for(7))
    np.testing.assert_array_equal(got._bounds_for(7), [1.5, 6.5])


@pytest.mark.parametrize("testskip", [1, 2, 3])
def test_testskip_strides_test_frames(testskip):
    cfg = _blender_cfg(testskip=testskip)
    want = j_datasets.BlenderDataset(cfg, j_datasets.DatasetType.TEST)
    got = t_datasets.BlenderDataset(cfg, t_datasets.DatasetType.TEST, device=CPU)
    assert len(got) == len(want) == len(range(0, 5, testskip))
    np.testing.assert_array_equal(got.poses, want.poses)
    np.testing.assert_array_equal(got.bundle.ray_targets, want.bundle.ray_targets)
    train = t_datasets.BlenderDataset(cfg, t_datasets.DatasetType.TRAIN, device=CPU)
    assert len(train) == 20  # the train split is never strided


@pytest.mark.parametrize("use_ndc", [False, True])
def test_device_arrays_match_jax(use_ndc):
    cfg = _blender_cfg(use_ndc=use_ndc)
    want = j_datasets.BlenderDataset(cfg, j_datasets.DatasetType.VALIDATION).device_arrays()
    got = t_datasets.BlenderDataset(cfg, t_datasets.DatasetType.VALIDATION,
                                    device=CPU).device_arrays()
    assert set(got) == set(want)
    for key in ("targets", "poses", "bounds"):
        assert got[key].dtype == torch.float32
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    assert got["hwf"] == tuple(float(v) for v in want["hwf"])


def test_synthetic_dataset_follows_the_config():
    cfg = get_default_cfg()
    cfg.dataset.update(type="synthetic", scene="hard")
    cfg.dataset.synthetic.update(num_images=9, image_size=6, gt_samples=16, with_depth=True)
    train = t_datasets.build_dataset(cfg, t_datasets.DatasetType.TRAIN, CPU)
    val = t_datasets.build_dataset(cfg, t_datasets.DatasetType.VALIDATION, CPU)
    assert type(train) is t_datasets.SyntheticDataset
    assert len(train) == 9 and len(val) == 2  # max(2, 9 // 4) held-out views
    arrays = train.device_arrays()
    assert arrays["targets"].shape == (9, 6, 6, 3) and arrays["target_depth"].shape == (9, 6, 6)
    assert arrays["hwf"][:2] == (6, 6)


def test_unported_datasets_raise(tmp_path):
    """Named when ScanNet raised: `scannet` now builds a ScanNetDataset over
    a .sens stream (2 JPEG frames); an unknown type still raises."""
    import io
    import zlib

    from PIL import Image

    from nerfmeshes_tpu_torch.data.loaders.scannet import RGBDFrame, write_sens
    from nerfmeshes_tpu_torch.data.scannet_dataset import ScanNetDataset

    rng = np.random.default_rng(0)
    frames = []
    for i in range(2):
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, (8, 12, 3), dtype=np.uint8)).save(buf, "JPEG")
        depth = rng.integers(500, 3000, (8, 12)).astype(np.uint16)
        frames.append(RGBDFrame(np.eye(4, dtype=np.float32), i, i, buf.getvalue(),
                                zlib.compress(depth.tobytes())))
    write_sens(str(tmp_path / "scene.sens"), frames, color_size=(12, 8), depth_size=(12, 8))
    cfg = get_default_cfg()
    cfg.dataset.update(type="scannet", basedir=str(tmp_path / "scene.sens"))
    ds = t_datasets.build_dataset(cfg, t_datasets.DatasetType.TRAIN, CPU)
    assert isinstance(ds, ScanNetDataset) and len(ds) == 2 and ds.device == CPU
    assert ds.bundle.ray_targets.shape == (2, 8, 12, 3)
    cfg.dataset.type = "nope"
    with pytest.raises(ValueError, match="nope"):
        t_datasets.build_dataset(cfg, t_datasets.DatasetType.TRAIN, CPU)


@pytest.mark.parametrize("factor", [2, 4, 5])
@pytest.mark.parametrize("channels", [3, 4])
def test_box_mean_matches_cv2_inter_area(factor, channels):
    rng = np.random.default_rng(factor * channels)
    img = rng.uniform(0.0, 1.0, (40, 60, channels)).astype(np.float32)
    h, w = 40 // factor, 60 // factor
    want = cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)
    got = t_helpers.resize_image(img, (h, w))
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


FRACTIONAL = {  # (H, W) -> (h, w): cv2's scale 1 / (h / H) is not an integer
    "3.0075": ((400, 400), (133, 133)),
    "2.5": ((40, 60), (16, 24)),
    "8.006": ((1297, 969), (162, 121)),
    "3.077": ((40, 60), (13, 20)),
    "mixed": ((48, 72), (16, 20)),
    "to-1x1": ((7, 5), (1, 1)),
}


@pytest.mark.parametrize("case", list(FRACTIONAL))
@pytest.mark.parametrize("channels", [None, 1, 2, 3, 4])
@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_fractional_area_matches_cv2(case, channels, dtype, capsys):
    """cv2 INTER_AREA at a fractional scale: f32 within 1e-5, uint8 within 1
    LSB; the share of samples that differ at all is printed (cv2's own
    f32 weights and order of sums are reproduced, so it is 0 here)."""
    (H, W), (h, w) = FRACTIONAL[case]
    rng = np.random.default_rng(H * W + (channels or 0))
    shape = (H, W) if channels is None else (H, W, channels)
    if dtype == "float32":
        img = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    else:
        img = rng.integers(0, 256, shape, dtype=np.uint8)
    want = cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)
    got = t_helpers.resize_image(img, (h, w))
    assert got.dtype == img.dtype and got.shape == (h, w, *shape[2:])
    want = want.reshape(got.shape)  # cv2 drops a trailing channel of 1
    diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert diff.max() <= (1e-5 if dtype == "float32" else 1)
    with capsys.disabled():
        print(f"\nINTER_AREA {H}x{W}->{h}x{w} c={channels} {dtype}: max |diff| "
              f"{diff.max():.3g}, {100 * (diff > 0).mean():.4f}% of samples differ")


@pytest.mark.parametrize("src,dst", [((40, 60), (20, 20)), ((48, 72), (16, 24)),
                                     ((40, 60), (10, 30))])
def test_unequal_integer_factors_match_cv2(src, dst):
    """Integer factors that differ by axis: cv2's fast path, a box mean."""
    rng = np.random.default_rng(1)
    for img in (rng.uniform(0, 1, (*src, 3)).astype(np.float32),
                rng.integers(0, 256, (*src, 3), dtype=np.uint8)):
        want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_AREA)
        got = t_helpers.resize_image(img, dst)
        assert got.dtype == img.dtype
        np.testing.assert_allclose(got.astype(np.float64), want, rtol=0, atol=1e-6)


def test_upscaling_raises():
    with pytest.raises(NotImplementedError, match="only a downscale"):
        t_helpers.resize_image(np.zeros((4, 4, 3), np.float32), (8, 4))
    with pytest.raises(NotImplementedError, match="only a downscale"):
        t_helpers.resize_image(np.zeros((4, 4, 3), np.float32), (0, 2))


@pytest.mark.parametrize("white_background", [False, True])
def test_reduced_resolution_matches_jax_loader(white_background):
    cfg = _blender_cfg(reduced_resolution=2, white_background=white_background)
    want = j_load_blender(cfg, str(SCENE / "transforms_val.json"))
    got = t_load_blender(cfg, "val")
    assert got.ray_targets.shape == (2, 200, 200, 3)
    np.testing.assert_allclose(got.ray_targets, want.ray_targets, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.poses, want.poses)
    np.testing.assert_array_equal(got.hwf, want.hwf)
