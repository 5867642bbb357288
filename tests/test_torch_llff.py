"""Forward-facing captures in the port (nerfmeshes_tpu_torch/data/loaders/
llff.py, data/colmap_dataset.py, the split cache, the NDC chain) against
the JAX package, on the CPU.

- load_llff_data on a fabricated LLFF scene (seeded PNGs and
  poses_bounds.npy) at factor 1 and 2, spherify on and off, and on the
  tracked data/hard_llff: images, poses, bounds and render poses equal
  JAX's bit for bit (the same numpy algebra; images uint8 / 255.0 in
  float64, cast to f32), i_test equal. Each stack minifies its own copy.
- minify's PNGs within 1 LSB of JAX's cv2 INTER_AREA ones, at factors that
  divide the photo's size and at one (3) that does not.
- JPEG originals (the scene's images re-encoded by PIL, 4:2:0):
  load_llff_data at factor 1 and minify's PNGs at factor 2 equal JAX's bit
  for bit (the port's decoder equals imageio's; the box mean at factor 2
  rounds as cv2 does).
- ColmapDataset: splits, hwf, bounds and device_arrays equal JAX's; one
  held-out view's NDC rays within 1e-6 of JAX's image_rays; synthesis()
  poses within 1e-6; a split cache written by either stack is read by the
  other, and the datasets built from it equal the uncached ones.
- The slice: a 2 x 4x32 hierarchical NDC model carried over from JAX
  (perturb off, sigma noise 0) renders a held-out view within atol 1e-4
  of JAX's render; 30 NDC train steps through setup + fit give a finite,
  falling loss.
- The shipped colmap configs (hard-llff, both fern ones) load and build
  their datasets on a fabricated scene.
"""

import shutil
from pathlib import Path

import cv2
import imageio.v2 as imageio
import jax
import numpy as np
import pytest
import torch

from nerfmeshes_tpu.config import get_default_cfg as j_default_cfg
from nerfmeshes_tpu.config import load_config as j_load_config
from nerfmeshes_tpu.data import colmap_dataset as j_colmap
from nerfmeshes_tpu.data.datasets import DatasetType as JDatasetType
from nerfmeshes_tpu.data.loaders import llff as j_llff
from nerfmeshes_tpu.train.system import NeRFSystem as JNeRFSystem
from nerfmeshes_tpu_torch.config import get_default_cfg, load_config
from nerfmeshes_tpu_torch.data import colmap_dataset as t_colmap
from nerfmeshes_tpu_torch.data import datasets as t_datasets
from nerfmeshes_tpu_torch.data.datasets import DatasetType
from nerfmeshes_tpu_torch.data.loaders import llff as t_llff
from nerfmeshes_tpu_torch.models.transplant import state_dict_from_flax
from nerfmeshes_tpu_torch.train.system import NeRFSystem

torch.set_num_threads(1)
CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parents[1]
SMALL = dict(num_layers=4, hidden_size=32, skip_step=2, num_encoding_fn_xyz=4,
             num_encoding_fn_dir=2)


def make_llff_scene(root: Path, n: int = 6, H: int = 32, W: int = 40, f: float = 35.0,
                    seed: int = 0) -> Path:
    """An LLFF scene: n seeded RGB PNGs in images/ (a colour ramp under
    noise) and poses_bounds.npy with cameras on a ring facing the origin,
    columns [down, right, back]."""
    (root / "images").mkdir(parents=True)
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W), indexing="ij")
    ramp = np.stack([0.8 - 0.3 * xx, 0.2 + 0.5 * yy, 0.1 + 0.2 * xx * yy], -1)
    rows = []
    for i in range(n):
        noisy = ramp + rng.uniform(-0.1, 0.1, (H, W, 3))
        img = (np.clip(noisy, 0, 1) * 255).astype(np.uint8)
        imageio.imwrite(root / "images" / f"im_{i:03d}.png", img)
        th = 2 * np.pi * i / n
        pos = np.array([0.5 * np.cos(th), 0.5 * np.sin(th), 4.0])
        back = pos / np.linalg.norm(pos)
        right = np.cross([0, 1, 0], back)
        right /= np.linalg.norm(right)
        down = np.cross(back, right)
        m = np.stack([down, right, back, pos], 1)
        hwf = np.array([[H], [W], [f]])
        rows.append(np.concatenate([np.concatenate([m, hwf], 1).ravel(),
                                    [2.0 + 0.1 * i, 6.0 + 0.2 * i]]))
    np.save(root / "poses_bounds.npy", np.stack(rows))
    return root


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_llff_scene(tmp_path_factory.mktemp("llff") / "scene")


def _copy(scene: Path, tmp_path: Path, name: str) -> Path:
    """A copy of the scene's images/ and poses_bounds.npy only (no minify
    cache), so each stack builds its own."""
    dst = tmp_path / name
    shutil.copytree(scene / "images", dst / "images")
    shutil.copy(scene / "poses_bounds.npy", dst)
    return dst


def _assert_same_load(got, want):
    for g, w in zip(got[:4], want[:4]):
        assert g.dtype == w.dtype and g.shape == w.shape  # bds f64 after spherify
        np.testing.assert_array_equal(g, w)
    assert got[4] == want[4]


@pytest.mark.parametrize("factor", [1, 2])
@pytest.mark.parametrize("spherify", [False, True])
def test_load_llff_data_matches_jax(scene, tmp_path, factor, spherify):
    kw = dict(factor=factor, spherify=spherify)
    got = t_llff.load_llff_data(str(_copy(scene, tmp_path, "port")), **kw)
    want = j_llff.load_llff_data(str(_copy(scene, tmp_path, "jax")), **kw)
    _assert_same_load(got, want)
    assert got[0].shape == (6, 32 // factor, 40 // factor, 3)
    assert got[3].shape == (120, 3, 5)
    assert (tmp_path / "port" / "images_2").exists() == (factor == 2)


def test_load_llff_data_on_hard_llff_matches_jax():
    kw = dict(factor=1, spherify=False)  # configs/hard-llff.yml's settings
    got = t_llff.load_llff_data(str(REPO / "data" / "hard_llff"), **kw)
    want = j_llff.load_llff_data(str(REPO / "data" / "hard_llff"), **kw)
    _assert_same_load(got, want)
    assert got[0].shape == (24, 400, 400, 3)


@pytest.mark.parametrize("factor", [2, 3, 4])  # 3 divides neither side: a fractional scale
def test_minify_within_one_lsb_of_cv2(scene, tmp_path, factor):
    got_dir = t_llff.minify(str(_copy(scene, tmp_path, "port")), factor)
    want_dir = j_llff.minify(str(_copy(scene, tmp_path, "jax")), factor)
    names = sorted(p.name for p in got_dir.iterdir())
    assert names == sorted(p.name for p in want_dir.iterdir()) and len(names) == 6
    for name in names:
        got = imageio.imread(got_dir / name)
        want = imageio.imread(want_dir / name)
        assert got.shape == want.shape == (32 // factor, 40 // factor, 3)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    # A second call finds the cache and leaves it as it is.
    stamp = (got_dir / names[0]).stat().st_mtime_ns
    assert t_llff.minify(str(tmp_path / "port"), factor) == got_dir
    assert (got_dir / names[0]).stat().st_mtime_ns == stamp


def test_uint8_box_mean_rounds_as_cv2():
    from nerfmeshes_tpu_torch.data.helpers import resize_image

    rng = np.random.default_rng(3)
    for factor in (2, 3, 4, 8):
        for channels in (3, 4):
            img = rng.integers(0, 256, (48, 72, channels), dtype=np.uint8)
            hw = (48 // factor, 72 // factor)
            want = cv2.resize(img, hw[::-1], interpolation=cv2.INTER_AREA)
            got = resize_image(img, hw)
            assert got.dtype == np.uint8
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def _jpeg_copy(scene: Path, tmp_path: Path, name: str) -> Path:
    """_copy with every image re-encoded as a baseline 4:2:0 JPEG (.JPG)."""
    from PIL import Image

    dst = _copy(scene, tmp_path, name)
    for png in sorted((dst / "images").iterdir()):
        Image.open(png).convert("RGB").save(png.with_suffix(".JPG"), quality=90,
                                            subsampling=2)
        png.unlink()
    return dst


def test_jpeg_input_raises(scene, tmp_path):
    """Named when a JPEG raised; now JPEG originals load as JAX loads them."""
    got = t_llff.load_llff_data(str(_jpeg_copy(scene, tmp_path, "port")), factor=1)
    want = j_llff.load_llff_data(str(_jpeg_copy(scene, tmp_path, "jax")), factor=1)
    _assert_same_load(got, want)
    got_dir = t_llff.minify(str(tmp_path / "port"), 2)
    want_dir = j_llff.minify(str(tmp_path / "jax"), 2)
    names = sorted(p.name for p in got_dir.iterdir())
    assert names == sorted(p.name for p in want_dir.iterdir()) == [
        f"im_{i:03d}.png" for i in range(6)]
    for name in names:
        np.testing.assert_array_equal(imageio.imread(got_dir / name),
                                      imageio.imread(want_dir / name))


def _colmap_cfgs(basedir, hold=3, use_ndc=True, spherify=False, factor=2, **dataset):
    """The same colmap dataset settings in the JAX and the port config."""
    cfgs = []
    for cfg in (j_default_cfg(), get_default_cfg()):
        cfg.dataset.update(type="colmap", basedir=str(basedir), use_ndc=use_ndc,
                           spherify=spherify, llff_downsample_factor=factor,
                           llff_hold_step=hold, near=0.0, far=1.0, **dataset)
        cfgs.append(cfg)
    return cfgs


@pytest.fixture(scope="module")
def shared_scene(scene, tmp_path_factory):
    """A copy whose images_2 cache JAX writes first: both datasets then read
    the same pixels, so the dataset tests see no rounding of either minify."""
    root = _copy(scene, tmp_path_factory.mktemp("shared"), "scene")
    j_llff.minify(str(root), 2)
    return root


@pytest.mark.parametrize("split", ["train", "val", "test"])
@pytest.mark.parametrize("hold, spherify", [(3, False), (3, True), (0, False)])
def test_colmap_dataset_matches_jax(shared_scene, split, hold, spherify):
    j_cfg, t_cfg = _colmap_cfgs(shared_scene, hold=hold, spherify=spherify)
    want = j_colmap.ColmapDataset(j_cfg, JDatasetType(split))
    got = t_colmap.ColmapDataset(t_cfg, DatasetType(split), device=CPU)
    # Hold step 3 holds out views 0 and 3 of 6; 0 holds out i_test alone.
    held = 2 if hold else 1
    assert len(got) == len(want) == (6 - held if split == "train" else held)
    for key in ("ray_targets", "ray_bounds", "poses", "hwf"):
        g, w = getattr(got.bundle, key), np.asarray(getattr(want.bundle, key))
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    j_arrays, t_arrays = want.device_arrays(), got.device_arrays()
    assert set(t_arrays) == set(j_arrays)
    for key in ("targets", "poses", "bounds"):
        np.testing.assert_array_equal(t_arrays[key].numpy(), np.asarray(j_arrays[key]))
    assert t_arrays["hwf"] == tuple(float(v) for v in j_arrays["hwf"])
    idx = len(got) - 1
    for g, w in zip(got.image_rays(idx), want.image_rays(idx)):
        assert g.shape == w.shape == (16 * 20, 3)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got._bounds_for(idx), want._bounds_for(idx))
    got.synthesis()
    want.synthesis()
    assert got.synthetic_poses.shape == (120, 4, 4)
    np.testing.assert_allclose(got.synthetic_poses, want.synthetic_poses, rtol=0, atol=1e-6)
    for g, w in zip(got.image_rays(119), want.image_rays(119)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_split_cache_is_shared_with_jax(shared_scene, tmp_path, writer):
    cache = tmp_path / "cache"
    j_cfg, t_cfg = _colmap_cfgs(shared_scene)
    for cfg in (j_cfg, t_cfg):
        cfg.dataset.caching.update(use_caching=True, cache_dir=str(cache))
    uncached = t_colmap.ColmapDataset(_colmap_cfgs(shared_scene)[1], DatasetType.VALIDATION,
                                      device=CPU)
    if writer == "jax":
        j_colmap.ColmapDataset(j_cfg, JDatasetType.VALIDATION)
    else:
        t_colmap.ColmapDataset(t_cfg, DatasetType.VALIDATION, device=CPU)
    assert sorted(p.name for p in cache.iterdir()) == ["val.npz"]
    with np.load(cache / "val.npz") as data:
        assert set(data.files) == {"ray_targets", "ray_bounds", "poses", "hwf"}
    # The scene is gone: the reader can only take the cache.
    moved = tmp_path / "moved"
    shutil.copytree(shared_scene, moved)
    for cfg in (j_cfg, t_cfg):
        cfg.dataset.basedir = str(tmp_path / "nowhere")
    readers = [t_colmap.ColmapDataset(t_cfg, DatasetType.VALIDATION, device=CPU).bundle,
               j_colmap.ColmapDataset(j_cfg, JDatasetType.VALIDATION).bundle]
    for bundle in readers:
        for key in ("ray_targets", "ray_bounds", "poses", "hwf"):
            np.testing.assert_array_equal(np.asarray(getattr(bundle, key)),
                                          getattr(uncached.bundle, key))
    # override_caching reloads from the scene and rewrites the cache.
    t_cfg.dataset.basedir = str(moved)
    t_cfg.dataset.caching.override_caching = True
    stamp = (cache / "val.npz").stat().st_mtime_ns
    t_colmap.ColmapDataset(t_cfg, DatasetType.VALIDATION, device=CPU)
    assert (cache / "val.npz").stat().st_mtime_ns != stamp


def test_blender_split_cache_round_trips(tmp_path):
    cfg = get_default_cfg()
    cfg.dataset.update(basedir=str(REPO / "data" / "hard_blender"))
    cfg.dataset.caching.update(use_caching=True, cache_dir=str(tmp_path))
    first = t_datasets.BlenderDataset(cfg, DatasetType.VALIDATION, device=CPU)
    with np.load(tmp_path / "val.npz") as data:
        assert set(data.files) == {"ray_targets", "poses", "hwf"}  # as JAX writes it
    again = t_datasets.BlenderDataset(cfg, DatasetType.VALIDATION, device=CPU)
    for key in ("ray_targets", "poses", "hwf", "ray_bounds"):
        np.testing.assert_array_equal(getattr(again.bundle, key), getattr(first.bundle, key))


def test_build_dataset_dispatches_colmap(shared_scene):
    _, cfg = _colmap_cfgs(shared_scene)
    ds = t_datasets.build_dataset(cfg, DatasetType.TRAIN, CPU)
    assert type(ds) is t_colmap.ColmapDataset and len(ds) == 4


def _slice_cfgs(basedir):
    """The JAX and port configs of the CPU slice: 2 x 4x32 FlexibleNeRF,
    f32, NDC, 16 + 16 samples, perturb off and no sigma noise in
    validation."""
    cfgs = _colmap_cfgs(basedir)
    for cfg in cfgs:
        for node in (cfg.models.coarse, cfg.models.fine):
            node.update(SMALL)
        cfg.experiment.update(compute_dtype="float32", use_fused_kernel=False, randomseed=3,
                              steps_per_call=5, validate_every=0, print_every=1000)
        cfg.nerf.train.update(num_random_rays=128, num_coarse=16, num_fine=16)
        cfg.nerf.validation.update(num_coarse=16, num_fine=16, chunksize=128, num_samples=-1,
                                   perturb=False, radiance_field_noise_std=0.0)
        cfg.optimizer.lr = 5e-3
    return cfgs


def test_ndc_render_of_a_held_out_view_matches_jax(shared_scene):
    j_cfg, t_cfg = _slice_cfgs(shared_scene)
    j_val = j_colmap.ColmapDataset(j_cfg, JDatasetType.VALIDATION)
    j_sys = JNeRFSystem(j_cfg).setup(j_colmap.ColmapDataset(j_cfg, JDatasetType.TRAIN), j_val)
    t_val = t_colmap.ColmapDataset(t_cfg, DatasetType.VALIDATION, device=CPU)
    t_sys = NeRFSystem(t_cfg, device=CPU).setup_eval(t_val)
    for model, name in ((t_sys.coarse, "coarse"), (t_sys.fine, "fine")):
        params = jax.tree_util.tree_map(np.asarray, j_sys.state.params[name])
        model.load_state_dict(state_dict_from_flax(params, dict(t_cfg.models[name])))
    near, far = t_val._bounds_for(1)
    assert (near, far) == (0.0, 1.0)
    want = j_sys.query_rays(*j_val.image_rays(1), near, far, fields=("rgb_map", "depth_map"))
    got = t_sys.query_rays(*t_val.image_rays(1), near, far, fields=("rgb_map", "depth_map"))
    assert got.rgb_map.shape == (16 * 20, 3)
    np.testing.assert_allclose(got.rgb_map, want.rgb_map, rtol=0, atol=1e-4)
    both = (got.depth_map > 0) & (np.asarray(want.depth_map) > 0)
    np.testing.assert_allclose(got.depth_map[both], np.asarray(want.depth_map)[both], rtol=0,
                               atol=1e-4)
    j_metrics = j_sys.validate(step=0, log_images=False)
    t_metrics = t_sys.validate(step=0, log_images=False)
    for key, value in j_metrics.items():
        assert t_metrics[key] == pytest.approx(value, rel=1e-4), key


def test_ndc_training_loss_falls(shared_scene):
    _, cfg = _slice_cfgs(shared_scene)
    system = NeRFSystem(cfg, device=CPU).setup()
    assert isinstance(system.train_dataset, t_colmap.ColmapDataset)
    assert system._data["bounds"].tolist() == [0.0, 1.0]
    before = system.validate(log_images=False)["validation/loss"]
    metrics = system.fit(30)
    after = system.validate(log_images=False)["validation/loss"]
    assert system.state.step == 30
    assert np.isfinite(metrics["train/loss"]) and np.isfinite(after) and after < before


@pytest.mark.parametrize("name", ["hard-llff.yml", "nerf-colmap-fern.yml",
                                  "buff-colmap-fern.yml"])
def test_shipped_colmap_configs_build_their_datasets(tmp_path, name):
    scene = make_llff_scene(tmp_path / "scene", n=9, H=64, W=80)
    factor = {"hard-llff.yml": 1}.get(name, 8)
    overrides = ["dataset.basedir", str(scene)]
    got_cfg = load_config(str(REPO / "configs" / name), overrides)
    want_cfg = j_load_config(str(REPO / "configs" / name), overrides)
    assert got_cfg.dataset.type == "colmap"
    assert got_cfg.dataset.llff_downsample_factor == factor
    if factor > 1:  # one minify for both stacks
        j_llff.minify(str(scene), factor)
    for split in ("train", "val"):
        got = t_datasets.build_dataset(got_cfg, DatasetType(split), CPU)
        want = j_colmap.ColmapDataset(want_cfg, JDatasetType(split))
        assert type(got) is t_colmap.ColmapDataset
        assert len(got) == len(want) == {"train": 7, "val": 2}[split]
        np.testing.assert_array_equal(got.bundle.hwf, np.asarray(want.bundle.hwf))
        np.testing.assert_array_equal(got.bundle.poses, np.asarray(want.bundle.poses))
        np.testing.assert_array_equal(got.device_arrays()["bounds"].numpy(),
                                      np.asarray(want.device_arrays()["bounds"]))
