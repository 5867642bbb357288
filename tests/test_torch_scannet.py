"""ScanNet in the port (nerfmeshes_tpu_torch/data/loaders/scannet.py,
data/scannet_dataset.py, the nearest resize and the 16-bit PNG writer) and
the dataset's camera intrinsics in both train steps, against the JAX
package, on the CPU.

Tolerances: bit for bit (assert_array_equal) for the .sens bytes, every
parsed field, decoded colour and depth, the exporters' files, the nearest
resize against cv2 and every ScanNetDataset bundle array; 1e-6 absolute
for rays (image_rays, and the train batch's origins and directions),
targets, near/far and depth of the train batch exactly.

- .sens streams fabricated as tests/test_data.py:268-298 does (JPEG
  colour, zlib depth) with an off-centre principal point: 4 frames at
  24x32, and a ScanNet-like 12-frame stream whose depth is 12x16 (resized
  to the colour size) and whose frame 5 has a -inf pose (dropped).
- The intrinsics repair: JAX's _sample_ray_batch under ScanNet's
  intrinsics (+z, image-down y, off-centre principal point, unnormalised)
  against the port's rays_from_indices on the same indices; NeRFSystem and
  BuFFSystem pass the dataset's intrinsics to their train steps (the
  sampled rays equal JAX's full-image rays at those pixels), and a dict of
  arrays passes its "intrinsics" entry.
- export_color_images writes JAX's files byte for byte (names, resize,
  frame_skip, the JPEG re-encode).
- JAX's composition test on the port: tiny.yml on the 4-frame stream, 30
  steps, the validation loss falls.
"""

import io
import zlib
from pathlib import Path

import cv2
import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfmeshes_tpu.config import get_default_cfg as j_default_cfg
from nerfmeshes_tpu.data.datasets import DatasetType as JDatasetType
from nerfmeshes_tpu.data.loaders import scannet as j_scannet
from nerfmeshes_tpu.data.scannet_dataset import ScanNetDataset as JScanNetDataset
from nerfmeshes_tpu.ops import rays as j_rays
from nerfmeshes_tpu.train import step as j_step
from nerfmeshes_tpu_torch.config import get_default_cfg, load_config
from nerfmeshes_tpu_torch.data import helpers as t_helpers
from nerfmeshes_tpu_torch.data.blender import write_png
from nerfmeshes_tpu_torch.data.datasets import DatasetType, build_dataset
from nerfmeshes_tpu_torch.data.loaders import scannet as t_scannet
from nerfmeshes_tpu_torch.data.scannet_dataset import ScanNetDataset
from nerfmeshes_tpu_torch.ops.rays import CameraIntrinsics
from nerfmeshes_tpu_torch.train import step as t_step

torch.set_num_threads(1)
CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parents[1]
H, W = 24, 32


def _intrinsic(fx=30.0, fy=28.0, cx=14.5, cy=10.25) -> np.ndarray:
    K = np.eye(4, dtype=np.float32)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = fx, fy, cx, cy
    return K


def _pose(i: int) -> np.ndarray:
    """OpenCV camera-to-world: a small turn about y, looking along +z."""
    a = 0.1 * i
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
    c2w[:3, 3] = [0.1 * i, -0.05 * i, -0.5]
    return c2w


def _frames(mod, n: int, depth_hw, seed: int = 0, lost=()):
    rng = np.random.default_rng(seed)
    frames = []
    for i in range(n):
        color = (rng.uniform(0, 1, (H, W, 3)) * 255).astype(np.uint8)
        buf = io.BytesIO()
        imageio.imwrite(buf, color, format="jpeg")
        depth = rng.uniform(500, 3000, depth_hw).astype(np.uint16)
        c2w = np.full((4, 4), -np.inf, np.float32) if i in lost else _pose(i)
        frames.append(mod.RGBDFrame(c2w, i, i, buf.getvalue(), zlib.compress(depth.tobytes())))
    return frames


STREAMS = {
    "small": dict(n=4, depth_hw=(H, W), lost=()),
    "scannet_like": dict(n=12, depth_hw=(12, 16), lost=(5,)),
}


def _write(mod, path: Path, n, depth_hw, lost) -> Path:
    K = _intrinsic()
    Kd = _intrinsic(15.0, 14.0, 7.25, 5.125) if depth_hw != (H, W) else K
    mod.write_sens(str(path), _frames(mod, n, depth_hw, lost=lost), intrinsic_color=K,
                   intrinsic_depth=Kd, color_size=(W, H), depth_size=depth_hw[::-1])
    return path


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    root = tmp_path_factory.mktemp("scannet")
    return {name: _write(j_scannet, root / f"{name}.sens", **kw) for name, kw in STREAMS.items()}


# -- the stream ------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(STREAMS))
def test_write_sens_matches_jax(name, tmp_path):
    got = _write(t_scannet, tmp_path / "port.sens", **STREAMS[name])
    want = _write(j_scannet, tmp_path / "jax.sens", **STREAMS[name])
    assert got.read_bytes() == want.read_bytes()


@pytest.mark.parametrize("name", list(STREAMS))
def test_sensor_data_matches_jax(streams, name):
    got = t_scannet.SensorData(str(streams[name]))
    want = j_scannet.SensorData(str(streams[name]))
    for key in ("sensor_name", "color_compression_type", "depth_compression_type",
                "color_width", "color_height", "depth_width", "depth_height", "depth_shift"):
        assert getattr(got, key) == getattr(want, key), key
    for key in ("intrinsic_color", "extrinsic_color", "intrinsic_depth", "extrinsic_depth"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key))
    assert len(got.frames) == len(want.frames) == STREAMS[name]["n"]
    for i, (g, w) in enumerate(zip(got.frames, want.frames)):
        np.testing.assert_array_equal(g.camera_to_world, w.camera_to_world)
        assert (g.timestamp_color, g.timestamp_depth) == (w.timestamp_color, w.timestamp_depth)
        color, want_color = got.color_image(i), want.color_image(i)
        assert color.dtype == want_color.dtype and color.shape == (H, W, 3)
        np.testing.assert_array_equal(color, want_color)
        depth, want_depth = got.depth_image(i), want.depth_image(i)
        assert depth.dtype == want_depth.dtype == np.float32
        np.testing.assert_array_equal(depth, want_depth)


def test_header_only_reads_no_frame(streams):
    sd = t_scannet.SensorData(str(streams["scannet_like"]), header_only=True)
    assert sd.frames == [] and (sd.depth_width, sd.depth_height) == (16, 12)
    np.testing.assert_array_equal(sd.intrinsic_color, _intrinsic())


@pytest.mark.parametrize("image_size,frame_skip", [(None, 1), ((24, 32), 1), ((29, 41), 2),
                                                   ((7, 9), 3)])
def test_depth_exporter_matches_jax(streams, tmp_path, image_size, frame_skip):
    kw = dict(image_size=image_size, frame_skip=frame_skip)
    t_scannet.SensorData(str(streams["scannet_like"])).export_depth_images(tmp_path / "port", **kw)
    j_scannet.SensorData(str(streams["scannet_like"])).export_depth_images(tmp_path / "jax", **kw)
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert len(names) == len(range(0, 12, frame_skip))
    for name in names:
        got, want = imageio.imread(tmp_path / "port" / name), imageio.imread(tmp_path / "jax" / name)
        assert got.dtype == want.dtype == np.uint16
        np.testing.assert_array_equal(got, want)


def test_pose_and_intrinsics_exporters_match_jax(streams, tmp_path):
    for mod, out in ((t_scannet, tmp_path / "port"), (j_scannet, tmp_path / "jax")):
        sd = mod.SensorData(str(streams["scannet_like"]))
        sd.export_poses(out / "pose", frame_skip=2)
        sd.export_intrinsics(out / "intrinsic")
    for sub in ("pose", "intrinsic"):
        names = sorted(p.name for p in (tmp_path / "port" / sub).iterdir())
        assert names == sorted(p.name for p in (tmp_path / "jax" / sub).iterdir()) and names
        for name in names:
            assert ((tmp_path / "port" / sub / name).read_bytes()
                    == (tmp_path / "jax" / sub / name).read_bytes())


@pytest.mark.parametrize("name", list(STREAMS))
@pytest.mark.parametrize("image_size,frame_skip", [(None, 1), ((24, 32), 1), ((29, 41), 3)])
def test_export_color_images_matches_jax(streams, tmp_path, name, image_size, frame_skip):
    """JAX's file names, and each JPEG byte for byte as JAX's imageio
    writes it (PIL's default save: quality 75, 4:2:0, JFIF 1.01)."""
    for mod, out in ((t_scannet, tmp_path / "port"), (j_scannet, tmp_path / "jax")):
        mod.SensorData(str(streams[name])).export_color_images(str(out), image_size=image_size,
                                                               frame_skip=frame_skip)
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    n = STREAMS[name]["n"]
    assert names == sorted(f"{f}.jpg" for f in range(0, n, frame_skip))
    for fname in names:
        assert (tmp_path / "port" / fname).read_bytes() == (tmp_path / "jax" / fname).read_bytes()


def test_cli_writes_what_jax_writes(streams, tmp_path):
    flags = ["--export_depth_images", "--export_color_images", "--export_poses",
             "--export_intrinsics"]
    for mod, out in ((t_scannet, tmp_path / "port"), (j_scannet, tmp_path / "jax")):
        mod.main(["--filename", str(streams["small"]), "--output_path", str(out), *flags])
    files = sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*.*"))
    assert files == sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.*"))
    assert len(files) == 4 + 4 + 4 + 4
    for rel in files:
        got, want = tmp_path / "port" / rel, tmp_path / "jax" / rel
        if rel.suffix == ".png":
            np.testing.assert_array_equal(imageio.imread(got), imageio.imread(want))
        else:
            assert got.read_bytes() == want.read_bytes()


# -- the helpers -------------------------------------------------------------------------

@pytest.mark.parametrize("src,dst", [((480, 640), (968, 1296)), ((968, 1296), (480, 640)),
                                     ((12, 16), (24, 32)), ((7, 5), (13, 11)),
                                     ((100, 100), (33, 77)), ((5, 9), (17, 3)),
                                     ((3, 3), (10, 10)), ((10, 10), (3, 3))])
@pytest.mark.parametrize("dtype", [np.uint16, np.float32])
def test_resize_nearest_matches_cv2(src, dst, dtype):
    img = np.random.default_rng(0).uniform(0, 60000, src).astype(dtype)
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_NEAREST)
    got = t_helpers.resize_nearest(img, dst)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_resize_nearest_matches_cv2_on_random_sizes():
    """Includes sizes where W / w and 1 / (w / W) differ in the last bit."""
    rng = np.random.default_rng(1)
    for _ in range(200):
        sh, sw, dh, dw = (int(v) for v in rng.integers(1, 200, 4))
        img = rng.integers(0, 256, (sh, sw, 3), dtype=np.uint8)
        want = cv2.resize(img, (dw, dh), interpolation=cv2.INTER_NEAREST)
        np.testing.assert_array_equal(t_helpers.resize_nearest(img, (dh, dw)), want)


def test_write_png_16_bit_grey_reads_back_with_imageio(tmp_path):
    img = np.random.default_rng(2).integers(0, 65536, (13, 21)).astype(np.uint16)
    write_png(tmp_path / "d.png", img)
    back = imageio.imread(tmp_path / "d.png")
    assert back.dtype == np.uint16
    np.testing.assert_array_equal(back, img)
    with pytest.raises(ValueError, match="uint16"):
        write_png(tmp_path / "e.png", np.dstack([img] * 3))


def test_png_colour_frames_decode_as_jax_decodes_them():
    """A stream may store its colour as PNG (compression type 1)."""
    buf = io.BytesIO()
    imageio.imwrite(buf, np.random.default_rng(4).integers(0, 256, (H, W, 3), dtype=np.uint8),
                    format="png")
    frames = [mod.RGBDFrame(np.eye(4, dtype=np.float32), 0, 0, buf.getvalue(), b"")
              for mod in (t_scannet, j_scannet)]
    got, want = (f.decompress_color("png") for f in frames)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="raw"):
        frames[0].decompress_color("raw")


# -- the dataset -------------------------------------------------------------------------

def _cfgs(path, **dataset):
    cfgs = []
    for cfg in (j_default_cfg(), get_default_cfg()):
        cfg.dataset.update(type="scannet", basedir=str(path), near=0.1, far=4.0, **dataset)
        cfgs.append(cfg)
    return cfgs


SPLITS = [(DatasetType.TRAIN, JDatasetType.TRAIN), (DatasetType.VALIDATION,
                                                    JDatasetType.VALIDATION),
          (DatasetType.TEST, JDatasetType.TEST)]


def _assert_same_dataset(got, want):
    assert len(got) == len(want)
    for key in ("ray_targets", "target_depth", "poses", "hwf", "ray_bounds"):
        g, w = getattr(got.bundle, key), np.asarray(getattr(want.bundle, key))
        assert g.dtype == w.dtype and g.shape == w.shape, key
        np.testing.assert_array_equal(g, w, err_msg=key)
    assert tuple(got.intrinsics()) == tuple(want.intrinsics())
    for idx in range(len(got)):
        for g, w in zip(got.image_rays(idx), want.image_rays(idx)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", list(STREAMS))
@pytest.mark.parametrize("split", range(3))
def test_scannet_dataset_matches_jax(streams, name, split):
    j_cfg, t_cfg = _cfgs(streams[name])
    t_type, j_type = SPLITS[split]
    got = ScanNetDataset(t_cfg, t_type, device=CPU)
    _assert_same_dataset(got, JScanNetDataset(j_cfg, j_type))
    arrays = got.device_arrays()
    assert arrays["target_depth"].shape == (len(got), H, W)
    if name == "scannet_like":
        # Frame 5's pose is -inf: dropped. Val strides 8 from 1, test from 2.
        assert len(got) == (11, 2, 2)[split]
    intr = got.intrinsics()
    assert (intr.z_sign, intr.flip_y, intr.normalize) == (1.0, False, False)
    assert (intr.cx, intr.cy) == (14.5, 10.25)


def test_scannet_frame_skip_matches_jax(streams):
    j_cfg, t_cfg = _cfgs(streams["scannet_like"])
    got = ScanNetDataset(t_cfg, DatasetType.TRAIN, frame_skip=3, device=CPU)
    _assert_same_dataset(got, JScanNetDataset(j_cfg, JDatasetType.TRAIN, frame_skip=3))
    assert len(got) == 4


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_scannet_split_cache_read_across_stacks(streams, tmp_path, writer):
    caching = dict(use_caching=True, cache_dir=str(tmp_path / "cache"), override_caching=False)
    j_cfg, t_cfg = _cfgs(streams["scannet_like"])
    for cfg in (j_cfg, t_cfg):
        cfg.dataset.caching.update(caching)
    if writer == "port":
        fresh = ScanNetDataset(t_cfg, DatasetType.VALIDATION, device=CPU)
        cached = JScanNetDataset(j_cfg, JDatasetType.VALIDATION)
        _assert_same_dataset(fresh, cached)
    else:
        fresh = JScanNetDataset(j_cfg, JDatasetType.VALIDATION)
        cached = ScanNetDataset(t_cfg, DatasetType.VALIDATION, device=CPU)
        # A cache hit decodes no frame: intrinsics() reads the header alone.
        assert not hasattr(cached, "_intrinsic")
        _assert_same_dataset(cached, fresh)
    assert (tmp_path / "cache" / "val.npz").exists()


# -- the intrinsics in the train steps -----------------------------------------------------

SCANNET_INTR = (30.0, 28.0, 14.5, 10.25, 1.0, False, False)


@pytest.mark.parametrize("sample_all,per_image_bounds", [(False, False), (True, True)])
def test_ray_batch_under_dataset_intrinsics_matches_jax(sample_all, per_image_bounds):
    rng = np.random.default_rng(0)
    N, R = 3, 64
    data = {
        "targets": rng.uniform(0, 1, (N, H, W, 3)).astype(np.float32),
        "poses": np.stack([_pose(i) for i in range(N)]),
        "bounds": (rng.uniform(0.1, 4, (N, 2)).astype(np.float32) if per_image_bounds
                   else np.array([0.1, 4.0], np.float32)),
        "target_depth": rng.uniform(0, 6, (N, H, W)).astype(np.float32),
    }
    key = jax.random.key(3)
    want = j_step._sample_ray_batch(
        {k: jnp.asarray(v) for k, v in data.items()}, key, H=H, W=W, focal=30.0, num_rays=R,
        use_ndc=False, intrinsics=j_rays.CameraIntrinsics(*SCANNET_INTR),
        sample_all_images=sample_all)
    k_img, k_pix = jax.random.split(key)
    img = jax.random.randint(k_img, (R,) if sample_all else (), 0, N)
    pix = jax.random.randint(k_pix, (R,), 0, H * W)
    got = t_step.rays_from_indices(
        {k: torch.from_numpy(v) for k, v in data.items()},
        torch.from_numpy(np.asarray(img, np.int64)), torch.from_numpy(np.asarray(pix, np.int64)),
        H=H, W=W, focal=30.0, use_ndc=False, intrinsics=CameraIntrinsics(*SCANNET_INTR))
    for name, g, w in zip(("origins", "directions", "targets", "near", "far", "depth"), got,
                          want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=name)
    # Unnormalised: the camera-space z of every direction is 1.
    pose = data["poses"][np.asarray(img)]
    cam_z = np.einsum("...ji,...j->...i", pose[..., :3, :3], got[1].numpy())[..., 2]
    np.testing.assert_allclose(cam_z, 1.0, rtol=0, atol=1e-5)


def _tiny_cfg(path, model="NeRFModel"):
    cfg = load_config(str(REPO / "configs" / "tiny.yml"))
    cfg.dataset.update(type="scannet", basedir=str(path), near=0.1, far=4.0)
    cfg.experiment.update(randomseed=1, steps_per_call=1, model=model)
    cfg.nerf.train.num_random_rays = 32
    if model == "BuFFModel":
        cfg.tree.update(step_size_integration_offset=10_000, step_size_tree=10_000)
    return cfg


def _capture_batches(monkeypatch) -> list:
    seen = []
    inner = t_step.rays_from_indices

    def spy(data, img, pix, **kw):
        out = inner(data, img, pix, **kw)
        seen.append((img, pix, kw.get("intrinsics"), out))
        return out

    monkeypatch.setattr(t_step, "rays_from_indices", spy)
    return seen


@pytest.mark.parametrize("model", ["NeRFModel", "BuFFModel"])
def test_systems_train_on_the_dataset_intrinsics(streams, monkeypatch, model):
    from nerfmeshes_tpu_torch.train.factory import build_system

    cfg = _tiny_cfg(streams["small"], model)
    train = ScanNetDataset(cfg, DatasetType.TRAIN, device=CPU)
    seen = _capture_batches(monkeypatch)
    system = build_system(cfg, device=CPU).setup(train, ScanNetDataset(
        cfg, DatasetType.VALIDATION, device=CPU))
    system.fit(2)
    assert len(seen) == 2
    for img, pix, intr, (origins, directions, *_) in seen:
        assert intr == train.intrinsics()
        # JAX's full-image rays of that pose under the same intrinsics.
        pose = jnp.asarray(train.bundle.poses[int(img)])
        o, d = j_rays.get_ray_bundle_intrinsics(H, W, j_rays.CameraIntrinsics(*SCANNET_INTR),
                                                pose)
        want = np.asarray(d).reshape(-1, 3)[pix.numpy()]
        np.testing.assert_allclose(directions.numpy(), want, rtol=0, atol=1e-6)
        np.testing.assert_allclose(origins.numpy(), np.broadcast_to(np.asarray(o), want.shape),
                                   rtol=0, atol=1e-6)


def test_dict_setup_takes_its_intrinsics_entry(streams, monkeypatch):
    from nerfmeshes_tpu_torch.train.system import NeRFSystem

    cfg = _tiny_cfg(streams["small"])
    train = ScanNetDataset(cfg, DatasetType.TRAIN, device=CPU)
    val = ScanNetDataset(cfg, DatasetType.VALIDATION, device=CPU)
    seen = _capture_batches(monkeypatch)
    NeRFSystem(cfg, device=CPU).setup(train.device_arrays(), val).fit(1)
    arrays = dict(train.device_arrays(), intrinsics=train.intrinsics())
    NeRFSystem(cfg, device=CPU).setup(arrays, val).fit(1)
    assert [s[2] for s in seen] == [None, train.intrinsics()]


def test_scannet_train_composition(streams, tmp_path):
    """tests/test_data.py:338-365 on the port: tiny.yml on the 4-frame
    stream, 30 steps through fit (seed 1: tiny.yml's 42 draws a dead start
    in the port, ROADMAP.md section 3); the depth targets ride along to
    the train arrays and the validation loss falls."""
    from nerfmeshes_tpu_torch.config.paths import ExperimentPaths
    from nerfmeshes_tpu_torch.train.system import NeRFSystem

    cfg = load_config(str(REPO / "configs" / "tiny.yml"))
    cfg.dataset.update(type="scannet", basedir=str(streams["small"]), near=0.1, far=4.0)
    cfg.experiment.update(train_iters=30, validate_every=30, steps_per_call=5, randomseed=1)
    train = build_dataset(cfg, DatasetType.TRAIN, CPU)
    assert isinstance(train, ScanNetDataset) and "target_depth" in train.device_arrays()
    paths = ExperimentPaths(tmp_path / "run").create()
    system = NeRFSystem(cfg, paths, device=CPU)
    system.setup(train, build_dataset(cfg, DatasetType.VALIDATION, CPU))
    before = system.validate(log_images=False)["validation/loss"]
    system.fit()
    after = system.validate(log_images=False)["validation/loss"]
    assert system.state.step == 30
    assert np.isfinite(after) and after < before
