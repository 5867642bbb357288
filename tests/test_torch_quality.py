"""scripts/torch_quality_parity.py on the CPU.

- The blobs protocol's train batches and eval set are those of
  scripts/r5_blobs_attribution.py:make_data (the JAX package's), to 1e-6,
  for seeds 42, 0 and 1 over the first steps: the scene is rendered in
  each stack (f32 sums in other orders), the draws are the same numpy
  streams.
- A cut run of each protocol (--device cpu, 20 steps) writes its keyed
  entries, and a second call skips them: kernel width and blobs in one
  call, forward-facing (views at 1/16 of a copy of data/hard_llff, one
  test view evaluated) and quality_800 (16^2 views, a 32^3 mesh) in
  another.
- The forward-facing protocol's train and test views (targets, per-image
  bounds, poses, hwf) equal JAX's ColmapDataset on data/hard_llff under
  configs/hard-llff.yml, views 0, 8 and 16 held out; NDC sets the train
  step's bounds to [0, 1] in both.
- quality_800's Newton projection of its numpy draw onto the hard scene's
  surface (torch autograd) equals the JAX package's (jax.grad through
  nerfmeshes_tpu/data/synthetic.py:hard_sdf, the body of
  scripts/quality_800.py:project) to 1e-5, and keeps the same points.
- A read between two fit calls leaves the train stream alone: the
  generator, the parameters and the losses equal those of a run without
  the read.
- The script imports nothing of nerfmeshes_tpu or jax (an ast scan), and
  without a card it runs only when told --device cpu.
"""

import ast
import functools
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
SCRIPT = REPO / "scripts" / "torch_quality_parity.py"

torch.set_num_threads(1)


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def quality():
    return _load("torch_quality_parity", SCRIPT)


@pytest.fixture
def cached_scenes(monkeypatch):
    """Each stack renders a scene once for the module: only the draws
    depend on the seed."""
    import nerfmeshes_tpu.data.synthetic as j_synthetic
    import nerfmeshes_tpu_torch.data.synthetic as t_synthetic

    for module in (j_synthetic, t_synthetic):
        monkeypatch.setattr(module, "make_synthetic_dataset", _CACHED.setdefault(
            module.__name__, functools.lru_cache(maxsize=None)(module.make_synthetic_dataset)))


_CACHED = {}


@pytest.mark.parametrize("seed", [42, 0, 1])
def test_blobs_batches_are_r5_make_data(quality, cached_scenes, seed):
    r5 = _load("r5_blobs_attribution", REPO / "scripts" / "r5_blobs_attribution.py")
    got, want = quality.make_data(seed, 4), r5.make_data(seed, 4)
    for name, g, w in zip(("origins", "directions", "targets", "eval origins",
                           "eval directions", "eval targets"), got[0] + got[1], want[0] + want[1]):
        assert g.shape == w.shape and g.dtype == np.float32, name
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=name)


def test_cut_runs_write_their_keys_and_a_second_call_skips_them(quality, cached_scenes,
                                                                  tmp_path, capsys):
    out = tmp_path / "q.json"
    argv = ["--device", "cpu", "--protocol", "kernel_width", "--protocol", "blobs", "--seeds",
            "42", "--steps", "20", "--image-size", "8", "--rays", "16", "--out", str(out)]
    assert quality.main(argv) == 0
    data = json.loads(out.read_text())
    assert set(data) == {"kernel_width_hier_on_42", "kernel_width_hier_off_42",
                         "blobs_hier_module_42", "blobs_buff_module_42"}
    for key in ("kernel_width_hier_on_42", "kernel_width_hier_off_42"):
        entry = data[key]
        assert entry["steps"] == 20 and set(entry["reads"]) == {"0", "20"}
        for read in entry["reads"].values():
            assert np.isfinite(read["validation"]["validation/fine_psnr"])
            assert np.isfinite(read["train_views"]["validation/coarse_psnr"])
        assert entry["launches"] == {"fwd": 0, "bwd": 0}  # CPU tensors: the plain versions
        assert entry["cut"] == {"steps": 20, "reads": [20], "image_size": 8, "rays": 16}
        assert entry["card"] == "cpu" and entry["train_s"] > 0
    for key in ("blobs_hier_module_42", "blobs_buff_module_42"):
        entry = data[key]
        assert entry["steps"] == 20 and np.isfinite(entry["psnr"])
        assert entry["launches"] == {"chords": 0, "fwd": 0, "bwd": 0}
    assert "coarse_psnr" in data["blobs_hier_module_42"]
    assert data["blobs_buff_module_42"]["voxel_counts"] == []  # no tick before step 1000
    text = out.read_text()
    capsys.readouterr()
    assert quality.main(argv) == 0
    assert out.read_text() == text
    assert capsys.readouterr().out.count("skip ") == 4


def test_cut_runs_of_the_new_protocols_write_their_keys_and_a_second_call_skips_them(
        quality, tmp_path, capsys):
    import shutil

    out = tmp_path / "q.json"
    scene = tmp_path / "hard_llff"
    shutil.copytree(quality.LLFF_DIR, scene)
    argv = ["--device", "cpu", "--protocol", "forward_facing", "--protocol", "quality_800",
            "--seeds", "42", "--steps", "20", "--rays", "16", "--image-size", "16",
            "--llff-factor", "16", "--eval-views", "1", "--mesh-res", "32",
            "--llff-dir", str(scene), "--logdir", str(tmp_path / "runs"), "--out", str(out)]
    assert quality.main(argv) == 0
    data = json.loads(out.read_text())
    assert set(data) == {"forward_facing_hier_on_42", "quality_800_hier_on_42"}

    ff = data["forward_facing_hier_on_42"]
    assert ff["cut"] == {"steps": 20, "rays": 16, "llff_factor": 16, "eval_views": 1}
    assert ff["steps"] == 20
    assert set(ff["validations"]) == set(ff["train_losses"]) == {"20"}
    assert [v["view"] for v in ff["per_view"]] == [0]
    for read in (ff["test"]["psnr"], ff["test"]["ssim"], ff["per_view"][0]["psnr"],
                 ff["untrained"]["validation/fine_psnr"],
                 ff["validations"]["20"]["validation/coarse_psnr"]):
        assert np.isfinite(read)
    assert ff["launches"] == ff["projection_launches"] == {"fwd": 0, "bwd": 0}
    assert ff["eval_launches"] == ff["untrained_launches"] == 0
    assert ff["fit_s"] >= ff["train_s"] + ff["validate_s"] + ff["projection_s"] - 1e-9
    assert Path(ff["run_dir"]).is_relative_to(tmp_path / "runs")
    assert ff["card"] == "cpu" and ff["train_s"] > 0

    q8 = data["quality_800_hier_on_42"]
    assert q8["cut"] == {"steps": 20, "image_size": 16, "rays": 16, "mesh_res": 32}
    assert q8["steps"] == 20 and len(q8["held_out"]["psnr_per_view"]) == 2
    for read in (q8["held_out"]["psnr"], q8["held_out"]["ssim"], q8["untrained"]["psnr"],
                 q8["chamfer_sq"], q8["chamfer_rms"]):
        assert np.isfinite(read)
    assert q8["mesh_vertices"] > 0 and q8["surface_kept"] >= quality.CHAMFER_POINTS
    assert q8["launches"] == {"fwd": 0, "bwd": 0} and q8["sigma_launches"] == 0
    assert q8["mesh_timings"]["iso_requested"] == quality.MESH_ISO

    text = out.read_text()
    capsys.readouterr()
    assert quality.main(argv) == 0
    assert out.read_text() == text
    assert capsys.readouterr().out.count("skip ") == 2


def test_forward_facing_views_are_jax_colmap_datasets(quality, tmp_path):
    from nerfmeshes_tpu.config import load_config as j_load_config
    from nerfmeshes_tpu.data import colmap_dataset as j_colmap
    from nerfmeshes_tpu.data.datasets import DatasetType as JDatasetType
    from nerfmeshes_tpu_torch.data.colmap_dataset import ColmapDataset
    from nerfmeshes_tpu_torch.data.datasets import DatasetType
    from nerfmeshes_tpu_torch.data.loaders.llff import load_llff_data

    cfg = quality.forward_facing_cfg(0, tmp_path)
    assert (cfg.experiment.randomseed, cfg.experiment.logdir) == (0, str(tmp_path))
    assert cfg.dataset.use_ndc and int(cfg.dataset.llff_hold_step) == 8
    assert int(cfg.dataset.llff_downsample_factor) == 1 and cfg.experiment.train_iters == 20000
    j_cfg = j_load_config(str(quality.FF_CONFIG))
    j_cfg.dataset.basedir = cfg.dataset.basedir
    images, poses, bounds, _, _ = load_llff_data(str(quality.LLFF_DIR), factor=1,
                                                 spherify=False)
    held = [0, 8, 16]
    for split, views in (("train", [i for i in range(24) if i not in held]), ("test", held)):
        got = ColmapDataset(cfg, DatasetType(split), device="cpu")
        want = j_colmap.ColmapDataset(j_cfg, JDatasetType(split))
        for key in ("ray_targets", "ray_bounds", "poses", "hwf"):
            g, w = getattr(got.bundle, key), np.asarray(getattr(want.bundle, key))
            assert g.dtype == w.dtype == np.float32, key
            np.testing.assert_array_equal(g, w, err_msg=f"{split} {key}")
        np.testing.assert_array_equal(got.bundle.ray_targets, images[views].astype(np.float32))
        np.testing.assert_array_equal(got.bundle.ray_bounds, bounds[views].astype(np.float32))
        np.testing.assert_array_equal(got.bundle.poses[:, :3, :4], poses[views, :3, :4])
        assert got.bundle.ray_bounds.shape == (len(views), 2)
        assert got.device_arrays()["bounds"].tolist() == [0.0, 1.0]
        assert np.asarray(want.device_arrays()["bounds"]).tolist() == [0.0, 1.0]


def test_newton_projection_is_jaxs(quality):
    import jax
    import jax.numpy as jnp

    from nerfmeshes_tpu.data.synthetic import hard_sdf

    @jax.jit
    def project(pts):  # scripts/quality_800.py:project on given points
        g = jax.grad(lambda p: jnp.sum(hard_sdf(p)))

        def body(pts, _):
            s = hard_sdf(pts)
            grad = g(pts)
            denom = jnp.maximum(jnp.sum(grad * grad, axis=-1, keepdims=True), 1e-8)
            return pts - s[..., None] * grad / denom, None

        pts, _ = jax.lax.scan(body, pts, None, length=quality.NEWTON_STEPS)
        return pts, hard_sdf(pts)

    draw = quality.surface_draw()
    assert draw.shape == (131072, 3) and draw.dtype == np.float32
    assert draw.min() >= -1.2 and draw.max() <= 1.2
    got, got_sdf = quality.newton_project(draw, torch.device("cpu"))
    want, want_sdf = (np.asarray(a) for a in project(jnp.asarray(draw)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    kept = np.abs(got_sdf) < quality.SURFACE_TOL
    np.testing.assert_array_equal(kept, np.abs(want_sdf) < quality.SURFACE_TOL)
    assert kept.sum() >= quality.CHAMFER_POINTS


def test_a_read_leaves_the_train_stream_alone(quality):
    from nerfmeshes_tpu_torch.data.datasets import DatasetType, SyntheticDataset
    from nerfmeshes_tpu_torch.train.system import NeRFSystem

    def system():
        cfg = quality.kernel_width_cfg("on", 42, rays=16)
        cfg.experiment.steps_per_call = 2
        cfg.nerf.validation.chunksize = 64
        return NeRFSystem(cfg, device="cpu").setup(
            SyntheticDataset(cfg, DatasetType.TRAIN, num_images=4, image_size=8, device="cpu"),
            SyntheticDataset(cfg, DatasetType.VALIDATION, num_images=2, image_size=8,
                             device="cpu"))

    read, plain = system(), system()
    first = read.fit(4)["train/loss"]
    quality._read(read)
    last = read.fit(8)["train/loss"]
    assert plain.fit(4)["train/loss"] == first
    assert plain.fit(8)["train/loss"] == last
    assert torch.equal(read.state.generator.get_state(), plain.state.generator.get_state())
    for a, b in zip(read.optimizer.params, plain.optimizer.params):
        assert torch.equal(a, b)


def test_the_script_imports_nothing_of_jax():
    names = set()
    for node in ast.walk(ast.parse(SCRIPT.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module or "")
    tops = {n.split(".")[0] for n in names}
    assert "nerfmeshes_tpu_torch" in tops
    assert not tops & {"nerfmeshes_tpu", "jax", "jaxlib", "flax", "optax"}, sorted(tops)


def test_the_script_needs_a_card_unless_told_cpu(quality, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        quality.main(["--out", str(tmp_path / "q.json")])
    assert not (tmp_path / "q.json").exists()
