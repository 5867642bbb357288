"""scripts/torch_quality_parity.py on the CPU.

- The blobs protocol's train batches and eval set are those of
  scripts/r5_blobs_attribution.py:make_data (the JAX package's), to 1e-6,
  for seeds 42, 0 and 1 over the first steps: the scene is rendered in
  each stack (f32 sums in other orders), the draws are the same numpy
  streams.
- A cut run of each protocol (--device cpu, 20 steps) writes its keyed
  entries, and a second call skips them.
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
    argv = ["--device", "cpu", "--seeds", "42", "--steps", "20", "--image-size", "8",
            "--rays", "16", "--out", str(out)]
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
