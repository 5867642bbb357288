"""import_checkpoint on the card: a reference-layout checkpoint of a system
trained on the card imports into a run whose render through the kernels
equals the source system's, bit for bit.

These tests carry the `gpu` marker and skip without a card. On a GPU host:

    python -m pytest tests/test_torch_import_gpu.py -m gpu --noconftest -q

- Hierarchical at lego width (2 x 8x256, bf16, the fused kernels), 10
  steps on small procedural views: the weights go into a Lightning-layout
  model_last.ckpt under model_coarse.* / model_fine.*, the run's flat
  hparams.yaml beside it; the CLI imports it (on the card, its default),
  and the imported run, restored as eval restores it, renders 4096 rays
  as the source does.
- BuFF (buff-hard-250k.yml's field) through a consolidation: model.* and
  the reference's tree {voxels, memm, counter}; the imported tree's
  serialization equals the source's and so does the render through the
  chord and forward kernels.
"""

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from nerfmeshes_tpu_torch.cli import import_checkpoint
from nerfmeshes_tpu_torch.config import load_config
from nerfmeshes_tpu_torch.config.paths import ExperimentPaths, resolve_paths, save_hparams
from nerfmeshes_tpu_torch.data.datasets import DatasetType, SyntheticDataset
from nerfmeshes_tpu_torch.ops.kernels import chords as tc
from nerfmeshes_tpu_torch.ops.kernels import fused_mlp as fm
from nerfmeshes_tpu_torch.train.factory import build_system

pytestmark = pytest.mark.gpu
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _trained(tmp_path: Path, name: str, cuda):
    cfg = load_config(str(REPO / "configs" / name))
    cfg.experiment.update(validate_every=0, steps_per_call=5, print_every=5,
                          logdir=str(tmp_path / "logs"))
    cfg.dataset.update(type="synthetic", scene="hard")
    if cfg.experiment.model == "BuFFModel":
        cfg.tree.update(step_size_integration_offset=5, step_size_tree=5)
    paths = ExperimentPaths(tmp_path / "source").create()
    save_hparams(cfg, paths)
    system = build_system(cfg, paths, cuda)
    train = SyntheticDataset(cfg, DatasetType.TRAIN, num_images=4, image_size=32, device=cuda)
    val = SyntheticDataset(cfg, DatasetType.VALIDATION, num_images=2, image_size=16, device=cuda)
    system.setup(train, val).fit(10)
    return system, paths


def _reference_checkpoint(system, paths: Path, tmp_path: Path) -> Path:
    buff = system.cfg.experiment.model == "BuFFModel"
    models = {"model.": system.coarse} if buff else {"model_coarse.": system.coarse,
                                                     "model_fine.": system.fine}
    sd = {f"{p}{k}": v.detach().cpu() for p, m in models.items()
          for k, v in m.state_dict().items()}
    ckpt = {"state_dict": sd, "global_step": system.state.step, "epoch": 0}
    if buff:
        leaves = system.tree.leaves
        ckpt["tree"] = {
            "voxels": torch.from_numpy(np.stack([np.stack([l.lo, l.hi]) for l in leaves])),
            "memm": system.tree_state.memm[:len(leaves)].cpu(),
            "counter": system.tree_state.counter}
    ref = tmp_path / "reference"
    (ref / "checkpoints").mkdir(parents=True)
    torch.save(ckpt, ref / "checkpoints" / "model_last.ckpt")
    shutil.copyfile(paths.hparams_path, ref / "hparams.yaml")
    return ref / "checkpoints" / "model_last.ckpt"


def _rays(cuda, R=4096, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((R, 3)).astype(np.float32)
    o = -4.0 * d / np.linalg.norm(d, axis=1, keepdims=True)
    return torch.from_numpy(o).to(cuda), torch.from_numpy(d).to(cuda)


@pytest.mark.parametrize("name", ["hard-blender.yml", "buff-hard-250k.yml"])
def test_imported_run_renders_as_its_source(tmp_path, cuda, name):
    source, paths = _trained(tmp_path, name, cuda)
    ckpt = _reference_checkpoint(source, paths, tmp_path)
    imported = import_checkpoint.main(["--ckpt", str(ckpt), "--override", "experiment.logdir",
                                       str(tmp_path / "imported")])
    assert imported.device.type == "cuda" and imported.state.step == 10
    cfg, run_paths = resolve_paths(log_checkpoint=str(imported.paths.log_dir))
    restored = build_system(cfg, run_paths).setup_eval().restore(last=True)
    if cfg.experiment.model == "BuFFModel":
        assert source.consolidation_steps
        got = restored.tree.serialize(restored.tree_state)
        want = source.tree.serialize(source.tree_state)
        for k in ("leaf_lo", "leaf_hi", "leaf_depth", "memm", "num_leaves"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    o, d = _rays(cuda)
    before = (fm.launches, tc.launches)
    a = source.setup_eval().query_rays(o, d, 2.0, 6.0, fields=("rgb_map", "depth_map"))
    b = restored.query_rays(o, d, 2.0, 6.0, fields=("rgb_map", "depth_map"))
    assert fm.launches > before[0]
    np.testing.assert_array_equal(a.rgb_map, b.rgb_map)
    np.testing.assert_array_equal(a.depth_map, b.depth_map)
    assert np.isfinite(a.rgb_map).all()
