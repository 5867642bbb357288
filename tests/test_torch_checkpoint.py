"""Checkpoints of the port (nerfmeshes_tpu_torch/train/checkpoint.py and the
systems' save/restore), on the CPU.

- The numbered checkpoints kept for a sequence of validation losses are
  the ones JAX's orbax policy keeps (top 3 by val_loss, ties and a save
  without a loss included), with `last` beside them.
- Training to step 20 in one go equals training to 10, restoring the
  checkpoint into a fresh system and training on to 20, bit for bit:
  parameters, Adam's state, the schedule, the accumulator and the
  generator; hierarchical with gradient accumulation split across the
  checkpoint, and BuFF across a consolidation and a grown chord cap,
  which reaches hparams.yaml.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfmeshes_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager
from nerfmeshes_tpu.train.step import TrainState as JaxTrainState
from nerfmeshes_tpu_torch.config import get_default_cfg
from nerfmeshes_tpu_torch.config.paths import ExperimentPaths, load_hparams, save_hparams
from nerfmeshes_tpu_torch.data.datasets import DatasetType, SyntheticDataset
from nerfmeshes_tpu_torch.train.checkpoint import CheckpointManager
from nerfmeshes_tpu_torch.train.factory import build_system

torch.set_num_threads(1)
CPU = torch.device("cpu")
SMALL = dict(num_layers=4, hidden_size=32, skip_step=2, num_encoding_fn_xyz=4,
             num_encoding_fn_dir=2)


def _numbered(directory):
    return sorted(int(p.name) for p in directory.iterdir() if p.name.isdigit())


@pytest.mark.parametrize("losses", [
    [0.5, 0.3, 0.4, 0.3, 0.6, 0.1, 0.3],
    [0.2, None, 0.4, 0.1, 0.5, 0.5],
    [0.9, 0.8, 0.7, 0.6, 0.5],
])
def test_kept_steps_follow_the_orbax_policy(tmp_path, losses):
    jm = JaxCheckpointManager(str(tmp_path / "jax"))
    tm = CheckpointManager(tmp_path / "port")
    for k, loss in enumerate(losses):
        step = 10 * (k + 1)
        jm.save(JaxTrainState(params={"w": jnp.full((2,), step, jnp.float32)}, opt_state={},
                              step=jnp.int32(step), key=jax.random.key(0)), val_loss=loss)
        tm.save({"w": torch.full((2,), float(step))}, step, val_loss=loss)
        assert tm.steps() == _numbered(tmp_path / "jax"), (k, loss)
    jm.close()
    assert tm.latest_step() == tm.steps()[-1]
    assert float(tm.restore(last=True)["w"][0]) == 10 * len(losses)
    assert float(tm.restore()["w"][0]) == tm.latest_step()
    assert not (tmp_path / "port" / "last.tmp").exists()


def _hier_cfg():
    cfg = get_default_cfg()
    for node in (cfg.models.coarse, cfg.models.fine):
        node.update(SMALL)
    cfg.experiment.update(compute_dtype="float32", use_fused_kernel=False, steps_per_call=2,
                          validate_every=10, print_every=10, randomseed=3)
    cfg.nerf.train.update(num_random_rays=64, num_coarse=8, num_fine=8, perturb=True,
                          radiance_field_noise_std=0.2)
    cfg.nerf.validation.update(num_coarse=8, num_fine=8, chunksize=256)
    cfg.optimizer.update(lr=5e-4, accumulate_steps=3)  # a partial mean at step 10
    cfg.dataset.type = "synthetic"
    return cfg


def _buff_cfg():
    cfg = get_default_cfg()
    cfg.experiment.update(model="BuFFModel", compute_dtype="float32", use_fused_kernel=False,
                          steps_per_call=2, validate_every=10, print_every=10, randomseed=5)
    cfg.models.use_fine = False
    cfg.models.coarse.update(SMALL)
    cfg.tree.update(subdivision_outer_count=4, max_voxel_count=256, eps=1e-6,
                    step_size_integration_offset=4, step_size_tree=4, max_chords_per_ray=2)
    cfg.nerf.train.update(num_random_rays=64, num_coarse=8)
    cfg.nerf.validation.update(num_coarse=8, chunksize=256)
    cfg.optimizer.lr = 5e-4
    cfg.dataset.type = "synthetic"
    return cfg


def _datasets(cfg):
    train = SyntheticDataset(cfg, DatasetType.TRAIN, num_images=4, image_size=12, gt_samples=32,
                             device=CPU)
    val = SyntheticDataset(cfg, DatasetType.VALIDATION, num_images=2, image_size=8,
                           gt_samples=32, device=CPU)
    return train, val


def _system(cfg, run, data):
    """A system logging to `run`, whose hparams.yaml a new run writes, as
    resolve_paths does."""
    paths = ExperimentPaths(run).create()
    if not paths.hparams_path.exists():
        save_hparams(cfg, paths)
    return build_system(cfg.clone(), paths, CPU).setup(*data)


def _snapshot(system) -> dict:
    state = system.checkpoint_state()
    state.pop("extra")
    return state


def _equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b or (isinstance(a, float) and math.isnan(a) and math.isnan(b))


@pytest.mark.parametrize("kind", ["hierarchical", "buff"])
def test_resumed_training_equals_uninterrupted(tmp_path, kind, capsys):
    cfg = _hier_cfg() if kind == "hierarchical" else _buff_cfg()
    data = _datasets(cfg)
    whole = _system(cfg, tmp_path / "whole", data)
    whole.fit(20)
    first = _system(cfg, tmp_path / "split", data)
    first.fit(10)
    saved = _snapshot(first)
    # As the train CLI resumes: the config from the run's hparams.yaml.
    resumed = _system(load_hparams(tmp_path / "split"), tmp_path / "split", data)
    resumed.restore(last=True)
    assert _equal(_snapshot(resumed), saved)
    assert resumed.state.step == 10 and resumed.ckpt.steps() == [10]
    resumed.fit(20)
    assert _equal(_snapshot(resumed), _snapshot(whole))
    assert resumed.ckpt.steps() == whole.ckpt.steps() == [10, 20]
    if kind == "hierarchical":
        assert resumed.optimizer._micro == 20 % 3 and first.optimizer._micro == 10 % 3
        return
    # BuFF: consolidated after steps 8, 12, 16 and 20, across the checkpoint.
    assert whole.consolidation_steps == resumed.consolidation_steps == [8, 12, 16, 20]
    for name, value in whole.tree.serialize(whole.tree_state).items():
        np.testing.assert_array_equal(value, resumed.tree.serialize(resumed.tree_state)[name])
    # The cap of 2 binds on the 4^3 grid and grows; the run's hparams.yaml
    # carries the grown cap.
    assert "doubling the cap" in capsys.readouterr().out
    cap = whole._effective_max_chords()
    assert cap > 2 and resumed._effective_max_chords() == cap
    assert load_hparams(tmp_path / "whole").tree.max_chords_per_ray == cap


def test_restore_picks_a_step(tmp_path):
    cfg = _hier_cfg()
    cfg.experiment.validate_every = 4
    data = _datasets(cfg)
    system = _system(cfg, tmp_path / "run", data)
    system.fit(12)
    assert system.ckpt.steps() == [4, 8, 12]
    at8 = _system(cfg, tmp_path / "run", data).restore(step=8)
    latest = _system(cfg, tmp_path / "run", data).restore()
    assert at8.state.step == 8 and latest.state.step == 12
    assert _equal(_snapshot(latest), _snapshot(system))
    assert not _equal(_snapshot(at8)["coarse"], _snapshot(system)["coarse"])


# Each optimizer with a zoo coarse model beside the FlexibleNeRF fine one:
# the rule's state, a DropModel's dropout draws (from the train generator)
# and FastRotPos's B buffer all cross the checkpoint.
OPTIMIZER_ZOO = [("Adam", "DropModel"), ("AdamW", "SpecularSimpleModel"), ("Adamax", "FlatModel"),
                 ("SGD", "ResModel"), ("RMSprop", "RotFlexibleNeRFModel"),
                 ("Adagrad", "SimpleModel")]


@pytest.mark.parametrize("kind,coarse", OPTIMIZER_ZOO, ids=[k for k, _ in OPTIMIZER_ZOO])
def test_resume_is_bit_for_bit_for_each_optimizer(tmp_path, kind, coarse):
    cfg = _hier_cfg()
    cfg.optimizer.type = kind
    cfg.models.coarse_type = coarse
    data = _datasets(cfg)
    whole = _system(cfg, tmp_path / "whole", data)
    whole.fit(20)
    first = _system(cfg, tmp_path / "split", data)
    first.fit(10)
    assert first.checkpoint_state()["optimizer"]["type"] == kind
    resumed = _system(load_hparams(tmp_path / "split"), tmp_path / "split", data)
    resumed.restore(last=True)
    assert _equal(_snapshot(resumed), _snapshot(first))
    resumed.fit(20)
    assert _equal(_snapshot(resumed), _snapshot(whole))
    assert type(resumed.coarse).__name__ == coarse


def test_checkpoint_with_the_adam_key_restores(tmp_path):
    """A checkpoint written before the optimizer state named its rule
    (Adam's state under "adam") restores and trains on as the
    uninterrupted run does."""
    cfg = _hier_cfg()
    data = _datasets(cfg)
    whole = _system(cfg, tmp_path / "whole", data)
    whole.fit(20)
    first = _system(cfg, tmp_path / "split", data)
    first.fit(10)
    path = tmp_path / "split" / "checkpoints" / "last" / "state.pt"
    state = torch.load(path, weights_only=True)
    opt = state["optimizer"]
    state["optimizer"] = {"adam": opt["rule"], "schedule_step": opt["schedule_step"],
                          "micro": opt["micro"], "mean": opt["mean"]}
    torch.save(state, path)
    resumed = _system(cfg, tmp_path / "split", data).restore(last=True)
    assert _equal(_snapshot(resumed), _snapshot(first))
    resumed.fit(20)
    assert _equal(_snapshot(resumed), _snapshot(whole))
