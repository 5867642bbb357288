"""Validation, its metrics and its logging (nerfmeshes_tpu_torch/train/
system.py:validate, ops/math.py:ssim, utils/logging.py) against the JAX
package, on the CPU.

- ssim equals JAX's within 1e-5 (both f32 'valid' Gaussian convolutions).
- NeRFSystem.validate on an f32 model carried over from JAX
  (state_dict_from_flax) gives JAX's validate metrics within rtol 1e-4 on
  the same synthetic validation views: view draws seeded by the step, by
  0 under fixed_views, and every view with num_samples -1.
- Early stopping exits with -1 on a collapsed render at its step only.
- The chamfer term of a field against its own surface is ~0.
- metrics.jsonl records, console lines and acronyms are JAX's; validation
  images are PNGs that imageio reads back.
"""

import json

import imageio.v2 as imageio
import jax
import numpy as np
import pytest
import torch

from nerfmeshes_tpu.config import get_default_cfg
from nerfmeshes_tpu.data.datasets import DatasetType as JDatasetType
from nerfmeshes_tpu.data.datasets import SyntheticDataset as JSyntheticDataset
from nerfmeshes_tpu.ops.math import ssim as j_ssim
from nerfmeshes_tpu.train.system import NeRFSystem as JNeRFSystem
from nerfmeshes_tpu.utils import logging as j_logging
from nerfmeshes_tpu_torch.config.paths import ExperimentPaths
from nerfmeshes_tpu_torch.data.datasets import DatasetType, SyntheticDataset
from nerfmeshes_tpu_torch.models.transplant import state_dict_from_flax
from nerfmeshes_tpu_torch.ops.math import ssim as t_ssim
from nerfmeshes_tpu_torch.train.system import NeRFSystem
from nerfmeshes_tpu_torch.utils import logging as t_logging

torch.set_num_threads(1)
CPU = torch.device("cpu")
SMALL = dict(num_layers=4, hidden_size=32, skip_step=2, num_encoding_fn_xyz=4,
             num_encoding_fn_dir=2)


@pytest.mark.parametrize("shape", [(11, 11, 3), (40, 37, 3), (64, 48, 1)])
def test_ssim_matches_jax(shape):
    rng = np.random.default_rng(shape[0])
    a = rng.uniform(size=shape).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.1, size=shape), 0, 1).astype(np.float32)
    got = t_ssim(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dim() == 0 and got.dtype == torch.float32
    assert abs(float(got) - float(j_ssim(a, b))) < 1e-5
    assert abs(float(t_ssim(torch.from_numpy(a), torch.from_numpy(a))) - 1.0) < 1e-5


def _cfg():
    cfg = get_default_cfg()
    for node in (cfg.models.coarse, cfg.models.fine):
        node.update(SMALL)
    cfg.experiment.update(compute_dtype="float32", use_fused_kernel=False, randomseed=7)
    cfg.nerf.validation.update(num_coarse=16, num_fine=16, chunksize=128, num_samples=3)
    cfg.dataset.type = "synthetic"
    return cfg


@pytest.fixture(scope="module")
def pair():
    """A JAX system and the port's with its weights, on the same views."""
    cfg = _cfg()
    kw = dict(num_images=3, image_size=10, gt_samples=32)
    j_val = JSyntheticDataset(cfg, JDatasetType.VALIDATION, **kw)
    j_sys = JNeRFSystem(cfg).setup(JSyntheticDataset(cfg, JDatasetType.TRAIN, **kw), j_val)
    t_val = SyntheticDataset(cfg, DatasetType.VALIDATION, **kw, device=CPU)
    t_val.bundle.ray_targets = np.asarray(j_val.bundle.ray_targets).copy()
    t_sys = NeRFSystem(cfg, device=CPU).setup_eval(t_val)
    for model, name in ((t_sys.coarse, "coarse"), (t_sys.fine, "fine")):
        params = jax.tree_util.tree_map(np.asarray, j_sys.state.params[name])
        model.load_state_dict(state_dict_from_flax(params, dict(cfg.models[name])))
    return j_sys, t_sys


@pytest.mark.parametrize("step, fixed_views, num_samples", [
    (0, False, 3), (10, False, 3), (10, True, 3), (5, False, -1)])
def test_validate_matches_jax(pair, step, fixed_views, num_samples):
    j_sys, t_sys = pair
    for system in pair:
        system.cfg.nerf.validation.update(fixed_views=fixed_views, num_samples=num_samples)
    want = j_sys.validate(step=step, log_images=False)
    got = t_sys.validate(step=step, log_images=False)
    assert t_sys._last_val_indices == j_sys._last_val_indices
    assert set(got) == set(want) == {
        "validation/coarse_loss", "validation/coarse_psnr", "validation/fine_loss",
        "validation/fine_psnr", "validation/loss"}
    for key, value in want.items():
        assert got[key] == pytest.approx(value, rel=1e-4), key


def test_early_stopping_exits_on_collapse(capsys):
    cfg = _cfg()
    cfg.experiment.update(use_early_stopping=True, early_stopping_step=4, steps_per_call=2,
                          validate_every=0, print_every=100)
    cfg.nerf.train.update(num_random_rays=16, num_coarse=8, num_fine=8)
    train = SyntheticDataset(cfg, DatasetType.TRAIN, num_images=2, image_size=6,
                             gt_samples=16, device=CPU)
    system = NeRFSystem(cfg, device=CPU).setup(train)
    system.fit(4)  # a live field at step 4: no exit
    collapsed = NeRFSystem(cfg, device=CPU).setup(train)
    with torch.no_grad():
        for model in (collapsed.coarse, collapsed.fine):
            # sigma far below 0 everywhere: the ReLU passes no gradient, the
            # field stays empty and the render sums to 0.
            model.fc_alpha.weight.zero_()
            model.fc_alpha.bias.fill_(-1e3)
    collapsed.fit(2)  # before the early-stopping step: no exit
    with pytest.raises(SystemExit) as exit_info:
        collapsed.fit(4)
    assert exit_info.value.code == -1
    assert "stuck in local minima" in capsys.readouterr().out


def test_chamfer_of_a_field_against_its_own_surface(tmp_path):
    from nerfmeshes_tpu_torch.mesh import MeshArgs, export_obj, extract_geometry

    cfg = _cfg()
    cfg.experiment.update(chamfer_loss=True, chamfer_sampling_size=500)
    cfg.dataset.basedir = str(tmp_path)
    system = NeRFSystem(cfg, device=CPU)
    assert system._chamfer_validation() is None  # no model.obj

    def ball(points):
        return 64.0 * (0.6 - torch.linalg.norm(torch.as_tensor(points), dim=-1))

    system.density_points = ball
    verts, tris, normals, _ = extract_geometry(system.sample_points,
                                               MeshArgs(res=64, limit=1.2, iso_level=32),
                                               density_fn=ball, device=CPU)
    export_obj(verts, tris, np.zeros_like(verts), normals, str(tmp_path / "model.obj"))
    chamfer = system._chamfer_validation()
    assert chamfer is not None and 0.0 <= chamfer < 1e-8


def test_logger_records_as_jax(tmp_path):
    names = ["train/coarse_loss", "train/lr", "validation/fine_psnr", "loss",
             "train/rays_per_sec", "train/dropped_chords"]
    assert [t_logging.acronym(n) for n in names] == [j_logging.acronym(n) for n in names]
    metrics = {"train/loss": 0.25, "train/lr": 5e-4, "train/rays_per_sec": 123456.7}
    port = t_logging.MetricsLogger(tmp_path / "port")
    jax_logger = j_logging.MetricsLogger(str(tmp_path / "jax"), use_tensorboard=False)
    for logger in (port, jax_logger):
        logger.log_scalars(metrics, 7)
        logger.close()
    assert port.console_line(metrics, 7) == jax_logger.console_line(metrics, 7)
    got = json.loads((tmp_path / "port" / "metrics.jsonl").read_text())
    want = json.loads((tmp_path / "jax" / "metrics.jsonl").read_text())
    assert list(got) == list(want) and got.pop("time") > 0
    want.pop("time")
    assert got == want


def test_validation_logs_images(tmp_path, pair):
    _, t_sys = pair
    cfg = t_sys.cfg.clone()
    cfg.nerf.validation.update(fixed_views=False, num_samples=1)
    system = NeRFSystem(cfg, ExperimentPaths(tmp_path).create(), device=CPU)
    system.coarse.load_state_dict(t_sys.coarse.state_dict())
    system.fine.load_state_dict(t_sys.fine.state_dict())
    system.setup_eval(t_sys.val_dataset).validate(step=3)
    images = tmp_path / "events" / "images"
    names = sorted(p.name for p in images.iterdir())
    assert names == [f"validation_{kind}_0_3.png" for kind in
                     ("disparity", "img_target", "rgb_coarse", "rgb_fine")]
    target = imageio.imread(images / "validation_img_target_0_3.png")
    idx = system._last_val_indices[0]
    want = (np.clip(np.asarray(t_sys.val_dataset.bundle.ray_targets[idx]), 0, 1) * 255)
    np.testing.assert_array_equal(target, want.astype(np.uint8))
