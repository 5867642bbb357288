"""configs/hard-blender.yml on ScanNet's camera layout, on the card: the
data/hard_scannet stream (1296x968 JPEG frames, +z rays from an
off-centre principal point, unnormalised directions) through the fused
kernels at the config's width (2 x 8x256 FlexibleNeRF, bf16).

These tests carry the `gpu` marker and skip without a card. On a GPU host:

    python -m pytest tests/test_torch_scannet_gpu.py -m gpu --noconftest -q

- The chain's train leg: train_nerf for 150 steps validating every 50 on
  one fixed view; 2 forward and 2 backward launches a step and 40 forward
  launches a validation (20 chunks of 65,536 rays, coarse and fine);
  every train batch is drawn under the dataset's intrinsics; the
  validation loss is finite and falls.
- One held-out 1296x968 view rendered on the card equals the plain render
  on the CPU with the same weights within 2e-2 (the kernels' bf16 bar), on
  three 2048-ray slices of the view.
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from nerfmeshes_tpu_torch.config import load_config
from nerfmeshes_tpu_torch.data.datasets import DatasetType, build_dataset
from nerfmeshes_tpu_torch.ops.kernels import fused_mlp as fm
from nerfmeshes_tpu_torch.train import step as t_step
from nerfmeshes_tpu_torch.train.factory import build_system

pytestmark = pytest.mark.gpu
REPO = Path(__file__).resolve().parents[1]
STREAM = REPO / "data" / "hard_scannet" / "scene.sens"
CONFIG = REPO / "configs" / "hard-blender.yml"
SLICE = 2048


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _overrides(logdir) -> list:
    return ["dataset.type", "scannet", "dataset.basedir", str(STREAM), "experiment.logdir",
            str(logdir), "experiment.train_iters", "150", "experiment.validate_every", "50",
            "nerf.validation.fixed_views", "True"]


def test_scannet_train_leg_through_the_kernels(cuda, tmp_path, monkeypatch):
    from nerfmeshes_tpu_torch.cli import train_nerf

    seen = []
    inner = t_step.rays_from_indices

    def spy(data, img, pix, **kw):
        seen.append(kw.get("intrinsics"))
        return inner(data, img, pix, **kw)

    monkeypatch.setattr(t_step, "rays_from_indices", spy)
    fm.launches = fm.bwd_launches = 0
    system = train_nerf.main(["--config", str(CONFIG), "--override", *_overrides(tmp_path)])
    torch.cuda.synchronize()
    chunks = math.ceil(968 * 1296 / 65536)
    assert system.state.step == 150
    assert fm.bwd_launches == 2 * 150 and fm.launches == 2 * 150 + 3 * 2 * chunks
    intr = system.train_dataset.intrinsics()
    assert (intr.z_sign, intr.flip_y, intr.normalize) == (1.0, False, False)
    assert len(seen) == 150 and all(s == intr for s in seen)
    records = [json.loads(line)
               for line in (system.paths.log_dir / "events" / "metrics.jsonl").open()]
    losses = {r["step"]: r["validation/loss"] for r in records if "validation/loss" in r}
    assert sorted(losses) == [50, 100, 150]
    assert all(math.isfinite(v) for v in losses.values()) and losses[150] < losses[50]


def test_scannet_view_on_the_card_matches_the_cpu(cuda, tmp_path):
    cfg = load_config(str(CONFIG), _overrides(tmp_path))
    val = build_dataset(cfg, DatasetType.VALIDATION, cuda)
    assert len(val) == 2 and tuple(int(v) for v in val.hwf[:2]) == (968, 1296)
    card = build_system(cfg.clone(), None, cuda).setup_eval(val)
    host = build_system(cfg.clone(), None, "cpu").setup_eval()
    host.coarse.load_state_dict(card.coarse.state_dict())
    host.fine.load_state_dict(card.fine.state_dict())
    origins, directions = val.image_rays(1)
    near, far = val._bounds_for(1)
    fm.launches = 0
    got = card.query_rays(origins, directions, near, far, fields=("rgb_map", "depth_map"),
                          as_numpy=False)
    assert fm.launches == 2 * math.ceil(968 * 1296 / 65536)
    n = origins.shape[0]
    for start in (0, (n - SLICE) // 2, n - SLICE):
        rays = slice(start, start + SLICE)
        want = host.query_rays(origins[rays].cpu(), directions[rays].cpu(), near, far,
                               chunk=SLICE, fields=("rgb_map",))
        np.testing.assert_allclose(got.rgb_map[rays].cpu().numpy(), want.rgb_map, rtol=0,
                                   atol=2e-2)
    assert bool(torch.isfinite(got.depth_map).all())
