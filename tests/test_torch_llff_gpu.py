"""configs/hard-llff.yml on the card: the forward-facing chain through the
fused kernels at the config's width (2 x 8x128 FlexibleNeRF, NDC, per-image
COLMAP bounds, data/hard_llff).

These tests carry the `gpu` marker and skip without a card. On a GPU host:

    python -m pytest tests/test_torch_llff_gpu.py -m gpu --noconftest -q

- 25 NDC steps, a checkpoint, a fresh system restored from it and 25 more
  steps equal 50 uninterrupted steps bit for bit (the kernels are bitwise
  repeatable).
- One held-out view rendered on the card (coarse and fine passes through
  the forward kernel) equals the plain render on the CPU with the same
  weights within 2e-2 (the kernels' bf16 bar), on three 2048-ray slices of
  the view.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from nerfmeshes_tpu_torch.config import load_config
from nerfmeshes_tpu_torch.config.paths import ExperimentPaths, load_hparams, save_hparams
from nerfmeshes_tpu_torch.data.datasets import DatasetType, build_dataset
from nerfmeshes_tpu_torch.ops.kernels import fused_mlp as fm
from nerfmeshes_tpu_torch.train.factory import build_system

pytestmark = pytest.mark.gpu
REPO = Path(__file__).resolve().parents[1]
SLICE = 2048


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _cfg():
    """configs/hard-llff.yml as shipped, but for a checkpoint every 25 steps
    and one validation view."""
    cfg = load_config(str(REPO / "configs" / "hard-llff.yml"),
                      ["dataset.basedir", str(REPO / "data" / "hard_llff")])
    cfg.experiment.update(validate_every=25, steps_per_call=5, print_every=25)
    cfg.nerf.validation.num_samples = 1
    return cfg


@pytest.fixture(scope="module")
def data(cuda):
    cfg = _cfg()
    return (build_dataset(cfg, DatasetType.TRAIN, cuda),
            build_dataset(cfg, DatasetType.VALIDATION, cuda))


def _state_equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_state_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_state_equal(x, y) for x, y in zip(a, b))
    return a == b


def test_llff_resume_through_the_kernels_is_bitwise(cuda, data, tmp_path):
    cfg = _cfg()
    assert len(data[0]) == 21 and len(data[1]) == 3

    def system(run, run_cfg):
        paths = ExperimentPaths(tmp_path / run).create()
        if not paths.hparams_path.exists():
            save_hparams(run_cfg, paths)
        return build_system(run_cfg.clone(), paths).setup(*data)

    fm.launches = fm.bwd_launches = 0
    whole = system("whole", cfg)
    whole.fit(50)
    # 2 forward and 2 backward launches a step; 2 validations of one
    # 400x400 view in 65536-ray chunks, 2 forward launches a chunk.
    assert fm.bwd_launches == 2 * 50 and fm.launches == 2 * 50 + 2 * 2 * 3
    system("split", cfg).fit(25)
    resumed = system("split", load_hparams(tmp_path / "split")).restore(last=True)
    assert resumed.state.step == 25
    resumed.fit(50)
    assert _state_equal(resumed.checkpoint_state(), whole.checkpoint_state())


def test_held_out_view_on_the_card_matches_the_cpu(cuda, data):
    cfg = _cfg()
    val = data[1]
    card = build_system(cfg.clone(), None, cuda).setup_eval(val)
    host = build_system(cfg.clone(), None, "cpu").setup_eval()
    host.coarse.load_state_dict(card.coarse.state_dict())
    host.fine.load_state_dict(card.fine.state_dict())
    origins, directions = val.image_rays(1)
    near, far = val._bounds_for(1)
    fm.launches = 0
    got = card.query_rays(origins, directions, near, far, fields=("rgb_map", "depth_map"),
                          as_numpy=False)
    assert fm.launches == 2 * 3  # coarse + fine per 65536-ray chunk
    n = origins.shape[0]
    for start in (0, (n - SLICE) // 2, n - SLICE):
        rays = slice(start, start + SLICE)
        want = host.query_rays(origins[rays].cpu(), directions[rays].cpu(), near, far,
                               fields=("rgb_map",))
        np.testing.assert_allclose(got.rgb_map[rays].cpu().numpy(), want.rgb_map, rtol=0,
                                   atol=2e-2)
    assert bool(torch.isfinite(got.depth_map).all())
