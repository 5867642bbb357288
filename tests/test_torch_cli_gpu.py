"""The run chain on the card: checkpoints, resume, the synthetic targets and
SSIM.

These tests carry the `gpu` marker and skip without a card. On a GPU host:

    python -m pytest tests/test_torch_cli_gpu.py -m gpu --noconftest -q

- Resume at lego width through the kernels (bf16, fused): 25 steps, a
  checkpoint, a fresh system restored from it and 25 more steps equal 50
  uninterrupted steps bit for bit (the kernels are bitwise repeatable);
  hierarchical, and BuFF across a consolidation (the tree's memm sums by
  atomics in a changing order, but feeds only the 1e-4 prune).
- The procedural hard scene rendered on the card equals its render on
  the CPU within atol 1e-5, and SSIM on the card equals SSIM on the CPU
  within 1e-5 (true f32 convolutions, no TF32).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from nerfmeshes_tpu_torch.config import load_config
from nerfmeshes_tpu_torch.config.paths import ExperimentPaths, load_hparams, save_hparams
from nerfmeshes_tpu_torch.data.datasets import DatasetType, SyntheticDataset
from nerfmeshes_tpu_torch.data.synthetic import make_synthetic_dataset
from nerfmeshes_tpu_torch.ops.math import ssim
from nerfmeshes_tpu_torch.train.factory import build_system

pytestmark = pytest.mark.gpu
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _cfg(name: str):
    """A shipped config at its width, on small procedural views, with a
    checkpoint every 25 steps (BuFF: consolidations every 10 from step 10)."""
    cfg = load_config(str(REPO / "configs" / name))
    cfg.experiment.update(validate_every=25, steps_per_call=5, print_every=25)
    cfg.nerf.validation.num_samples = 1
    cfg.dataset.update(type="synthetic", scene="hard")
    if cfg.experiment.model == "BuFFModel":
        cfg.tree.update(step_size_integration_offset=10, step_size_tree=10)
    return cfg


def _state_equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_state_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_state_equal(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("name", ["hard-blender.yml", "buff-hard-250k.yml"])
def test_resume_through_the_kernels_is_bitwise(cuda, tmp_path, name):
    cfg = _cfg(name)
    data = (SyntheticDataset(cfg, DatasetType.TRAIN, num_images=6, image_size=64,
                             gt_samples=128, device=cuda),
            SyntheticDataset(cfg, DatasetType.VALIDATION, num_images=2, image_size=64,
                             gt_samples=128, device=cuda))

    def system(run, run_cfg):
        paths = ExperimentPaths(tmp_path / run).create()
        if not paths.hparams_path.exists():
            save_hparams(run_cfg, paths)
        return build_system(run_cfg.clone(), paths).setup(*data)

    whole = system("whole", cfg)
    whole.fit(50)
    system("split", cfg).fit(25)
    # As the train CLI resumes: the config from the run's hparams.yaml.
    resumed = system("split", load_hparams(tmp_path / "split")).restore(last=True)
    assert resumed.state.step == 25
    resumed.fit(50)
    a, b = resumed.checkpoint_state(), whole.checkpoint_state()
    a_extra, b_extra = a.pop("extra"), b.pop("extra")
    assert _state_equal(a, b)
    if cfg.experiment.model == "BuFFModel":
        assert resumed.consolidation_steps == whole.consolidation_steps == [20, 30, 40, 50]
        for key in ("leaf_lo", "leaf_hi", "leaf_depth", "num_leaves"):
            assert torch.equal(a_extra["tree"][key], b_extra["tree"][key]), key


def test_synthetic_targets_on_the_card_match_the_cpu(cuda):
    kw = dict(num_images=2, image_size=48, scene="hard", with_depth=True, num_samples=256)
    got = make_synthetic_dataset(**kw, device=cuda)
    want = make_synthetic_dataset(**kw, device="cpu")
    np.testing.assert_allclose(got.ray_targets, want.ray_targets, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.target_depth, want.target_depth, rtol=0, atol=1e-5)


def test_ssim_on_the_card_matches_the_cpu(cuda):
    rng = np.random.default_rng(0)
    a = rng.uniform(size=(256, 200, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.05, size=a.shape), 0, 1).astype(np.float32)
    want = float(ssim(torch.from_numpy(a), torch.from_numpy(b)))
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True  # ssim turns it off for its convolutions
    try:
        got = float(ssim(torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda)))
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    assert abs(got - want) < 1e-5
