"""The model zoo on the card: each zoo model's CUDA run against its CPU run
with the same weights, and a DropModel coarse + FlexibleNeRF fine
hierarchical training on the card.

These tests carry the `gpu` marker and skip without a card. On a GPU host:

    python -m pytest tests/test_torch_zoo_gpu.py -m gpu --noconftest -q

- Each of the six zoo models at its class defaults (the reference's
  widths), f32 and bf16: one forward and one backward of sum(field^2)
  over 256 rays x 64 samples on the card against the same on the CPU;
  the field within 1e-5 (f32; TF32 off) or 2e-2 (bf16); every grad's
  worst relative error within 1e-3 (f32) or 5e-2 (bf16), chip_smoke.py's
  ZOO_GRAD_TOL: across devices the f32 sums run in other orders and a
  pre-activation within rounding of 0 flips its ReLU (4.4e-4 read here at
  this size), where the CPU tests hold f32 grads to 1e-4 on one device.
- configs/hard-blender.yml's settings with a DropModel coarse model: 4
  train steps on data/hard_blender. The fine FlexibleNeRF goes through the
  fused kernels (one forward and one backward launch a step), the coarse
  zoo model through the nn.Module (none); the dropout draws come from the
  train state's CUDA generator and keep 0.5 of the values within 3
  sigma; the loss is finite.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import importlib.util

from nerfmeshes_tpu_torch.models import nerf_models as tm
from nerfmeshes_tpu_torch.ops.kernels import fused_mlp as fm
from nerfmeshes_tpu_torch.train.system import init_params

pytestmark = pytest.mark.gpu
REPO = Path(__file__).resolve().parents[1]
ZOO = ["SimpleModel", "SpecularSimpleModel", "FlatModel", "ResModel", "DropModel",
       "RotFlexibleNeRFModel"]


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _points(R, S, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.standard_normal((R, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = -o / 4.0 + rng.uniform(-0.4, 0.4, (R, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t = np.linspace(2.0, 6.0, S)
    pts = o[:, None] + d[:, None] * t[None, :, None]
    dirs = np.broadcast_to(d[:, None], pts.shape)
    return (torch.from_numpy(pts.astype(np.float32)),
            torch.from_numpy(np.ascontiguousarray(dirs, dtype=np.float32)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _run(model, pts, dirs):
    out = model(pts, dirs)
    field = out[0] if isinstance(out, tuple) else out
    (field ** 2).sum().backward()
    return field.detach()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ZOO)
def test_zoo_model_on_the_card_matches_its_cpu_run(cuda, name, dtype):
    compute = getattr(torch, dtype)
    cpu = tm.build_model(name, {}, compute_dtype=compute)
    init_params(cpu, None, torch.Generator().manual_seed(0))
    card = tm.build_model(name, {}, compute_dtype=compute)
    card.load_state_dict(cpu.state_dict())
    card.to(cuda)
    pts, dirs = _points(256, 64)
    smoke = _chip_smoke()
    want = _run(cpu, pts, dirs)
    got = _run(card, pts.to(cuda), dirs.to(cuda)).cpu()
    tol = smoke.ZOO_FIELD_TOL[dtype]
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)
    worst, leaf = smoke.worst_grad_error(cpu, card)
    assert worst < smoke.ZOO_GRAD_TOL[dtype], (worst, leaf)


def test_dropmodel_coarse_trains_on_the_card(cuda, monkeypatch):
    from nerfmeshes_tpu_torch.config import load_config
    from nerfmeshes_tpu_torch.data.blender import train_arrays
    from nerfmeshes_tpu_torch.train.system import NeRFSystem

    cfg = load_config(str(REPO / "configs" / "hard-blender.yml"),
                      ["models.coarse_type", "DropModel", "dataset.basedir",
                       str(REPO / "data" / "hard_blender"), "experiment.steps_per_call", "1",
                       "experiment.validate_every", "0"])
    shares = []
    real = tm.dropout

    def recording(x, rate, generator):
        assert generator is not None and generator.device.type == "cuda"
        out = real(x, rate, generator)
        nonzero = x != 0
        shares.append((((out != 0) & nonzero).sum(), nonzero.sum()))
        return out

    monkeypatch.setattr(tm, "dropout", recording)
    system = NeRFSystem(cfg, device=cuda).setup(train_arrays(cfg, cuda, split="val"))
    fm.launches = fm.bwd_launches = 0
    metrics = system.fit(4)
    assert (fm.launches, fm.bwd_launches) == (4, 4)
    assert len(shares) == 4 and np.isfinite(metrics["train/loss"])
    for kept, n in shares:  # the share kept among the values that were not 0
        assert abs(float(kept) / float(n) - 0.5) <= 3 * np.sqrt(0.25 / float(n))
