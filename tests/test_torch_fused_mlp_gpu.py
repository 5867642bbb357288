"""The fused MLP CUDA kernel against its plain version, on the card.

A CUDA kernel has no CPU mode, so these tests carry the `gpu` marker and
skip without a card. On a GPU host:

    python -m pytest tests/test_torch_fused_mlp_gpu.py -m gpu --noconftest -q

(`--noconftest`: tests/conftest.py imports jax, which the GPU host does
not need.) Tolerance atol = rtol = 2e-2, the bf16 bar of
tests/test_fused_mlp.py:37; kernel and plain version share numerics but
sum in other orders.
"""

import numpy as np
import pytest
import torch

from nerfmeshes_tpu_torch.models import FlexibleNeRFModel
from nerfmeshes_tpu_torch.ops.kernels import fused_mlp as fm

pytestmark = pytest.mark.gpu

LEGO = dict(num_layers=8, hidden_size=256, skip_step=4, num_encoding_fn_xyz=10,
            num_encoding_fn_dir=4)
ARCHS = [
    LEGO,
    dict(num_layers=4, hidden_size=128, skip_step=2, num_encoding_fn_xyz=4, num_encoding_fn_dir=2),
    dict(num_layers=10, hidden_size=128, skip_step=3, num_encoding_fn_xyz=4,
         num_encoding_fn_dir=2, include_input_xyz=False, include_input_dir=False),
    dict(LEGO, num_layers=4, skip_step=2, num_encoding_fn_xyz=11, log_sampling_xyz=False,
         log_sampling_dir=False),
    # the edge of supports_fused: most layers and bands the kernel takes
    dict(LEGO, num_layers=fm.MAX_LAYERS, num_encoding_fn_xyz=fm.MAX_BANDS,
         num_encoding_fn_dir=fm.MAX_BANDS),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _rays(R, S, device, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-4.0, 4.0, (R, 3))
    d = rng.standard_normal((R, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    z = np.sort(rng.uniform(2.0, 6.0, (R, S)), axis=1)
    return [torch.from_numpy(a.astype(np.float32)).to(device) for a in (o, d, z)]


@pytest.mark.parametrize("kw", ARCHS)
@pytest.mark.parametrize("R,S,channels_first", [(2048, 64, True), (37, 5, False)])
def test_kernel_matches_plain(cuda, kw, R, S, channels_first):
    torch.manual_seed(0)
    model = FlexibleNeRFModel(**kw, compute_dtype=torch.bfloat16, device=cuda)
    packed = fm.pack_weights(model)
    o, d, z = _rays(R, S, cuda)
    before = fm.launches
    got = fm.fused_mlp_rays(packed, o, d, z, channels_first=channels_first)
    torch.cuda.synchronize()
    assert fm.launches == before + 1
    ref = fm.fused_mlp_plain(packed, o, d, z, channels_first=channels_first)
    assert got.shape == ref.shape and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, ref, atol=2e-2, rtol=2e-2)


def test_kernel_points_entry_and_empty_input(cuda):
    model = FlexibleNeRFModel(**LEGO, compute_dtype=torch.bfloat16, device=cuda)
    o, d, _ = _rays(50, 1, cuda)
    got = fm.fused_flexible_apply(model, o, d)
    z = torch.zeros((50, 1), device=cuda)
    ref = fm.fused_mlp_plain(fm.pack_weights(model), o, d, z, channels_first=False)
    torch.testing.assert_close(got, ref.reshape(50, 4), atol=2e-2, rtol=2e-2)
    before = fm.launches
    empty = fm.fused_mlp_cuda(fm.pack_weights(model), o[:0], d[:0], z[:0])
    assert empty.shape == (4, 0, 1) and fm.launches == before
