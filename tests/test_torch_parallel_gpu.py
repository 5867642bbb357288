"""Data parallelism on the card: chip_smoke.py's dist checks as tests.

The kernels have no CPU mode, so these tests carry the `gpu` marker and
skip without a card. On a GPU host:

    python -m pytest tests/test_torch_parallel_gpu.py -m gpu --noconftest -q

- A forced one-rank NCCL group against no group: a hierarchical and a
  BuFF step on one injected batch at lego width give bitwise equal grads
  and memm (BuFF's integrate under torch's deterministic algorithms).
- Two gloo ranks sharing the card, each on its 1024-ray half of the
  batch (chip_smoke.py:_dist_rank): the reduced grads within 1e-4 of max
  |grad| of one process's, BuFF's memm within 1e-5, a 400x400 view and
  the 480^3 sigma grid bit for bit, and each rank's launches as the code
  predicts (chip_smoke.py:check_dist_ranks).
"""

import json
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

pytestmark = pytest.mark.gpu


@pytest.fixture
def smoke():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import chip_smoke
    from nerfmeshes_tpu_torch.ops.kernels import build

    build.build_library()  # before any rank starts
    build.load_library()
    return chip_smoke


@pytest.mark.parametrize("buff", [False, True], ids=["hierarchical", "buff"])
def test_forced_nccl_one_rank_step_is_the_unforced_step(smoke, buff):
    import torch.distributed as dist

    from nerfmeshes_tpu_torch.parallel import mesh as pm

    group = pm.forced("cuda")
    try:
        cfg = smoke._dist_cfg(buff)
        batch = smoke._dist_batch(cfg, group.device)
        torch.use_deterministic_algorithms(True, warn_only=True)
        g_un, m_un = smoke._dist_step(cfg, batch, None, buff)
        g_fo, m_fo = smoke._dist_step(cfg, batch, group, buff)
    finally:
        torch.use_deterministic_algorithms(False)
        dist.destroy_process_group()
    assert torch.equal(g_un, g_fo)
    assert m_un is None or torch.equal(m_un, m_fo)


def test_two_gloo_ranks_share_the_card(smoke, tmp_path):
    from nerfmeshes_tpu_torch.parallel.mesh import launch

    device = torch.device("cuda", torch.cuda.current_device())
    launch(smoke._dist_rank, smoke.DIST_WORLD, device, backend="gloo", args=(str(tmp_path),))
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text())
             for r in range(smoke.DIST_WORLD)]
    want = smoke.check_dist_ranks(ranks, torch.cuda.get_device_name(0), device)
    assert want["render"]["fwd"] == 2 * 79 and want["grid"]["sigma"] == 422
