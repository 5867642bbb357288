"""The mesh slice on the card: the sigma kernel against its plain version
(at the ragged edges of its 128-point tiles and past two persistent
waves) and against the forward kernel, bitwise repeats, a launch refused
for its shared memory, the grid evaluation without a host sync,
and a small export_marching_cubes on a CUDA NeRFSystem.

A CUDA kernel has no CPU mode, so these tests carry the `gpu` marker and
skip without a card. On a GPU host:

    python -m pytest tests/test_torch_mesh_gpu.py -m gpu --noconftest -q

(`--noconftest`: tests/conftest.py imports jax, which the GPU host does
not need.) Tolerances: kernel vs plain atol = rtol = 2e-2, the bf16 bar
of tests/test_fused_mlp.py:37; kernel vs forward kernel channel 3 within
1e-5 (the two share their trunk and alpha head code, so they agree bit
for bit on equal points).
"""

import math

import numpy as np
import pytest
import torch

from nerfmeshes_tpu_torch.config import get_default_cfg
from nerfmeshes_tpu_torch.mesh import extract
from nerfmeshes_tpu_torch.mesh.export import read_ply_binary
from nerfmeshes_tpu_torch.models import FlexibleNeRFModel
from nerfmeshes_tpu_torch.ops.kernels import build
from nerfmeshes_tpu_torch.ops.kernels import fused_mlp as fm
from nerfmeshes_tpu_torch.train.system import NeRFSystem

pytestmark = pytest.mark.gpu

LEGO = dict(num_layers=8, hidden_size=256, skip_step=4, num_encoding_fn_xyz=10,
            num_encoding_fn_dir=4)
ARCHS = [
    LEGO,
    dict(num_layers=4, hidden_size=128, skip_step=2, num_encoding_fn_xyz=4, num_encoding_fn_dir=2),
    dict(num_layers=10, hidden_size=128, skip_step=3, num_encoding_fn_xyz=4,
         num_encoding_fn_dir=2, include_input_xyz=False, log_sampling_xyz=False),
    # the edge of supports_fused: most layers and bands the kernel takes
    dict(LEGO, num_layers=fm.MAX_LAYERS, num_encoding_fn_xyz=fm.MAX_BANDS,
         num_encoding_fn_dir=fm.MAX_BANDS),
    dict(LEGO, hidden_size=128, num_layers=1, num_encoding_fn_xyz=1, num_encoding_fn_dir=1),
    # the wide widths (64-point tiles split in N), and the widest edge at 512
    dict(LEGO, hidden_size=384),
    dict(LEGO, hidden_size=512),
    dict(LEGO, hidden_size=512, num_layers=fm.MAX_LAYERS, num_encoding_fn_xyz=15),
]
ARCH_IDS = ["lego", "small", "deep-linear", "edge", "one-layer", "w384", "w512", "w512-edge"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _points(n, device, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(-1.2, 1.2, (n, 3)).astype(np.float32)).to(device)


def _model(kw, device):
    torch.manual_seed(0)
    return FlexibleNeRFModel(**kw, compute_dtype=torch.bfloat16, device=device)


@pytest.mark.parametrize("kw", ARCHS, ids=ARCH_IDS)
# Ragged edges of the 128-point tiles, more tiles than two persistent waves
# (40,000 points), and one grid tile of the mesh path (262,144).
@pytest.mark.parametrize("n", [0, 1, 63, 65, 127, 128, 129, 257, 40000, 262144])
def test_sigma_kernel_matches_plain(cuda, kw, n):
    packed = fm.pack_weights(_model(kw, cuda))
    pts = _points(n, cuda)
    before = fm.sigma_launches
    got = fm.fused_sigma_cuda(packed, pts)
    torch.cuda.synchronize()
    assert fm.sigma_launches == before + (1 if n else 0)
    want = fm.fused_sigma_plain(packed, pts)
    assert got.shape == want.shape == (n,) and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("kw", ARCHS, ids=ARCH_IDS)
def test_sigma_kernel_is_forward_channel3(cuda, kw):
    packed = fm.pack_weights(_model(kw, cuda))
    pts = _points(4099, cuda, seed=1)
    zeros = torch.zeros_like(pts)
    full = fm.fused_mlp_cuda(packed, pts, zeros, torch.zeros((4099, 1), device=cuda))[3, :, 0]
    sigma = fm.fused_sigma_cuda(packed, pts)
    torch.testing.assert_close(sigma, full, atol=1e-5, rtol=0)


def test_sigma_kernel_is_deterministic_and_stays_in_its_output(cuda):
    """Two launches agree bit for bit, and the C entry point writes n
    values into a longer buffer without touching the rest."""
    packed = fm.pack_weights(_model(LEGO, cuda))
    n = 40001
    pts = _points(n, cuda, seed=2)
    first = fm.fused_sigma_cuda(packed, pts)
    assert torch.equal(first, fm.fused_sigma_cuda(packed, pts))
    lib = build.load_library()
    out = torch.full((n + 3,), float("nan"), device=cuda)
    rc = lib.nm_fused_sigma(pts.data_ptr(), n, packed.weights.data_ptr(),
                            packed.biases.data_ptr(), packed.desc.ctypes.data, packed.desc.size,
                            packed.freqs.ctypes.data, packed.freqs.size, out.data_ptr(),
                            torch.cuda.current_stream().cuda_stream)
    build.check(lib, rc, "fused_sigma launch")
    torch.cuda.synchronize()
    assert torch.equal(out[:n], first) and bool(torch.isnan(out[n:]).all())


def test_sigma_kernel_refuses_what_its_shared_memory_cannot_hold(cuda):
    """A descriptor whose PE tiles leave no room for two weight stages is
    refused at launch and raises from the wrapper; nothing is launched."""
    packed = fm.pack_weights(_model(LEGO, cuda))
    desc = packed.desc.copy()
    desc[7] = 2048  # pxp: PE(xyz) 2048 columns wide, 512 KB of PE tiles
    before = fm.sigma_launches
    with pytest.raises(RuntimeError, match="fused_sigma launch failed"):
        fm.fused_sigma_cuda(packed._replace(desc=desc), _points(100, cuda))
    assert fm.sigma_launches == before


def _lego_system(device, **experiment):
    cfg = get_default_cfg()
    cfg.experiment.compute_dtype = "bfloat16"
    cfg.experiment.use_fused_kernel = True
    cfg.nerf.validation.chunksize = 4096
    for k, v in experiment.items():
        cfg.experiment[k] = v
    return NeRFSystem(cfg, device=device).setup_eval()


def test_host_arrays_render_on_the_system_device(cuda):
    """numpy rays and points go to the system's card (the JAX query_rays
    takes host arrays and renders on its device)."""
    system = _lego_system(cuda)
    rng = np.random.default_rng(0)
    o = rng.standard_normal((300, 3)).astype(np.float32)
    o = 4.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = -o / 4.0
    out = system.query_rays(o, d, 2.0, 6.0, fields=("rgb_map",))
    assert out.rgb_map.shape == (300, 3) and np.isfinite(out.rgb_map).all()
    rgb = system.query_rgb(o, d, 2.0, 6.0, chunk=256, as_uint8=True)
    assert rgb.dtype == np.uint8 and rgb.shape == (300, 3)
    pts = rng.uniform(-1, 1, (50, 3)).astype(np.float32)
    assert system.sample_points(pts, d[:50]).device.type == "cuda"
    assert system.density_points(pts).device.type == "cuda"


def test_density_packing_follows_an_optimizer_step(cuda):
    """The packing density_points reuses is made anew after Adam's in-place
    update of the weights on the card."""
    system = _lego_system(cuda)
    pts = _points(1000, cuda)
    before = system.density_points(pts)
    pack = system._sigma_pack()
    assert system._sigma_pack() is pack
    for p in system.finest_model.parameters():
        p.grad = torch.full_like(p, 1e-2)
    system.optimizer.step()
    assert system._sigma_pack() is not pack
    after = system.density_points(pts)
    assert not torch.equal(after, before)
    torch.testing.assert_close(after, fm.fused_sigma_plain(fm.pack_weights(system.finest_model),
                                                           pts), atol=2e-2, rtol=2e-2)


def test_grid_eval_never_waits_for_the_device(cuda):
    """Every tile's sigma launch and the block statistics enqueue without
    one device-to-host sync; one launch per 262,144-point tile."""
    system = _lego_system(cuda)
    extract._grid_tiles(system.density_points, 1.2, (8, 8, 8), 262144, cuda, torch.float32)
    torch.cuda.synchronize()  # first call: allocations, the kernel's attributes
    res, tile = 80, 262144  # 512,000 points: two tiles, the second ragged
    before = fm.sigma_launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        flat = extract._grid_tiles(system.density_points, 1.2, (res,) * 3, tile, cuda,
                                   torch.float32)
        stats, blocks3, sigma = extract._block_stats(flat, res, None)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert fm.sigma_launches - before == math.ceil(res ** 3 / tile) == 2
    assert stats.shape == (3,) and blocks3.shape == (3, 10, 10, 10)
    assert sigma.dtype == torch.float16 and bool(torch.isfinite(flat).all())


def test_export_marching_cubes_on_the_card(cuda, tmp_path):
    system = _lego_system(cuda)
    args = extract.MeshArgs(res=64, limit=1.2, batch_size=65536, save_dir=str(tmp_path),
                            mesh_name="mesh.ply")
    fm.launches = fm.sigma_launches = 0
    verts, tris, colors, normals = extract.export_marching_cubes(system, args)
    assert fm.sigma_launches == math.ceil(64 ** 3 / 262144) == 1
    chunks = math.ceil(len(verts) / 65536)
    assert fm.launches == 2 * chunks
    assert len(verts) > 0 and tris.min() >= 0 and tris.max() < len(verts)
    assert np.isfinite(verts).all() and np.isfinite(normals).all()
    np.testing.assert_allclose(np.linalg.norm(normals, axis=1), 1.0, atol=1e-3)
    assert colors.min() >= 0.0 and colors.max() <= 1.0
    v, t, n, c = read_ply_binary(str(tmp_path / "mesh.ply"))
    assert v.shape == verts.shape and t.shape == tris.shape and c.shape == verts.shape
