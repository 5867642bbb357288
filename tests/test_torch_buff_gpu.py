"""The chord-compaction CUDA kernel against its plain version, and the BuFF
slice on the card.

A CUDA kernel has no CPU mode, so these tests carry the `gpu` marker and
skip without a card. On a GPU host:

    python -m pytest tests/test_torch_buff_gpu.py -m gpu --noconftest -q

(`--noconftest`: tests/conftest.py imports jax, which the GPU host does
not need.) The kernel and compact_chords_plain do the same f32 arithmetic
per (ray, voxel) test and move each kept value unchanged, so they must
agree bit for bit (torch.equal), and so must two launches.
"""

import numpy as np
import pytest
import torch

from nerfmeshes_tpu_torch.buff import tree as t_tree
from nerfmeshes_tpu_torch.buff.system import BuFFSystem, buff_render_rays
from nerfmeshes_tpu_torch.config import get_default_cfg
from nerfmeshes_tpu_torch.ops.kernels import chords as tc
from nerfmeshes_tpu_torch.ops.kernels import fused_mlp as fm
from nerfmeshes_tpu_torch.train.render import RenderSettings

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def grid_voxels(n, lo=-2.0, hi=2.0):
    edges = np.linspace(lo, hi, n + 1, dtype=np.float32)
    return np.array([[[edges[i], edges[j], edges[k]], [edges[i + 1], edges[j + 1], edges[k + 1]]]
                     for i in range(n) for j in range(n) for k in range(n)], np.float32)


def voxel_set(V, device, seed=0):
    """V = 1: one box; 27: a 3^3 grid; 4096: a 16^3 grid, 70% active."""
    rng = np.random.default_rng(seed)
    vox = grid_voxels(round(V ** (1 / 3)))
    act = np.ones(V, bool) if V < 4096 else rng.uniform(size=V) < 0.7
    return torch.from_numpy(vox).to(device), torch.from_numpy(act).to(device)


def camera_rays(R, device, seed=0):
    """Origins on the radius-4 camera sphere, aimed near the centre."""
    rng = np.random.default_rng(seed)
    o = rng.standard_normal((R, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = -o + rng.uniform(-1.5, 1.5, (R, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return [torch.from_numpy(a.astype(np.float32)).to(device) for a in (o, d)]


def axis_aligned_rays(n, rng, lo=-2.0, hi=2.0, cells=16):
    """n rays along +-x, +-y or +-z from outside the [lo, hi]^3 grid; the
    other two origin coordinates lie on the grid's face planes or at cell
    centres, and the zero direction components are +0 or -0."""
    edges = np.linspace(lo, hi, cells + 1, dtype=np.float32)
    spots = np.concatenate([edges, (edges[:-1] + edges[1:]) / 2])
    axis = rng.integers(0, 3, n)
    sign = rng.choice([-1.0, 1.0], n).astype(np.float32)
    origins = rng.choice(spots, (n, 3)).astype(np.float32)
    origins[np.arange(n), axis] = 2.0 * lo * sign
    dirs = np.where(rng.uniform(size=(n, 3)) < 0.5, np.float32(0.0), np.float32(-0.0))
    dirs[np.arange(n), axis] = sign
    return origins, dirs.astype(np.float32)


def both(voxels, active, o, d, near, far, K):
    before = tc.launches
    got = tc.compact_chords(voxels, active, o, d, near, far, K=K)
    torch.cuda.synchronize()
    assert tc.launches == before + (1 if d.shape[0] else 0)
    want = tc.compact_chords_plain(voxels, active, o, d, near, far, K=K)
    for name, g, w in zip(tc.Chords._fields, got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert torch.equal(g, w), name
    return got


@pytest.mark.parametrize("V", [1, 27, 4096])
@pytest.mark.parametrize("K", [1, 7, 64, 256])
def test_kernel_matches_plain_bitwise(cuda, V, K):
    voxels, active = voxel_set(V, cuda)
    o, d = camera_rays(1003, cuda)  # ragged: not a multiple of the 16-ray tile
    got = both(voxels, active, o, d, 2.0, 6.0, min(K, V))
    if V > 1:
        assert int(got.n_hit.max()) > 1


@pytest.mark.parametrize("R", [0, 1, 31, 65536 + 3])
def test_kernel_ragged_ray_counts(cuda, R):
    voxels, active = voxel_set(4096, cuda)
    o, d = camera_rays(R, cuda, seed=1)
    both(voxels, active, o, d, 2.0, 6.0, 64)


def test_kernel_bounds_origins_and_axis_aligned_rays(cuda):
    voxels, active = voxel_set(4096, cuda)
    o, d = camera_rays(777, cuda, seed=2)
    rng = np.random.default_rng(3)
    near = torch.from_numpy(rng.uniform(1.0, 3.0, 777).astype(np.float32)).to(cuda)
    far = near + torch.from_numpy(rng.uniform(1.0, 4.0, 777).astype(np.float32)).to(cuda)
    both(voxels, active, o, d, near, far, 64)  # per-ray bounds
    both(voxels, active, o, d, torch.tensor(2.0, device=cuda), torch.tensor(6.0, device=cuda), 64)
    both(voxels, active, o[0], d, 0.0, 8.0, 64)  # one origin for all rays
    # Axis-aligned rays: zero direction components (+0 or -0) give
    # inv = +-inf, and (lo - o) * inf = NaN where a ray runs in a face
    # plane, so those rays hit nothing; rays through cell interiors hit.
    o_axis, d_axis = axis_aligned_rays(600, rng)
    got = both(voxels, active, torch.from_numpy(o_axis).to(cuda),
               torch.from_numpy(d_axis).to(cuda), 0.5, 8.0, 64)
    assert 0 < int((got.n_hit > 0).sum()) < 600


def test_cap_binds_and_two_launches_agree(cuda):
    voxels, active = voxel_set(4096, cuda)
    o, d = camera_rays(2048, cuda, seed=4)
    first = both(voxels, active, o, d, 2.0, 6.0, 8)
    assert int((first.n_hit > 8).sum()) > 0
    second = tc.compact_chords_cuda(voxels, active, o, d, 2.0, 6.0, K=8)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_kernel_refuses_mixed_devices_and_strided_inputs(cuda):
    voxels, active = voxel_set(27, cuda)
    o, d = camera_rays(16, cuda)
    with pytest.raises(ValueError, match="on cpu"):
        tc.compact_chords(voxels.cpu(), active, o, d, 2.0, 6.0, K=8)
    with pytest.raises(ValueError, match="on cpu"):
        tc.compact_chords(voxels, active, o, d, torch.zeros(16), 6.0, K=8)
    strided = torch.zeros((3, 16), device=cuda).t()
    strided.copy_(d)
    with pytest.raises(ValueError, match="contiguous"):
        tc.compact_chords_cuda(voxels, active, o, strided, 2.0, 6.0, K=8)
    before = tc.launches
    with pytest.raises(ValueError):
        tc.compact_chords_cuda(voxels.cpu(), active.cpu(), o.cpu(), d.cpu(), 2.0, 6.0, K=8)
    assert tc.launches == before


# The kernel stages the active voxels once per CTA and walks tiles of 16
# rays (csrc/chords.cu: RT), splitting the active list across the CTA's
# warps; a table past 7232 voxels (CV_MAX) is scanned in chunks.
RAY_TILE = 16


def _initial_tree(device):
    """The padded initial tree as TreeSampling.device_state builds it: a
    12^3 grid (1728 active) padded with inactive far boxes to 4096."""
    cfg = _buff_cfg()
    assert cfg.tree.subdivision_outer_count == 12
    return t_tree.TreeSampling(cfg).device_state(device)


def test_kernel_on_the_padded_initial_tree(cuda):
    state = _initial_tree(cuda)
    assert int(state.active.sum()) == 1728 and state.voxels.shape[0] == 4096
    o, d = camera_rays(2048, cuda, seed=6)
    got = both(state.voxels, state.active, o, d, 2.0, 6.0, 64)
    assert int(got.n_hit.max()) > 1
    assert int(got.ids_k.max()) < 1728  # pad boxes are never chords


def test_kernel_with_no_voxel_active(cuda):
    voxels, active = voxel_set(4096, cuda)
    o, d = camera_rays(300, cuda, seed=7)
    got = both(voxels, torch.zeros_like(active), o, d, 2.0, 6.0, 64)
    assert int(got.n_hit.abs().sum()) == 0
    assert bool((got.lo_k == tc.BIG).all() and (got.hi_k == tc.BIG).all())
    assert int(got.ids_k.abs().sum()) == 0


@pytest.mark.parametrize("K", [1, 64, 300])
def test_kernel_on_a_table_past_one_stage(cuda, K):
    """20,000 random boxes, 60% active: the chunked path, ranks carried
    across chunks; K 300 is past every ray's hits."""
    rng = np.random.default_rng(8)
    lo = rng.uniform(-2.0, 2.0, (20000, 3)).astype(np.float32)
    boxes = np.stack([lo, lo + rng.uniform(0.02, 0.3, (20000, 3)).astype(np.float32)], axis=1)
    voxels = torch.from_numpy(boxes).to(cuda)
    active = torch.from_numpy(rng.uniform(size=20000) < 0.6).to(cuda)
    o, d = camera_rays(500, cuda, seed=9)
    got = both(voxels, active, o, d, 2.0, 6.0, K)
    assert int(got.n_hit.max()) > 1
    if K == 300:
        assert int(got.n_hit.max()) < K
    if K > 1:  # chords come from more than one chunk of the table
        assert int(got.ids_k.max()) > 7232


def test_kernel_on_boxes_with_lo_above_hi(cuda):
    """A table where some boxes have lo > hi on an axis: the kernel's short
    test holds only for ordered boxes, so such a table takes the full one,
    with the same bits as the plain version; so does a NaN coordinate."""
    rng = np.random.default_rng(13)
    lo = rng.uniform(-2.0, 2.0, (3000, 3)).astype(np.float32)
    boxes = np.stack([lo, lo + rng.uniform(0.02, 0.6, (3000, 3)).astype(np.float32)], axis=1)
    flip = rng.uniform(size=3000) < 0.1
    axis = rng.integers(0, 3, 3000)
    boxes[flip, 0, axis[flip]], boxes[flip, 1, axis[flip]] = (boxes[flip, 1, axis[flip]],
                                                             boxes[flip, 0, axis[flip]])
    boxes[7, 0, 1] = np.nan
    voxels = torch.from_numpy(boxes).to(cuda)
    active = torch.ones(3000, dtype=torch.bool, device=cuda)
    o, d = camera_rays(700, cuda, seed=14)
    got = both(voxels, active, o, d, 0.0, 8.0, 64)
    assert int(got.n_hit.max()) > 1


@pytest.mark.parametrize("K", [1, 200])
def test_kernel_caps_of_one_and_past_every_hit(cuda, K):
    voxels, active = voxel_set(4096, cuda)
    o, d = camera_rays(1003, cuda, seed=10)
    got = both(voxels, active, o, d, 2.0, 6.0, K)
    if K == 1:
        assert int((got.n_hit > 1).sum()) > 0
    else:
        assert int(got.n_hit.max()) < K


@pytest.mark.parametrize("R", [1, RAY_TILE - 1, RAY_TILE + 1, 132 * RAY_TILE + 1])
def test_kernel_around_the_ray_tile(cuda, R):
    state = _initial_tree(cuda)
    o, d = camera_rays(R, cuda, seed=11)
    both(state.voxels, state.active, o, d, 2.0, 6.0, 64)


def test_two_launches_agree_at_the_appearance_chunk(cuda):
    voxels, active = voxel_set(4096, cuda)
    o, d = camera_rays(65536 + 3, cuda, seed=12)
    first = both(voxels, active, o, d, 2.0, 6.0, 64)
    second = tc.compact_chords_cuda(voxels, active, o, d, 2.0, 6.0, K=64)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def _buff_cfg(**tree):
    cfg = get_default_cfg()
    cfg.experiment.model = "BuFFModel"
    cfg.experiment.compute_dtype = "bfloat16"
    cfg.experiment.validate_every = 0
    cfg.nerf.train.num_random_rays = 256
    cfg.nerf.train.num_coarse = 64
    cfg.nerf.train.perturb = True
    cfg.nerf.validation.num_coarse = 64
    cfg.nerf.validation.chunksize = 4096
    cfg.tree.max_voxel_count = 4096
    cfg.tree.update(tree)
    return cfg


def _scene(device):
    rng = np.random.default_rng(0)
    poses = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    poses[:, 2, 3] = 4.0
    return {"targets": torch.from_numpy(rng.uniform(0, 1, (3, 8, 8, 3)).astype(np.float32)).to(device),
            "poses": torch.from_numpy(poses).to(device),
            "bounds": torch.tensor([2.0, 6.0], device=device), "hwf": (8, 8, 10.0)}


def test_buff_train_step_never_waits_for_the_device(cuda):
    """Two BuFF steps (ray batch, tree sampling through the chord kernel,
    the forward and backward kernels, Adam, integration into the tree) and
    the dropped-chords pipeline enqueue without one device-to-host sync."""
    cfg = _buff_cfg(step_size_integration_offset=0, step_size_tree=10 ** 6)
    cfg.experiment.steps_per_call = 2
    data = _scene(cuda)
    system = BuFFSystem(cfg, device=cuda).setup(data)
    system.state, metrics = system._train_fn(system.state, data)  # first call: allocations
    torch.cuda.synchronize()
    counts = (tc.launches, fm.launches, fm.bwd_launches)
    memm = system.tree_state.memm.clone()
    torch.cuda.set_sync_debug_mode("error")
    try:
        system.state, metrics = system._train_fn(system.state, data)
        system.on_step(system.state.step, metrics)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert (tc.launches - counts[0], fm.launches - counts[1], fm.bwd_launches - counts[2]) == (2, 2, 2)
    assert system.tree_state.counter == 5
    assert not torch.equal(system.tree_state.memm, memm)  # integration ran on the card
    assert np.isfinite(float(metrics["train/loss"]))
    system.on_step(system.state.step, metrics)
    assert not system._dropped_pending  # every counter read once its copy landed


def test_buff_render_chunk_is_the_plain_compaction_render(cuda):
    """A CUDA BuFF system renders each chunk with one chord and one forward
    launch, and the kernel's chords give the same render, bit for bit, as
    the plain compaction's."""
    cfg = _buff_cfg()
    system = BuFFSystem(cfg, device=cuda).setup_eval()
    o, d = camera_rays(5000, cuda, seed=5)
    before = (tc.launches, fm.launches)
    out = system.query_rays(o, d, 2.0, 6.0, fields=("rgb_map",), as_numpy=False)
    torch.cuda.synchronize()
    assert (tc.launches - before[0], fm.launches - before[1]) == (2, 2)  # 2 chunks of 4096
    settings = RenderSettings.from_cfg(system.cfg, train=False)
    with torch.inference_mode():
        plain = buff_render_rays(system.coarse, system.tree_state, o[:4096], d[:4096], 2.0, 6.0,
                                 settings, train=False, compact=tc.compact_chords_plain)[0]
    assert torch.equal(out.rgb_map[:4096], plain.rgb_map)
    ref = t_tree.ray_voxel_intersect(system.tree_state.voxels, system.tree_state.active, o, d,
                                     2.0, 6.0, samples_count=64)
    assert bool(ref.ray_mask.any())
