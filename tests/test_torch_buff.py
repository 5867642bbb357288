"""The port's BuFF slice (nerfmeshes_tpu_torch/buff/) against the JAX
package's, on the CPU.

Weights start in JAX and are carried across with state_dict_from_flax;
rays, memm and integration inputs are made with numpy from a seed.
Tolerances:
- tree: the initial leaves, the consolidated leaves and the serialized
  dict are equal; `integrate` within rtol 1e-5 (scatter-add against JAX's
  one-hot contraction: sums in other orders).
- sampler: the compaction is bitwise equal (tests/test_torch_chords.py),
  but downstream it cannot be: torch.cumsum sums in another order than
  JAX's CPU cumsum. So z_vals agree within 1e-5 * far; ray_mask and
  dropped are exact; voxel_idx is exact except where a sample lies within
  1e-5 * far of a chord end, where the order of the sums may move it into
  the neighbouring chord.
- renders: f32 nn.Module path at deterministic settings, rgb within rtol
  1e-4; bf16 with the fused kernels (JAX: Pallas interpreted; the port:
  the plain versions) within 2e-2, the bar of tests/test_fused_mlp.py:37.
- one BuFF step's grads against jax.grad of the JAX loss (f32, perturb
  off, sigma noise 0): each grad within 1e-4 of its max, as
  tests/test_torch_train.py holds the hierarchical step.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfmeshes_tpu.buff import system as j_buff
from nerfmeshes_tpu.buff import tree as j_tree
from nerfmeshes_tpu.config import get_default_cfg, load_config
from nerfmeshes_tpu.ops.math import img2mse as j_img2mse
from nerfmeshes_tpu.train import render as j_render
from nerfmeshes_tpu.train import system as j_system
from nerfmeshes_tpu_torch.buff import system as t_buff
from nerfmeshes_tpu_torch.buff import tree as t_tree
from nerfmeshes_tpu_torch.data.blender import train_arrays
from nerfmeshes_tpu_torch.models.transplant import state_dict_from_flax
from nerfmeshes_tpu_torch.ops.kernels import chords as tc
from nerfmeshes_tpu_torch.ops.kernels import fused_mlp as fm
from nerfmeshes_tpu_torch.train import factory as t_factory
from nerfmeshes_tpu_torch.train import render as t_render
from nerfmeshes_tpu_torch.train import step as t_step
from nerfmeshes_tpu_torch.train import system as t_system

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SCENE = REPO / "data" / "hard_blender"
CPU = torch.device("cpu")
SMALL = dict(num_layers=4, hidden_size=128, skip_step=2, num_encoding_fn_xyz=4,
             num_encoding_fn_dir=2)
FAR = 6.0
Z_TOL = 1e-5 * FAR


def buff_cfg(outer=4, max_voxels=256, **tree):
    """The JAX schema with BuFF at a small width (tests/test_buff.py:26)."""
    cfg = get_default_cfg()
    cfg.experiment.model = "BuFFModel"
    cfg.models.use_fine = False
    cfg.models.coarse.update(SMALL)
    cfg.tree.subdivision_outer_count = outer
    cfg.tree.max_voxel_count = max_voxels
    cfg.tree.step_size_integration_offset = 10
    cfg.tree.step_size_tree = 20
    cfg.nerf.train.num_coarse = 16
    cfg.nerf.validation.num_coarse = 16
    for k, v in tree.items():
        cfg.tree[k] = v
    return cfg


def scene_rays(R, seed=0):
    """Origins on the camera sphere (radius 4), aimed near the centre."""
    rng = np.random.default_rng(seed)
    o = rng.standard_normal((R, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = -o + rng.uniform(-1.5, 1.5, (R, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def leaves_of(tree):
    return [(leaf.lo.tolist(), leaf.hi.tolist(), leaf.depth) for leaf in tree.leaves]


def states_equal(t_state, j_state):
    for name in ("voxels", "active", "memm"):
        np.testing.assert_array_equal(getattr(t_state, name).numpy(),
                                      np.asarray(getattr(j_state, name)), err_msg=name)
    assert t_state.counter == int(j_state.counter)


# -- the tree ------------------------------------------------------------------------

@pytest.mark.parametrize("outer,max_voxels", [(4, 256), (12, 1536), (12, 4096)])
def test_initial_tree_matches_jax(outer, max_voxels):
    cfg = buff_cfg(outer, max_voxels)
    jt, tt = j_tree.TreeSampling(cfg), t_tree.TreeSampling(cfg)
    assert tt.capacity == jt.capacity == max(max_voxels, outer ** 3)
    assert leaves_of(tt) == leaves_of(jt)
    states_equal(tt.device_state(CPU), jt.device_state())


def test_consolidate_and_serialize_match_jax():
    """Three rounds from the same seeded memm (some voxels under eps, so
    both prune), at a cap that binds; the serialized dict and its
    round trip."""
    cfg = buff_cfg(4, 128, max_depth=4)
    jt, tt = j_tree.TreeSampling(cfg), t_tree.TreeSampling(cfg)
    rng = np.random.default_rng(0)
    for _ in range(3):
        memm = rng.uniform(0.0, 1.0, tt.capacity).astype(np.float32)
        memm[rng.uniform(size=tt.capacity) < 0.2] = 0.0
        j_state = jt.consolidate(memm)
        t_state = tt.consolidate(torch.from_numpy(memm), CPU)
        assert leaves_of(tt) == leaves_of(jt)
        states_equal(t_state, j_state)
    t_state.memm = torch.from_numpy(rng.uniform(0, 1, tt.capacity).astype(np.float32))
    t_state.counter = 7
    j_state = j_state._replace(memm=jnp.asarray(t_state.memm.numpy()),
                               counter=jnp.asarray(7, jnp.int32))
    got, want = tt.serialize(t_state), jt.serialize(j_state)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)
        assert got[key].dtype == np.asarray(want[key]).dtype, key
    fresh = t_tree.TreeSampling(cfg)
    again = fresh.deserialize(got, CPU)
    assert leaves_of(fresh) == leaves_of(tt)
    assert torch.equal(again.voxels, t_state.voxels) and torch.equal(again.memm, t_state.memm)
    assert again.counter == 7


def test_consolidate_refuses_to_prune_everything():
    tt = t_tree.TreeSampling(buff_cfg())
    with pytest.raises(RuntimeError, match="removed every voxel"):
        tt.consolidate(np.zeros(tt.capacity, np.float32), CPU)


def test_integrate_matches_jax():
    cfg = buff_cfg()
    j_state = j_tree.TreeSampling(cfg).device_state()
    t_state = t_tree.TreeSampling(cfg).device_state(CPU)
    rng = np.random.default_rng(0)
    R, S, V = 16, 8, 64  # ids over the active leaves of the 4^3 tree
    for _ in range(2):  # the running mean over two batches
        idx = rng.integers(0, V, size=(R, S)).astype(np.int32)
        w = rng.uniform(0, 1, size=(R, S)).astype(np.float32)
        mw = (rng.uniform(size=(R, S)) > 0.3).astype(np.float32)
        mask = rng.uniform(size=R) > 0.25
        j_state = j_tree.integrate(j_state, *(jnp.asarray(a) for a in (idx, w, mw, mask)))
        t_state = t_tree.integrate(t_state, *(torch.from_numpy(a) for a in (idx, w, mw, mask)))
    np.testing.assert_allclose(t_state.memm.numpy(), np.asarray(j_state.memm), rtol=1e-5,
                               atol=1e-7)
    assert t_state.counter == int(j_state.counter) == 3
    assert float(t_state.memm.abs().sum()) > 0


# -- the sampler -----------------------------------------------------------------------

def sampler_case(name):
    """(cfg, origins, dirs, near, far, max_chords) of a named case."""
    if name == "initial_4":
        cfg, R, near, far, cap = buff_cfg(), 48, 2.0, FAR, 0
    elif name == "initial_12_capacity_4096":  # JAX: its slab scan (V > 2048)
        cfg, R, near, far, cap = buff_cfg(12, 4096), 128, 2.0, FAR, 0
    elif name == "cap_binding":
        cfg, R, near, far, cap = buff_cfg(12, 1536), 32, 2.0, FAR, 4
    elif name == "per_ray_bounds":
        rng = np.random.default_rng(5)
        cfg, R, cap = buff_cfg(), 40, 0
        near = rng.uniform(1.5, 3.0, R).astype(np.float32)
        far = (near + rng.uniform(2.0, 3.0, R)).astype(np.float32)
    else:
        raise KeyError(name)
    o, d = scene_rays(R, seed=1)
    return cfg, o, d, near, far, cap


def chord_ends(o, d, voxels, ids):
    """Entry and exit t of the given voxels along each ray (numpy, f64)."""
    box = voxels[ids]  # (R, S, 2, 3)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (box - o[:, None, None, :]) / d[:, None, None, :]
    return np.nanmax(t.min(axis=2), axis=-1), np.nanmin(t.max(axis=2), axis=-1)


@pytest.mark.parametrize("name", ["initial_4", "initial_12_capacity_4096", "cap_binding",
                                  "per_ray_bounds"])
def test_ray_voxel_intersect_matches_jax(name):
    cfg, o, d, near, far, cap = sampler_case(name)
    S = 24
    j_state = j_tree.TreeSampling(cfg).device_state()
    t_state = t_tree.TreeSampling(cfg).device_state(CPU)
    as_j = (lambda x: jnp.asarray(x) if isinstance(x, np.ndarray) else x)
    as_t = (lambda x: torch.from_numpy(x) if isinstance(x, np.ndarray) else x)
    want = j_tree.ray_voxel_intersect(j_state.voxels, j_state.active, jnp.asarray(o),
                                      jnp.asarray(d), as_j(near), as_j(far),
                                      samples_count=S, max_chords=cap)
    before = tc.launches
    got = t_tree.ray_voxel_intersect(t_state.voxels, t_state.active, torch.from_numpy(o),
                                     torch.from_numpy(d), as_t(near), as_t(far),
                                     samples_count=S, max_chords=cap)
    assert tc.launches == before
    z_w, idx_w, mask_w, drop_w = (np.asarray(a) for a in want)
    z_g, idx_g, mask_g, drop_g = (a.numpy() for a in got)
    assert z_g.shape == (o.shape[0], S) and idx_g.dtype == np.int32
    np.testing.assert_array_equal(mask_g, mask_w)
    np.testing.assert_array_equal(drop_g, drop_w)
    assert mask_g.any() and (not cap or drop_g.sum() > 0)
    np.testing.assert_allclose(z_g, z_w, atol=Z_TOL, rtol=0)
    moved = idx_g != idx_w
    if moved.any():
        voxels = t_state.voxels.numpy().astype(np.float64)
        t_in, t_out = chord_ends(o.astype(np.float64), d.astype(np.float64), voxels, idx_w)
        gap = np.minimum(np.abs(z_w - t_in), np.abs(z_w - t_out))
        assert (gap[moved] <= Z_TOL).all(), f"{moved.sum()} samples moved away from a chord end"
    assert moved.mean() < 0.01


def test_random_sampler_is_not_ported_yet():
    """Once a "not ported" check: the random sampler now runs, from a
    generator (without one it raises, as JAX's does without a key), and
    never reaches the chord compaction."""
    state = t_tree.TreeSampling(buff_cfg()).device_state(CPU)
    o, d = (torch.from_numpy(a) for a in scene_rays(4))
    with pytest.raises(ValueError, match="generator"):
        t_tree.ray_voxel_intersect(state.voxels, state.active, o, d, 2.0, FAR, samples_count=8,
                                   use_random_sampling=True)

    def no_compaction(*args, **kwargs):
        raise AssertionError("the random sampler ran the chord compaction")

    z, idx, mask, dropped = t_tree.ray_voxel_intersect(
        state.voxels, state.active, o, d, 2.0, FAR, samples_count=8, use_random_sampling=True,
        compact=no_compaction, generator=torch.Generator().manual_seed(0))
    assert z.shape == idx.shape == (4, 8) and idx.dtype == torch.int32
    assert mask.all() and not dropped.any()


def random_case(seed=0, R=48, per_ray=False):
    """A 4^3 tree with every third voxel inactive, rays of which some miss
    it, near/far scalars or per ray."""
    cfg = buff_cfg()
    state = t_tree.TreeSampling(cfg).device_state(CPU)
    active = np.arange(state.active.shape[0]) % 3 != 0
    state.active = torch.from_numpy(active) & state.active
    o, d = scene_rays(R, seed=seed)
    d[: R // 6] *= -1.0  # aimed away: these miss the tree
    near, far = 2.0, FAR
    if per_ray:
        rng = np.random.default_rng(seed + 1)
        near = rng.uniform(1.5, 3.0, R).astype(np.float32)
        far = (near + rng.uniform(2.0, 3.5, R)).astype(np.float32)
    return cfg, state, o, d, near, far


@pytest.mark.parametrize("per_ray", [False, True], ids=["scalar_bounds", "per_ray_bounds"])
def test_random_sampler_keeps_jax_invariants(per_ray):
    """Samples sorted by depth, each inside the chord of a voxel its ray
    hits (the slab test's own chord, to 1e-6 * far); ray_mask equal to
    JAX's; dropped all zero; with several ray chunks (RANDOM_SLAB_PAIRS
    cut small) the same samples."""
    cfg, state, o, d, near, far = random_case(per_ray=per_ray)
    S = 32
    as_t = (lambda x: torch.from_numpy(x) if isinstance(x, np.ndarray) else x)
    as_j = (lambda x: jnp.asarray(x) if isinstance(x, np.ndarray) else x)
    args = (state.voxels, state.active, torch.from_numpy(o), torch.from_numpy(d), as_t(near),
            as_t(far))
    got = t_tree.ray_voxel_intersect(*args, samples_count=S, use_random_sampling=True,
                                     generator=torch.Generator().manual_seed(1))
    z, idx, mask, dropped = (a.numpy() for a in got)
    want = j_tree.ray_voxel_intersect(jnp.asarray(state.voxels.numpy()),
                                      jnp.asarray(state.active.numpy()), jnp.asarray(o),
                                      jnp.asarray(d), as_j(near), as_j(far), samples_count=S,
                                      use_random_sampling=True, key=jax.random.key(1))
    np.testing.assert_array_equal(mask, np.asarray(want[2]))
    assert 0 < mask.sum() < len(mask)
    assert not dropped.any() and not np.asarray(want[3]).any()
    hit_z = np.where(mask[:, None], z, 0.0)
    assert (np.diff(hit_z, axis=1) >= 0).all()
    inv = 1.0 / torch.from_numpy(d)
    bounds = [x[:, None] if isinstance(x, torch.Tensor) and x.dim() else x
              for x in (as_t(near), as_t(far))]
    smask, tmin, tmax = tc.slab_test(state.voxels, state.active, torch.from_numpy(o), inv,
                                     inv < 0.0, *bounds)
    rows = np.nonzero(mask)[0]
    idx_h = torch.from_numpy(idx[rows].astype(np.int64))
    assert torch.gather(smask[rows], 1, idx_h).all()
    lo = torch.gather(tmin[rows], 1, idx_h).numpy()
    hi = torch.gather(tmax[rows], 1, idx_h).numpy()
    tol = 1e-6 * FAR
    assert ((z[rows] >= lo - tol) & (z[rows] <= hi + tol)).all()
    # The chunking over rays changes nothing.
    small = t_tree.RANDOM_SLAB_PAIRS
    try:
        t_tree.RANDOM_SLAB_PAIRS = 7 * state.voxels.shape[0]
        again = t_tree.ray_voxel_intersect(*args, samples_count=S, use_random_sampling=True,
                                           generator=torch.Generator().manual_seed(1))
    finally:
        t_tree.RANDOM_SLAB_PAIRS = small
    for a, b in zip(got, again):
        assert torch.equal(a, b)


def test_random_sampler_draws_uniformly_like_jax():
    """The voxel draws of both samplers on the same rays, pooled into
    (ray, voxel) bins: each is uniform over its ray's hit voxels (a
    chi-square test against that expectation) and the two histograms
    agree (a two-sample chi-square test); p-values above 1e-3. A ray
    that hits nothing draws uniformly over all V voxels in both, inactive
    ones included."""
    from scipy import stats

    cfg, state, o, d, near, far = random_case(seed=4, R=24)
    S = 512
    got = t_tree.ray_voxel_intersect(state.voxels, state.active, torch.from_numpy(o),
                                     torch.from_numpy(d), near, far, samples_count=S,
                                     use_random_sampling=True,
                                     generator=torch.Generator().manual_seed(2))
    want = j_tree.ray_voxel_intersect(jnp.asarray(state.voxels.numpy()),
                                      jnp.asarray(state.active.numpy()), jnp.asarray(o),
                                      jnp.asarray(d), near, far, samples_count=S,
                                      use_random_sampling=True, key=jax.random.key(2))
    mask = got[2].numpy()
    V = state.voxels.shape[0]
    inv = 1.0 / torch.from_numpy(d)
    smask = tc.slab_test(state.voxels, state.active, torch.from_numpy(o), inv, inv < 0.0,
                         near, far)[0].numpy()

    def hist(ids):
        h = np.zeros((len(o), V), np.int64)
        for r in range(len(o)):
            h[r] = np.bincount(ids[r], minlength=V)
        return h

    h_t, h_j = hist(got[1].numpy()), hist(np.asarray(want[1]))
    hit = mask
    for h in (h_t, h_j):
        assert (h[hit][~smask[hit]] == 0).all()  # never a missed voxel on a hitting ray
        expected = np.where(smask[hit], S / smask[hit].sum(1, keepdims=True), 0.0)
        cells = smask[hit]
        chi = (((h[hit] - expected) ** 2)[cells] / expected[cells]).sum()
        dof = int(cells.sum()) - int(hit.sum())
        assert stats.chi2.sf(chi, dof) > 1e-3
        # Rays without a hit: every voxel, active or not, is a candidate.
        miss = h[~hit].sum(0)
        chi_m = ((miss - miss.sum() / V) ** 2 / (miss.sum() / V)).sum()
        assert stats.chi2.sf(chi_m, V - 1) > 1e-3
        assert miss[~state.active.numpy()].sum() > 0
    both = (h_t + h_j)[hit] > 0
    chi2 = (((h_t - h_j)[hit] ** 2)[both] / (h_t + h_j)[hit][both]).sum()
    assert stats.chi2.sf(chi2, int(both.sum()) - int(hit.sum())) > 1e-3


# -- renders and one step ------------------------------------------------------------------

def both_models(cfg):
    jc, _ = j_system.create_models(cfg)
    params = j_system.init_params(cfg, jc, None, jax.random.key(0))
    tc_model, _ = t_system.create_models(cfg)
    tc_model.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params["coarse"]), dict(cfg.models.coarse)))
    return jc, params, tc_model


@pytest.mark.parametrize("dtype,fused", [("float32", False), ("bfloat16", True)])
def test_buff_render_rays_matches_jax(dtype, fused):
    cfg = buff_cfg()
    cfg.experiment.compute_dtype = dtype
    cfg.experiment.use_fused_kernel = fused
    jc, params, tm = both_models(cfg)
    j_state = j_tree.TreeSampling(cfg).device_state()
    t_state = t_tree.TreeSampling(cfg).device_state(CPU)
    # Half the tree inactive: some rays miss it and take the stratified samples.
    active = np.arange(t_state.active.shape[0]) % 2 == 0
    j_state = j_state._replace(active=jnp.asarray(active) & j_state.active)
    t_state.active = torch.from_numpy(active) & t_state.active
    o, d = scene_rays(64, seed=2)
    settings_j = j_render.RenderSettings.from_cfg(cfg, train=False)
    settings_t = t_render.RenderSettings.from_cfg(cfg, train=False)
    want = j_buff.buff_render_rays(jc, params["coarse"], j_state, jnp.asarray(o), jnp.asarray(d),
                                   2.0, FAR, settings_j, train=False, use_random_sampling=False)
    before = (fm.launches, tc.launches)
    with torch.no_grad():
        got = t_buff.buff_render_rays(tm, t_state, torch.from_numpy(o), torch.from_numpy(d),
                                      2.0, FAR, settings_t, train=False)
    assert (fm.launches, tc.launches) == before
    mask = got[2].numpy()
    np.testing.assert_array_equal(mask, np.asarray(want[2]))
    assert 0 < mask.sum() < len(mask)
    if dtype == "float32":
        np.testing.assert_allclose(got[0].rgb_map.numpy(), np.asarray(want[0].rgb_map),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(got[0].acc_map.numpy(), np.asarray(want[0].acc_map),
                                   rtol=1e-4, atol=1e-6)
    else:
        np.testing.assert_allclose(got[0].rgb_map.numpy(), np.asarray(want[0].rgb_map),
                                   atol=2e-2, rtol=0)


def test_training_render_without_a_generator_draws_from_seed_0():
    """JAX's BuFF render falls back to jax.random.key(0) without a key
    (nerfmeshes_tpu/buff/system.py:62-64); the port falls back to a
    generator seeded 0 on the rays' device, so a training render with
    jitter and noise runs and equals the same render given that generator."""
    cfg = buff_cfg()
    cfg.nerf.train.perturb = True
    cfg.nerf.train.radiance_field_noise_std = 0.5
    _, _, tm = both_models(cfg)
    t_state = t_tree.TreeSampling(cfg).device_state(CPU)
    active = np.arange(t_state.active.shape[0]) % 2 == 0
    t_state.active = torch.from_numpy(active) & t_state.active
    o, d = (torch.from_numpy(a) for a in scene_rays(32, seed=3))
    settings = t_render.RenderSettings.from_cfg(cfg, train=True)
    assert settings.perturb and settings.radiance_field_noise_std > 0.0
    with torch.no_grad():
        got = t_buff.buff_render_rays(tm, t_state, o, d, 2.0, FAR, settings, train=True)
        want = t_buff.buff_render_rays(tm, t_state, o, d, 2.0, FAR, settings, train=True,
                                       generator=torch.Generator(CPU).manual_seed(0))
        other = t_buff.buff_render_rays(tm, t_state, o, d, 2.0, FAR, settings, train=True,
                                        generator=torch.Generator(CPU).manual_seed(1))
    assert 0 < int(got[2].sum()) < len(got[2])
    for name in ("rgb_map", "depth_map", "acc_map"):
        torch.testing.assert_close(getattr(got[0], name), getattr(want[0], name),
                                   rtol=0, atol=0)
    assert not torch.equal(got[0].rgb_map, other[0].rgb_map)


def test_buff_step_grads_match_jax():
    """f32, perturb off, sigma noise 0: the loss and every grad of one BuFF
    step against jax.grad of the JAX loss, from the same weights and rays."""
    cfg = buff_cfg()
    cfg.experiment.compute_dtype = "float32"
    cfg.experiment.use_fused_kernel = False
    cfg.nerf.train.perturb = False
    cfg.nerf.train.radiance_field_noise_std = 0.0
    jc, params, tm = both_models(cfg)
    j_state = j_tree.TreeSampling(cfg).device_state()
    t_state = t_tree.TreeSampling(cfg).device_state(CPU)
    o, d = scene_rays(48, seed=3)
    t = np.random.default_rng(4).uniform(0, 1, (48, 3)).astype(np.float32)
    settings = j_render.RenderSettings.from_cfg(cfg, train=True)

    def loss_fn(p):
        bundle = j_buff.buff_render_rays(jc, p, j_state, jnp.asarray(o), jnp.asarray(d), 2.0,
                                         FAR, settings, train=True, use_random_sampling=False,
                                         key=jax.random.key(0))[0]
        return j_img2mse(bundle.rgb_map, jnp.asarray(t))

    want_loss, grads = jax.value_and_grad(loss_fn)(params["coarse"])
    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, grads), dict(cfg.models.coarse))
    loss, metrics, aux = t_buff.buff_train_loss(
        cfg, tm, t_state, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t), 2.0, FAR)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-5)
    got = dict(tm.named_parameters())
    assert set(got) == set(want)
    for name in want:
        scale = float(want[name].abs().max())
        err = float((got[name].grad - want[name]).abs().max())
        assert err <= 1e-4 * scale, f"{name}: {err} vs max {scale}"
    assert set(metrics) == {"train/loss", "train/psnr", "train/rgb_sum", "train/dropped_chords"}
    assert float(metrics["train/dropped_chords"]) == 0.0
    assert set(aux) == {"weights", "mask_weights", "voxel_idx", "ray_mask"}


def test_dropped_chords_sum_over_a_call():
    """A call's train/dropped_chords is the sum over its steps
    (nerfmeshes_tpu/buff/system.py:275-277), and past the integration
    offset every step integrates."""
    cfg = buff_cfg(max_chords_per_ray=2, step_size_integration_offset=0)
    cfg.nerf.train.num_random_rays = 32
    cfg.experiment.compute_dtype = "float32"
    cfg.experiment.use_fused_kernel = False
    data = train_arrays(cfg_with_scene(cfg), CPU, split="val")
    H, W, focal = data["hwf"]

    def run(steps):
        system = t_system.NeRFSystem(cfg_with_scene(cfg), device=CPU)
        step = t_buff.make_buff_train_step(cfg, H=H, W=W, focal=focal, steps_per_call=steps)
        tree = t_tree.TreeSampling(cfg).device_state(CPU)
        state, tree, metrics = step(system.state, tree, data)
        return state, tree, metrics

    state1, tree1, one = run(1)
    state4, tree4, four = run(4)
    assert state4.step == 4 and tree4.counter == 5 and tree1.counter == 2
    assert float(one["train/dropped_chords"]) > 0
    assert float(four["train/dropped_chords"]) > 1.5 * float(one["train/dropped_chords"])


# -- the system -----------------------------------------------------------------------------

def cfg_with_scene(cfg):
    cfg = cfg.clone()
    cfg.dataset.basedir = str(SCENE)
    cfg.experiment.validate_every = 0
    return cfg


def tiny_system_cfg():
    cfg = cfg_with_scene(buff_cfg(step_size_integration_offset=4, step_size_tree=4, eps=1e-6,
                                  max_chords_per_ray=2))
    cfg.nerf.train.num_random_rays = 32
    cfg.nerf.train.num_coarse = 8
    cfg.nerf.validation.num_coarse = 8
    cfg.nerf.validation.chunksize = 24
    cfg.experiment.steps_per_call = 2
    cfg.experiment.print_every = 4
    cfg.optimizer.lr = 5e-4
    return cfg


def test_buff_system_consolidates_grows_its_cap_and_renders_the_fresh_tree(capsys):
    cfg = tiny_system_cfg()
    system = t_buff.BuFFSystem(cfg, device=CPU).setup(train_arrays(cfg, CPU, split="val"))
    assert system.fine is None and cfg.models.use_fine is False
    assert system.cfg is not cfg and system._effective_max_chords() == 2
    voxels0 = system.tree_state.voxels.clone()
    before = (fm.launches, fm.bwd_launches, tc.launches)
    metrics = system.fit(12)
    assert (fm.launches, fm.bwd_launches, tc.launches) == before
    assert system.state.step == 12
    # Boundaries at offset + k * step_size_tree: steps 8 and 12.
    assert system.consolidation_steps == [8, 12]
    assert not torch.equal(system.tree_state.voxels, voxels0)
    assert system.tree_state.counter == 1  # reset by the last consolidation
    assert len(system.tree.leaves) > 64  # subdivided
    # The cap of 2 binds on the 4^3 grid: it grew, within the ceiling.
    assert 2 < system._effective_max_chords() <= system._chord_cap_ceiling()
    assert "doubling the cap" in capsys.readouterr().out
    assert np.isfinite(metrics["train/loss"]) and "train/dropped_chords" in metrics
    # Renders read the current tree: equal to a direct render on it, and
    # different once the tree is emptied.
    o, d = scene_rays(40, seed=6)
    out = system.query_rays(o, d, 2.0, FAR, fields=("rgb_map", "depth_map"))
    settings = t_render.RenderSettings.from_cfg(system.cfg, train=False)
    with torch.no_grad():
        direct = t_buff.buff_render_rays(system.coarse, system.tree_state, torch.from_numpy(o),
                                         torch.from_numpy(d), 2.0, FAR, settings, train=False,
                                         max_chords=system._effective_max_chords())[0]
    np.testing.assert_array_equal(out.rgb_map, direct.rgb_map.numpy())
    system.tree_state = system.tree_state.replace(
        active=torch.zeros_like(system.tree_state.active))
    emptied = system.query_rays(o, d, 2.0, FAR, fields=("rgb_map", "depth_map"))
    assert not np.allclose(out.depth_map, emptied.depth_map)
    assert system.query_rgb(o, d, 2.0, FAR, chunk=16).shape == (40, 3)
    aabbs = system.mesh_mask_aabbs()
    assert aabbs.shape == (len(system.tree.leaves), 2, 3)


def test_buff_system_trains_and_renders_with_the_random_sampler(monkeypatch):
    """tree.use_random_sampling with RMSprop: the system trains through a
    consolidation and renders, the chord compaction never runs, the loss
    is finite, and an eval render (no generator: one seeded 0) repeats."""
    cfg = tiny_system_cfg()
    cfg.tree.use_random_sampling = True
    cfg.optimizer.type = "RMSprop"

    def no_compaction(*args, **kwargs):
        raise AssertionError("the random sampler ran the chord compaction")

    monkeypatch.setattr(tc, "compact_chords_plain", no_compaction)
    system = t_buff.BuFFSystem(cfg, device=CPU).setup(train_arrays(cfg, CPU, split="val"))
    before = (fm.launches, fm.bwd_launches, tc.launches)
    metrics = system.fit(8)
    assert (fm.launches, fm.bwd_launches, tc.launches) == before
    assert system.consolidation_steps == [8]
    assert np.isfinite(metrics["train/loss"]) and metrics["train/dropped_chords"] == 0.0
    o, d = scene_rays(40, seed=6)
    first = system.query_rays(o, d, 2.0, FAR, fields=("rgb_map",))
    second = system.query_rays(o, d, 2.0, FAR, fields=("rgb_map",))
    np.testing.assert_array_equal(first.rgb_map, second.rgb_map)
    assert np.isfinite(first.rgb_map).all()


def test_chord_cap_stops_at_its_ceiling(capsys):
    cfg = tiny_system_cfg()
    cfg.tree.max_chord_cap = 2
    system = t_buff.BuFFSystem(cfg, device=CPU).setup(train_arrays(cfg, CPU, split="val"))
    metrics = system.fit(4)
    assert system._effective_max_chords() == 2
    assert np.isfinite(metrics["train/loss"])
    assert "ceiling" in capsys.readouterr().out


def test_build_system_picks_the_class():
    cfg = cfg_with_scene(buff_cfg())
    assert type(t_factory.build_system(cfg, device=CPU)) is t_buff.BuFFSystem
    cfg.experiment.model = "NeRFModel"
    assert type(t_factory.build_system(cfg, device=CPU)) is t_system.NeRFSystem
    cfg.experiment.model = "Nope"
    with pytest.raises(ValueError, match="Nope"):
        t_factory.build_system(cfg, device=CPU)


def test_entry_points_default_to_the_card(monkeypatch):
    """Without a device the port runs on the card; with no card it says to
    pass device='cpu' instead of falling back to the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = cfg_with_scene(buff_cfg())
    for make in (lambda: t_system.NeRFSystem(cfg), lambda: t_buff.BuFFSystem(cfg),
                 lambda: t_factory.build_system(cfg), lambda: train_arrays(cfg, split="val"),
                 lambda: t_step.init_train_state(None, None, None, 0)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert t_system.NeRFSystem(cfg, device="cpu").device == CPU
    assert train_arrays(cfg, "cpu", split="val")["targets"].device == CPU


# -- the smoke's configuration --------------------------------------------------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_buff_cfg_is_buff_hard_250k():
    """chip_smoke.py's in-code BuFF settings equal configs/buff-hard-250k.yml
    field by field where they define the workload (the model, optimizer,
    scheduler, nerf and tree sections, seed, dtype, system); the dataset
    (data/hard_blender's 400^2 images instead of the procedural 800^2
    scene), the consolidation schedule (200 instead of 6000), validation,
    steps per call and printing are the smoke's cuts."""
    smoke = _chip_smoke()
    got = smoke.buff_hard_cfg()
    want = load_config(str(REPO / "configs" / "buff-hard-250k.yml"))
    for section in ("models", "optimizer", "scheduler", "nerf"):
        assert got[section].to_dict() == want[section].to_dict(), section
    for key, value in want.tree.to_dict().items():
        if key in ("step_size_integration_offset", "step_size_tree"):
            assert got.tree[key] == smoke.BUFF_TREE_STEP == 200
        else:
            assert got.tree[key] == value, key
    for key in ("randomseed", "compute_dtype", "model", "use_early_stopping"):
        assert got.experiment[key] == want.experiment[key], key
    assert got.dataset.type == "blender" and Path(got.dataset.basedir) == SCENE
    assert (got.dataset.near, got.dataset.far) == (want.dataset.near, want.dataset.far)
    assert got.dataset.white_background == want.dataset.white_background
    assert got.experiment.validate_every == 0 and got.experiment.steps_per_call == 1


def test_chip_smoke_chord_reads_are_the_stated_shapes():
    """The chord kernel's timed reads in chip_smoke.py (and
    scripts/torch_chords_ab.py) are the shapes PERF.md names: 2048 rays on
    the consolidated tree (4095 of 4096 active) and on the padded initial
    12^3 tree (1728 active), the 65536-ray appearance chunk; its bitwise
    cases include a sparse active set and a 20,000-box table, past one
    shared-memory stage of the kernel (7232 boxes)."""
    smoke = _chip_smoke()
    inputs = smoke._chord_inputs(CPU)
    shapes = {name: (args[3].shape[0], args[0].shape[0], int(args[1].sum()))
              for name, args in smoke.chord_timed_cases(inputs).items()}
    assert shapes == {"train": (2048, 4096, 4095), "initial": (2048, 4096, 1728),
                      "chunk": (65536, 4096, 4095)}
    assert 0 < int(inputs["sparse"].sum()) < 4095 // 5
    voxels, active = inputs["large"]
    assert voxels.shape == (20000, 2, 3) and int(active.sum()) > 7232


def test_buff_system_logs_the_tree_around_each_consolidation(tmp_path):
    """With a logger, each consolidation writes the "Tree" mesh and the
    "Tree Memm" image twice: at the step (the tree about to be pruned and
    subdivided) and at the step + 1 (the new tree, memm reset); each mesh
    holds the active voxels only. Training is the same with or without."""
    from nerfmeshes_tpu_torch.config.paths import ExperimentPaths
    from nerfmeshes_tpu_torch.utils.tb_events import event_files, read_events

    cfg = tiny_system_cfg()
    cfg.logging.use_projection = False
    data = train_arrays(cfg, CPU, split="val")
    paths = ExperimentPaths(tmp_path / "run").create()
    system = t_buff.BuFFSystem(cfg, paths, device=CPU).setup(data)
    logged = []
    real = system._log_tree

    def counted(step):
        logged.append((step, int(system.tree_state.active.sum())))
        real(step)

    system._log_tree = counted
    system.fit(12)
    assert system.consolidation_steps == [8, 12]
    assert [s for s, _ in logged] == [8, 9, 12, 13]
    events = [e for f in event_files(paths.events_dir) for e in read_events(f)[1:]
              if e["summary"][0]["tag"] in ("Tree_VERTEX", "Tree Memm")]
    trees = [(e["step"], e["summary"]) for e in events if e["summary"][0]["tag"] == "Tree_VERTEX"]
    memms = [e["step"] for e in events if e["summary"][0]["tag"] == "Tree Memm"]
    assert [s for s, _ in trees] == memms == [8, 9, 12, 13]
    for (step, values), (_, active) in zip(trees, logged):
        assert [v["tag"] for v in values] == ["Tree_VERTEX", "Tree_FACE", "Tree_COLOR"]
        assert values[0]["tensor"]["shape"] == [1, 8 * active, 3]
        assert values[1]["tensor"]["shape"] == [1, 12 * active, 3]
    assert logged[-1][1] == len(system.tree.leaves)
    plain = t_buff.BuFFSystem(cfg, device=CPU).setup(data)
    plain.fit(12)
    assert torch.equal(plain.tree_state.voxels, system.tree_state.voxels)
    assert torch.equal(plain.state.generator.get_state(), system.state.generator.get_state())
