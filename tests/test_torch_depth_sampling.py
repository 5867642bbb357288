"""The port's depth-guided samplers (nerfmeshes_tpu_torch/ops/depth_sampling.py)
and ops/sampling.py's sorted_uniforms / merge_sorted, against the JAX
package's (nerfmeshes_tpu/ops/depth_sampling.py, tests/test_depth_sampling.py's
cases).

- The deterministic strategies (linear, proximal) and the deterministic
  branches of the others (depth_informed's rays with depth, surface_band's
  rays without) equal JAX's within 1e-6.
- merge_sorted equals JAX's exactly, ties included.
- The random draws (JAX and torch streams differ) pass distribution
  tests: sorted, inside their bounds, means within 3 sigma, and the order
  statistics' means k / (n + 1).
- The dispatcher's argument checks, and the extra-interval merge.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfmeshes_tpu.ops import depth_sampling as jds
from nerfmeshes_tpu.ops.sampling import merge_sorted as j_merge_sorted
from nerfmeshes_tpu_torch.ops import depth_sampling as ds
from nerfmeshes_tpu_torch.ops.sampling import merge_sorted, sorted_uniforms

torch.set_num_threads(1)
KEY = jax.random.key(7)
R, S = 32, 24
EMPTY = 5.0


def _depth_with_holes(seed=0):
    """Per-ray depth where every other ray is 'empty' (no surface)."""
    rng = np.random.default_rng(seed)
    depth = rng.uniform(2.5, 4.5, size=R).astype(np.float32)
    depth[::2] = EMPTY
    return depth


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("lindisp", [False, True])
@pytest.mark.parametrize("bounds", ["scalar", "per_ray"])
def test_linear_matches_jax(lindisp, bounds):
    near, far = (2.0, 6.0) if bounds == "scalar" else (
        np.linspace(1.0, 2.0, R, dtype=np.float32), np.linspace(5.0, 8.0, R, dtype=np.float32))
    got = ds.depth_guided_intervals("linear", near, far, R, S, lindisp=lindisp).numpy()
    want = np.asarray(jds.depth_guided_intervals("linear", near, far, R, S, lindisp=lindisp))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("lindisp", [False, True])
@pytest.mark.parametrize("off", [0.4, 1.0])
def test_proximal_matches_jax(lindisp, off):
    depth = _depth_with_holes(1)
    got = ds.proximal_intervals(torch.from_numpy(depth), 2.0, 6.0, S, empty=EMPTY, off=off,
                                lindisp=lindisp).numpy()
    want = np.asarray(jds.proximal_intervals(jnp.asarray(depth), 2.0, 6.0, S, empty=EMPTY,
                                             off=off, lindisp=lindisp))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    via = ds.depth_guided_intervals("proximal", 2.0, 6.0, R, S, depth=torch.from_numpy(depth),
                                    empty=EMPTY, lindisp=lindisp)
    if off == 0.4:
        np.testing.assert_array_equal(via.numpy(), got)


def test_depth_informed_guided_rays_match_jax():
    """Rays with depth: the linear ramp to depth + threshold, equal to
    JAX's; the others: sorted uniforms in [near, far]."""
    depth = _depth_with_holes(2)
    has = depth != EMPTY
    got = ds.depth_informed_intervals(_gen(), torch.from_numpy(depth), 2.0, 6.0, S,
                                      empty=EMPTY, threshold=0.5).numpy()
    want = np.asarray(jds.depth_informed_intervals(KEY, jnp.asarray(depth), 2.0, 6.0, S,
                                                   empty=EMPTY, threshold=0.5))
    np.testing.assert_allclose(got[has], want[has], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[has, -1], depth[has] + 0.5, rtol=1e-6)
    assert (np.diff(got, axis=-1) >= 0).all()
    assert (got[~has] >= 2.0).all() and (got[~has] <= 6.0).all()
    assert np.abs(got[~has] - np.linspace(2.0, 6.0, S)).max() > 1e-3  # random, not the ramp


def test_surface_band_plain_rays_match_jax():
    """Rays without depth: the plain linear ramp, equal to JAX's; the
    others: the jittered band, sorted, inside [(0-off)/fc2, (1-off)/fc2]."""
    depth = _depth_with_holes(3)
    has = depth != EMPTY
    fc2, off = 2.0, 0.5
    got = ds.surface_band_intervals(_gen(), torch.from_numpy(depth), 2.0, 6.0, S, empty=EMPTY,
                                    fc2=fc2, off=off).numpy()
    want = np.asarray(jds.surface_band_intervals(KEY, jnp.asarray(depth), 2.0, 6.0, S,
                                                 empty=EMPTY, fc2=fc2, off=off))
    np.testing.assert_allclose(got[~has], want[~has], rtol=1e-6, atol=1e-6)
    lo, hi = (0.0 - off) / fc2, (1.0 - off) / fc2
    assert (got[has] >= lo - 1e-6).all() and (got[has] <= hi + 1e-6).all()
    assert (np.diff(got, axis=-1) >= 0).all()


def test_random_intervals_sorted_bounded_per_ray_and_uniform():
    near = np.linspace(1.0, 2.0, R, dtype=np.float32)
    far = np.linspace(5.0, 8.0, R, dtype=np.float32)
    n_rays = 4096
    near_big = np.resize(near, n_rays)
    far_big = np.resize(far, n_rays)
    z = ds.random_intervals(_gen(1), near_big, far_big, n_rays, S).numpy()
    assert z.shape == (n_rays, S)
    assert (np.diff(z, axis=-1) >= 0).all()
    assert (z >= near_big[:, None]).all() and (z <= far_big[:, None]).all()
    u = (z - near_big[:, None]) / (far_big - near_big)[:, None]
    # Sample k of n sorted uniforms has mean k / (n + 1) and variance
    # k (n + 1 - k) / ((n + 1)^2 (n + 2)): each column's mean within 3 sigma.
    k = np.arange(1, S + 1)
    var = k * (S + 1 - k) / ((S + 1) ** 2 * (S + 2))
    assert (np.abs(u.mean(0) - k / (S + 1)) < 3 * np.sqrt(var / n_rays)).all()
    # JAX's law: its draws of the same shape have the same column means.
    zj = np.asarray(jds.random_intervals(KEY, near_big, far_big, n_rays, S))
    uj = (zj - near_big[:, None]) / (far_big - near_big)[:, None]
    assert (np.abs(uj.mean(0) - k / (S + 1)) < 3 * np.sqrt(var / n_rays)).all()


@pytest.mark.parametrize("n", [1, 5, 64])
def test_sorted_uniforms_have_the_order_statistic_means(n):
    rows = 20000
    u = sorted_uniforms(_gen(n), (rows, n)).numpy()
    assert u.shape == (rows, n) and u.dtype == np.float32
    assert (np.diff(u, axis=-1) >= 0).all() and (u > 0).all() and (u < 1).all()
    k = np.arange(1, n + 1)
    var = k * (n + 1 - k) / ((n + 1) ** 2 * (n + 2))
    assert (np.abs(u.mean(0) - k / (n + 1)) < 3 * np.sqrt(var / rows)).all()
    # Same shape and seed -> same draws; the generator's device by default.
    np.testing.assert_array_equal(sorted_uniforms(_gen(n), (rows, n)).numpy(), u)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_sorted_equals_jax_exactly(seed):
    rng = np.random.default_rng(seed)
    a = np.sort(rng.uniform(2.0, 6.0, (R, 17)).astype(np.float32), -1)
    b = np.sort(rng.uniform(2.0, 6.0, (R, 9)).astype(np.float32), -1)
    b[:, ::3] = a[:, :3]  # ties between the two
    b = np.sort(b, -1)
    got = merge_sorted(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(j_merge_sorted(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.sort(np.concatenate([a, b], -1), -1))


def test_dispatch_extra_merge_matches_full_sort():
    rng = np.random.default_rng(3)
    extra = np.sort(rng.uniform(2.0, 6.0, (R, 7)).astype(np.float32), -1)
    z = ds.depth_guided_intervals("random", 2.0, 6.0, R, S, generator=_gen(4),
                                  extra_intervals=torch.from_numpy(extra)).numpy()
    base = ds.random_intervals(_gen(4), 2.0, 6.0, R, S).numpy()
    np.testing.assert_array_equal(z, np.sort(np.concatenate([base, extra], -1), -1))


def test_dispatch_validates_arguments():
    with pytest.raises(ValueError, match="unknown strategy"):
        ds.depth_guided_intervals("nope", 2.0, 6.0, R, S)
    with pytest.raises(ValueError, match="requires per-ray depth"):
        ds.depth_guided_intervals("proximal", 2.0, 6.0, R, S)
    for strategy in ("random", "depth_informed", "surface_band"):
        with pytest.raises(ValueError, match="requires a generator"):
            ds.depth_guided_intervals(strategy, 2.0, 6.0, R, S,
                                      depth=torch.from_numpy(_depth_with_holes()))
    assert ds.STRATEGIES == jds.STRATEGIES


def test_every_strategy_has_its_static_shape():
    depth = torch.from_numpy(_depth_with_holes())
    for strategy in ds.STRATEGIES:
        z = ds.depth_guided_intervals(strategy, 2.0, 6.0, R, S, generator=_gen(), depth=depth,
                                      empty=EMPTY)
        assert z.shape == (R, S) and torch.isfinite(z).all(), strategy
        assert (z[:, 1:] >= z[:, :-1]).all(), strategy
