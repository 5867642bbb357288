"""nerfmeshes_tpu_torch.ops against the JAX package's ops, in f32.

Inputs are made with numpy from a seed and fed to both stacks. Tolerance
atol = rtol = 1e-5 (f32; the stacks sum and scan in other orders), with
jax_default_matmul_precision=highest from conftest.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from nerfmeshes_tpu.ops import encoding as j_enc
from nerfmeshes_tpu.ops import math as j_math
from nerfmeshes_tpu.ops import rays as j_rays
from nerfmeshes_tpu.ops import render as j_render
from nerfmeshes_tpu.ops import sampling as j_samp
from nerfmeshes_tpu_torch.ops import encoding as t_enc
from nerfmeshes_tpu_torch.ops import math as t_math
from nerfmeshes_tpu_torch.ops import rays as t_rays
from nerfmeshes_tpu_torch.ops import render as t_render
from nerfmeshes_tpu_torch.ops import sampling as t_samp

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)


def T(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def J(x):
    return jnp.asarray(np.asarray(x, dtype=np.float32))


def assert_close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **{**TOL, **tol})


def _depths(rng, R, S, near=2.0, far=6.0):
    return np.sort(rng.uniform(near, far, (R, S)), axis=1).astype(np.float32)


@pytest.mark.parametrize("axis", [-1, 1])
def test_cumprod_exclusive(rng, axis):
    x = rng.uniform(0.0, 1.0, (4, 7, 9)).astype(np.float32)
    assert_close(t_math.cumprod_exclusive(T(x), axis), j_math.cumprod_exclusive(J(x), axis))


def test_cumprod_exclusive_positive_grads(rng):
    """Same values as cumprod_exclusive and the same grads as autograd
    through torch.cumprod, on inputs with no zeros."""
    x = rng.uniform(1e-3, 1.5, (5, 9)).astype(np.float32)
    g = rng.standard_normal((5, 9)).astype(np.float32)
    a, b = T(x).requires_grad_(), T(x).requires_grad_()
    got = t_math.cumprod_exclusive_positive(a)
    want = t_math.cumprod_exclusive(b)
    assert torch.equal(got, want)
    (got * T(g)).sum().backward()
    (want * T(g)).sum().backward()
    torch.testing.assert_close(a.grad, b.grad, atol=1e-6, rtol=1e-5)


def test_img2mse_mse2psnr(rng):
    a, b = rng.uniform(size=(2, 16, 3)).astype(np.float32)
    mse_t, mse_j = t_math.img2mse(T(a), T(b)), j_math.img2mse(J(a), J(b))
    assert_close(mse_t, mse_j)
    assert_close(t_math.mse2psnr(mse_t), j_math.mse2psnr(mse_j))
    # zero MSE is clamped to 1e-5 -> 50 dB in both
    assert_close(t_math.mse2psnr(torch.tensor(0.0)), j_math.mse2psnr(jnp.float32(0.0)))


@pytest.mark.parametrize("L,include,log", [(6, True, True), (4, False, True), (5, True, False)])
def test_positional_encoding(rng, L, include, log):
    np.testing.assert_array_equal(t_enc.frequency_bands(L, log), j_enc.frequency_bands(L, log))
    x = rng.uniform(-2.0, 2.0, (5, 6, 3)).astype(np.float32)
    got = t_enc.positional_encoding(T(x), L, include, log)
    assert got.shape[-1] == t_enc.positional_encoding_output_size(L, include)
    assert_close(got, j_enc.positional_encoding(J(x), L, include, log))


def _pose(rng):
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = q
    pose[:3, 3] = rng.uniform(-4.0, 4.0, 3)
    return pose


@pytest.mark.parametrize(
    "intr",
    [
        j_rays.CameraIntrinsics.from_hwf(6, 8, 7.5),
        # ScanNet convention: +z, image-down y, off-centre principal point,
        # unnormalised directions
        j_rays.CameraIntrinsics(fx=7.0, fy=6.0, cx=3.2, cy=2.9, z_sign=1.0,
                                flip_y=False, normalize=False),
    ],
)
def test_ray_bundle(rng, intr):
    poses = np.stack([_pose(rng), _pose(rng)])
    o_t, d_t = t_rays.get_ray_bundle_intrinsics(6, 8, t_rays.CameraIntrinsics(*intr), T(poses))
    o_j, d_j = j_rays.get_ray_bundle_intrinsics(6, 8, intr, J(poses))
    assert d_t.shape == (2, 6, 8, 3)
    assert_close(o_t, o_j)
    assert_close(d_t, d_j)


def test_get_ray_bundle_hwf(rng):
    pose = _pose(rng)
    for got, want in zip(t_rays.get_ray_bundle(5, 7, 6.0, T(pose)),
                         j_rays.get_ray_bundle(5, 7, 6.0, J(pose))):
        assert_close(got, want)


def test_ndc_rays(rng):
    o = rng.uniform(-0.5, 0.5, (32, 3)).astype(np.float32)
    o[:, 2] = rng.uniform(-0.3, 0.3, 32)
    d = rng.standard_normal((32, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 0.5  # forward-facing
    for got, want in zip(t_rays.ndc_rays(40, 30, 35.0, 1.0, T(o), T(d)),
                         j_rays.ndc_rays(40, 30, 35.0, 1.0, J(o), J(d))):
        assert_close(got, want)


def test_intervals_to_ray_points(rng):
    z = _depths(rng, 9, 5)
    d = rng.standard_normal((9, 3)).astype(np.float32)
    for o in (rng.standard_normal((9, 3)), rng.standard_normal(3)):
        assert_close(t_rays.intervals_to_ray_points(T(z), T(d), T(o)),
                     j_rays.intervals_to_ray_points(J(z), J(d), J(o)))


@pytest.mark.parametrize("lindisp", [False, True])
@pytest.mark.parametrize("per_ray", [False, True])
def test_ray_sample_interval(rng, lindisp, per_ray):
    R, S = 6, 16
    near = rng.uniform(1.0, 2.0, R).astype(np.float32) if per_ray else 2.0
    far = rng.uniform(5.0, 7.0, R).astype(np.float32) if per_ray else 6.0
    got = t_samp.ray_sample_interval(S, R, T(near) if per_ray else near,
                                     T(far) if per_ray else far, lindisp=lindisp)
    want = j_samp.ray_sample_interval(S, R, J(near) if per_ray else near,
                                      J(far) if per_ray else far, lindisp=lindisp)
    assert got.shape == (R, S)
    assert_close(got, want)


def test_ray_sample_interval_perturbed_stays_in_bins(rng):
    """The stochastic branch (no JAX stream to compare with): every jittered
    depth stays inside its mid-point bin."""
    g = torch.Generator().manual_seed(0)
    base = t_samp.ray_sample_interval(8, 5, 2.0, 6.0)
    jit = t_samp.ray_sample_interval(8, 5, 2.0, 6.0, perturb=True, generator=g)
    mids = 0.5 * (base[:, 1:] + base[:, :-1])
    lower = torch.cat([base[:, :1], mids], 1)
    upper = torch.cat([mids, base[:, -1:]], 1)
    assert bool(((jit >= lower) & (jit <= upper)).all())
    assert not torch.equal(jit, base)


def _pdf_inputs(rng, R=64, B=24):
    bins = _depths(rng, R, B)
    weights = rng.uniform(0.0, 1.0, (R, B - 1)).astype(np.float32)
    weights[:, ::5] = 0.0  # empty bins: denom < 1e-5 -> 1
    weights[:4] = 0.0  # flat pdf rows
    return bins, weights


def test_sample_pdf_deterministic(rng):
    bins, weights = _pdf_inputs(rng)
    got = t_samp.sample_pdf(T(bins), T(weights), 32)
    want = j_samp.sample_pdf(J(bins), J(weights), 32, deterministic=True)
    assert got.shape == (64, 32)
    assert_close(got, want)


def test_sample_pdf_clamp_at_cdf_end(rng):
    """u = 1 >= cdf[-1] takes the clamp to the last bin (the sample lands on
    bins[-1]); the inputs are checked to reach that branch."""
    bins, weights = _pdf_inputs(rng)
    w = T(weights) + 1e-5
    cdf_end = torch.cumsum(w / w.sum(-1, keepdim=True), -1)[:, -1]
    assert bool((cdf_end <= 1.0).any()), "inputs never reach the u >= cdf[-1] clamp"
    got = t_samp.sample_pdf(T(bins), T(weights), 7)
    want = j_samp.sample_pdf(J(bins), J(weights), 7, deterministic=True)
    clamped = (cdf_end <= 1.0).numpy()
    np.testing.assert_array_equal(got[clamped, -1].numpy(), bins[clamped, -1])
    assert_close(got, want)


def test_sample_pdf_stochastic_is_sorted_and_inside(rng):
    bins, weights = _pdf_inputs(rng)
    got = t_samp.sample_pdf(T(bins), T(weights), 16, deterministic=False,
                            generator=torch.Generator().manual_seed(1))
    assert bool((got[:, 1:] >= got[:, :-1]).all())
    assert bool(((got >= T(bins)[:, :1]) & (got <= T(bins)[:, -1:])).all())


def test_sample_pdf_shape_check():
    with pytest.raises(ValueError):
        t_samp.sample_pdf(torch.zeros(2, 5), torch.zeros(2, 5), 4)


def test_hierarchical_intervals(rng):
    # Weights are 0 or O(1): a cdf step just above the 1e-5 denominator
    # floor would divide the stacks' f32 summation-order difference (~1e-7)
    # by ~1e-5 and magnify it past an f32 tolerance.
    R, Sc, Sf = 32, 16, 24
    z = np.asarray(j_samp.ray_sample_interval(Sc, R, 2.0, 6.0))
    weights = rng.uniform(0.0, 1.0, (R, Sc)).astype(np.float32)
    weights[:, ::3] = 0.0
    got = t_samp.hierarchical_intervals(T(z), T(weights), Sf)
    want = j_samp.hierarchical_intervals(J(z), J(weights), Sf)
    assert got.shape == (R, Sc + Sf)
    assert bool((got[:, 1:] >= got[:, :-1]).all())
    assert_close(got, want)


def _field(rng, R, S, channels_first):
    rgb = rng.uniform(0.0, 1.0, (R, S, 3))
    sigma = rng.standard_normal((R, S))
    sigma[:3] = -1.0  # empty rays: acc = 0, disp NaN -> 0
    sigma[:, -1] = -1.0  # the 1e10 last interval stays transparent: acc < 1
    field = np.concatenate([rgb, sigma[..., None]], -1).astype(np.float32)
    return np.moveaxis(field, -1, 0).copy() if channels_first else field


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("white_background", [False, True])
@pytest.mark.parametrize("channels_first", [False, True])
def test_volume_render(rng, train, white_background, channels_first):
    R, S = 24, 16
    field = _field(rng, R, S, channels_first)
    z = _depths(rng, R, S)
    d = rng.standard_normal((R, 3)).astype(np.float32)
    kw = dict(train=train, white_background=white_background, channels_first=channels_first)
    got = t_render.volume_render(T(field), T(z), T(d), **kw)
    want = j_render.volume_render(J(field), J(z), J(d), **kw)
    for name in t_render.RenderOutput._fields:
        assert_close(getattr(got, name), getattr(want, name), err_msg=name)
    assert float(got.acc_map.max()) < 1.0 - 1e-4
    assert float(got.disp_map[:3].abs().max()) == 0.0


def test_volume_render_noise_needs_no_stream(rng):
    """The sigma-noise branch runs from a torch.Generator and is seeded."""
    field = _field(rng, 4, 8, False)
    z, d = _depths(rng, 4, 8), rng.standard_normal((4, 3)).astype(np.float32)
    outs = [t_render.volume_render(T(field), T(z), T(d), train=True,
                                   radiance_field_noise_std=1.0,
                                   generator=torch.Generator().manual_seed(3))
            for _ in range(2)]
    assert torch.equal(outs[0].rgb_map, outs[1].rgb_map)


def test_density_weights(rng):
    R, S = 12, 10
    sigma = rng.standard_normal((R, S)).astype(np.float32)
    z = _depths(rng, R, S)
    d = rng.standard_normal((R, 3)).astype(np.float32)
    assert_close(t_render.density_weights(T(sigma), T(z), T(d)),
                 j_render.density_weights(J(sigma), J(z), J(d)))
