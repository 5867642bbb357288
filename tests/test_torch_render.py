"""The port's render slice against the JAX package's, end to end, at a
small width (4 layers, hidden 128, skip 2, L 4/2; 64 rays, 16+16
samples): make_render_chunk + render_image on both sides with the same
weights (initialised in JAX, carried across by state_dict_from_flax) and
the same rays, made with numpy from a seed.

Tolerances:
- f32, nn.Module path on both sides: rgb/acc/weights atol 1e-4 and
  depth/disp rtol 1e-3 — the fine samples move continuously with the
  coarse weights, which the stacks sum in other orders.
- bf16, the JAX fused kernel (Pallas, interpreted) against the port's
  plain kernel version: rgb atol 2e-2, the bf16 bar of
  tests/test_fused_mlp.py:37.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from nerfmeshes_tpu.config import get_default_cfg
from nerfmeshes_tpu.train import step as j_step
from nerfmeshes_tpu.train import system as j_system
from nerfmeshes_tpu_torch.data.blender_poses import png_size, read_blender_poses
from nerfmeshes_tpu_torch.models.transplant import state_dict_from_flax
from nerfmeshes_tpu_torch.ops.kernels import fused_mlp as fm
from nerfmeshes_tpu_torch.train import step as t_step
from nerfmeshes_tpu_torch.train import system as t_system

torch.set_num_threads(1)

SMALL = dict(num_layers=4, hidden_size=128, skip_step=2, num_encoding_fn_xyz=4,
             num_encoding_fn_dir=2)
R, CHUNK = 64, 48  # two chunks, the second padded with the last ray
SCENE = Path(__file__).resolve().parents[1] / "data" / "hard_blender"


def small_cfg(compute_dtype: str, fused: bool, white_background: bool = False):
    cfg = get_default_cfg()
    for node in (cfg.models.coarse, cfg.models.fine):
        for k, v in SMALL.items():
            node[k] = v
    cfg.nerf.validation.num_coarse = 16
    cfg.nerf.validation.num_fine = 16
    cfg.nerf.validation.chunksize = CHUNK
    cfg.experiment.compute_dtype = compute_dtype
    cfg.experiment.use_fused_kernel = fused
    cfg.dataset.white_background = white_background
    return cfg


def scene_rays(seed=0):
    """Origins on the camera sphere, directions at the centre with jitter."""
    rng = np.random.default_rng(seed)
    o = rng.standard_normal((R, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = -o + rng.uniform(-1.5, 1.5, (R, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def both_renders(cfg):
    """(JAX (coarse, fine), port (coarse, fine)) RenderOutputs of numpy maps."""
    jc, jf = j_system.create_models(cfg)
    params = j_system.init_params(cfg, jc, jf, jax.random.key(0))
    o, d = scene_rays()
    want = j_step.render_image(j_step.make_render_chunk(cfg, jc, jf), params, o, d, 2.0, 6.0,
                               chunk_size=CHUNK)

    tc, tf = t_system.create_models(cfg)
    for model, name, node in ((tc, "coarse", cfg.models.coarse), (tf, "fine", cfg.models.fine)):
        sd = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params[name]), dict(node))
        model.load_state_dict(sd)
    before = fm.launches
    got = t_step.render_image(t_step.make_render_chunk(cfg, tc, tf), o, d, 2.0, 6.0,
                              chunk_size=CHUNK)
    assert fm.launches == before, "CPU renders must never launch the kernel"
    return want, got


@pytest.mark.parametrize("white_background", [False, True])
def test_render_slice_f32_matches_jax(white_background):
    want, got = both_renders(small_cfg("float32", fused=False, white_background=white_background))
    for w_bundle, g_bundle in zip(want, got):
        assert g_bundle.rgb_map.shape == (R, 3) and g_bundle.weights.shape[0] == R
        for name in ("rgb_map", "acc_map", "weights"):
            np.testing.assert_allclose(getattr(g_bundle, name), getattr(w_bundle, name),
                                       atol=1e-4, rtol=0, err_msg=name)
        np.testing.assert_allclose(g_bundle.disp_map, w_bundle.disp_map, rtol=1e-3, atol=0)
        # Eval depth is zeroed where acc < 1; where acc sits within f32
        # rounding of 1 the stacks may fall on either side of that line.
        near_one = np.abs(w_bundle.acc_map - 1.0) < 1e-5
        np.testing.assert_allclose(g_bundle.depth_map[~near_one], w_bundle.depth_map[~near_one],
                                   rtol=1e-3, atol=0)
        both = near_one & (g_bundle.depth_map != 0) & (w_bundle.depth_map != 0)
        assert both.sum() >= R // 8, "too few opaque rays to compare depth on"
        np.testing.assert_allclose(g_bundle.depth_map[both], w_bundle.depth_map[both],
                                   rtol=1e-3, atol=0)
        # Transmittance threshold: agree except within rounding of 1e-5.
        assert np.mean(g_bundle.mask_weights == w_bundle.mask_weights) > 0.999


def test_render_slice_bf16_fused_matches_jax():
    want, got = both_renders(small_cfg("bfloat16", fused=True))
    for w_bundle, g_bundle in zip(want, got):
        np.testing.assert_allclose(g_bundle.rgb_map, w_bundle.rgb_map, atol=2e-2, rtol=0)
        assert np.isfinite(g_bundle.depth_map).all()


def test_pose_rays_match_jax():
    poses, H, W, focal = read_blender_poses(SCENE, "test", reduced=20)
    for use_ndc in (False, True):
        got = t_step.make_pose_rays(H, W, focal, use_ndc=use_ndc)(poses[1])
        want = j_step.make_pose_rays(H, W, focal, use_ndc=use_ndc)(poses[1])
        for g, w in zip(got, want):
            assert g.shape == (H * W, 3)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)


def test_round_chunk_matches_jax():
    for chunk in (1, 7, 2048, 2049):
        assert t_step.round_chunk(chunk) == j_step.round_chunk(chunk, None)
    assert t_step.round_chunk(2049, 4) == 2052


def test_blender_poses_match_jax_loader():
    from nerfmeshes_tpu.data.loaders.blender import load_blender_data

    cfg = get_default_cfg()
    bundle = load_blender_data(cfg, str(SCENE / "transforms_test.json"))
    poses, H, W, focal = read_blender_poses(SCENE, "test")
    np.testing.assert_array_equal(poses, bundle.poses)
    np.testing.assert_allclose([H, W, focal], bundle.hwf, rtol=1e-6)
    assert png_size(SCENE / "test" / "r_0.png") == (H, W)


def test_nerf_system_serves_on_cpu():
    cfg = small_cfg("bfloat16", fused=True)
    system = t_system.NeRFSystem(cfg).setup_eval()
    again = t_system.NeRFSystem(cfg)
    for a, b in zip(system.fine.state_dict().values(), again.fine.state_dict().values()):
        assert torch.equal(a, b)  # weights follow the config's seed
    o, d = scene_rays()
    before = fm.launches
    out = system.query_rays(torch.from_numpy(o), torch.from_numpy(d), 2.0, 6.0,
                            fields=("rgb_map",))
    assert fm.launches == before
    assert out.rgb_map.shape == (R, 3) and out.depth_map is None
    assert np.isfinite(out.rgb_map).all()

    pts = torch.from_numpy(o[:8, None, :] + d[:8, None, :] * np.linspace(2, 6, 5)[:, None])
    dirs = torch.from_numpy(d[:8])
    fused = system.sample_points(pts.float(), dirs)
    with torch.no_grad():
        module = system.fine(pts.float(), dirs[:, None, :].expand(pts.shape))
    assert fused.shape == (8, 5, 4)
    np.testing.assert_allclose(fused.numpy(), module.numpy(), atol=2e-2, rtol=2e-2)
