"""The surface-ray point cloud of the port (nerfmeshes_tpu_torch/mesh/
surface_ray.py, cli/surface_ray.py) against the JAX package, on the CPU.

- neighborhood_consistency_mask equals JAX's bit for bit on seeded maps
  (a smooth sheet with outliers), for step sizes 1-3 and two thresholds.
- orbit_poses and the camera-space pixel directions equal JAX's.
- surface_points_from_views through one analytic ray-traced sphere (the
  same stand-in for both stacks) gives JAX's points within 1e-6, and the
  same count, normals and colours.
- export_surface_ray on tiny systems with the same weights (2 x 4x32, f32,
  an alpha head scaled up so that rays stop at the field's first dense
  sample) gives JAX's point count, points within 1e-4 and JAX's colours
  within one uint8 step; the binary PLY reads back and the ASCII one holds
  the same points.
- The CLI on a tiny run of the port, --device cpu, --focal 0: the focal of
  the validation split, and a PLY that reads back.
"""

from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfmeshes_tpu.config import get_default_cfg
from nerfmeshes_tpu.mesh import surface_ray as j_sr
from nerfmeshes_tpu.train import system as j_system
from nerfmeshes_tpu_torch.cli import surface_ray as surface_ray_cli
from nerfmeshes_tpu_torch.cli import train_nerf
from nerfmeshes_tpu_torch.mesh import surface_ray as t_sr
from nerfmeshes_tpu_torch.mesh.export import read_ply_binary
from nerfmeshes_tpu_torch.models.transplant import state_dict_from_flax
from nerfmeshes_tpu_torch.train import system as t_system

torch.set_num_threads(1)
CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parents[1]
SMALL = dict(num_layers=4, hidden_size=32, skip_step=2, num_encoding_fn_xyz=4,
             num_encoding_fn_dir=2)


def _sheet(h, w, step_size, dist_threshold, seed):
    """A smooth sheet whose (2s+1)^2 windows agree within the threshold,
    with 15% of its points thrown off it by about twice the threshold's
    distance."""
    rng = np.random.default_rng(seed)
    extent = 0.6 * np.sqrt(dist_threshold) / step_size * np.array([h, w])
    yy, xx = np.meshgrid(np.linspace(0, extent[0], h), np.linspace(0, extent[1], w),
                         indexing="ij")
    sp = np.stack([xx, yy, 0.05 * np.sin(7 * xx)], -1).astype(np.float32)
    outliers = rng.random((h, w)) < 0.15
    noise = rng.normal(0, 2.0 * np.sqrt(dist_threshold), size=(int(outliers.sum()), 3))
    sp[outliers] += noise.astype(np.float32)
    return sp


@pytest.mark.parametrize("step_size", [1, 2, 3])
@pytest.mark.parametrize("dist_threshold", [0.002, 0.01])
def test_mask_matches_jax_bit_for_bit(step_size, dist_threshold):
    sp = _sheet(29, 23, step_size, dist_threshold, seed=step_size)
    kw = dict(step_size=step_size, dist_threshold=dist_threshold, prob_threshold=0.6)
    want = np.asarray(j_sr.neighborhood_consistency_mask(jnp.asarray(sp), **kw))
    got = t_sr.neighborhood_consistency_mask(torch.from_numpy(sp), **kw)
    assert got.dtype == torch.bool and got.shape == (29, 23)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < want.size


def test_orbit_and_pixel_directions_match_jax():
    np.testing.assert_array_equal(t_sr.orbit_poses(), j_sr.orbit_poses())
    np.testing.assert_array_equal(t_sr.orbit_poses(3, 2, 2.5), j_sr.orbit_poses(3, 2, 2.5))
    np.testing.assert_array_equal(t_sr._pixel_dirs_cam(12, 17, 20.0),
                                  j_sr._pixel_dirs_cam(12, 17, 20.0))


class _Sphere:
    """A sphere of radius 1 at the origin, ray-traced in float64: depth 0
    on a miss (the eval render's semantics), one colour on a hit. With
    `device` it stands in for the port's systems (tensors in and out)."""

    color = np.array([0.2, 0.5, 0.8], np.float32)

    def __init__(self, device=None):
        self.device = device

    def query_rays(self, o, d, near, far, fields=None, as_numpy=True):
        o = np.asarray(o.cpu() if self.device else o, np.float64)
        d = np.asarray(d.cpu() if self.device else d, np.float64)
        b = 2.0 * np.sum(o * d, -1)
        a = np.sum(d * d, -1)
        disc = b * b - 4.0 * a * (np.sum(o * o, -1) - 1.0)
        hit = disc > 0
        t = np.where(hit, (-b - np.sqrt(np.maximum(disc, 0.0))) / (2.0 * a), 0.0)
        depth = np.where(hit & (t > near) & (t < far), t, 0.0).astype(np.float32)
        rgb = np.where(depth[..., None] > 0, self.color, np.zeros(3, np.float32))
        out = dict(rgb_map=rgb.astype(np.float32), depth_map=depth)
        if self.device:
            out = {k: torch.from_numpy(v) for k, v in out.items()}
        return SimpleNamespace(**out)


def test_sphere_views_match_jax():
    poses = t_sr.orbit_poses(poses_y=4, poses_x=2)
    kw = dict(hwf=(40, 40, 50.0), near=0.5, far=8.0, dist_threshold=0.05)
    want = j_sr.surface_points_from_views(_Sphere(), poses, **kw)
    got = t_sr.surface_points_from_views(_Sphere(CPU), poses, **kw)
    assert len(got[0]) == len(want[0]) > 300
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(np.linalg.norm(got[0], axis=-1), 1.0, atol=0.05)


@pytest.fixture(scope="module")
def systems():
    """The JAX system and the port's with its weights, the alpha heads
    scaled by 1e5: sigma is 0 or far past saturation, so rays stop at the
    first dense sample and acc is 1 exactly on both sides, but for rays
    that graze a thin shell of partial density (acc at 1 within f32
    rounding, whose eval depth may flip between stacks: ROADMAP.md)."""
    cfg = get_default_cfg()
    for node in (cfg.models.coarse, cfg.models.fine):
        node.update(SMALL)
    cfg.experiment.update(compute_dtype="float32", use_fused_kernel=False, randomseed=5)
    cfg.nerf.validation.update(num_coarse=16, num_fine=16, chunksize=512)
    jsys = j_system.NeRFSystem(cfg).setup_eval()
    alpha = f"TorchLinear_{SMALL['num_layers'] + 1}"  # layer1, trunk, fc_feat, fc_alpha
    params = jax.tree_util.tree_map(np.array, jsys.state.params)
    for name in ("coarse", "fine"):
        params[name]["params"][alpha]["kernel"] *= 1e5
    jsys.state = jsys.state._replace(params=jax.tree_util.tree_map(jnp.asarray, params))
    tsys = t_system.NeRFSystem(cfg, device=CPU).setup_eval()
    for model, name in ((tsys.coarse, "coarse"), (tsys.fine, "fine")):
        model.load_state_dict(state_dict_from_flax(params[name], dict(cfg.models[name])))
    return jsys, tsys


def test_export_surface_ray_matches_jax(systems, tmp_path):
    jsys, tsys = systems
    kw = dict(hwf=(24, 24, 30.0), poses_y=2, poses_x=3, dist_threshold=0.02, log_every=0)
    want = j_sr.export_surface_ray(jsys, str(tmp_path / "jax.ply"), **kw)
    got = t_sr.export_surface_ray(tsys, str(tmp_path / "port.ply"), **kw)
    assert 100 < len(got[0]) == len(want[0]) < 6 * 24 * 24
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1.0 / 255.0 + 1e-6)
    points, triangles, normals, colors = read_ply_binary(str(tmp_path / "port.ply"))
    assert triangles.shape == (0, 3)
    np.testing.assert_array_equal(points, got[0])
    np.testing.assert_array_equal(normals, got[1])
    np.testing.assert_array_equal(colors, np.round(got[2] * 255).astype(np.uint8))
    t_sr.export_surface_ray(tsys, str(tmp_path / "port.txt.ply"), binary=False, **kw)
    text = (tmp_path / "port.txt.ply").read_text().splitlines()
    assert text[0] == "ply" and f"element vertex {len(got[0])}" in text
    first = text[text.index("end_header") + 1].split()
    np.testing.assert_allclose([float(v) for v in first[:3]], got[0][0], rtol=0, atol=1e-5)


def test_cli_on_a_tiny_run(tmp_path, capsys):
    system = train_nerf.main(["--config", str(REPO / "configs" / "tiny.yml"), "--device", "cpu",
                              "--override", "experiment.logdir", str(tmp_path / "logs"),
                              "experiment.train_iters", "10", "experiment.validate_every",
                              "10"])
    run = system.paths.log_dir
    out = tmp_path / "pts" / "points.ply"
    points, normals, colors = surface_ray_cli.main(
        ["--log-checkpoint", str(run), "--device", "cpu", "--img-size", "16", "--focal", "0",
         "--poses-y", "2", "--poses-x", "1", "--dist-threshold", "1.0",
         "--save-path", str(out)])
    assert f"wrote {len(points)} surface points -> {out}" in capsys.readouterr().out
    back = read_ply_binary(str(out))
    np.testing.assert_array_equal(back[0], points)
    assert np.isfinite(points).all()
    np.testing.assert_allclose(np.linalg.norm(normals, axis=-1), 1.0, atol=1e-5)
    assert ((colors >= 0) & (colors <= 1)).all()
