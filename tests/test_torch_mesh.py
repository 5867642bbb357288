"""The port's mesh slice against the JAX package's, on the CPU.

Weights start in JAX and are carried across with state_dict_from_flax;
points, rays and grids are made with numpy from a seed. Tolerances:
- sigma: the port's plain version against JAX's sigma kernel (Pallas,
  interpreted) at atol = rtol = 2e-2, the bf16 bar of
  tests/test_fused_mlp.py:37; against the port's own forward channel 3
  within 1e-5 (one trunk, one alpha head: the counterpart of
  tests/test_fused_mlp.py:182-193).
- marching, files, sampling, support masks: identical; chamfer 1e-6
  relative (sums in another order).
- analytic field through both extractors: the same fetched blocks and
  triangles (after the canonical sort of tests/test_mesh.py:276-282), the
  iso within 1e-3 (f32 statistics summed in another order).
- the whole slice, f32 nn.Module path on both sides: equal counts,
  vertices within 1e-4, colours within one uint8 step; bf16 with the
  fused kernels: sigma grids within 2e-2 and a chamfer distance between
  the meshes below one grid cell squared.
The CUDA kernels themselves run only on a card: tests/test_torch_mesh_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfmeshes_tpu.config import get_default_cfg
from nerfmeshes_tpu.mesh import export as j_export
from nerfmeshes_tpu.mesh import extract as j_extract
from nerfmeshes_tpu.mesh import metrics as j_metrics
from nerfmeshes_tpu.mesh import native as j_native
from nerfmeshes_tpu.models import FlexibleNeRFModel as JaxFlexible
from nerfmeshes_tpu.ops.pallas import fused_mlp as j_fused
from nerfmeshes_tpu.train import system as j_system
from nerfmeshes_tpu_torch.mesh import export as t_export
from nerfmeshes_tpu_torch.mesh import extract as t_extract
from nerfmeshes_tpu_torch.mesh import metrics as t_metrics
from nerfmeshes_tpu_torch.mesh import native as t_native
from nerfmeshes_tpu_torch.models import FlexibleNeRFModel
from nerfmeshes_tpu_torch.models.transplant import state_dict_from_flax
from nerfmeshes_tpu_torch.ops.kernels import fused_mlp as fm
from nerfmeshes_tpu_torch.train import system as t_system

torch.set_num_threads(1)

TOL = dict(atol=2e-2, rtol=2e-2)
BASE = dict(num_layers=4, hidden_size=128, skip_step=2, num_encoding_fn_xyz=4,
            num_encoding_fn_dir=2)


def _pair(kw, seed=0):
    jm = JaxFlexible(**kw, dtype=jnp.bfloat16)
    pts = jnp.zeros((2, 3), jnp.float32)
    params = jm.init(jax.random.key(seed), pts, pts)
    tm = FlexibleNeRFModel(**kw, compute_dtype=torch.bfloat16)
    tm.load_state_dict(state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params), kw))
    return jm, params, tm


# -- the sigma kernel's plain version ----------------------------------------------

@pytest.mark.parametrize("num_layers,skip", [(4, 2), (8, 4)])
def test_sigma_plain_matches_jax_kernel(rng, num_layers, skip):
    """The architectures of tests/test_fused_mlp.py:169."""
    kw = dict(BASE, num_layers=num_layers, skip_step=skip)
    jm, params, tm = _pair(kw)
    pts = rng.standard_normal((40, 3)).astype(np.float32)
    want = j_fused.fused_sigma_points(jm, params, jnp.asarray(pts))
    before = fm.sigma_launches
    got = fm.fused_sigma_points(tm, torch.from_numpy(pts))
    assert fm.sigma_launches == before, "CPU tensors must never launch the kernel"
    assert got.shape == (40,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kw", [BASE, dict(BASE, num_layers=8, skip_step=4, num_encoding_fn_xyz=10),
                                dict(BASE, include_input_xyz=False, log_sampling_xyz=False)],
                         ids=["small", "deep-lego-bands", "linear-bands"])
def test_sigma_plain_is_forward_channel3(rng, kw):
    _, _, tm = _pair(kw)
    packed = fm.pack_weights(tm)
    pts = torch.from_numpy(rng.uniform(-1.2, 1.2, (65, 3)).astype(np.float32))
    zeros = torch.zeros_like(pts)
    full = fm.fused_mlp_plain(packed, pts, zeros, torch.zeros((65, 1)))[3, :, 0]
    sigma = fm.fused_sigma_plain(packed, pts)
    np.testing.assert_allclose(sigma.numpy(), full.numpy(), atol=1e-5, rtol=1e-5)
    # Any batch shape; a model or its packing.
    grid = fm.fused_sigma_points(tm, pts.reshape(5, 13, 3))
    assert grid.shape == (5, 13) and torch.equal(grid.reshape(-1), sigma)


def test_sigma_dispatch_never_falls_back(rng):
    _, _, tm = _pair(BASE)
    packed = fm.pack_weights(tm)
    pts = torch.from_numpy(rng.standard_normal((3, 3)).astype(np.float32))
    with pytest.raises(ValueError, match="CUDA"):
        fm.fused_sigma_cuda(packed, pts)
    with pytest.raises(ValueError):
        fm.fused_sigma_points(packed, pts.to("meta"))
    with pytest.raises(ValueError, match=r"\(N, 3\)"):
        fm.fused_sigma_plain(packed, pts[:, :2])
    assert fm.fused_sigma_points(packed, pts[:0]).shape == (0,)


# -- native marching, files, metrics -----------------------------------------------

def sphere_density(n=24, peak=20.0):
    ax = np.arange(n) - n / 2 + 0.5
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    return (peak - np.sqrt(X ** 2 + Y ** 2 + Z ** 2)).astype(np.float32)


def test_native_marching_matches_jax():
    density = sphere_density(32)
    for got, want in zip(t_native.marching_cubes(density, 10.0),
                         j_native.marching_cubes(density, 10.0)):
        np.testing.assert_array_equal(got, want)
    # Block-sparse: the 3^3 blocks around the sphere fetched, the rest min-filled.
    B = 4
    blocks = density.reshape(B, 8, B, 8, B, 8).transpose(0, 2, 4, 1, 3, 5).reshape(-1, 512)
    ids = np.flatnonzero((blocks.min(1) <= 10.0) & (blocks.max(1) >= 10.0)).astype(np.int32)
    fill = blocks.min(1).reshape(B, B, B)
    sparse_t = t_extract.SparseDensityGrid(32, fill, ids, blocks[ids])
    sparse_j = j_extract.SparseDensityGrid(32, fill, ids, blocks[ids])
    for got, want in zip(t_native.marching_cubes(sparse_t, 10.0),
                         j_native.marching_cubes(sparse_j, 10.0)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(sparse_t.to_dense(), sparse_j.to_dense())
    with pytest.raises(ValueError):
        t_native.marching_tetrahedra_native(np.zeros((1, 4, 4), np.float32), 0.5)


def test_numpy_marching_matches_native_triangle_count():
    density = sphere_density(20)
    _, tris_n, _ = t_native.marching_tetrahedra_native(density, 10.0)
    verts_f, tris_f, normals_f = t_native.marching_tetrahedra_numpy(density, 10.0)
    assert tris_n.shape == tris_f.shape
    for got, want in zip((verts_f, tris_f, normals_f),
                         j_native.marching_tetrahedra_numpy(density, 10.0)):
        np.testing.assert_array_equal(got, want)


def _mesh_arrays(seed=3):
    verts, tris, normals = t_native.marching_cubes(sphere_density(16), 10.0)
    colors = np.random.default_rng(seed).uniform(size=(len(verts), 3)).astype(np.float32)
    return verts, tris, colors, normals


def test_mesh_files_are_byte_identical_to_jax(tmp_path):
    verts, tris, colors, normals = _mesh_arrays()
    rgba = np.concatenate([colors, np.ones((len(colors), 1), np.float32)], 1)
    writers = {
        "m.obj": lambda mod, f: mod.export_obj(verts, tris, colors, normals, f),
        "rgba.obj": lambda mod, f: mod.export_obj(verts, tris, rgba, None, f),
        "m.ply": lambda mod, f: mod.export_ply(verts, tris, colors=colors, normals=normals,
                                               filename=f),
        "b.ply": lambda mod, f: mod.export_ply_binary(verts, tris, colors=colors,
                                                      normals=normals, filename=f),
        "u8.ply": lambda mod, f: mod.export_ply_binary(
            verts, tris, colors=(colors * 255).astype(np.uint8), filename=f),
    }
    for name, write in writers.items():
        write(t_export, str(tmp_path / f"t_{name}"))
        write(j_export, str(tmp_path / f"j_{name}"))
        assert (tmp_path / f"t_{name}").read_bytes() == (tmp_path / f"j_{name}").read_bytes(), name
    v2, t2, c2, n2 = t_export.import_obj(str(tmp_path / "t_m.obj"))
    np.testing.assert_array_equal(v2, verts)
    np.testing.assert_array_equal(t2, tris)
    np.testing.assert_array_equal(c2, colors)
    v3, t3, n3, c3 = t_export.read_ply_binary(str(tmp_path / "t_b.ply"))
    np.testing.assert_array_equal(v3, verts)
    np.testing.assert_array_equal(t3, tris)
    np.testing.assert_array_equal(n3, normals)
    np.testing.assert_array_equal(c3, np.clip(colors * 255, 0, 255).astype(np.uint8))
    assert t_export.read_ply_binary(str(tmp_path / "t_u8.ply"))[2] is None


def test_sampling_and_chamfer_match_jax():
    verts, tris, _, _ = _mesh_arrays()
    for seed in (0, 5):
        np.testing.assert_array_equal(t_metrics.sample_points_from_mesh(verts, tris, 700, seed),
                                      j_metrics.sample_points_from_mesh(verts, tris, 700, seed))
    rng = np.random.default_rng(1)
    a = rng.standard_normal((900, 3)).astype(np.float32)
    b = a[:700] + rng.normal(0.0, 0.05, (700, 3)).astype(np.float32)
    want = j_metrics.chamfer_distance(a, b)
    assert t_metrics.chamfer_distance(a, b) == pytest.approx(want, rel=1e-6)
    assert t_metrics.chamfer_distance(a, b, block=128) == pytest.approx(want, rel=1e-6)
    assert t_metrics.chamfer_distance(torch.from_numpy(a), b) == pytest.approx(want, rel=1e-6)
    small = t_native.marching_cubes(sphere_density(16, peak=18.0), 10.0)[:2]
    assert (t_metrics.chamfer_between_meshes((verts, tris), small)
            == pytest.approx(j_metrics.chamfer_between_meshes((verts, tris), small), rel=1e-6))
    np.testing.assert_array_equal(t_metrics.normalize_mesh(verts), j_metrics.normalize_mesh(verts))


def test_support_masks_match_jax():
    rng = np.random.default_rng(2)
    lo = rng.uniform(-1.6, 1.0, (40, 3))
    aabbs = np.stack([lo, lo + rng.uniform(0.05, 0.6, (40, 3))], 1).astype(np.float32)
    shell = np.asarray([[[-1.2, -1.2, -1.2], [1.2, 1.2, -0.45]],
                        [[-1.2, -1.2, 0.45], [1.2, 1.2, 1.2]],
                        [[-1.2, -1.2, -1.2], [1.2, -0.45, 1.2]],
                        [[-1.2, 0.45, -1.2], [1.2, 1.2, 1.2]],
                        [[-1.2, -1.2, -1.2], [-0.45, 1.2, 1.2]],
                        [[0.45, -1.2, -1.2], [1.2, 1.2, 1.2]]], np.float32)
    for boxes in (aabbs, shell):
        for res, cells in ((48, 8), (24, 1)):
            got = t_extract._support_masks(boxes, 1.2, res, cells)
            want = j_extract._support_masks(boxes, 1.2, res, cells)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
    assert t_extract._support_masks(shell, 1.2, 48, 8)[1].any()


# -- analytic field through both extractors ----------------------------------------

C1, C2 = np.array([0.3, 0.0, 0.1], np.float32), np.array([-0.4, -0.2, 0.0], np.float32)


def blobs_jax(pts):
    """The two blobs of tests/test_mesh.py:248-254."""
    r1 = jnp.linalg.norm(pts - jnp.asarray(C1), axis=-1)
    r2 = jnp.linalg.norm(pts - jnp.asarray(C2), axis=-1)
    return 80.0 * jnp.maximum(0.45 - r1, 0.0) + 60.0 * jnp.maximum(0.35 - r2, 0.0)


def blobs_torch(pts):
    r1 = torch.linalg.norm(pts - torch.from_numpy(C1), dim=-1)
    r2 = torch.linalg.norm(pts - torch.from_numpy(C2), dim=-1)
    return 80.0 * torch.clamp_min(0.45 - r1, 0.0) + 60.0 * torch.clamp_min(0.35 - r2, 0.0)


def canon(v, t):
    """Triangles as coordinate rows, sorted (tests/test_mesh.py:276-282)."""
    tv = v[t].round(4).reshape(len(t), 9)
    return tv[np.lexsort(tv.T)]


@pytest.mark.parametrize("mask", [False, True], ids=["unmasked", "support-mask"])
def test_sparse_extract_matches_jax(mask):
    res, limit = 48, 1.2
    aabbs = (np.asarray([[[-0.9, -0.7, -0.6], [0.5, 0.6, 0.7]]], np.float32) if mask
             else None)
    got, iso_t = t_extract._sparse_density_extract(blobs_torch, limit, res, 32.0, tile=4096,
                                                   mask_aabbs=aabbs)
    t_timings = dict(t_extract.LAST_TIMINGS)
    want, iso_j = j_extract._sparse_density_extract(blobs_jax, limit, res, 32.0, tile=4096,
                                                    mask_aabbs=aabbs)
    assert abs(iso_t - iso_j) < 1e-3
    np.testing.assert_array_equal(got.block_ids, want.block_ids)
    # The blob formula rounds differently in torch and jnp (the grids
    # themselves agree bit for bit): one f16 step apart at most.
    np.testing.assert_allclose(got.block_values, want.block_values, rtol=1e-3, atol=0)
    np.testing.assert_allclose(got.block_fill, want.block_fill, rtol=1e-3, atol=0)
    for key in ("sparse_blocks_fetched", "sparse_blocks_total", "transfer_packed_mb"):
        assert t_timings[key] == j_extract.LAST_TIMINGS[key], key
    assert t_timings["sparse_blocks_fetched"] < 0.5 * t_timings["sparse_blocks_total"]
    v_t, t_t, _ = t_native.marching_cubes(got, iso_t)
    v_j, t_j, _ = j_native.marching_cubes(want, iso_j)
    assert v_t.shape == v_j.shape and t_t.shape == t_j.shape and len(t_t) > 100
    np.testing.assert_allclose(canon(v_t, t_t), canon(v_j, t_j), atol=2e-4)


def test_dense_and_geometry_paths_match_jax():
    """res 24 takes the dense path (f16-rounded grid), res 32 the sparse one
    through extract_geometry; both in world coordinates."""
    for res in (24, 32):
        args = dict(res=res, limit=1.2, iso_level=1.0, clamp_iso=False)
        v_t, t_t, n_t, _ = t_extract.extract_geometry(
            None, t_extract.MeshArgs(**args), density_fn=blobs_torch)
        v_j, t_j, n_j, _ = j_extract.extract_geometry(
            None, j_extract.MeshArgs(**args), density_fn=blobs_jax)
        np.testing.assert_array_equal(t_t, t_j)
        np.testing.assert_allclose(v_t, v_j, atol=1e-4)
        np.testing.assert_allclose(n_t, n_j, atol=1e-3)
    dense_t = t_extract.extract_density(None, 1.2, (8, 10, 12), density_fn=blobs_torch)
    dense_j = j_extract.extract_density(None, 1.2, (8, 10, 12), density_fn=blobs_jax)
    np.testing.assert_allclose(dense_t, dense_j, rtol=1e-3, atol=0)
    assert np.array_equal(dense_t, dense_t.astype(np.float16).astype(np.float32))


def test_super_sampling_and_radiance_match_jax():
    def field_torch(pts, dirs):
        return torch.cat([pts.clamp(-1, 1) * 0.5 + 0.5, blobs_torch(pts)[..., None]], -1)

    def field_jax(pts, dirs):
        return jnp.concatenate([jnp.clip(pts, -1, 1) * 0.5 + 0.5, blobs_jax(pts)[..., None]], -1)

    args = dict(res=16, limit=1.2, iso_level=1.0, clamp_iso=False, super_sampling=1)
    got = t_extract.extract_geometry_with_super_sampling(field_torch, t_extract.MeshArgs(**args))
    want = j_extract.extract_geometry_with_super_sampling(field_jax, j_extract.MeshArgs(**args))
    np.testing.assert_allclose(got[3], want[3], rtol=1e-3, atol=1e-6)
    assert len(got[1]) == len(want[1]) > 0
    rad_t = t_extract.extract_radiance(field_torch, 1.2, 12, tile=500)
    rad_j = j_extract.extract_radiance(field_jax, 1.2, 12, tile=500)
    assert rad_t.shape == (12, 12, 12, 4)
    np.testing.assert_allclose(rad_t, rad_j, rtol=1e-3, atol=0)


# -- the whole slice: systems with the same weights --------------------------------

def small_cfg(compute_dtype: str, fused: bool):
    cfg = get_default_cfg()
    for node in (cfg.models.coarse, cfg.models.fine):
        node.update(BASE)
    cfg.nerf.validation.num_coarse = 16
    cfg.nerf.validation.num_fine = 16
    cfg.experiment.compute_dtype = compute_dtype
    cfg.experiment.use_fused_kernel = fused
    return cfg


def both_systems(cfg):
    jsys = j_system.NeRFSystem(cfg).setup_eval()
    tsys = t_system.NeRFSystem(cfg, device="cpu").setup_eval()
    for model, name, node in ((tsys.coarse, "coarse", cfg.models.coarse),
                              (tsys.fine, "fine", cfg.models.fine)):
        params = jax.tree_util.tree_map(np.asarray, jsys.state.params[name])
        model.load_state_dict(state_dict_from_flax(params, dict(node)))
    return jsys, tsys


@pytest.fixture(scope="module")
def f32_systems():
    """f32, the nn.Module path on both sides."""
    return both_systems(small_cfg("float32", False))


@pytest.fixture(scope="module")
def bf16_systems():
    """bf16 with the fused kernels (JAX: Pallas interpreted; the port: the
    plain versions)."""
    return both_systems(small_cfg("bfloat16", True))


def scene_rays(R=96, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.standard_normal((R, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = -o + rng.uniform(-1.5, 1.5, (R, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("systems", ["f32_systems", "bf16_systems"])
def test_query_rgb_matches_jax(request, systems):
    jsys, tsys = request.getfixturevalue(systems)
    dtype = tsys.cfg.experiment.compute_dtype
    o, d = scene_rays()
    before = fm.launches
    got_f = tsys.query_rgb(o, d, 2.0, 6.0, chunk=64)
    got_u8 = tsys.query_rgb(o, d, 2.0, 6.0, chunk=64, as_uint8=True)
    assert fm.launches == before
    want_f = jsys.query_rgb(o, d, 2.0, 6.0, chunk=64)
    want_u8 = jsys.query_rgb(o, d, 2.0, 6.0, chunk=64, as_uint8=True)
    assert got_f.shape == (96, 3) and got_u8.dtype == np.uint8 and got_u8.shape == (96, 3)
    np.testing.assert_array_equal(got_u8, np.round(np.clip(got_f, 0, 1) * 255).astype(np.uint8))
    bar = 1e-4 if dtype == "float32" else TOL["atol"]
    np.testing.assert_allclose(got_f, want_f, atol=bar, rtol=0)
    # Quantized colours: one uint8 step apart, beyond what the renders differ.
    steps = np.abs(got_u8.astype(int) - want_u8.astype(int))
    assert (steps <= 1 + np.ceil(255 * np.abs(got_f - want_f))).all()
    if dtype == "float32":
        assert steps.max() <= 1


def test_density_points_takes_the_kernel_or_the_module(rng):
    cfg = small_cfg("bfloat16", True)
    tsys = t_system.NeRFSystem(cfg, device="cpu")
    pts = rng.uniform(-1.2, 1.2, (7, 9, 3)).astype(np.float32)
    before = fm.sigma_launches
    fused = tsys.density_points(pts)
    assert fm.sigma_launches == before
    cfg.experiment.use_fused_kernel = False
    module = tsys.density_points(torch.from_numpy(pts))
    assert fused.shape == module.shape == (7, 9)
    assert fused.dtype == module.dtype == torch.float32
    np.testing.assert_allclose(fused.numpy(), module.numpy(), **TOL)
    np.testing.assert_array_equal(
        fused.numpy(), fm.fused_sigma_points(tsys.finest_model, torch.from_numpy(pts)).numpy())


def test_density_points_packs_once_until_the_weights_change(rng, monkeypatch):
    """The grid's tiles share one packing of the weights; an in-place
    update or a load_state_dict makes a new one."""
    tsys = t_system.NeRFSystem(small_cfg("bfloat16", True), device="cpu")
    packs = []
    monkeypatch.setattr(t_system, "pack_weights",
                        lambda model: packs.append(fm.pack_weights(model)) or packs[-1])
    pts = rng.uniform(-1.2, 1.2, (50, 3)).astype(np.float32)
    saved = {k: v.clone() for k, v in tsys.finest_model.state_dict().items()}
    first = tsys.density_points(pts)
    tsys.density_points(pts[::-1].copy())
    assert len(packs) == 1
    with torch.no_grad():
        tsys.finest_model.fc_alpha.bias.add_(1.0)
    torch.testing.assert_close(tsys.density_points(pts), first + 1.0, atol=1e-5, rtol=0)
    assert len(packs) == 2
    tsys.finest_model.load_state_dict(saved)
    assert torch.equal(tsys.density_points(pts), first) and len(packs) == 3


def _export(system, module, tmp_path, name, **kw):
    args = module.MeshArgs(res=32, limit=1.2, save_dir=str(tmp_path), mesh_name=name, **kw)
    return module.export_marching_cubes(system, args)


def test_mesh_cache_and_direct_colours_match_jax(tmp_path, f32_systems, monkeypatch):
    """no_view_dependence colours the vertices by the field at them; the
    geometry cache written by one package is read by the other and by a
    later call, which then evaluates no grid."""
    jsys, tsys = f32_systems
    flags = dict(no_view_dependence=True, override_cache_mesh=True)
    v_t, t_t, c_t, n_t = _export(tsys, t_extract, tmp_path, "t.obj", **flags)
    assert len(t_t) > 100 and (tmp_path / "mesh_cache.npz").exists()
    # JAX meshes the port's cached geometry and colours it by its own field.
    v_j, t_j, c_j, n_j = _export(jsys, j_extract, tmp_path, "j.obj", no_view_dependence=True,
                                 use_cached_mesh=True)
    for got, want in ((v_t, v_j), (t_t, t_j), (n_t, n_j)):
        np.testing.assert_array_equal(got, want)
    assert c_t.shape == (len(v_t), 3)
    np.testing.assert_allclose(c_t, c_j, atol=1e-5, rtol=0)

    def no_grid(*args, **kwargs):
        raise AssertionError("a cached mesh evaluates no grid")

    monkeypatch.setattr(t_extract, "extract_geometry", no_grid)
    again = _export(tsys, t_extract, tmp_path, "t2.obj", no_view_dependence=True,
                    use_cached_mesh=True)
    for got, want in zip(again, (v_t, t_t, c_t, n_t)):
        np.testing.assert_array_equal(got, want)
    assert (tmp_path / "t.obj").read_bytes() == (tmp_path / "t2.obj").read_bytes()


def test_export_marching_cubes_f32_matches_jax(tmp_path, f32_systems):
    """The nn.Module path on both sides, f32: the same mesh and colours."""
    jsys, tsys = f32_systems
    before = (fm.launches, fm.sigma_launches)
    v_t, t_t, c_t, n_t = _export(tsys, t_extract, tmp_path, "t.ply")
    assert (fm.launches, fm.sigma_launches) == before
    v_j, t_j, c_j, n_j = _export(jsys, j_extract, tmp_path, "j.ply")
    assert len(t_t) > 100
    assert v_t.shape == v_j.shape and t_t.shape == t_j.shape
    assert t_extract.LAST_TIMINGS["iso_effective"] == pytest.approx(
        j_extract.LAST_TIMINGS["iso_effective"], abs=1e-3)
    np.testing.assert_allclose(canon(v_t, t_t), canon(v_j, t_j), atol=1e-4)
    np.testing.assert_allclose(v_t, v_j, atol=1e-4)
    np.testing.assert_allclose(c_t, c_j, atol=1 / 255 + 1e-6)
    np.testing.assert_allclose(n_t, n_j, atol=1e-4)
    v_r, t_r, n_r, c_r = t_export.read_ply_binary(str(tmp_path / "t.ply"))
    np.testing.assert_array_equal(v_r, v_t)
    np.testing.assert_array_equal(t_r, t_t)
    np.testing.assert_array_equal(c_r, np.round(c_t * 255).astype(np.uint8))
    for key in ("grid_eval_device_s", "grid_transfer_s", "marching_cubes_s", "appearance_s",
                "write_s", "sparse_blocks_fetched"):
        assert key in t_extract.LAST_TIMINGS, key


def test_export_marching_cubes_bf16_fused_matches_jax(tmp_path, bf16_systems):
    """Fused kernels on both sides, bf16: sigma grids within the bf16 bar,
    and meshes within one grid cell squared of each other."""
    jsys, tsys = bf16_systems
    # A 16^3 grid in one tile: JAX's interpreted kernel pads a tile to 8192.
    grid_t = t_extract.extract_density(tsys.sample_points, 1.2, 16, tile=4096,
                                       density_fn=tsys.density_points)
    grid_j = j_extract.extract_density(jsys.sample_points, 1.2, 16, tile=4096,
                                       density_fn=jsys.density_points)
    np.testing.assert_allclose(grid_t, grid_j, **TOL)
    v_t, t_t, c_t, _ = _export(tsys, t_extract, tmp_path, "t.obj")
    v_j, t_j, _, _ = _export(jsys, j_extract, tmp_path, "j.obj")
    assert len(t_t) > 100 and len(t_j) > 100
    cell2 = (2 * 1.2 / 32) ** 2
    assert t_metrics.chamfer_between_meshes((v_t, t_t), (v_j, t_j)) < cell2
    assert np.isfinite(c_t).all() and c_t.min() >= 0 and c_t.max() <= 1
