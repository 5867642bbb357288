"""The layer route's gate, route, slab planner and plain versions on the
CPU (nerfmeshes_tpu_torch/ops/kernels/field_layers.py,
csrc/field_layers.cu: every model supports_fused admits that the fused
kernels' plans refuse).

- The port's supports_fused is JAX's (nerfmeshes_tpu/ops/pallas/
  fused_mlp.py:750-761) on a grid of widths, band counts, depths and
  viewdirs on and off.
- field_route is "fused" exactly where the fused kernels' plans hold
  (fm.field_plan) at the widths of fm.FUSED_WIDTHS (128-384), and "layers"
  at every other width for every band pair: at 512 and 1024 wide the
  plans themselves refuse 412 of the 576.
- The workspace's regions (workspace_layout), the bias-grad reduction's
  segments and scratch, and the launches a slab and a call make
  (slab_launches, call_launches), which the chip smoke holds the route's
  kernel counts to.
- The slab planner keeps a call's workspace under its bound at the mesh
  appearance chunk of a 2048-wide field, and plans whole tiles.
- The plain forward, sigma and backward, which the route's kernels are
  held to on the card, against JAX's Pallas kernels in interpret mode
  (fused_flexible_apply, fused_sigma_points, jax.grad through
  fused_flexible_apply_rays) at the shapes only the layer route takes on
  the card: 3 x 1152, 3 x 2048, 8 x 1024 at mip-NeRF's 16 position bands,
  16 layers and 32 bands at 128 wide; 64 points each.

Tolerances are those of tests/test_torch_fused_mlp.py: forward atol = rtol
= 2e-2 (bf16 operands rounded at other points, a polynomial sine on the
TPU side); grads worst relative error < 5e-2, or, where a ReLU mask within
~1e-5 of zero flips between the two stacks' sines, against a float64
truth no worse than twice JAX's fused path.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfmeshes_tpu.models import FlexibleNeRFModel as JaxFlexible
from nerfmeshes_tpu.ops.pallas import fused_mlp as j_fused
from nerfmeshes_tpu_torch.models import FlexibleNeRFModel
from nerfmeshes_tpu_torch.models.transplant import state_dict_from_flax
from nerfmeshes_tpu_torch.ops.kernels import field_layers as fl
from nerfmeshes_tpu_torch.ops.kernels import fused_mlp as fm

torch.set_num_threads(1)

TOL = dict(atol=2e-2, rtol=2e-2)
GRAD_BAR = 5e-2
LEGO = dict(num_layers=8, hidden_size=256, skip_step=4, num_encoding_fn_xyz=10,
            num_encoding_fn_dir=4)

# The supports_fused grid: one case per width, each over bands, depths and
# viewdirs.
GATE_WIDTHS = [100, 128, 512, 1024, 1152, 1536, 2048]
GATE_BANDS = [0, 1, 24, 25, 32]
GATE_LAYERS = [1, 14, 16]


@pytest.mark.parametrize("hidden", GATE_WIDTHS)
def test_supports_fused_is_jax_predicate(hidden):
    for lx, ld, layers, viewdirs in itertools.product(GATE_BANDS, GATE_BANDS, GATE_LAYERS,
                                                      (True, False)):
        kw = dict(num_layers=layers, hidden_size=hidden, skip_step=4, num_encoding_fn_xyz=lx,
                  num_encoding_fn_dir=ld, use_viewdirs=viewdirs)
        got = fm.supports_fused(FlexibleNeRFModel(**kw, device="meta"))
        assert got == j_fused.supports_fused(JaxFlexible(**kw)), kw
        assert got == (hidden % 128 == 0 and lx > 0 and ld > 0 and viewdirs), kw


# 8-layer fields over L_x, L_d in 1..24: the band pairs whose model the
# fused plans refuse at each width (the rest of HIDDEN_SIZES: none).
REFUSED = {512: 412, 896: 1, 1024: 412}


@pytest.mark.parametrize("hidden", [*fm.HIDDEN_SIZES, 1152])
def test_route_is_fused_exactly_where_the_plans_hold(hidden):
    """At FUSED_WIDTHS the route is "fused" exactly where the plans hold;
    at 512-1024 (the plans hold all but REFUSED of the band pairs) and past
    1024 it is "layers" for all 576."""
    refused = layers = 0
    for lx, ld in itertools.product(range(1, 25), repeat=2):
        model = FlexibleNeRFModel(**dict(LEGO, hidden_size=hidden, num_encoding_fn_xyz=lx,
                                         num_encoding_fn_dir=ld), device="meta")
        spec = fm.spec_from_model(model)
        plans = all(fm.field_plan(spec, k) is not None for k in ("fwd", "sigma", "bwd"))
        fused = hidden in fm.FUSED_WIDTHS and plans
        assert fm.field_route(spec) == ("fused" if fused else "layers"), (lx, ld)
        refused += not (hidden in fm.HIDDEN_SIZES and plans)
        layers += not fused
    assert refused == (576 if hidden not in fm.HIDDEN_SIZES else REFUSED.get(hidden, 0))
    assert layers == (0 if hidden in fm.FUSED_WIDTHS else 576)
    # mip-NeRF's 16 position bands: the plans refuse them at 512 and 1024
    # wide (15 fit); the route takes every width from 512 on
    mip = fm.spec_from_model(FlexibleNeRFModel(**dict(LEGO, hidden_size=hidden,
                                                      num_encoding_fn_xyz=16), device="meta"))
    refused = any(fm.field_plan(mip, k) is None for k in ("fwd", "sigma", "bwd"))
    assert refused == (hidden in (512, 1024)) or hidden not in fm.HIDDEN_SIZES
    assert (fm.field_route(mip) == "layers") == (hidden not in fm.FUSED_WIDTHS)


@pytest.mark.parametrize("overrides", [dict(num_layers=15), dict(num_layers=40, skip_step=3),
                                       dict(num_encoding_fn_dir=25)],
                         ids=["15-layers", "40-layers", "25-bands"])
def test_route_takes_depths_and_bands_past_the_fused_limits(overrides):
    """Past MAX_LAYERS and MAX_BANDS every width takes the layer route,
    and the pack holds each product's K, which the route reads off the
    offsets (40 layers: skips past the descriptor's 31 mask bits)."""
    model = FlexibleNeRFModel(**dict(LEGO, **overrides), device="meta")
    spec = fm.spec_from_model(model)
    assert fm.supports_fused(model) and fm.field_route(spec) == "layers"
    packed = fm.pack_weights(FlexibleNeRFModel(**dict(LEGO, **dict(overrides, hidden_size=128))))
    spec = packed.spec
    offs = packed.desc[fm._DESC_FIXED:fm._DESC_FIXED + spec.num_layers + 2].tolist()
    ends = offs[1:] + [int(packed.desc[9])]
    assert [(e - o) // n for o, e, (n, _) in zip(offs, ends, spec.gemm_shapes())] == \
        [k for _, k in spec.gemm_shapes()]


@pytest.mark.parametrize("kind", ["fwd", "sigma", "bwd"])
@pytest.mark.parametrize("hidden,L_x", [(2048, 10), (1024, 16), (1152, 10)])
def test_slab_planner_keeps_the_workspace_under_its_bound(kind, hidden, L_x):
    """At the mesh appearance chunk (65,536 rays x 192 samples): the slab
    is whole 128-point tiles, its workspace at most the bound, one more
    tile's over it; one activation buffer of the whole chunk alone would
    be 51.5 GB at 2048 wide. A small call takes one slab of all its
    points."""
    spec = fm.spec_from_model(FlexibleNeRFModel(**dict(LEGO, hidden_size=hidden,
                                                       num_encoding_fn_xyz=L_x), device="meta"))
    n = 65536 * 192
    assert n * hidden * 2 / 1e9 > 25
    slab = fl.slab_points(spec, kind, n)
    assert slab % 128 == 0 and 128 <= slab < n
    assert fl.workspace_bytes(spec, kind, slab) <= fl.LAYER_WORKSPACE_BOUND
    assert fl.workspace_bytes(spec, kind, slab + 128) > fl.LAYER_WORKSPACE_BOUND
    assert fl.slab_points(spec, kind, 1000) == 1024
    # the planner's workspace grows with the slab, tile by tile
    assert fl.workspace_bytes(spec, kind, 256) > fl.workspace_bytes(spec, kind, 128)


def test_dw_groups_cover_every_weight():
    """The backward's dW launches write every packed weight's grad once:
    their grads add up to the pack's weights."""
    for kw in (dict(LEGO, hidden_size=1152), dict(LEGO, num_layers=16),
               dict(LEGO, num_encoding_fn_xyz=32)):
        packed = fm.pack_weights(FlexibleNeRFModel(**dict(kw, hidden_size=128)))
        assert sum(c for c, _ in fl.dw_groups(packed.spec)) == packed.weights.numel()
        assert all(1 <= r <= 24 for _, r in fl.dw_groups(packed.spec))


# The plain versions against JAX's Pallas kernels (interpret mode).
ARCHS = [
    dict(LEGO, num_layers=3, hidden_size=1152),
    dict(LEGO, num_layers=3, hidden_size=2048),
    dict(LEGO, hidden_size=1024, num_encoding_fn_xyz=16),
    dict(LEGO, num_layers=16, hidden_size=128),
    dict(LEGO, hidden_size=128, num_encoding_fn_xyz=32, num_encoding_fn_dir=32),
]
IDS = ["3x1152", "3x2048", "8x1024-L16", "16x128", "bands32"]
R, S = 8, 8


def _pair(kw, seed=0):
    jm = JaxFlexible(**kw, dtype=jnp.bfloat16)
    pts = jnp.zeros((2, 3), jnp.float32)
    params = jm.init(jax.random.key(seed), pts, pts)
    tm = FlexibleNeRFModel(**kw, compute_dtype=torch.bfloat16)
    tm.load_state_dict(state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params), kw))
    assert j_fused.supports_fused(jm) and fm.supports_fused(tm)
    assert fm.field_route(fm.spec_from_model(tm)) == "layers"
    return jm, params, tm


def _rays(rng):
    o = rng.uniform(-1.5, 1.5, (R, 3)).astype(np.float32)
    d = rng.standard_normal((R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    z = np.sort(rng.uniform(0.0, 2.0, (R, S)), axis=1).astype(np.float32)
    return o, d, z


def _hold(got, pallas, model):
    """The port within TOL of JAX's model, and of JAX's Pallas kernel
    unless that kernel itself misses JAX's model by more than TOL: past
    ~24 bands its sine (a polynomial of the phase in turns, x f / 2 pi
    rounded to f32) and the models' (sin of x f rounded to f32) are sines
    of two roundings of one product whose f32 spacing reaches radians (at
    32 bands, JAX's kernel against its model: 0.074)."""
    np.testing.assert_allclose(got, model, **TOL)
    gap = float(np.abs(pallas - model).max())
    if np.allclose(pallas, model, **TOL):
        np.testing.assert_allclose(got, pallas, **TOL)
    else:
        print(f"JAX's Pallas kernel misses JAX's model by {gap:.4f}; the port "
              f"{float(np.abs(got - model).max()):.4f}")


def _worst_rel(want: dict, got: dict) -> float:
    return max(float((got[k] - want[k]).abs().max() / (want[k].abs().max() + 1e-6))
               for k in want)


@pytest.mark.parametrize("kw", ARCHS, ids=IDS)
def test_plain_forward_and_sigma_match_jax_kernels(rng, kw):
    """The forward at 64 points and sigma at 64 grid points against JAX's
    Pallas forward and sigma kernels and JAX's model (_hold); no kernel
    launched on CPU tensors; the plain sigma bit for bit the plain
    forward's channel 3."""
    jm, params, tm = _pair(kw)
    pts = rng.standard_normal((R * S, 3)).astype(np.float32)
    dirs = rng.standard_normal((R * S, 3)).astype(np.float32)

    def model(p, d):
        return np.asarray(jm.apply(params, jnp.asarray(p), jnp.asarray(d)).astype(jnp.float32))

    want = j_fused.fused_flexible_apply(jm, params, jnp.asarray(pts), jnp.asarray(dirs),
                                        inference=True)
    before = (fl.launches, fl.sigma_launches, fm.launches, fm.sigma_launches)
    got = fm.fused_flexible_apply(tm, torch.from_numpy(pts), torch.from_numpy(dirs))
    _hold(got.numpy(), np.asarray(want), model(pts, dirs))
    grid = rng.uniform(-1.2, 1.2, (R * S, 3)).astype(np.float32)
    want = j_fused.fused_sigma_points(jm, params, jnp.asarray(grid))
    sigma = fm.fused_sigma_points(tm, torch.from_numpy(grid))
    assert (fl.launches, fl.sigma_launches, fm.launches, fm.sigma_launches) == before
    _hold(sigma.numpy(), np.asarray(want), model(grid, dirs)[:, 3])
    packed = fm.pack_weights(tm)
    zeros = torch.zeros((R * S, 3))
    full = fm.fused_mlp_plain(packed, torch.from_numpy(grid), zeros, zeros[:, :1])
    assert torch.equal(sigma, full[3, :, 0])


@pytest.mark.parametrize("kw", ARCHS, ids=IDS)
def test_plain_backward_matches_jax_kernel(rng, kw):
    """The training Function's grads (plain forward and backward on the
    CPU) against jax.grad through JAX's fused path, whose backward is the
    Pallas _bwd_kernel in interpret mode: within 5e-2, or against the
    float64 truth (the f64 flax model on the same weights and points) no
    worse than twice JAX's fused path."""
    jm, params, tm = _pair(kw)
    o, d, z = _rays(rng)
    cot = rng.standard_normal((4, R, S)).astype(np.float32)

    def loss(p):
        out = j_fused.fused_flexible_apply_rays(jm, p, jnp.asarray(o), jnp.asarray(d),
                                                jnp.asarray(z), inference=False)
        return jnp.sum(out * jnp.asarray(cot))

    g = jax.grad(loss)(params)
    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, g), kw)
    before = (fl.launches, fl.bwd_launches, fm.launches, fm.bwd_launches)
    out = fm.fused_flexible_apply_rays(tm, *(torch.from_numpy(a) for a in (o, d, z)))
    (out * torch.from_numpy(cot)).sum().backward()
    assert (fl.launches, fl.bwd_launches, fm.launches, fm.bwd_launches) == before
    got = {k: p.grad for k, p in tm.named_parameters()}
    assert set(got) == set(want)
    worst = _worst_rel(want, got)
    if worst < GRAD_BAR:
        return
    m64 = JaxFlexible(**kw, dtype=jnp.float64)
    pts = (o[:, None] + d[:, None] * z[..., None]).reshape(-1, 3)
    dirs = np.repeat(d, S, axis=0)
    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(lambda x: jnp.asarray(np.asarray(x), jnp.float64), params)
        cot64 = jnp.asarray(cot.reshape(4, -1).T, jnp.float64)
        g64 = jax.grad(lambda q: jnp.sum(m64.apply(q, jnp.asarray(pts, jnp.float64),
                                                   jnp.asarray(dirs, jnp.float64)) * cot64))(p64)
        g64 = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64), g64)
    truth = {k: v.double() for k, v in state_dict_from_flax(g64, kw).items()}
    err_jax = _worst_rel(truth, {k: v.double() for k, v in want.items()})
    err_port = _worst_rel(truth, {k: v.double() for k, v in got.items()})
    assert err_port < max(2.0 * err_jax, GRAD_BAR), (
        f"port grads ({err_port:.4f} vs f64; {worst:.4f} vs JAX) worse than JAX's fused path "
        f"({err_jax:.4f})")


def test_pe_plain_is_the_plain_forward_s_pe(rng):
    """The PE kernel's plain version is the PE the plain forward feeds its
    first product (rounded to bf16), at rays and at points."""
    packed = fm.pack_weights(FlexibleNeRFModel(**ARCHS[4]))
    o, d, z = (torch.from_numpy(a) for a in _rays(rng))
    pe_x, pe_d = fl.layers_pe_plain(packed, o, d, z)
    spec = packed.spec
    assert pe_x.shape == (R * S, spec.pxp) and pe_d.shape == (R * S, spec.pdp)
    pts = (o[:, None, :] + d[:, None, :] * z[..., None]).reshape(-1, 3)
    assert torch.equal(fl.layers_pe_plain(packed, pts)[0], pe_x)
    assert torch.equal(pe_x, fm._padded_pe(pts, spec.L_x, spec.include_x, spec.log_x,
                                           spec.pxp).to(torch.bfloat16))


def test_product_plain_and_wrappers_refuse_cpu_tensors(rng):
    """The product kernel's plain version: [a1 | a2] W^T + bias with ReLU,
    or A W's first n columns under a mask, and its column sums per 128
    rows; the CUDA wrappers raise on CPU tensors rather than fall back."""
    a1 = torch.from_numpy(rng.standard_normal((200, 64)).astype(np.float32)).bfloat16()
    a2 = torch.from_numpy(rng.standard_normal((200, 16)).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.standard_normal((64, 80)).astype(np.float32)).bfloat16()
    bias = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
    y, cs = fl.layers_product_plain(a1, a2, w, 64, bias=bias, relu=True)
    ref = torch.cat([a1, a2], 1).float() @ w.float().t() + bias
    torch.testing.assert_close(y.float(), ref.clamp_min(0).bfloat16().float())
    torch.testing.assert_close(cs, torch.stack([ref.clamp_min(0)[:128].sum(0),
                                                ref.clamp_min(0)[128:].sum(0)]))
    wt = torch.from_numpy(rng.standard_normal((64, 96)).astype(np.float32)).bfloat16()
    mask = a1.clone()
    y, _ = fl.layers_product_plain(a1, None, wt, 64, nn=True, mask=mask)
    ref = a1.float() @ wt.float()[:, :64]
    torch.testing.assert_close(y.float(), torch.where(mask > 0, ref, 0.0).bfloat16().float())
    packed = fm.pack_weights(FlexibleNeRFModel(**ARCHS[3]))
    o, d, z = (torch.from_numpy(a) for a in _rays(rng))
    h = torch.zeros((R * S, packed.spec.hidden // 2), dtype=torch.bfloat16)
    for call in (lambda: fl.layers_mlp_cuda(packed, o, d, z),
                 lambda: fl.layers_sigma_cuda(packed, o),
                 lambda: fl.layers_bwd_cuda(packed, o, d, z, torch.zeros((4, R, S))),
                 lambda: fl.layers_pe_cuda(packed, o, d, z),
                 lambda: fl.layers_product_cuda(a1, a2, w, 64),
                 lambda: fl.layers_heads_bwd_cuda(packed, h, torch.zeros((4, R * S))),
                 lambda: fl.layers_bias_cuda([torch.zeros((3, 4))], [torch.zeros(4)]),
                 lambda: fl.layers_dw_cuda([fl.DwJob(h, h, 0, h.shape[1], 0)],
                                           torch.zeros(h.shape[1] ** 2))):
        with pytest.raises(ValueError, match="CUDA"):
            call()


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_cases_take_the_layer_route():
    """chip_smoke.py's layer-route cases (hard-blender.yml's fields changed
    as LAYER_CASES says) are models JAX's Pallas kernels take and
    fm.field_route sends to the layer route, both fields; its chains and
    its cases broken down by kernel are among them; the wide chains
    (wide_cfg) take the fused route at 384 and the layer route from 512 on,
    on fields every fused plan holds (wide_phase calls those kernels
    directly); every kernel name it groups a trace by is a __global__ of
    csrc/."""
    import re
    from pathlib import Path

    from nerfmeshes_tpu_torch.models import build_model

    smoke = _chip_smoke()
    assert set(smoke.LAYER_CHAINS) <= set(smoke.LAYER_CASES)
    assert set(smoke.LAYER_LEG_CASES) <= set(smoke.LAYER_CASES)
    configs = [(case, smoke.layer_cfg(case), "layers") for case in smoke.LAYER_CASES]
    configs += [(f"w{H}", smoke.wide_cfg(H), "fused" if H in fm.FUSED_WIDTHS else "layers")
                for H in smoke.WIDE_HIDDEN]
    assert [H for H in smoke.WIDE_HIDDEN if H not in fm.FUSED_WIDTHS] == [
        512, 640, 768, 896, 1024]
    for case, cfg, route in configs:
        for node, kind in ((cfg.models.coarse, cfg.models.coarse_type),
                           (cfg.models.fine, cfg.models.fine_type)):
            model = build_model(kind, dict(node), device="meta")
            spec = fm.spec_from_model(model)
            assert fm.supports_fused(model), case
            assert fm.field_route(spec) == route, case
            if case in [f"w{H}" for H in smoke.WIDE_HIDDEN]:
                assert all(fm.field_plan(spec, k) for k in ("fwd", "sigma", "bwd")), case
    csrc = Path(fm.__file__).resolve().parents[2] / "csrc"
    pattern = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(")
    defined = {name for src in csrc.glob("*.cu*") for name in pattern.findall(src.read_text())}
    names = {k for keys in smoke.LAYER_KERNELS.values() for k in keys}
    assert names <= defined, sorted(names - defined)


def _layer_specs():
    """(id, MLPSpec) of every layer-route field the tests and the chip
    smoke run: ARCHS, and both fields of chip_smoke.py's LAYER_CASES."""
    from nerfmeshes_tpu_torch.models import build_model

    specs = [(i, fm.spec_from_model(FlexibleNeRFModel(**kw, device="meta")))
             for i, kw in zip(IDS, ARCHS)]
    smoke = _chip_smoke()
    for case in smoke.LAYER_CASES:
        cfg = smoke.layer_cfg(case)
        for tag, node, kind in (("coarse", cfg.models.coarse, cfg.models.coarse_type),
                                ("fine", cfg.models.fine, cfg.models.fine_type)):
            specs.append((f"{case}-{tag}",
                          fm.spec_from_model(build_model(kind, dict(node), device="meta"))))
    return specs


LAYER_SPECS = _layer_specs()
# Row counts of the walk: one row, a ragged tile, whole tiles, a 2048-wide
# backward slab of the smoke (42,240 points) and its ragged neighbour.
WALK_ROWS = [1, 127, 128, 129, 4097, 42240, 42241]


@pytest.mark.parametrize("spec", [s for _, s in LAYER_SPECS], ids=[i for i, _ in LAYER_SPECS])
def test_product_plans_fit_and_the_walk_covers_every_tile_once(spec):
    """Every product the route issues for this field (forward, sigma and
    backward, field_layers.route_products) gets a plan within the H100's
    232,448 B of shared memory with at least 2 ring stages and a tile width
    wgmma takes, the one of least tiles x (width + 64), the columns computed
    with each tile's share of A loads and epilogue; and the persistent
    kernel's tile walk (product_tiles, 132 CTAs) computes each 128 x bn
    output tile of the product exactly once, row blocks in order with N
    fastest."""
    seen = set()
    for kind in ("fwd", "sigma", "bwd"):
        products = fl.route_products(spec, kind)
        assert len(products) == spec.num_layers + {"fwd": 2, "sigma": 0,
                                                   "bwd": 3 + spec.num_layers}[kind]
        for k1, k2, n, nn in products:
            assert k1 > 0 and k2 >= 0 and n % 64 == 0 and (k2 == 0 or k1 % 64 == 0)
            plan = fl.product_plan(n)
            assert plan is not None and plan.bytes <= fm.SMEM_LIMIT and plan.stages >= 2
            assert plan.bn in (64, 128, 192, 256) and plan.col_tiles * plan.bn >= n
            cost = [-(-n // bn) * (bn + 64) for bn in (64, 128, 192, 256)]
            assert plan.col_tiles * (plan.bn + 64) == min(cost)
            seen.add(n)
    for n in seen:
        bn = fl.product_bn(n)
        for m in WALK_ROWS:
            walk = fl.product_tiles(m, n, 132)
            tiles = [t for cta in walk for t in cta]
            want = {(r, c) for r in range(0, m, 128) for c in range(0, n, bn)}
            assert len(walk) == min(132, len(want))
            assert len(tiles) == len(want) and set(tiles) == want
            assert all(cta == sorted(cta) for cta in walk)
            assert max(map(len, walk)) - min(map(len, walk)) <= 1  # waves, the last ragged


def test_product_tile_widths_fit_n():
    """The tile width per product: no empty columns where a width divides
    n with as few tiles (576 and 1152 -> 192, 64 -> 64, 128 -> 128, 1024 and
    2048 -> 256), and 1088 on 192-wide tiles (64 empty columns, not 192);
    the plan's bytes and stages are field_layers.cu's layout."""
    assert {n: fl.product_bn(n) for n in (64, 128, 576, 1024, 1088, 1152, 2048)} == {
        64: 64, 128: 128, 576: 192, 1024: 256, 1088: 192, 1152: 192, 2048: 256}
    assert fl.product_plan(1024) == fl.ProductPlan(256, 3, 4, 221320)
    assert fl.product_plan(576) == fl.ProductPlan(192, 4, 3, 219272)
    assert fl.product_plan(64) == fl.ProductPlan(64, 8, 1, 215176)
    assert fl.product_plan(64, smem_limit=16384 + 24576 * 2 + 2048 + 136 - 1) is None


# Backward slabs of the workspace tests: one tile, ragged-free multiples of
# 128 (every slab is), an 8x2048 slab of the smoke (41,856 points at 2048 x
# 192) and the largest the C entry takes.
LAYOUT_SLABS = [128, 384, 41856, 65535 * 128]


@pytest.mark.parametrize("spec", [s for _, s in LAYER_SPECS], ids=[i for i, _ in LAYER_SPECS])
def test_workspace_regions_follow_one_another(spec):
    """workspace_layout's regions (the C layers_layout's, in its order)
    for every kind: each on a 256 B boundary right after the one before,
    the total workspace_bytes; in the backward every dX product's column
    sums a region of their own (L + 1 of slab / 128 rows x H f32), the
    heads' partials (slab / 64 rows x H/2 + 4), and the bias-grad
    reduction's level-1 rows and counters, bias_scratch of the slab's
    bias_segments; the regions the dir layer's cotangent and everything
    before it lie in are where they were before these (a backward call's
    dy_dir offset is the one its parent layout gave)."""
    H, L = spec.hidden, spec.num_layers
    for kind in ("fwd", "sigma", "bwd"):
        for slab in LAYOUT_SLABS:
            layout = fl.workspace_layout(spec, kind, slab)
            off = 0
            for name, (at, nbytes) in layout.items():
                if name == "total":
                    assert at == off == fl.workspace_bytes(spec, kind, slab)
                    continue
                assert at == off and at % 256 == 0, (kind, slab, name)
                off = at + -(-nbytes // 256) * 256
            if kind != "bwd":
                assert "colsum" not in layout and "bpart" not in layout
                continue
            assert list(layout)[-7:] == ["dy1", "colsum", "hpart", "bpart", "bcount", "dwpart",
                                         "total"]
            assert layout["colsum"][1] == (L + 1) * (slab // 128) * H * 4
            assert layout["hpart"][1] == slab // 64 * (H // 2 + 4) * 4
            level1, counters = fl.bias_scratch(fl.bias_segments(spec, slab))
            assert (layout["bpart"][1], layout["bcount"][1]) == (4 * level1, 4 * counters)
            before = sum(-(-b // 256) * 256 for b in (
                (spec.pxp + spec.pdp) * 8, slab * spec.pxp * 2, slab * spec.pdp * 2,
                L * slab * H * 2, slab * H * 2, slab * H, slab * 32, slab * 32))
            assert layout["dy_dir"][0] == before


@pytest.mark.parametrize("spec", [s for _, s in LAYER_SPECS], ids=[i for i, _ in LAYER_SPECS])
def test_backward_slabs_fit_the_bound(spec):
    """At the smoke's train shape (2048 x 192) and its mesh appearance
    chunk (65,536 x 192), the backward's slabs, the new regions included,
    keep the workspace under LAYER_WORKSPACE_BOUND, one tile more over it
    or all the points in one slab."""
    for n in (2048 * 192, 65536 * 192):
        slab = fl.slab_points(spec, "bwd", n)
        assert fl.workspace_bytes(spec, "bwd", slab) <= fl.LAYER_WORKSPACE_BOUND
        assert slab >= n or fl.workspace_bytes(spec, "bwd", slab + 128) > \
            fl.LAYER_WORKSPACE_BOUND


def test_bias_segments_and_scratch():
    """A backward slab's bias vectors, in field_layers.cu's order: the L + 1
    dX products' column sums per 128 points (ragged: ceil), then the heads'
    per 64 (H/2 and 4 columns); the reduction's level-1 rows (one per 64
    partial rows) and counters (one per 128 columns)."""
    spec = fm.spec_from_model(FlexibleNeRFModel(**dict(LEGO, hidden_size=2048), device="meta"))
    assert fl.bias_segments(spec, 41856) == [(327, 2048)] * 9 + [(654, 1024), (654, 4)]
    assert fl.bias_segments(spec, 300) == [(3, 2048)] * 9 + [(5, 1024), (5, 4)]
    assert fl.bias_scratch([(327, 2048), (654, 4), (65, 576)]) == (
        6 * 2048 + 11 * 4 + 2 * 576, 16 + 1 + 5)


# (architecture, backward slabs at 2048 x 192 points) of the smoke's chains
# on the layer route: 8x512 and 8x1024 at L 10/4, 8x1024 at L 16/4, 8x2048.
CHAIN_SLABS = [(dict(LEGO, hidden_size=512), 3), (dict(LEGO, hidden_size=1024), 5),
               (dict(LEGO, hidden_size=1024, num_encoding_fn_xyz=16), 5),
               (dict(LEGO, hidden_size=2048), 10)]


@pytest.mark.parametrize("kw,slabs", CHAIN_SLABS, ids=["w512", "w1024", "w1024-L16", "w2048"])
def test_launch_mirror_of_a_call(kw, slabs):
    """The launches the chip smoke holds the route's counts to: per slab a
    PE, the route's products, a heads launch (the backward's heads kernel
    counted apart from the forward's and sigma's); in the backward, per
    weight matrix a dW launch (two where its units leave a last wave part
    full: dw_plan) and a reduction of its range partials, and one
    bias-grad launch: 11 reduction launches a slab at 8 layers (21 before
    the bias grads shared one launch); per call the slabs'."""
    spec = fm.spec_from_model(FlexibleNeRFModel(**kw, device="meta"))
    per_slab = fl.slab_launches(spec, "bwd", 128)
    groups = list(zip(fl.dw_groups(spec), fl._group_jobs(spec)))
    dw = sum(fl.dw_plan(jobs, 128, r).launches for (_, r), jobs in groups)
    assert per_slab == {"pe": 1, "product": 2 * 8 + 3, "heads": 0, "dw": dw, "reduce": 10,
                        "bias": 1, "heads_bwd": 1} and 10 <= dw <= 20
    assert per_slab["reduce"] + per_slab["bias"] == 11
    assert fl.slab_launches(spec, "fwd", 128) == {"pe": 1, "product": 10, "heads": 1, "dw": 0,
                                                  "reduce": 0, "bias": 0, "heads_bwd": 0}
    assert fl.slab_launches(spec, "sigma", 128)["product"] == 8
    n = 2048 * 192
    slab = fl.slab_points(spec, "bwd", n)
    assert -(-n // slab) == slabs
    want = {k: v * slabs for k, v in per_slab.items()}
    want["dw"] = sum(fl.dw_plan(jobs, min(slab, n - row0), r).launches
                     for row0 in range(0, n, slab) for (_, r), jobs in groups)
    assert fl.call_launches(spec, "bwd", n) == want and 10 * slabs < want["dw"] <= 20 * slabs
    assert fl.call_launches(spec, "fwd", 0) == dict.fromkeys(fl.KERNELS, 0)
    # past 29 layers the bias vectors take two launches a slab
    deep = fm.spec_from_model(FlexibleNeRFModel(**dict(LEGO, num_layers=40, skip_step=3),
                                                device="meta"))
    assert fl.slab_launches(deep, "bwd", 128)["bias"] == 2


@pytest.mark.parametrize("kw", [ARCHS[0], ARCHS[3]], ids=["3x1152", "16x128"])
def test_heads_and_bias_plain_are_the_plain_backward_s(rng, kw):
    """The backward heads kernel's plain version, on the h and cotangent of
    a plain backward (fm.fused_mlp_bwd_plain, held to JAX's Pallas kernel
    above), gives that backward's heads bias grads and the dir layer's bias
    grad once its partials are summed (layers_bias_plain); its dy_dir is
    the backward's bf16 cotangent of the dir layer's output."""
    _, _, tm = _pair(kw)
    packed = fm.pack_weights(tm)
    spec = packed.spec
    H, L = spec.hidden, spec.num_layers
    o, d, z = (torch.from_numpy(a) for a in _rays(rng))
    cot = torch.from_numpy(rng.standard_normal((4, R, S)).astype(np.float32))
    pe_x, pe_d = fl.layers_pe_plain(packed, o, d, z)
    x = fm._layer(packed, pe_x.float(), 0, H, relu=False).bfloat16().float()
    for i in range(L - 1):
        a = torch.cat([x, pe_x.float()], 1) if i in spec.skip_layers else x
        x = fm._layer(packed, a, 1 + i, H, relu=True).bfloat16().float()
    feat = fm._layer(packed, x, L, H, relu=True).bfloat16().float()
    h = fm._layer(packed, torch.cat([feat, pe_d.float()], 1), L + 1, H // 2,
                  relu=True).bfloat16()
    dy_rgb, dy_a, dy_dir, part = fl.layers_heads_bwd_plain(packed, h, cot.reshape(4, -1))
    _, dB = fm.fused_mlp_bwd_plain(packed, o, d, z, cot)
    segs = packed.segments(biases=dB)
    heads, dir_b = fl.layers_bias_plain([part[:, H // 2:], part[:, :H // 2]],
                                        [torch.zeros(4), torch.zeros(H // 2)])
    torch.testing.assert_close(heads, torch.cat([segs["ba"], segs["br"]]), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dir_b, segs[f"b{L + 1}"], rtol=1e-5, atol=1e-5)
    assert torch.equal(dy_a[:, 0], cot[3].reshape(-1).bfloat16())
    assert not dy_rgb[:, 3:].float().any() and not dy_a[:, 1:].float().any()
    assert dy_dir.dtype == torch.bfloat16 and dy_dir.shape == (R * S, H // 2)


# The dW leg's plan (dw_groups, dw_plan, dw_walk: the mirrors of
# field_layers.cu's): the (block, range) units, the whole waves and the last
# wave's pieces.
DW_ROWS = [1, 63, 64, 65, 4097, 39936, 82944]


@pytest.mark.parametrize("spec", [s for _, s in LAYER_SPECS], ids=[i for i, _ in LAYER_SPECS])
def test_dw_walk_covers_every_block_and_range_once(spec):
    """For every dW launch of the field at its 2048 x 192 backward slab and
    at ragged point counts: the walk (132 SMs) sums every column of each
    128 x 256 block of each job over each point range exactly once; the
    ranges cover the points in whole 64-point slabs (the last one short);
    the first launch's units fill whole waves at 256 columns, the second
    takes the rest in pieces of 128 or 64 columns, as many as the SMs hold
    at once; a launch's CTAs walk their items in unit order, range by
    range."""
    slab = fl.slab_points(spec, "bwd", 2048 * 192)
    for (cols, ranges), jobs in zip(fl.dw_groups(spec), fl._group_jobs(spec)):
        assert 1 <= ranges <= 24
        for m in DW_ROWS + [slab]:
            plan = fl.dw_plan(jobs, m, ranges)
            n_pad = -(-m // 64) * 64
            assert plan.range_pts % 64 == 0 and (plan.ranges - 1) * plan.range_pts < n_pad
            assert plan.ranges * plan.range_pts >= n_pad and plan.ranges <= ranges
            assert plan.whole % 132 == 0 and plan.units - plan.whole < 132
            left = plan.units - plan.whole
            assert plan.pieces in (1, 2, 4) and (left == 0 or left * plan.pieces <= 132)
            assert plan.pieces == 4 or left == 0 or left * plan.pieces * 2 > 132
            walk = fl.dw_walk(jobs, plan)
            assert len(walk) == plan.launches == (plan.whole > 0) + (left > 0)
            want = {(r, j, c0, r0): set(range(c0, c0 + min(256, n - c0)))
                    for r in range(plan.ranges) for j, (rows, n) in enumerate(jobs)
                    for c0 in range(0, n, 256) for r0 in range(0, rows, 128)}
            got = {}
            for launch in walk:
                assert len(launch) <= 132
                for parts in launch:
                    units = [(r, j, b, r0) for r, j, b, r0, _ in parts]
                    assert units == sorted(units)
                    for r, j, c, r0, width in parts:
                        block = (r, j, c - c % 256, r0)
                        cols_ = set(range(c, c + width))
                        assert not cols_ & got.get(block, set())
                        got.setdefault(block, set()).update(cols_)
            assert got == want


# (width, the trunk matrices' whole-wave units and last-wave pieces a
# unit) at the smoke's 2048 x 192 backward slab of an 8-layer field.
WAVE_WIDTHS = [(512, 132, 2), (1024, 264, 4), (2048, 264, 1)]


@pytest.mark.parametrize("hidden,whole,pieces", WAVE_WIDTHS)
def test_dw_units_fill_whole_waves(hidden, whole, pieces):
    """At the smoke's backward slab, every dW launch of an 8-layer field
    keeps the route's point ranges (dw_groups, so dW keeps its bits) and
    runs its units in whole waves of the 132 SMs, then the last wave's
    units in as many column pieces as fill the SMs: at 1024 wide 264 units
    and 24 in 64-column pieces (96 CTAs), where a CTA a unit ran a third
    wave of 24 units on 132 SMs; the modelled time (waves of a unit's
    slabs, a piece a quarter or half of one) never longer than that."""
    spec = fm.spec_from_model(FlexibleNeRFModel(**dict(LEGO, hidden_size=hidden),
                                                device="meta"))
    slab = fl.slab_points(spec, "bwd", 2048 * 192)
    for g, ((cols, r), jobs) in enumerate(zip(fl.dw_groups(spec), fl._group_jobs(spec))):
        plan = fl.dw_plan(jobs, slab, r)
        if jobs == [(hidden, hidden)]:
            assert (plan.whole, plan.pieces) == (whole, pieces), plan
        left = plan.units - plan.whole
        modelled = plan.whole // 132 + (left > 0) / plan.pieces
        assert modelled <= -(-plan.units // 132), (g, plan)


def test_dw_pieces_fill_the_sms():
    """dw_pieces: 64-column pieces where four a unit fit the SMs, 128 where
    two do, else whole units; more SMs take more pieces."""
    assert [fl.dw_pieces(n) for n in (1, 33, 34, 66, 67, 131)] == [4, 4, 2, 2, 1, 1]
    assert fl.dw_pieces(66, sms=264) == 4
    assert fl.dw_plan([(1024, 1024)], 82944, 9) == fl.DwPlan(9, 9216, 32, 288, 264, 4, 2)
    assert fl.dw_plan([(1024, 1024)], 82944, 9, plain=True) == fl.DwPlan(9, 9216, 32, 288,
                                                                         288, 1, 1)
    assert fl.dw_plan([(256, 256)], 131072, 24) == fl.DwPlan(24, 5504, 2, 48, 0, 2, 1)


@pytest.mark.parametrize("spec", [s for _, s in LAYER_SPECS], ids=[i for i, _ in LAYER_SPECS])
def test_workspace_holds_the_dw_partials(spec):
    """The backward workspace's dW region holds the largest launch's
    partials, ranges x grads rounded to 64 floats, which every slab of a
    call fits (a short last slab takes no more ranges); the carries lie
    beside the workspace (fl.dw_scratch_for), so the slabs are the ones
    the route planned before its dW kernel carried units."""
    for n in (2048 * 192, 65536 * 192, 5000):
        slab = fl.slab_points(spec, "bwd", n)
        layout = fl.workspace_layout(spec, "bwd", slab)
        need = max(r * -(-c // 64) * 64 for c, r in fl.dw_groups(spec)) * 4
        assert layout["dwpart"][1] == need and list(layout)[-2:] == ["dwpart", "total"]
        for m in (slab, n - (n - 1) // slab * slab, 1):
            for (c, r), jobs in zip(fl.dw_groups(spec), fl._group_jobs(spec)):
                assert fl.dw_plan(jobs, m, r).ranges * -(-c // 64) * 64 * 4 <= need


@pytest.mark.parametrize("kw", [ARCHS[0], ARCHS[3]], ids=["3x1152", "16x128"])
def test_dw_plain_is_the_plain_backward_s(rng, kw):
    """The dW leg's plain version over the route's jobs (route_dw_jobs: each
    weight matrix's, [x | PE] at skips, dir's with the heads') on the
    activations and cotangents of a plain backward (fm.fused_mlp_bwd_plain,
    held to JAX's Pallas kernel above) gives that backward's dW, every
    packed weight once, at one point range and at the kernel's plan; f32
    sums of exact bf16 products in another order: within 1e-5 of the sum
    of magnitudes."""
    _, _, tm = _pair(kw)
    packed = fm.pack_weights(tm)
    spec = packed.spec
    H, L = spec.hidden, spec.num_layers
    o, d, z = (torch.from_numpy(a) for a in _rays(rng))
    cot = torch.from_numpy(rng.standard_normal((4, R, S)).astype(np.float32))
    dW, _ = fm.fused_mlp_bwd_plain(packed, o, d, z, cot)
    bf = torch.bfloat16
    pe_x, pe_d = fl.layers_pe_plain(packed, o, d, z)
    xs = [fm._layer(packed, pe_x.float(), 0, H, relu=False).to(bf)]
    for i in range(L - 1):
        a = torch.cat([xs[-1].float(), pe_x.float()], 1) if i in spec.skip_layers else xs[-1]
        xs.append(fm._layer(packed, a.float(), 1 + i, H, relu=True).to(bf))
    feat = fm._layer(packed, xs[-1].float(), L, H, relu=True).to(bf)
    h = fm._layer(packed, torch.cat([feat, pe_d], 1).float(), L + 1, H // 2, relu=True).to(bf)
    dy_rgb, dy_a, dy_dir, _ = fl.layers_heads_bwd_plain(packed, h, cot.reshape(4, -1))
    wa, _, _, _ = packed.heads()
    groups = {L + 1: (dy_dir, feat, pe_d, (dy_a, xs[-1], dy_rgb, h))}
    w = lambda g: packed.gemm(g, *spec.gemm_shapes()[g])[0][:, :H].float()  # noqa: E731
    df = (dy_dir.float() @ w(L + 1) * (feat.float() > 0)).to(bf)
    groups[L] = (df, xs[-1], None, None)
    dy = df.float() @ w(L) + dy_a[:, :1].float() @ wa.float()
    for i in reversed(range(L - 1)):  # trunk product 1 + i: input xs[i], output xs[i + 1]
        dy = (dy * (xs[i + 1].float() > 0)).to(bf)
        groups[1 + i] = (dy, xs[i], pe_x if i in spec.skip_layers else None, None)
        dy = dy.float() @ w(1 + i)
    groups[0] = (dy.to(bf), pe_x, None, None)
    covered = 0
    for g, (dy_g, x_g, pe_g, heads) in sorted(groups.items()):
        jobs, base, cols = fl.route_dw_jobs(packed, g, dy_g, x_g, pe_g, heads)
        want = dW[base:base + cols]
        mag = fl.layers_dw_plain([j._replace(dy=j.dy.abs(), x=j.x.abs()) for j in jobs],
                                 torch.zeros(cols), ranges=1)
        for ranges in (1, 0):
            got = fl.layers_dw_plain(jobs, torch.zeros(cols), ranges=ranges)
            assert bool(((got - want).abs() <= 1e-5 * mag + 1e-6).all()), (g, ranges)
        covered += cols
    assert covered == packed.weights.numel()
