"""The fused MLP kernel module's plain versions against the JAX fused
forward and backward, which on the CPU run the Pallas kernels in
interpret mode (nerfmeshes_tpu/ops/pallas/fused_mlp.py:549-550).

Weights start in JAX and are carried across with state_dict_from_flax;
JAX grads share the params tree, so the same function maps them to torch
names. Inputs and cotangents are made with numpy from a seed.
Tolerances: forward atol = rtol = 2e-2, the bf16 bar of
tests/test_fused_mlp.py:37 (bf16 operands rounded at other points, a
polynomial sine on the TPU side); grads worst relative error < 5e-2, the
bar of tests/test_fused_mlp.py:65, and on the layout edge cases the
float64-truth criterion of tests/test_fused_mlp.py:127-166 (the sine's
error can flip a ReLU mask that sits within ~1e-5 of zero). The kernels
themselves run only on a card: tests/test_torch_fused_mlp_gpu.py."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfmeshes_tpu.models import FlexibleNeRFModel as JaxFlexible
from nerfmeshes_tpu.ops.pallas import fused_mlp as j_fused
from nerfmeshes_tpu_torch.models import FlexibleNeRFModel
from nerfmeshes_tpu_torch.models.transplant import state_dict_from_flax
from nerfmeshes_tpu_torch.ops.kernels import fused_mlp as fm

torch.set_num_threads(1)

TOL = dict(atol=2e-2, rtol=2e-2)
BASE = dict(num_layers=4, hidden_size=128, skip_step=2, num_encoding_fn_xyz=4,
            num_encoding_fn_dir=2)

# The architectures of tests/test_fused_mlp.py (:29 and :84-99); its
# hidden_size=384 trunk (:96) is admitted too, and held with 512 below
# (WIDE_ARCHS).
ARCHS = [
    dict(BASE, num_layers=4, skip_step=2),
    dict(BASE, num_layers=8, skip_step=4),
    dict(BASE, num_layers=3, skip_step=4),
    dict(BASE, num_encoding_fn_xyz=11, num_encoding_fn_dir=4),
    dict(BASE, log_sampling_xyz=False, log_sampling_dir=False),
    dict(BASE, include_input_xyz=False, include_input_dir=False),
    dict(BASE, num_layers=10, skip_step=3),
]


def _pair(kw, seed=0):
    jm = JaxFlexible(**kw, dtype=jnp.bfloat16)
    pts = jnp.zeros((2, 3), jnp.float32)
    params = jm.init(jax.random.key(seed), pts, pts)
    tm = FlexibleNeRFModel(**kw, compute_dtype=torch.bfloat16)
    tm.load_state_dict(state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params), kw))
    return jm, params, tm


def _rays(rng, R, S):
    o = rng.uniform(-1.5, 1.5, (R, 3)).astype(np.float32)
    d = rng.standard_normal((R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    z = np.sort(rng.uniform(0.0, 2.0, (R, S)), axis=1).astype(np.float32)
    return o, d, z


@pytest.mark.parametrize("kw", ARCHS)
def test_points_forward_matches_jax_kernel(rng, kw):
    jm, params, tm = _pair(kw)
    assert fm.supports_fused(tm) and j_fused.supports_fused(jm)
    pts = rng.standard_normal((33, 3)).astype(np.float32)
    dirs = rng.standard_normal((33, 3)).astype(np.float32)
    want = j_fused.fused_flexible_apply(jm, params, jnp.asarray(pts), jnp.asarray(dirs),
                                        inference=True)
    before = fm.launches
    got = fm.fused_flexible_apply(tm, torch.from_numpy(pts), torch.from_numpy(dirs))
    assert fm.launches == before, "CPU tensors must never launch the kernel"
    assert got.shape == (33, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kw", [ARCHS[0], ARCHS[1]])
def test_rays_forward_matches_jax_kernel(rng, kw):
    jm, params, tm = _pair(kw)
    o, d, z = _rays(rng, 12, 9)
    want = j_fused.fused_flexible_apply_rays(jm, params, jnp.asarray(o), jnp.asarray(d),
                                             jnp.asarray(z), inference=True)
    before = fm.launches
    got = fm.fused_flexible_apply_rays(tm, *(torch.from_numpy(a) for a in (o, d, z)),
                                       inference=True)
    assert fm.launches == before
    assert got.shape == (4, 12, 9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_plain_layouts_and_module_agree(rng):
    """channels-first and channels-last are one field, and the plain kernel
    version tracks the nn.Module's own bf16 path."""
    _, _, tm = _pair(BASE)
    o, d, z = (torch.from_numpy(a) for a in _rays(rng, 7, 5))
    packed = fm.pack_weights(tm)
    cf = fm.fused_mlp_rays(packed, o, d, z)
    cl = fm.fused_mlp_rays(packed, o, d, z, channels_first=False)
    assert torch.equal(cf.permute(1, 2, 0), cl)
    pts = o[:, None, :] + d[:, None, :] * z[..., None]
    with torch.no_grad():
        ref = tm(pts, d[:, None, :].expand(pts.shape))
    np.testing.assert_allclose(cl.numpy(), ref.numpy(), **TOL)


def test_packing_layout():
    """Products are (out, in_padded) with 16-multiple PE widths, at
    32-byte-aligned offsets, in the descriptor's order."""
    _, _, tm = _pair(dict(BASE, num_layers=8, skip_step=4, hidden_size=256,
                          num_encoding_fn_xyz=10, num_encoding_fn_dir=4))
    p = fm.pack_weights(tm)
    spec = p.spec
    assert (spec.pe_x, spec.pxp, spec.pe_d, spec.pdp) == (63, 64, 27, 32)
    assert spec.skip_layers == (4,)
    n_gemms = spec.num_layers + 2
    w_offs = p.desc[fm._DESC_FIXED:fm._DESC_FIXED + n_gemms]
    assert p.desc.size == fm._DESC_FIXED + 2 * n_gemms
    assert all(int(o) % 16 == 0 for o in w_offs)
    w, b = p.gemm(5, 256, 256 + 64)  # trunk layer 4: [x | PE(xyz)]
    src = tm.layers_xyz[4].weight.detach()
    torch.testing.assert_close(w[:, :256].float(), src[:, :256].bfloat16().float())
    torch.testing.assert_close(w[:, 256:319].float(), src[:, 256:].bfloat16().float())
    assert not w[:, 319:].any()
    torch.testing.assert_close(b, tm.layers_xyz[4].bias.detach())
    # lego size: 595,844 parameters plus the zero padding columns
    assert p.weights.numel() + p.biases.numel() == 595844 + 256 * (1 + 1) + 128 * 5


def test_supports_fused_bound():
    lego = dict(num_layers=8, hidden_size=256, skip_step=4, num_encoding_fn_xyz=10,
                num_encoding_fn_dir=4)
    assert fm.supports_fused(FlexibleNeRFModel(**lego))
    assert fm.supports_fused(FlexibleNeRFModel(**dict(lego, hidden_size=128)))
    # 384 to 1024 are admitted: JAX's Pallas kernels take any H % 128 == 0.
    for hidden in (384, 512, 640, 768, 896, 1024):
        assert fm.supports_fused(FlexibleNeRFModel(**dict(lego, hidden_size=hidden)))
    # Past 1024 wide, 24 bands and 14 layers JAX's kernels still run; the
    # fused kernels have no instantiation there, so the layer route takes
    # them, on the same packing.
    for past in (dict(hidden_size=1152), dict(num_encoding_fn_xyz=fm.MAX_BANDS + 1),
                 dict(num_layers=fm.MAX_LAYERS + 1)):
        model = FlexibleNeRFModel(**dict(lego, **past))
        assert fm.supports_fused(model), past
        assert fm.field_route(fm.spec_from_model(model)) == "layers", past
        assert fm.pack_weights(model).spec == fm.spec_from_model(model)
    for bad in (dict(hidden_size=100), dict(use_viewdirs=False),
                dict(num_encoding_fn_xyz=0), dict(num_encoding_fn_dir=0)):
        model = FlexibleNeRFModel(**dict(lego, **bad))
        assert not fm.supports_fused(model), bad
        with pytest.raises(ValueError):
            fm.pack_weights(model)
    edge = FlexibleNeRFModel(**dict(lego, num_layers=fm.MAX_LAYERS))
    assert fm.supports_fused(edge) and fm.field_route(fm.spec_from_model(edge)) == "fused"
    assert not fm.supports_fused(torch.nn.Linear(3, 4))


def test_dispatch_never_falls_back(rng):
    """CPU tensors take the plain version; the CUDA entry refuses CPU
    tensors, and other devices raise."""
    _, _, tm = _pair(BASE)
    p = fm.pack_weights(tm)
    o, d, z = (torch.from_numpy(a) for a in _rays(rng, 3, 2))
    with pytest.raises(ValueError, match="CUDA"):
        fm.fused_mlp_cuda(p, o, d, z)
    with pytest.raises(ValueError):
        fm.fused_mlp_rays(p, o.to("meta"), d.to("meta"), z.to("meta"))
    with pytest.raises(ValueError, match=r"\(3, 3\)"):
        fm.fused_mlp_rays(p, o[:2], d, z)


# Interpreted Pallas backward: 8 rays x 8 samples, 64 points.
BWD_R, BWD_S = 8, 8
GRAD_BAR = 5e-2


def _worst_rel(want: dict, got: dict) -> float:
    return max(float((got[k] - want[k]).abs().max() / (want[k].abs().max() + 1e-6))
               for k in want)


def _jax_grads(jm, params, kw, o, d, z, cot):
    def loss(p):
        out = j_fused.fused_flexible_apply_rays(jm, p, jnp.asarray(o), jnp.asarray(d),
                                                jnp.asarray(z), inference=False)
        return jnp.sum(out * jnp.asarray(cot))

    g = jax.grad(loss)(params)
    return state_dict_from_flax(jax.tree_util.tree_map(np.asarray, g), kw)


def _port_grads(tm, o, d, z, cot):
    before = (fm.launches, fm.bwd_launches)
    out = fm.fused_flexible_apply_rays(tm, *(torch.from_numpy(a) for a in (o, d, z)))
    (out * torch.from_numpy(cot)).sum().backward()
    assert (fm.launches, fm.bwd_launches) == before, "CPU tensors must never launch a kernel"
    return {k: p.grad for k, p in tm.named_parameters()}


def _case(rng, kw):
    jm, params, tm = _pair(kw)
    o, d, z = _rays(rng, BWD_R, BWD_S)
    cot = rng.standard_normal((4, BWD_R, BWD_S)).astype(np.float32)
    want = _jax_grads(jm, params, kw, o, d, z, cot)
    got = _port_grads(tm, o, d, z, cot)
    assert set(got) == set(want)
    return params, (o, d, z, cot), want, got


@pytest.mark.parametrize("kw", ARCHS[:3])
def test_backward_matches_jax_kernel(rng, kw):
    """The training Function (plain forward and backward on the CPU)
    against jax.grad through the JAX fused path (Pallas backward), on the
    architectures of tests/test_fused_mlp.py:29."""
    _, _, want, got = _case(rng, kw)
    worst = _worst_rel(want, got)
    assert worst < GRAD_BAR, f"worst grad rel err {worst}"


@pytest.mark.parametrize("kw", ARCHS[3:])
def test_backward_edge_architectures_vs_f64(rng, kw):
    """The layout edge cases of tests/test_fused_mlp.py:84-99 (more bands,
    linear bands, no raw-input lanes, a deep trunk): with 64 points one
    ReLU mask flipped by the two sines' 1e-5 difference moves a grad by
    several percent, in either stack. So, as tests/test_fused_mlp.py:127-166
    does, both are judged against a float64 truth (the f64 flax model on the
    same weights and points): the port no worse than twice the JAX fused
    path, or within 5e-2."""
    params, (o, d, z, cot), want, got = _case(rng, kw)
    m64 = JaxFlexible(**kw, dtype=jnp.float64)
    pts = (o[:, None] + d[:, None] * z[..., None]).reshape(-1, 3)
    dirs = np.repeat(d, BWD_S, axis=0)
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
        f"port grads ({err_port:.4f} vs f64) worse than the JAX fused path ({err_jax:.4f})")


def test_grads_are_f32_and_unrounded(rng):
    """The Function is differentiable in the f32 packed weights, so the
    grads reach the f32 parameters without a bf16 rounding."""
    _, _, tm = _pair(BASE)
    o, d, z = (torch.from_numpy(a) for a in _rays(rng, 6, 5))
    out = fm.fused_flexible_apply_rays(tm, o, d, z)
    assert out.requires_grad and out.dtype == torch.float32
    out.square().sum().backward()
    for name, p in tm.named_parameters():
        assert p.grad is not None and p.grad.dtype == torch.float32, name
    weight = tm.layers_xyz[0].weight.grad
    assert (weight.bfloat16().float() != weight).any(), "weight grads were rounded to bf16"


def test_bwd_plain_is_the_function_backward(rng):
    """fused_mlp_bwd_plain on the packed weights gives the packed grads
    the Function hands to autograd; padding columns stay out of the
    parameters' grads."""
    _, _, tm = _pair(BASE)
    o, d, z = (torch.from_numpy(a) for a in _rays(rng, 5, 4))
    cot = torch.from_numpy(rng.standard_normal((4, 5, 4)).astype(np.float32))
    packed = fm.pack_params(tm)
    packed.weights.retain_grad()
    packed.biases.retain_grad()
    out = fm.FusedMLPTrain.apply(packed.weights, packed.biases,
                                 (packed.spec, packed.desc, packed.freqs), o, d, z)
    (out * cot).sum().backward()
    dW, dB = fm.fused_mlp_bwd_plain(fm.pack_weights(tm), o, d, z, cot)
    assert torch.equal(packed.weights.grad, dW) and torch.equal(packed.biases.grad, dB)
    spec = packed.spec
    w_grad, _ = packed.gemm(0, spec.hidden, spec.pxp, dW, dB)
    torch.testing.assert_close(tm.layer1.weight.grad, w_grad[:, :spec.pe_x])
    with pytest.raises(ValueError, match="channels-first"):
        fm.fused_mlp_bwd_plain(fm.pack_weights(tm), o, d, z, cot.movedim(0, -1))


def test_inference_path_builds_no_graph(rng):
    _, _, tm = _pair(BASE)
    o, d, z = (torch.from_numpy(a) for a in _rays(rng, 3, 2))
    out = fm.fused_flexible_apply_rays(tm, o, d, z, inference=True)
    assert not out.requires_grad
    torch.testing.assert_close(out, fm.fused_flexible_apply_rays(tm, o, d, z).detach())


def test_backward_dispatch_never_falls_back(rng):
    _, _, tm = _pair(BASE)
    p = fm.pack_weights(tm)
    o, d, z = (torch.from_numpy(a) for a in _rays(rng, 3, 2))
    cot = torch.zeros((4, 3, 2))
    with pytest.raises(ValueError, match="CUDA"):
        fm.fused_mlp_bwd_cuda(p, o, d, z, cot)
    with pytest.raises(ValueError):
        fm.fused_mlp_bwd(p, o.to("meta"), d.to("meta"), z.to("meta"), cot.to("meta"))


# The supports_fused grid: every hidden width, the fewest and most layers
# and bands, skips on and off, include-input on and off. At 512, 896 and
# 1024 wide the most bands (PE 320 columns; 288 without the raw inputs at
# 512 and 1024) take the layer route: no shared-memory plan holds them.
# PE_LIMIT: the most PE columns of the grid's models that the plans hold
# there.
PE_LIMIT = {512: 128, 896: 288, 1024: 128}
PACK_GRID = [
    dict(hidden_size=h, num_layers=n, skip_step=s, num_encoding_fn_xyz=lx,
         num_encoding_fn_dir=ld, include_input_xyz=inc, include_input_dir=inc)
    for h in fm.HIDDEN_SIZES
    for n, s in ((1, 4), (8, 4), (fm.MAX_LAYERS, 3))
    for lx, ld in ((1, 1), (10, 4), (fm.MAX_BANDS, fm.MAX_BANDS))
    for inc in (True, False)
]


@pytest.mark.parametrize("kw", PACK_GRID, ids=lambda kw: "-".join(map(str, kw.values())))
def test_packing_feeds_the_asynchronous_copies(kw):
    """What the forward and sigma kernels' TMA weight copies and register
    heads need of pack_weights: every product's matrix starts on a 16-byte
    boundary of the bf16 buffer and its rows are a multiple of 16 bytes
    long; the alpha and rgb rows start on 16-byte boundaries; every bias
    vector starts on an even f32 index (read two at a time). A model whose
    kernels no plan holds, or of a width past FUSED_WIDTHS, takes the layer
    route, which reads the same packing (its product kernel's TMA copies
    too)."""
    model = FlexibleNeRFModel(**kw, compute_dtype=torch.bfloat16)
    assert fm.supports_fused(model)
    spec = fm.spec_from_model(model)
    hidden = kw["hidden_size"]
    if any(fm.field_plan(spec, k) is None for k in ("fwd", "sigma", "bwd")):
        assert hidden in PE_LIMIT and spec.pxp + spec.pdp > PE_LIMIT[hidden]
        assert fm.field_route(spec) == "layers"
    elif hidden not in fm.FUSED_WIDTHS:
        assert fm.field_route(spec) == "layers"
    packed = fm.pack_weights(model)
    spec, desc = packed.spec, packed.desc
    n_gemms = spec.num_layers + 2
    shapes = spec.gemm_shapes()
    assert len(shapes) == n_gemms and packed.weights.dtype == torch.bfloat16
    nbytes = packed.weights.element_size()
    w_offs = desc[fm._DESC_FIXED:fm._DESC_FIXED + n_gemms]
    b_offs = desc[fm._DESC_FIXED + n_gemms:]
    for (n, k), w_off, b_off in zip(shapes, w_offs, b_offs):
        assert (int(w_off) * nbytes) % 16 == 0 and (k * nbytes) % 16 == 0, (n, k, w_off)
        assert int(b_off) % 2 == 0
    wa_off, ba_off, wr_off, br_off = (int(v) for v in desc[9:13])
    assert (wa_off * nbytes) % 16 == 0 and (wr_off * nbytes) % 16 == 0
    end = int(w_offs[-1]) + shapes[-1][0] * shapes[-1][1]
    assert wa_off == end and packed.weights.numel() == wr_off + 3 * (spec.hidden // 2)


# The widest edge the gate admits at 512: most layers, PE 96 + 32 columns.
W512_EDGE = dict(hidden_size=512, num_layers=fm.MAX_LAYERS, skip_step=3, num_encoding_fn_xyz=15,
                 num_encoding_fn_dir=4)


@pytest.mark.parametrize("kw", [*PACK_GRID, W512_EDGE,
                                dict(W512_EDGE, num_encoding_fn_xyz=fm.MAX_BANDS,
                                     num_encoding_fn_dir=fm.MAX_BANDS)],
                         ids=lambda kw: "-".join(map(str, kw.values())))
def test_gate_admits_only_what_the_plans_hold(kw):
    """field_route against the mirror of the kernels' shared-memory plan
    (fm.field_plan, csrc/fused_field.cuh:field_layout): a model the plans
    hold has a plan of at least 2 ring stages for each of its kernels,
    within the card's limit, and takes the fused route at FUSED_WIDTHS
    (the layer route past them); 512, 896 and 1024 wide with the most
    layers and bands the plans refuse. supports_fused admits all."""
    model = FlexibleNeRFModel(**kw)
    spec = fm.spec_from_model(model)
    plans = {k: fm.field_plan(spec, k) for k in ("fwd", "sigma", "bwd")}
    hold = all(plan is not None for plan in plans.values())
    hidden = kw["hidden_size"]
    assert fm.supports_fused(model)
    if hidden not in PE_LIMIT:  # every layer and band count fits at these widths
        assert hold
    elif spec.pxp + spec.pdp > PE_LIMIT[hidden]:
        assert plans["fwd"] is None and plans["bwd"] is None
    assert fm.field_route(spec) == ("fused" if hold and hidden in fm.FUSED_WIDTHS else "layers")
    if hold:
        for kernel, plan in plans.items():
            assert 2 <= plan.stages <= 8, kernel
            assert plan.pe_slots in (1, 2) and plan.bytes <= fm.SMEM_LIMIT, kernel
            # two PE tiles only where they leave the ring 3 stages
            assert plan.pe_slots == 1 or plan.stages >= 3, kernel


def test_plans_of_the_lego_and_wide_fields():
    """The plans the kernels' launches make for the lego field (as the
    header of csrc/fused_field.cuh states: the forward on the register
    design, 5 slots of 32 KB, 2 PE tiles, 225,316 B) and for 8x384 and
    8x512 at L 10/4: 64-point tiles of 48 / 64 KB, ring slots of 51 / 67 KB
    (3 / 2 stages), one PE tile."""
    lego = dict(num_layers=8, skip_step=4, num_encoding_fn_xyz=10, num_encoding_fn_dir=4)
    plan = {H: {k: fm.field_plan(fm.spec_from_model(FlexibleNeRFModel(**lego, hidden_size=H)), k)
                for k in ("fwd", "sigma", "bwd")} for H in (256, 384, 512)}
    assert plan[256]["fwd"] == fm.FieldPlan(5, 2, 225316)
    assert (plan[384]["fwd"].stages, plan[384]["fwd"].pe_slots) == (3, 1)
    assert (plan[512]["fwd"].stages, plan[512]["fwd"].pe_slots) == (2, 1)
    assert (plan[512]["bwd"].stages, plan[512]["bwd"].pe_slots) == (2, 1)
    assert plan[512]["bwd"].bytes == 230772 <= fm.SMEM_LIMIT


# The plans of csrc/fused_field.cuh:field_layout at 128 and 256 wide:
# (stages, PE tiles, bytes) of the forward and sigma on the register design
# (no activation tiles; ring slots of a 64-column slab alone, 32 KB at 256
# and 16 KB at 128, at most 8; the resident biases and head weights,
# params_bytes; 20 barriers: the ring's 16 and the PE slots' 4) and of the
# backward's tile kernel on its own plan (activation tiles, slots with 2 KB
# of params, its column partials). Lego: PE 64 + 32 columns, params 9,744 +
# 1,280 B; hard-llff.yml's 8x128 at L 10/4 likewise, params 4,880 + 640 B;
# the gate's edge (14 layers, 24 bands: PE 160 + 160 columns) at both.
REGS_PLANS = {
    "lego": ({}, {"fwd": (5, 2, 225316), "sigma": (5, 2, 208676), "bwd": (3, 2, 228724)}),
    "llff": ({"hidden_size": 128},
             {"fwd": (8, 2, 187044), "sigma": (8, 2, 170404), "bwd": (7, 2, 216436)}),
    "edge": ({"num_layers": 14, "num_encoding_fn_xyz": 24, "num_encoding_fn_dir": 24},
             {"fwd": (3, 1, 200484), "sigma": (4, 2, 231972), "bwd": (2, 1, 228468)}),
    "edge-w128": ({"hidden_size": 128, "num_layers": 14, "num_encoding_fn_xyz": 24,
                   "num_encoding_fn_dir": 24},
                  {"fwd": (3, 2, 224676), "sigma": (8, 2, 223396), "bwd": (5, 1, 214132)}),
}


@pytest.mark.parametrize("case", sorted(REGS_PLANS))
def test_plans_of_the_register_design(case):
    """field_plan at 128 and 256 wide equals the C plan of each kernel
    (REGS_PLANS), under the card's 232,448 B; the register design's
    resident parameters are every packed bias and the heads' weights."""
    over, want = REGS_PLANS[case]
    kw = dict(num_layers=8, hidden_size=256, skip_step=4, num_encoding_fn_xyz=10,
              num_encoding_fn_dir=4)
    model = FlexibleNeRFModel(**{**kw, **over})
    spec = fm.spec_from_model(model)
    packed = fm.pack_params(model)
    assert fm.params_bytes(spec) == (-(-4 * packed.biases.numel() // 16) * 16
                                     + -(-5 * spec.hidden // 16) * 16)
    for kernel, plan in want.items():
        assert fm.field_plan(spec, kernel) == fm.FieldPlan(*plan), kernel
        assert fm.field_plan(spec, kernel).bytes <= fm.SMEM_LIMIT
    assert fm.field_route(spec) == "fused"


# The plans of csrc/fused_field.cuh:field_layout for 8 layers at L 10/4
# (PE 64 + 32 columns) from 640 to 1024 wide: (stages, PE tiles, bytes,
# slab K-columns, CTAs a tile is split across), as the header's arithmetic
# gives them. At 1024: a 64 x 1024 bf16 activation tile (131,072 B), one
# PE tile (16,384 B; sigma's 64 columns 8,192 B), slots of a 32 x 512 bf16
# slab and 6,144 B of params (38,912 B, two of them), the exchange (4
# warpgroups x 4 x 64 f32 = 4,096 B), 18 barriers (144 B), the PE table (8 B
# a column) and the descriptor (372 B). The backward's column partials,
# 2 x 4 x (256 + 4) f32 = 8,320 B, lie in the PE tile where one is all
# the plan holds.
PAIRED_PLANS = {
    640: {"fwd": (4, 2, 210180), "sigma": (5, 2, 226308), "bwd": (4, 2, 215428)},
    768: {"fwd": (3, 2, 217348), "sigma": (3, 2, 208900), "bwd": (3, 2, 223620)},
    896: {"fwd": (2, 1, 206084), "sigma": (2, 1, 197636), "bwd": (2, 1, 206084)},
    1024: {"fwd": (2, 1, 230660), "sigma": (2, 1, 222212), "bwd": (2, 1, 230660)},
}


@pytest.mark.parametrize("hidden", sorted(PAIRED_PLANS))
def test_plans_of_the_paired_fields(hidden):
    """field_plan at 640 to 1024 wide equals the C plan: 32-column slabs,
    tiles split across a 2-CTA cluster, the forward's, sigma's and the
    backward's stages, PE tiles and bytes, all under the card's 232,448 B
    (the backward at 1024 at 230,660 B)."""
    lego = dict(num_layers=8, skip_step=4, num_encoding_fn_xyz=10, num_encoding_fn_dir=4)
    spec = fm.spec_from_model(FlexibleNeRFModel(**lego, hidden_size=hidden))
    for kernel, want in PAIRED_PLANS[hidden].items():
        plan = fm.field_plan(spec, kernel)
        assert plan == fm.FieldPlan(*want, slab_k=32, cluster=2), (kernel, plan)
        assert plan.bytes <= fm.SMEM_LIMIT


# 4 layers, skip 2, L 4/2 at the wide widths (2 layers from 640 on): JAX
# runs them through its Pallas kernels
# (nerfmeshes_tpu/ops/pallas/fused_mlp.py:750-761), the port through the
# kernels' plain versions here.
WIDE_ARCHS = [dict(BASE, hidden_size=384), dict(BASE, hidden_size=512),
              *(dict(BASE, num_layers=2, hidden_size=h) for h in (640, 768, 896, 1024))]
WIDE_IDS = [f"w{kw['hidden_size']}" for kw in WIDE_ARCHS]


@pytest.mark.parametrize("kw", WIDE_ARCHS, ids=WIDE_IDS)
def test_wide_forward_and_sigma_match_jax_kernel(rng, kw):
    """The forward at 33 points and the sigma field at 40 points against
    JAX's Pallas forward and sigma kernels (interpret mode); the plain
    sigma bit for bit the plain forward's channel 3."""
    jm, params, tm = _pair(kw)
    assert fm.supports_fused(tm) and j_fused.supports_fused(jm)
    pts = rng.standard_normal((33, 3)).astype(np.float32)
    dirs = rng.standard_normal((33, 3)).astype(np.float32)
    want = j_fused.fused_flexible_apply(jm, params, jnp.asarray(pts), jnp.asarray(dirs),
                                        inference=True)
    got = fm.fused_flexible_apply(tm, torch.from_numpy(pts), torch.from_numpy(dirs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    grid = rng.uniform(-1.2, 1.2, (40, 3)).astype(np.float32)
    want = j_fused.fused_sigma_points(jm, params, jnp.asarray(grid))
    before = fm.sigma_launches
    sigma = fm.fused_sigma_points(tm, torch.from_numpy(grid))
    assert fm.sigma_launches == before
    np.testing.assert_allclose(sigma.numpy(), np.asarray(want), **TOL)
    packed = fm.pack_weights(tm)
    zeros = torch.zeros((40, 3))
    full = fm.fused_mlp_plain(packed, torch.from_numpy(grid), zeros, zeros[:, :1])
    assert torch.equal(sigma, full[3, :, 0])


@pytest.mark.parametrize("kw", WIDE_ARCHS, ids=WIDE_IDS)
def test_wide_backward_matches_jax_kernel(rng, kw):
    """The training Function's grads (plain forward and backward) against
    jax.grad through JAX's fused path, whose backward is the Pallas
    _bwd_kernel in interpret mode, and through JAX's model itself
    (model.apply in bf16, no kernel). The port holds the 5e-2 bar against
    both; against the Pallas path it may miss it only where the Pallas
    path itself misses JAX's model by more than the bar (at 512 wide on
    this case: 0.152, the port 0.0087 from the model)."""
    params, (o, d, z, cot), want, got = _case(rng, kw)
    jm = JaxFlexible(**kw, dtype=jnp.bfloat16)
    pts = (o[:, None] + d[:, None] * z[..., None]).reshape(-1, 3)
    dirs = np.repeat(d, BWD_S, axis=0)
    cot_pts = jnp.asarray(cot.reshape(4, -1).T)
    g = jax.grad(lambda p: jnp.sum(jm.apply(p, jnp.asarray(pts), jnp.asarray(dirs))
                                   .astype(jnp.float32) * cot_pts))(params)
    module = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, g), kw)
    err_kernel, err_module = _worst_rel(want, got), _worst_rel(module, got)
    gap = _worst_rel(module, want)  # JAX's Pallas path against JAX's model
    print(f"H={kw['hidden_size']}: worst grad rel err, port vs Pallas {err_kernel:.4f}, "
          f"port vs model {err_module:.4f}, Pallas vs model {gap:.4f}")
    assert err_module < GRAD_BAR, f"port vs JAX's model: worst grad rel err {err_module}"
    assert err_kernel < GRAD_BAR or gap > GRAD_BAR, (
        f"port vs JAX's Pallas path: worst grad rel err {err_kernel} (Pallas vs model {gap})")


@pytest.mark.parametrize("hidden", [384, 1024])
def test_wide_slice_renders_through_the_fused_route(rng, monkeypatch, hidden):
    """The slice end to end at 384 and 1024 wide: render_rays of a 2-layer
    coarse and fine pair with use_fused_kernel, against JAX's render_rays
    on its Pallas kernel, at the forward's bar; both passes take the port's
    fused route (fused_flexible_apply_rays), none the nn.Module."""
    from nerfmeshes_tpu.config import get_default_cfg as j_cfg
    from nerfmeshes_tpu.train import render as j_render
    from nerfmeshes_tpu.train import system as j_system
    from nerfmeshes_tpu_torch.config import get_default_cfg as t_cfg
    from nerfmeshes_tpu_torch.train import render as t_render
    from nerfmeshes_tpu_torch.train import system as t_system

    arch = dict(num_layers=2, hidden_size=hidden, skip_step=4, num_encoding_fn_xyz=4,
                num_encoding_fn_dir=2)
    cfgs = []
    for get in (j_cfg, t_cfg):
        cfg = get()
        for node in (cfg.models.coarse, cfg.models.fine):
            node.update(arch)
        cfg.nerf.validation.num_coarse = cfg.nerf.validation.num_fine = 8
        cfg.experiment.compute_dtype = "bfloat16"
        cfg.experiment.use_fused_kernel = True
        cfgs.append(cfg)
    jc, jf = j_system.create_models(cfgs[0])
    params = j_system.init_params(cfgs[0], jc, jf, jax.random.key(0))
    tc, tf = t_system.create_models(cfgs[1])
    for model, name in ((tc, "coarse"), (tf, "fine")):
        model.load_state_dict(state_dict_from_flax(
            jax.tree_util.tree_map(np.asarray, params[name]), arch))
    o, d, _ = _rays(rng, 6, 1)
    want = j_render.render_rays(jc, jf, params, jnp.asarray(o), jnp.asarray(d), 2.0, 6.0,
                                j_render.RenderSettings.from_cfg(cfgs[0], train=False),
                                train=False)
    calls = []

    def counted(model, *args, **kwargs):
        calls.append(model.hidden_size)
        return fm.fused_flexible_apply_rays(model, *args, **kwargs)

    monkeypatch.setattr(t_render, "fused_flexible_apply_rays", counted)
    with torch.no_grad():
        got = t_render.render_rays(tc, tf, torch.from_numpy(o), torch.from_numpy(d), 2.0, 6.0,
                                   t_render.RenderSettings.from_cfg(cfgs[1], train=False),
                                   train=False)
    assert calls == [hidden, hidden], "both passes must take the fused route"
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.rgb_map.numpy(), np.asarray(w.rgb_map), **TOL)
        np.testing.assert_allclose(g.acc_map.numpy(), np.asarray(w.acc_map), **TOL)


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# (architecture, forward FLOPs per point, dX-chain FLOPs per point, stash
# bytes for 1000 points). Lego: 2 x 593,408 weights; dX over the x parts,
# 2 x (7 trunk + feat) x 256^2 + 2 x 128 x 256 + the heads' 2 x (3 x 128 +
# 256); stash per point 96 PE + 8 x 256 act + 256 feat + 128 h + 9 x 256
# dY + 128 dY_dir + 2 x 16 heads = 4992 bf16, on 1024 rows (128-point
# tiles). The 4x128 base: PE widths 27 -> 32 and 15 -> 16, skip at layer 2.
LEG_COUNTS = [
    (dict(num_layers=8, hidden_size=256, skip_step=4, num_encoding_fn_xyz=10,
          num_encoding_fn_dir=4), 1186816, 1115392, 1024 * 4992 * 2),
    (BASE, 163840, 148096, 1024 * 1488 * 2),
]


@pytest.mark.parametrize("kw,field,dx,stash", LEG_COUNTS, ids=["lego", "base"])
def test_chip_smoke_counts_the_backward_legs_work(kw, field, dx, stash):
    """The counts chip_smoke.py reckons the backward's legs' bounds from:
    the forward's FLOPs (the tile kernel's recompute, and the dW leg's
    products), the dX chain's, and the bytes of the bf16 stash
    (stash_layout in csrc/fused_mlp_bwd.cu) that the tile kernel writes
    and the dW leg reads."""
    smoke = _chip_smoke()
    model = FlexibleNeRFModel(**kw, compute_dtype=torch.bfloat16)
    packed = fm.pack_weights(model)
    assert smoke._field_flops(model) == field
    assert smoke._dx_flops(model) == dx
    assert smoke._stash_bytes(packed, 1000) == stash


@pytest.mark.parametrize("kw", [kw for kw, *_ in LEG_COUNTS], ids=["lego", "base"])
def test_chip_smoke_dw_yardstick_covers_every_weight(kw):
    """chip_smoke.py's dW yardstick times one torch.mm per product of the
    dW leg (dw_jobs in csrc/fused_mlp_bwd.cu): together they make every
    packed weight's grad once, and their views lie inside the stash."""
    smoke = _chip_smoke()
    packed = fm.pack_weights(FlexibleNeRFModel(**kw, compute_dtype=torch.bfloat16))
    jobs, size = smoke._dw_products(packed.spec, 1000)
    assert sum(m * cols for _, _, m, _, _, _, cols in jobs) == packed.weights.numel()
    for dy0, ldy, m, x0, ldx, c0, cols in jobs:
        assert m <= ldy and c0 + cols <= ldx
        assert dy0 + 1024 * ldy <= size and x0 + 1024 * ldx <= size


def test_chip_smoke_groups_kernels_the_sources_define():
    """Every kernel name chip_smoke.py groups a trace by (the backward's legs,
    the step profiles) is a __global__ of nerfmeshes_tpu_torch/csrc/, so a
    renamed kernel fails here rather than in a profile on the card."""
    import re

    smoke = _chip_smoke()
    csrc = Path(fm.__file__).resolve().parents[2] / "csrc"
    pattern = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(")
    defined = {name for src in csrc.glob("*.cu*") for name in pattern.findall(src.read_text())}
    assert {"bwd_tile_kernel", "dw_kernel", "fused_mlp_fwd_kernel"} <= defined
    names = {k for keys in (*smoke.BWD_LEGS.values(), *smoke.PROFILE_GROUPS.values())
             for k in keys}
    assert names <= defined, sorted(names - defined)


def _script(name: str):
    path = Path(__file__).resolve().parents[1] / "scripts" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("n_pad", [128, 384])
@pytest.mark.parametrize("kw", PACK_GRID, ids=lambda kw: "-".join(map(str, kw.values())))
def test_stash_store_boxes_cover_each_region_once(kw, n_pad):
    """The mirror of the tile kernel's TMA stores (fm.stash_store_boxes,
    csrc/fused_mlp_bwd.cuh) on every architecture of the packing grid, so
    on both tile heights (128 points to 256 wide, 64 past it) and in the
    2-CTA pairs: the maps (fm.stash_maps) lie over stash_layout's act and
    feat, dy, and dy_dir regions exactly, and a tile's 64 x 64 boxes cover
    each of those regions' rows of the tile's points once and nothing else.
    The stash's rows are padded to 128 points at every width
    (workspace_layout)."""
    spec = fm.spec_from_model(FlexibleNeRFModel(**kw))
    H, L = spec.hidden, spec.num_layers
    rows = 64 if H > 256 else 128
    st = fm.stash_layout(spec, n_pad)
    maps = fm.stash_maps(spec, n_pad)
    assert maps == {"act": (st["act"], H, (L + 1) * n_pad),
                    "dy": (st["dy"], H, (L + 1) * n_pad), "dy_dir": (st["dy_dir"], H // 2, n_pad)}
    assert (st["feat"], st["h"]) == (st["act"] + L * n_pad * H, st["feat"] + n_pad * H)
    assert st["dy_a"] == st["dy_dir"] + n_pad * H // 2
    for tile in range(n_pad // rows):
        cover = {name: np.zeros((n, width), np.int32) for name, (_, width, n) in maps.items()}
        for name, col, row in fm.stash_store_boxes(spec, n_pad, tile):
            assert col % 64 == 0 and 0 <= row and row + 64 <= cover[name].shape[0]
            cover[name][row:row + 64, col:col + 64] += 1
        for name, grid in cover.items():
            want = np.zeros_like(grid)
            blocks = 1 if name == "dy_dir" else L + 1
            for g in range(blocks):
                want[g * n_pad + tile * rows:g * n_pad + (tile + 1) * rows] = 1
            assert np.array_equal(grid, want), (name, tile)


def test_ablation_patches_apply(tmp_path):
    """scripts/torch_field_ablation.py patches its switches into a copy of
    csrc/: every text it patches is in the sources at most once, and each
    switch finds one, so a change to a kernel that moves one fails here,
    not in a run on the card. The register design (field_body_regs) takes
    each forward switch: its PE warps' arguments, its epilogue and its
    register-A products."""
    out = _script("torch_field_ablation").patched_sources(out=tmp_path / "csrc")
    fwd = (out / "fused_field.cuh").read_text()
    bwd = (out / "fused_mlp_bwd.cuh").read_text()
    for flag in ("ABLATE_PE", "ABLATE_EPILOGUE", "ABLATE_STASH", "ABLATE_MMA"):
        assert flag in fwd
    for flag in ("ABLATE_STASH", "ABLATE_COLSUM", "ABLATE_MASK"):
        assert flag in bwd
    regs = fwd[fwd.index("void pe_component("):fwd.index("void field_body_split(")]
    assert regs.count("ABLATE_PE") == 1 and regs.count("ABLATE_EPILOGUE") == 1
    assert "#ifdef ABLATE_MMA\n      if constexpr (false)\n#endif\n      wgmma_rs(" in regs
    assert regs.count("ABLATE_MMA") == 2


def test_ptxas_usage_reads_the_report():
    """build.ptxas_usage on ptxas's -v lines as nvcc prints them: registers,
    stack, spill stores and loads per entry, and C7519 notes per kernel;
    chip_smoke.tile_kernel_usage keeps the tile kernel's, by width."""
    from nerfmeshes_tpu_torch.ops.kernels import build

    tile = "_ZN12_GLOBAL__N_115bwd_tile_kernelILi{}EEEvNS_7BwdMapsENS_4DescE"
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{tile.format(256)}' for 'sm_90a'",
        f"ptxas info    : Function properties for {tile.format(256)}",
        "    240 bytes stack frame, 236 bytes spill stores, 232 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers, 4088 bytes cmem[0]",
        f"ptxas info    : Compiling entry function '{tile.format(128)}' for 'sm_90a'",
        f"ptxas info    : Function properties for {tile.format(128)}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 154 registers, used 1 barriers, 4088 bytes cmem[0]",
        "ptxas /tmp/x.ptx, line 9; warning : (C7519) Potential Performance Loss: wgmma.mma_async "
        f"instructions are serialized in the function '{tile.format(128)}'",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_19dw_kernelENS_6DwArgsE' "
        "for 'sm_90a'",
        "ptxas info    : Used 90 registers, used 1 barriers",
    ])
    usage = build.ptxas_usage(log)
    assert usage[tile.format(256)] == dict(registers=168, stack=240, spill_stores=236,
                                           spill_loads=232, c7519=0)
    assert usage[tile.format(128)] == dict(registers=154, stack=0, spill_stores=0,
                                           spill_loads=0, c7519=1)
    assert usage["_ZN12_GLOBAL__N_19dw_kernelENS_6DwArgsE"]["registers"] == 90
    assert sorted(_chip_smoke().tile_kernel_usage(log)) == [128, 256]
    fwd = "_ZN12_GLOBAL__N_120fused_mlp_fwd_kernelILi{}EEEvNS_9FieldMapsE"
    sigma = "_ZN12_GLOBAL__N_118fused_sigma_kernelILi128EEEvNS_9FieldMapsE"
    log += "\n" + "\n".join([
        f"ptxas info    : Compiling entry function '{fwd.format(128)}' for 'sm_90a'",
        f"ptxas info    : Function properties for {fwd.format(128)}",
        "    32 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers, used 16 barriers, 32 bytes cumulative stack size",
        f"ptxas info    : Compiling entry function '{fwd.format(512)}' for 'sm_90a'",
        "ptxas info    : Used 168 registers, used 4 barriers",
        f"ptxas info    : Compiling entry function '{sigma}' for 'sm_90a'",
        f"ptxas info    : Function properties for {sigma}",
        "    40 bytes stack frame, 8 bytes spill stores, 16 bytes spill loads",
        "ptxas info    : Used 168 registers, used 16 barriers",
    ])
    got = _chip_smoke().field_kernel_usage(log, (128, 256))
    assert [(H, k) for H, k, _ in got] == [(128, "fused_mlp_fwd_kernel"),
                                           (128, "fused_sigma_kernel")]
    assert got[0][2] == dict(registers=168, stack=32, spill_stores=0, spill_loads=0, c7519=0)
    assert got[1][2] == dict(registers=168, stack=40, spill_stores=8, spill_loads=16, c7519=0)
