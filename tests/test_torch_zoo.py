"""The port's model zoo (nerfmeshes_tpu_torch/models/{layers,nerf_models}.py)
against the JAX package's flax modules, on the CPU.

Weights start in flax and are carried across with state_dict_from_flax
(module_state_from_flax for a single layer); FastRotPos's B, which flax
derives from jax.random.PRNGKey(0) at every call, is computed here with
the same three jax.random calls and passed in. Inputs come from numpy
seeds: points along rays from the camera sphere (radius 4, depths 2-6),
as the renders query them.

Tolerances:
- f32: atol = rtol = 1e-5 (the same f32 arithmetic, other summation
  orders); bf16: atol = rtol = 2e-2, the bar of tests/test_fused_mlp.py:37
  (both stacks round every layer's output to bf16).
- Embeddings at the models' own multipliers (8; FastRotPos 10, as
  FlatModel builds it), where |B| reaches 1e5-1e7: sin(x.B) is then
  ill-conditioned, and the summation order of x.B alone can move it by
  1e-2 or more. Both stacks are judged against a float64 numpy truth on
  the same (compute-dtype-rounded) operands, within |a| (4 eps32 |x|.|B| +
  4 eps32) per element; where that bound passes 2 the check says nothing,
  and that is the honest answer there.
- grads against jax.grad of the same loss: the worst relative error of a
  leaf (max |port - jax| / max |jax|) under 1e-4 in f32 and under 5e-2 in
  bf16 (tests/test_fused_mlp.py:65).
- renders at validation settings (f32): the hierarchical render of two
  zoo models judged, as JAX's own f32 render, against JAX's render in
  float64 (the port's mean error within 4x JAX's + 1e-6; see the test);
  the BuFF render within rtol 1e-4, atol 1e-6, as
  tests/test_torch_render.py holds the FlexibleNeRF.
- dropout: the kept share within 3 sigma of 0.5 (sigma = sqrt(0.25 / n)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfmeshes_tpu.buff import system as j_buff
from nerfmeshes_tpu.buff import tree as j_tree
from nerfmeshes_tpu.config import get_default_cfg
from nerfmeshes_tpu.models import layers as jl
from nerfmeshes_tpu.models import nerf_models as jm
from nerfmeshes_tpu.train import render as j_render
from nerfmeshes_tpu_torch.buff import system as t_buff
from nerfmeshes_tpu_torch.buff import tree as t_tree
from nerfmeshes_tpu_torch.config import get_default_cfg as t_default_cfg
from nerfmeshes_tpu_torch.models import layers as tl
from nerfmeshes_tpu_torch.models import nerf_models as tm
from nerfmeshes_tpu_torch.models.transplant import (
    flax_paths,
    module_state_from_flax,
    state_dict_from_flax,
)
from nerfmeshes_tpu_torch.train import render as t_render
from nerfmeshes_tpu_torch.train import system as t_system

torch.set_num_threads(1)

CPU = torch.device("cpu")
EPS32 = float(np.finfo(np.float32).eps)
F32_TOL = 1e-5
BF16_TOL = 2e-2
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}

ZOO = ["SimpleModel", "SpecularSimpleModel", "FlatModel", "ResModel", "DropModel",
       "RotFlexibleNeRFModel"]
SMALL = {
    "SimpleModel": dict(num_layers=2, num_layers_view=1, hidden_size=32,
                        num_encoding_fn_xyz=16, skip_step=1),
    "SpecularSimpleModel": dict(num_layers=2, num_layers_view=1, hidden_size=32,
                                num_encoding_fn_xyz=16, skip_step=2),
    "FlatModel": dict(hidden_size=32, num_layers=2, num_encoding_fn_xyz=16),
    "ResModel": dict(hidden_size=32, num_layers=2, num_encoding_fn_xyz=16),
    "DropModel": dict(num_layers=2, num_layers_view=1, hidden_size=32,
                      num_encoding_fn_xyz=16, skip_step=1),
    "RotFlexibleNeRFModel": dict(num_layers=4, hidden_size=32, skip_step=2,
                                 num_encoding_fn_xyz=16, num_encoding_fn_dir=2),
}
# Variants of the branches: the other encodings, no view branch.
VARIANTS = [(name, {}) for name in ZOO] + [
    ("SimpleModel", dict(encoding="fastrot")),
    ("SimpleModel", dict(encoding="positional", num_encoding_fn_xyz=4)),
    ("SimpleModel", dict(num_layers_view=-1)),
    ("SpecularSimpleModel", dict(num_layers_view=-1, luminance_function="fillup")),
    ("DropModel", dict(encoding="fastrot")),
    ("RotFlexibleNeRFModel", dict(encoding="fastrot")),
    ("RotFlexibleNeRFModel", dict(encoding="positional", num_encoding_fn_xyz=4,
                                  use_viewdirs=False)),
]


def variant_id(v):
    name, extra = v
    return name + "".join(f"-{k}={x}" for k, x in extra.items())


def jax_fastrot_b(in_features, out_features, mult):
    """FastRotPos's B as JAX derives it (nerfmeshes_tpu/models/layers.py:187-196)."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    b = jax.random.normal(k1, (in_features, out_features))
    b = b / jnp.linalg.norm(b, axis=0, keepdims=True)
    m = 2.0 ** (jax.random.uniform(k2, (1, out_features)) * mult) - 1.0
    return np.asarray(b * m)


def fastrot_of(name, kw):
    """JAX's B for the model's FastRotPos, or None without one."""
    if name == "FlatModel":
        return jax_fastrot_b(3, kw["num_encoding_fn_xyz"], 10)
    if kw.get("encoding") == "fastrot":
        return jax_fastrot_b(3, kw["num_encoding_fn_xyz"], 8)
    return None


def scene_points(n_rays, n_samples, seed=0):
    """(R, S, 3) points and directions along rays from the camera sphere."""
    rng = np.random.default_rng(seed)
    o = rng.standard_normal((n_rays, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = -o / 4.0 + rng.uniform(-0.4, 0.4, (n_rays, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t = np.sort(rng.uniform(2.0, 6.0, (n_rays, n_samples)), axis=1)
    pts = o[:, None] + d[:, None] * t[..., None]
    dirs = np.broadcast_to(d[:, None], pts.shape)
    return pts.astype(np.float32), np.ascontiguousarray(dirs, dtype=np.float32)


def model_pair(name, extra, dtype, seed=0):
    """(flax model, flax params, port model with the same weights, kw)."""
    kw = {**SMALL[name], **extra}
    jdt, tdt = DTYPES[dtype]
    jmodel = jm.build_model(name, kw, jdt)
    pts, dirs = scene_points(2, 3)
    params = jmodel.init(jax.random.key(seed), jnp.asarray(pts), jnp.asarray(dirs))
    params_np = jax.tree_util.tree_map(np.asarray, params)
    port = tm.build_model(name, kw, compute_dtype=tdt)
    port.load_state_dict(state_dict_from_flax(params_np, kw, name, fastrot_b=fastrot_of(name, kw)),
                         strict=True)
    return jmodel, params, port, kw


def first(out):
    return out[0] if isinstance(out, tuple) else out


# -- layers ------------------------------------------------------------------------------

def layer_cases():
    """(id, port layer factory (compute_dtype), flax layer factory (dtype), input width)."""
    return [
        ("SimpleModule-relu", lambda d: tl.SimpleModule(20, 16, compute_dtype=d),
         lambda d: jl.SimpleModule(16, dtype=d), 20),
        ("SimpleModule-sigmoid", lambda d: tl.SimpleModule(20, 3, torch.sigmoid, compute_dtype=d),
         lambda d: jl.SimpleModule(3, activation=jax.nn.sigmoid, dtype=d), 20),
        ("SimpleModule-tanh", lambda d: tl.SimpleModule(20, 1, torch.tanh, compute_dtype=d),
         lambda d: jl.SimpleModule(1, activation=jnp.tanh, dtype=d), 20),
        ("ResBlock", lambda d: tl.ResBlock(16, 8, compute_dtype=d),
         lambda d: jl.ResBlock(16, 8, dtype=d), 16),
        ("SirenModule", lambda d: tl.SirenModule(6, 16, 1.5, compute_dtype=d),
         lambda d: jl.SirenModule(16, 1.5, dtype=d), 6),
        ("SirenModuleNormal", lambda d: tl.SirenModuleNormal(6, 16, 0.7, compute_dtype=d),
         lambda d: jl.SirenModuleNormal(16, 0.7, dtype=d), 6),
        ("SirenModuleExp", lambda d: tl.SirenModuleExp(6, 16, 2.0, compute_dtype=d),
         lambda d: jl.SirenModuleExp(16, 2.0, dtype=d), 6),
        ("PotCoSirenModule", lambda d: tl.PotCoSirenModule(6, 16, 2.0, compute_dtype=d),
         lambda d: jl.PotCoSirenModule(16, 2.0, dtype=d), 6),
        ("CoSirenModule", lambda d: tl.CoSirenModule(6, 16, 1.0, compute_dtype=d),
         lambda d: jl.CoSirenModule(16, 1.0, dtype=d), 6),
    ]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", layer_cases(), ids=lambda c: c[0])
def test_layer_matches_flax(case, dtype):
    _, port_f, flax_f, width = case
    jdt, tdt = DTYPES[dtype]
    x = np.random.default_rng(1).uniform(-1.0, 1.0, (40, width)).astype(np.float32)
    jlayer = flax_f(jdt)
    params = jlayer.init(jax.random.key(3), jnp.asarray(x))
    port = port_f(tdt)
    port.load_state_dict(module_state_from_flax(port, jax.tree_util.tree_map(np.asarray, params)))
    out = jlayer.apply(params, jnp.asarray(x))
    want = np.asarray(out.astype(jnp.float32))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.dtype == {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[out.dtype.type]
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_multiskip_concat_promotes_as_jnp(dtype):
    """A compute-dtype value beside an f32 skip: jnp.concatenate promotes
    to f32, and so does the port's concat (then TorchLinear rounds it)."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (30, 16)).astype(np.float32)
    skip = rng.uniform(-1, 1, (30, 12)).astype(np.float32)
    jlayer = jl.MultiSkipModule(16, 2, skip_step=2, dtype=jdt)
    xj = jnp.asarray(x).astype(jdt)
    params = jlayer.init(jax.random.key(0), xj, jnp.asarray(skip))
    port = tl.MultiSkipModule(16, 12, 16, 2, skip_step=2, compute_dtype=tdt)
    port.load_state_dict(module_state_from_flax(port, jax.tree_util.tree_map(np.asarray, params)))
    assert tl._cat_promoted([torch.zeros(1, dtype=tdt), torch.zeros(1)]).dtype == torch.float32
    want = np.asarray(jlayer.apply(params, xj, jnp.asarray(skip)).astype(jnp.float32))
    with torch.no_grad():
        got = port(torch.from_numpy(x).to(tdt), torch.from_numpy(skip))
    assert got.dtype == tdt and len(port.layers) == 2 * (1 + 2)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)


def round_to(x, dtype):
    """float64 copy of x rounded to `dtype` (torch's round to nearest even)."""
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype).double().numpy()


EMBEDDINGS = [
    ("SpatialEmbedding", 16, 8.0), ("SimpleSpatialEmbedding", 16, 8.0), ("FastRotPos", 16, 10.0),
    ("FastRotPos", 128, 8.0), ("SpatialEmbedding", 128, 8.0),
    ("FlexiblePositionalEncoding", 6, 8.0), ("Embbed2", 12, 8.0),
]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name,width,mult", EMBEDDINGS,
                         ids=[f"{n}-{w}-x{m:g}" for n, w, m in EMBEDDINGS])
def test_embedding_against_float64_truth(name, width, mult, dtype):
    """Both stacks' embeddings at the models' multipliers against a float64
    truth on the same operands, within the conditioning bound (module
    docstring). The spatial embeddings round x and B to the compute dtype;
    FlexiblePositionalEncoding and Embbed2 take x's dtype (f32) whatever
    the compute dtype."""
    jdt, tdt = DTYPES[dtype]
    pts, _ = scene_points(64, 8, seed=5)
    x = pts.reshape(-1, 3)
    jlayer = getattr(jl, name)(width, mult, dtype=jdt)
    params = jlayer.init(jax.random.key(4), jnp.asarray(x))
    params_np = jax.tree_util.tree_map(np.asarray, params)
    port = getattr(tl, name)(3, width, mult, compute_dtype=tdt)
    fastrot = jax_fastrot_b(3, width, mult) if name == "FastRotPos" else None
    port.load_state_dict(module_state_from_flax(port, params_np, fastrot_b=fastrot))
    want = np.asarray(jlayer.apply(params, jnp.asarray(x)), np.float64)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).double().numpy()

    rounds = name in ("SpatialEmbedding", "SimpleSpatialEmbedding", "FastRotPos")
    op = tdt if rounds else torch.float32
    if name == "FlexiblePositionalEncoding":
        b = np.zeros((3, 3 * width))
        for i in range(3):
            b[i, i * width:(i + 1) * width] = port.bands
    else:
        b = port.b.detach().double().numpy()
    xr, br = round_to(x, op), round_to(b, op)
    proj = xr @ br
    cond = np.abs(xr) @ np.abs(br)
    a = port.a.detach().double().numpy() if hasattr(port, "a") else np.ones(proj.shape[1])
    truth = np.concatenate([a * np.sin(proj), a * np.cos(proj)], axis=-1)
    bound = np.abs(np.concatenate([a, a])) * (4 * EPS32 * np.concatenate([cond, cond], -1)
                                              + 4 * EPS32)
    if name == "FlexiblePositionalEncoding":
        truth = np.concatenate([x, truth], axis=-1)
        bound = np.concatenate([np.zeros_like(x), bound], axis=-1)
    assert np.abs(b).max() > (1e3 if "Spatial" in name else 1e2)  # the real conditioning
    for label, out in (("port", got), ("jax", want)):
        err = np.abs(out - truth)
        assert (err <= bound + 1e-7).all(), (
            f"{label}: {(err > bound + 1e-7).sum()} elements past the bound, worst "
            f"{float((err - bound).max()):.3e}")
    # Where the bound is tight the two stacks agree to it.
    tight = bound < 1e-4
    assert tight.mean() > 0.5
    np.testing.assert_allclose(got[tight], want[tight], atol=2e-4, rtol=0)


def test_encoding_and_luminance_registries():
    assert tl.get_encoding("fastrot") is tl.FastRotPos
    assert tl.get_encoding("spatial") is tl.SpatialEmbedding
    assert tl.get_encoding("positional") is tl.FlexiblePositionalEncoding
    with pytest.raises(KeyError):
        tl.get_encoding("siren")
    rng = np.random.default_rng(6)
    color = rng.uniform(0, 1, (50, 3)).astype(np.float32)
    lum = rng.uniform(0, 1, (50, 1)).astype(np.float32)
    for name in ("simple", "disabled", "multiply", "fillup", "min1"):
        want = np.asarray(jl.get_luminance_function(name)(jnp.asarray(color), jnp.asarray(lum)))
        got = tl.get_luminance_function(name)(torch.from_numpy(color), torch.from_numpy(lum))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_fastrot_b_is_a_buffer_and_inits_follow_jax_distributions():
    """FastRotPos's B: a buffer (no optimizer sees it, a checkpoint holds
    it) with unit columns scaled into [0, 2^mult - 1]; SpatialEmbedding's B
    is 2^(N(0,1) mult) - 1 (a ~ 1); the Siren kernels' bounds; seeded
    draws repeat."""
    g = torch.Generator().manual_seed(0)
    rot = tl.FastRotPos(3, 4096, 10.0)
    rot.reset_parameters(g)
    assert list(rot.parameters()) == [] and list(rot.state_dict()) == ["b"]
    norms = torch.linalg.vector_norm(rot.b, dim=0)
    assert float(norms.min()) >= 0.0 and float(norms.max()) <= 2.0 ** 10 - 1.0
    emb = tl.SpatialEmbedding(3, 4096, 8.0)
    emb.reset_parameters(torch.Generator().manual_seed(1))
    # 2^(8N) - 1: above 0 when N > 0 (half), above 2^8 - 1 when N > 1 (15.87%).
    b = emb.b.detach()
    assert abs(float((b > 0).float().mean()) - 0.5) < 0.02
    assert abs(float((b > 2.0 ** 8 - 1).float().mean()) - 0.1587) < 0.02
    assert torch.equal(emb.a.detach(), torch.ones(4096))
    siren = tl.SirenModule(6, 512, 2.0)
    siren.reset_parameters(torch.Generator().manual_seed(2))
    assert float(siren.weight.detach().abs().max()) <= np.sqrt(6 / 6) * 2.0
    exp = tl.SirenModuleExp(6, 512, 2.0)
    exp.reset_parameters(torch.Generator().manual_seed(2))
    assert 2.0 ** -2 <= float(exp.weight.detach().min()) and float(exp.weight.detach().max()) <= 4.0
    other = tl.SpatialEmbedding(3, 4096, 8.0)
    other.reset_parameters(torch.Generator().manual_seed(1))
    assert torch.equal(other.b, emb.b)


# -- models --------------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("variant", VARIANTS, ids=variant_id)
def test_model_forward_matches_flax(variant, dtype):
    name, extra = variant
    jmodel, params, port, _ = model_pair(name, extra, dtype)
    pts, dirs = scene_points(6, 8, seed=1)
    want = jmodel.apply(params, jnp.asarray(pts), jnp.asarray(dirs))
    with torch.no_grad():
        got = port(torch.from_numpy(pts), torch.from_numpy(dirs))
    assert isinstance(got, tuple) == isinstance(want, tuple) == (name == "SpecularSimpleModel")
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    outs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
    for g, w in outs:
        assert g.shape == w.shape
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32), atol=tol, rtol=tol)
    assert first(got).dtype == torch.float32 and first(got).shape == (6, 8, 4)
    # Without directions: the view branch is skipped in both.
    if name in ("SimpleModel", "SpecularSimpleModel", "DropModel", "FlatModel", "ResModel"):
        want = first(jmodel.apply(params, jnp.asarray(pts), None))
        with torch.no_grad():
            got = first(port(torch.from_numpy(pts), None))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, rtol=tol)


def _worst_rel(port, grads_j):
    """Worst relative error of the port's .grad against the flax grads, per
    leaf (the port's weights transposed back to flax's layout)."""
    flat = {}

    def walk(tree, path=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, (*path, k))
            else:
                flat[(*path, k)] = np.asarray(v, np.float64)

    walk(jax.tree_util.tree_map(np.asarray, grads_j)["params"])
    named = dict(port.named_parameters())
    worst = 0.0
    for path, (key, transposed) in flax_paths(port).items():
        if key not in named:
            continue  # FastRotPos's B: a constant in both
        g = named[key].grad.double().numpy()
        g = g.T if transposed else g
        j = flat[path]
        worst = max(worst, float(np.abs(g - j).max() / (np.abs(j).max() + 1e-9)))
    assert len(flat) == len([k for k, _ in flax_paths(port).values() if k in named])
    return worst


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", ZOO)
def test_model_grads_match_jax(name, dtype):
    """sum(field^2) (+ sum(specular^2)) over 48 points: every parameter's
    grad against jax.grad."""
    jmodel, params, port, _ = model_pair(name, {}, dtype, seed=2)
    pts, dirs = scene_points(6, 8, seed=3)

    def loss_j(p):
        out = jmodel.apply(p, jnp.asarray(pts), jnp.asarray(dirs))
        if isinstance(out, tuple):
            return jnp.sum(out[0] ** 2) + jnp.sum(out[1].astype(jnp.float32) ** 2)
        return jnp.sum(out ** 2)

    grads_j = jax.grad(loss_j)(params)
    out = port(torch.from_numpy(pts), torch.from_numpy(dirs))
    if isinstance(out, tuple):
        loss = (out[0] ** 2).sum() + (out[1].float() ** 2).sum()
    else:
        loss = (out ** 2).sum()
    loss.backward()
    worst = _worst_rel(port, grads_j)
    assert worst < (1e-4 if dtype == "float32" else 5e-2), worst


def test_transplant_checks_the_zoo_layout():
    jmodel, params, _, kw = model_pair("SimpleModel", {}, "float32")
    params_np = jax.tree_util.tree_map(np.asarray, params)
    with pytest.raises(ValueError, match="layout"):
        state_dict_from_flax(params_np, {**kw, "num_layers": 3}, "SimpleModel")
    with pytest.raises(ValueError, match="shape"):
        state_dict_from_flax(params_np, {**kw, "hidden_size": 16}, "SimpleModel")
    with pytest.raises(ValueError, match="layout"):
        state_dict_from_flax(params_np, kw, "ResModel")
    flat = dict(SMALL["FlatModel"])
    jf = jm.build_model("FlatModel", flat)
    pf = jax.tree_util.tree_map(np.asarray, jf.init(jax.random.key(0), jnp.zeros((2, 3))))
    with pytest.raises(ValueError, match="fastrot_b"):
        state_dict_from_flax(pf, flat, "FlatModel")
    sd = state_dict_from_flax(pf, flat, "FlatModel", fastrot_b=jax_fastrot_b(3, 16, 10))
    assert "encode_xyz.b" in sd and ("FastRotPos_0", "b") in flax_paths(
        tm.build_model("FlatModel", flat))


def test_registry_and_class_defaults():
    """Every registry name builds at its class defaults, the reference's
    widths: SimpleModel has 435,588 parameters."""
    assert set(tm.MODEL_REGISTRY) == set(jm.MODEL_REGISTRY)
    counts = {}
    for name in tm.MODEL_REGISTRY:
        jmodel = jm.build_model(name, {})
        params = jmodel.init(jax.random.key(0), jnp.zeros((1, 3)), jnp.zeros((1, 3)))
        want = sum(int(np.prod(v.shape)) for v in jax.tree_util.tree_leaves(params))
        got = sum(p.numel() for p in tm.build_model(name, {}).parameters())
        assert got == want, name
        counts[name] = got
    assert counts["SimpleModel"] == 435_588
    assert not t_render.supports_fused(tm.build_model("RotFlexibleNeRFModel", {"hidden_size": 128}))


# -- dropout -------------------------------------------------------------------------------

def test_dropout_rate_scale_and_repeatability():
    n = 1 << 16
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.full((n,), 0.75, dtype=dtype)
        out = tm.dropout(x, 0.5, torch.Generator().manual_seed(0))
        assert out.dtype == dtype
        kept = out != 0
        assert abs(float(kept.float().mean()) - 0.5) <= 3 * np.sqrt(0.25 / n)
        assert torch.equal(out[kept], torch.full((int(kept.sum()),), 1.5, dtype=dtype))
        again = tm.dropout(x, 0.5, torch.Generator().manual_seed(0))
        other = tm.dropout(x, 0.5, torch.Generator().manual_seed(1))
        assert torch.equal(out, again) and not torch.equal(out, other)


def _settings(train):
    return t_render.RenderSettings(num_coarse=8, num_fine=8, perturb=False, lindisp=False,
                                   radiance_field_noise_std=0.0, white_background=False,
                                   use_fine=True, use_fused_kernel=False)


def test_dropmodel_drops_in_training_renders_only(monkeypatch):
    """A training render drops on the coarse and on the fine field, from
    the render's generator, with other masks for the two; repeatable from
    a seed. An eval render (and a training render of a model without
    dropout) draws nothing, and equals flax's deterministic apply."""
    jmodel, params, port, kw = model_pair("DropModel", {}, "float32")
    fine = tm.build_model("DropModel", kw)
    fine.load_state_dict(port.state_dict())
    masks = []
    real = tm.dropout

    def recording(x, rate, generator):
        out = real(x, rate, generator)
        masks.append((out != 0, x != 0))
        return out

    monkeypatch.setattr(tm, "dropout", recording)
    o, d = (torch.from_numpy(a) for a in scene_points(64, 1, seed=7)[:2])
    o, d = o[:, 0] - 3.0 * d[:, 0], d[:, 0]
    with torch.no_grad():
        a = t_render.render_rays(port, fine, o, d, 2.0, 6.0, _settings(True), train=True,
                                 generator=torch.Generator().manual_seed(5))
        assert len(masks) == 2
        assert masks[0][0].shape == (64, 8, 32) and masks[1][0].shape == (64, 16, 32)
        assert not torch.equal(masks[0][0][:, :8], masks[1][0][:, :8])
        for kept, nonzero in masks:  # the share kept among the values that were not 0
            share = kept[nonzero].float()
            assert abs(float(share.mean()) - 0.5) <= 3 * np.sqrt(0.25 / share.numel())
        b = t_render.render_rays(port, fine, o, d, 2.0, 6.0, _settings(True), train=True,
                                 generator=torch.Generator().manual_seed(5))
        assert torch.equal(a[1].rgb_map, b[1].rgb_map)
        masks.clear()
        ev = t_render.render_rays(port, fine, o, d, 2.0, 6.0, _settings(False), train=False)
        assert masks == [] and not torch.allclose(ev[1].rgb_map, a[1].rgb_map)
        # A training render without a generator falls back to seed 0, as JAX's to key(0).
        c = t_render.render_rays(port, fine, o, d, 2.0, 6.0, _settings(True), train=True)
        z = t_render.render_rays(port, fine, o, d, 2.0, 6.0, _settings(True), train=True,
                                 generator=torch.Generator().manual_seed(0))
        assert torch.equal(c[1].rgb_map, z[1].rgb_map)
    points = torch.from_numpy(scene_points(4, 4, seed=8)[0])
    want = np.asarray(jmodel.apply(params, jnp.asarray(points.numpy()),
                                   jnp.asarray(points.numpy())))
    with torch.no_grad():
        got = port(points, points)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=F32_TOL)


# -- fields through the render paths and the systems ------------------------------------------

PAIRS = [("SpecularSimpleModel", "ResModel"), ("DropModel", "RotFlexibleNeRFModel"),
         ("ResModel", "SimpleModel")]


@pytest.mark.parametrize("coarse,fine", PAIRS, ids=[f"{c}+{f}" for c, f in PAIRS])
def test_hierarchical_render_of_zoo_models_matches_jax(coarse, fine):
    """render_rays at validation settings (f32) of two zoo models (a
    (field, specular) output, a DropModel in eval) against JAX's
    render_rays with the same weights.

    The spatial embeddings make the fields ill-conditioned in position:
    the last-bit differences of the sample depths (linspace, sample_pdf)
    move them, in JAX's own f32 render as much as in the port's. So both
    are judged against JAX's render in float64 (same weights, same rays):
    the port's mean error in rgb, acc and weights within 4x JAX's own f32
    mean error + 1e-6 (measured ratios 0.1-3.0 over three ray seeds).
    depth_map is left out: at validation it is zeroed where acc < 1, a
    step at acc = 1 that most rays of these random fields sit on."""
    jc, pc, tc_model, kc = model_pair(coarse, {}, "float32", seed=1)
    jf, pf, tf_model, kf = model_pair(fine, {}, "float32", seed=2)
    rng = np.random.default_rng(9)
    o = rng.standard_normal((40, 3)).astype(np.float32)
    o = 4.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = (-o / 4.0 + rng.uniform(-0.3, 0.3, (40, 3))).astype(np.float32)
    settings_t = _settings(False)
    settings_j = j_render.RenderSettings(*settings_t)
    want = j_render.render_rays(jc, jf, {"coarse": pc, "fine": pf}, jnp.asarray(o),
                                jnp.asarray(d), 2.0, 6.0, settings_j, train=False)
    with jax.enable_x64(True):
        params64 = jax.tree_util.tree_map(lambda x: jnp.asarray(np.asarray(x), jnp.float64),
                                          {"coarse": pc, "fine": pf})
        truth = j_render.render_rays(
            jm.build_model(coarse, kc, jnp.float64), jm.build_model(fine, kf, jnp.float64),
            params64, jnp.asarray(o, jnp.float64), jnp.asarray(d, jnp.float64), 2.0, 6.0,
            settings_j, train=False)
        truth = [{f: np.asarray(getattr(b, f), np.float64) for f in ("rgb_map", "acc_map",
                                                                     "weights")}
                 for b in truth]
    with torch.no_grad():
        got = t_render.render_rays(tc_model, tf_model, torch.from_numpy(o), torch.from_numpy(d),
                                   2.0, 6.0, settings_t, train=False)
    for g, w, t in zip(got, want, truth):
        for field in ("rgb_map", "acc_map", "weights"):
            port_err = np.abs(getattr(g, field).numpy() - t[field]).mean()
            jax_err = np.abs(np.asarray(getattr(w, field)) - t[field]).mean()
            assert port_err <= 4 * jax_err + 1e-6, (field, port_err, jax_err)
    # The fields are alive: the fine render is not empty.
    assert float(got[1].acc_map.max()) > 0.1


def test_buff_render_of_a_zoo_model_matches_jax():
    """buff_render_rays of a SpecularSimpleModel (its tuple unwrapped) on a
    half-active 4^3 tree, at validation settings, against JAX's."""
    cfg = get_default_cfg()
    cfg.models.use_fine = False
    cfg.tree.subdivision_outer_count = 4
    cfg.tree.max_voxel_count = 256
    jmodel, params, port, _ = model_pair("SpecularSimpleModel", {}, "float32", seed=3)
    j_state = j_tree.TreeSampling(cfg).device_state()
    t_state = t_tree.TreeSampling(cfg).device_state(CPU)
    active = np.arange(t_state.active.shape[0]) % 2 == 0
    j_state = j_state._replace(active=jnp.asarray(active) & j_state.active)
    t_state.active = torch.from_numpy(active) & t_state.active
    rng = np.random.default_rng(10)
    o = rng.standard_normal((48, 3)).astype(np.float32)
    o = 4.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = (-o / 4.0 + rng.uniform(-0.3, 0.3, (48, 3))).astype(np.float32)
    settings_t = _settings(False)._replace(num_coarse=16)
    settings_j = j_render.RenderSettings(*settings_t)
    want = j_buff.buff_render_rays(jmodel, params, j_state, jnp.asarray(o), jnp.asarray(d), 2.0,
                                   6.0, settings_j, train=False, use_random_sampling=False)
    with torch.no_grad():
        got = t_buff.buff_render_rays(port, t_state, torch.from_numpy(o), torch.from_numpy(d),
                                      2.0, 6.0, settings_t, train=False)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for field in ("rgb_map", "depth_map", "acc_map"):
        np.testing.assert_allclose(getattr(got[0], field).numpy(),
                                   np.asarray(getattr(want[0], field)), rtol=1e-4, atol=1e-6)


def zoo_cfg(coarse="SpecularSimpleModel", fine="SpecularSimpleModel"):
    cfg = t_default_cfg()
    cfg.models.coarse_type, cfg.models.fine_type = coarse, fine
    for node in (cfg.models.coarse, cfg.models.fine):
        node.update(dict(SMALL["SpecularSimpleModel"], num_layers=2, hidden_size=32))
    cfg.experiment.update(compute_dtype="float32", use_fused_kernel=False)
    return cfg


def test_sample_and_density_points_unwrap_the_specular_tuple():
    """A NeRFSystem whose finest field is a SpecularSimpleModel: its point
    queries give the field of the (field, specular) tuple, and that field
    equals flax's with the same weights."""
    cfg = zoo_cfg()
    system = t_system.NeRFSystem(cfg, device=CPU)
    jmodel, params, port, kw = model_pair("SpecularSimpleModel", {}, "float32", seed=4)
    system.fine.load_state_dict(port.state_dict())
    pts, dirs = scene_points(5, 6, seed=11)
    field = system.sample_points(pts, dirs)
    sigma = system.density_points(pts)
    want = jmodel.apply(params, jnp.asarray(pts), jnp.asarray(dirs))[0]
    want_sigma = jmodel.apply(params, jnp.asarray(pts), jnp.asarray(pts))[0][..., 3]
    assert isinstance(field, torch.Tensor) and field.shape == (5, 6, 4)
    np.testing.assert_allclose(field.numpy(), np.asarray(want), atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_allclose(sigma.numpy(), np.asarray(want_sigma), atol=F32_TOL, rtol=F32_TOL)


def test_zoo_system_trains_on_cpu():
    """SpecularSimpleModel coarse + DropModel fine with AdamW: a few train
    steps through NeRFSystem.fit, finite losses, and the seeded init
    repeats (every layer drawn from the config's seed)."""
    cfg = zoo_cfg("SpecularSimpleModel", "DropModel")
    cfg.optimizer.type = "AdamW"
    cfg.nerf.train.update(num_random_rays=32, num_coarse=8, num_fine=8)
    cfg.experiment.update(steps_per_call=2, print_every=2, validate_every=0)
    rng = np.random.default_rng(12)
    H = W = 6
    data = {"poses": torch.from_numpy(np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))),
            "targets": torch.from_numpy(rng.uniform(0, 1, (2, H, W, 3)).astype(np.float32)),
            "bounds": torch.tensor([2.0, 6.0]), "hwf": (H, W, 5.0)}
    data["poses"][:, 2, 3] = 4.0
    system = t_system.NeRFSystem(cfg, device=CPU).setup(data)
    twin = t_system.NeRFSystem(cfg, device=CPU)
    for a, b in zip(system.coarse.state_dict().values(), twin.coarse.state_dict().values()):
        assert torch.equal(a, b)
    metrics = system.fit(4)
    assert system.state.step == 4 and np.isfinite(metrics["train/loss"])
    # AdamW: optax's rule (train/optim.py:OptaxAdam) with its decay of 1e-4.
    rule = system.optimizer.rule
    assert system.optimizer.kind == "AdamW" and type(rule).__name__ == "OptaxAdam"
    assert rule.param_groups[0]["weight_decay"] == 1e-4


def test_chip_smoke_zoo_chain_builds_the_class_defaults():
    """chip_smoke.py's zoo_cli overrides on configs/hard-blender.yml give a
    SpecularSimpleModel coarse model at its class defaults (the widths the
    smoke checks by parameter count) beside the config's 8x256
    FlexibleNeRF fine model, and AdamW."""
    import importlib.util
    from pathlib import Path

    from nerfmeshes_tpu_torch.config import load_config

    repo = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke", repo / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    config, first, second, overrides = smoke.CLI_RUNS["zoo_cli"]
    cfg = load_config(str(repo / "configs" / config), overrides)
    assert (cfg.models.coarse_type, cfg.optimizer.type) == ("SpecularSimpleModel", "AdamW")
    coarse, fine = t_system.create_models(cfg, torch.device("meta"))
    defaults = tm.SpecularSimpleModel(device=torch.device("meta"))
    assert {k: v.shape for k, v in coarse.state_dict().items()} == {
        k: v.shape for k, v in defaults.state_dict().items()}
    assert sum(p.numel() for p in coarse.parameters()) == smoke.ZOO_COARSE_PARAMS
    assert type(fine).__name__ == "FlexibleNeRFModel" and t_render.supports_fused(fine)
    assert (first, second) == (500, 1000)


@pytest.mark.parametrize("fault", ["ulp", "projection", "head"])
def test_chip_smoke_zoo_compare_holds_the_projection_apart(fault):
    """chip_smoke.zoo_compare on two CPU copies of SimpleModel (class
    defaults, |B| up to 2^31), the second standing in for the card. One
    ulp on the largest x @ B, the most another summation order of the
    3-term sum moves it, sends the end-to-end field past the f32 bar, yet
    lies within f32's rounding bound: zoo_compare passes it. A projection
    off by 1e-4 of itself, or a sigma head's bias off by 1e-4, fails it."""
    import importlib.util
    from pathlib import Path

    from nerfmeshes_tpu_torch.models.nerf_models import field_of

    repo = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke", repo / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cpu = tm.build_model("SimpleModel", {}, compute_dtype=torch.float32)
    t_system.init_params(cpu, None, torch.Generator().manual_seed(0))
    other = tm.build_model("SimpleModel", {}, compute_dtype=torch.float32)
    other.load_state_dict(cpu.state_dict())
    pts, dirs = smoke._zoo_points(torch.device("cpu"))
    pts, dirs = pts[:8, :16].contiguous(), dirs[:8, :16].contiguous()
    enc = other.encode_xyz
    assert isinstance(enc, tl.SpatialEmbedding) and float(enc.b.detach().abs().max()) >= 2.0 ** 31

    class Moved(type(enc)):
        def projection(self, x):
            p = super().projection(x).flatten()
            i = int(p.abs().argmax())
            if fault == "projection":
                step = p[i] * (1.0 + 1e-4)
            else:
                step = torch.nextafter(p[i], torch.tensor(float("inf")))
            return torch.cat([p[:i], step[None], p[i + 1:]]).view(*x.shape[:-1], -1)

    if fault == "head":
        with torch.no_grad():
            other.fc_depth.bias += 1e-4
    else:
        enc.__class__ = Moved
    _, reads = smoke.zoo_compare(cpu, other, pts, dirs, "float32")
    holds = reads["proj_ok"] and reads["field_ok"] and reads["grad_err"] < smoke.ZOO_GRAD_TOL[
        "float32"]
    if fault == "ulp":
        with torch.no_grad():
            plain = (field_of(other(pts, dirs)) - field_of(cpu(pts, dirs))).abs()
        assert float(plain.max()) > smoke.ZOO_FIELD_TOL["float32"] * 10
        assert reads["proj_moved"] == 1 and reads["proj_ratio"] <= 1.0
        assert holds, reads
    elif fault == "projection":
        assert not reads["proj_ok"] and not holds
    else:
        assert reads["proj_moved"] == 0 and not reads["field_ok"] and not holds
