"""The fused MLP kernel module's plain version against the JAX fused
forward, which on the CPU runs the Pallas kernel in interpret mode
(nerfmeshes_tpu/ops/pallas/fused_mlp.py:549-550).

Weights start in JAX and are carried across with state_dict_from_flax;
inputs are made with numpy from a seed. Tolerance atol = rtol = 2e-2, the
bf16 bar of tests/test_fused_mlp.py:37 (bf16 operands rounded at other
points, a polynomial sine on the TPU side). The kernel itself runs only
on a card: tests/test_torch_fused_mlp_gpu.py."""

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

# The architectures of tests/test_fused_mlp.py (:29 and :84-99) that the
# port's kernel admits; hidden_size=384 is outside its bound (see below).
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
    got = fm.fused_flexible_apply_rays(tm, *(torch.from_numpy(a) for a in (o, d, z)))
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
    for bad in (dict(hidden_size=384), dict(hidden_size=100), dict(hidden_size=512),
                dict(use_viewdirs=False), dict(num_encoding_fn_xyz=0),
                dict(num_encoding_fn_dir=0), dict(num_encoding_fn_xyz=fm.MAX_BANDS + 1),
                dict(num_layers=fm.MAX_LAYERS + 1)):
        model = FlexibleNeRFModel(**dict(lego, **bad))
        assert not fm.supports_fused(model), bad
        with pytest.raises(ValueError):
            fm.pack_weights(model)
    assert fm.supports_fused(FlexibleNeRFModel(**dict(lego, num_layers=fm.MAX_LAYERS)))
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
