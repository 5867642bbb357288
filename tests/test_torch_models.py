"""The port's FlexibleNeRFModel against the flax model, with the weights
initialised in JAX and carried across by state_dict_from_flax.

Tolerances: f32 atol 1e-5 (same math, other summation order); bf16
atol = rtol = 2e-2, the bf16 bar of tests/test_fused_mlp.py:37 (both
stacks round every layer's output to bf16, in other orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfmeshes_tpu.cli.import_checkpoint import _torch_linear_order
from nerfmeshes_tpu.models import FlexibleNeRFModel as JaxFlexible
from nerfmeshes_tpu_torch.models import FlexibleNeRFModel, build_model
from nerfmeshes_tpu_torch.models.layers import TorchLinear
from nerfmeshes_tpu_torch.models.transplant import state_dict_from_flax

torch.set_num_threads(1)

ARCHS = [
    dict(num_layers=4, hidden_size=128, skip_step=2, num_encoding_fn_xyz=4, num_encoding_fn_dir=2),
    # lego width
    dict(num_layers=8, hidden_size=256, skip_step=4, num_encoding_fn_xyz=10, num_encoding_fn_dir=4),
    dict(num_layers=5, hidden_size=64, skip_step=2, num_encoding_fn_xyz=3, num_encoding_fn_dir=2,
         include_input_xyz=False, include_input_dir=False, log_sampling_xyz=False),
    dict(num_layers=4, hidden_size=64, skip_step=2, num_encoding_fn_xyz=4, use_viewdirs=False),
]


def _jax_model(kw, dtype):
    return JaxFlexible(**kw, dtype=dtype)


def _pair(kw, rng, jdtype, tdtype, seed=0):
    """(jax model, flax params, port model with the same weights, pts, dirs)."""
    jm = _jax_model(kw, jdtype)
    pts = rng.uniform(-2.0, 2.0, (6, 7, 3)).astype(np.float32)
    dirs = rng.standard_normal((6, 7, 3)).astype(np.float32)
    params = jm.init(jax.random.key(seed), jnp.asarray(pts), jnp.asarray(dirs))
    params_np = jax.tree_util.tree_map(np.asarray, params)
    tm = FlexibleNeRFModel(**kw, compute_dtype=tdtype)
    tm.load_state_dict(state_dict_from_flax(params_np, kw), strict=True)
    return jm, params, tm, pts, dirs


@pytest.mark.parametrize("kw", ARCHS)
def test_forward_f32(rng, kw):
    jm, params, tm, pts, dirs = _pair(kw, rng, jnp.float32, torch.float32)
    want = np.asarray(jm.apply(params, jnp.asarray(pts), jnp.asarray(dirs)))
    with torch.no_grad():
        got = tm(torch.from_numpy(pts), torch.from_numpy(dirs))
    assert got.dtype == torch.float32 and got.shape == (6, 7, 4)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("kw", ARCHS[:2])
def test_forward_bf16(rng, kw):
    jm, params, tm, pts, dirs = _pair(kw, rng, jnp.bfloat16, torch.bfloat16)
    want = np.asarray(jm.apply(params, jnp.asarray(pts), jnp.asarray(dirs)))
    with torch.no_grad():
        got = tm(torch.from_numpy(pts), torch.from_numpy(dirs))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("num_layers,use_viewdirs", [(8, True), (4, True), (3, False)])
def test_state_dict_names_follow_import_order(num_layers, use_viewdirs):
    model = FlexibleNeRFModel(num_layers=num_layers, use_viewdirs=use_viewdirs)
    names = _torch_linear_order(num_layers, use_viewdirs)
    assert list(model.state_dict()) == [f"{n}.{p}" for n in names for p in ("weight", "bias")]


def test_transplant_raises_on_mismatch(rng):
    kw = ARCHS[0]
    jm = _jax_model(kw, jnp.float32)
    pts = jnp.zeros((2, 3))
    params_np = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.key(0), pts, pts))
    with pytest.raises(ValueError, match="shape"):
        state_dict_from_flax(params_np, {**kw, "hidden_size": 64})
    with pytest.raises(ValueError, match="shape"):
        state_dict_from_flax(params_np, {**kw, "num_encoding_fn_xyz": 5})
    with pytest.raises(ValueError, match="layout"):
        state_dict_from_flax(params_np, {**kw, "num_layers": 5})


def test_build_model_config_and_zoo():
    """build_model ignores the keys a model does not take; the zoo's other
    names build (once a "not ported" check; their parity with flax is
    tests/test_torch_zoo.py), and an unknown name raises KeyError, as the
    JAX registry lookup does."""
    m = build_model("FlexibleNeRFModel", {"num_layers": 3, "hidden_size": 32,
                                          "encoding": "positional"})
    assert (m.num_layers, m.hidden_size) == (3, 32)
    m = build_model("SimpleModel", {"num_layers": 3, "hidden_size": 32, "use_viewdirs": False,
                                    "encoding": "fastrot"})
    assert (m.num_layers, m.hidden_size, type(m.encode_xyz).__name__) == (3, 32, "FastRotPos")
    with pytest.raises(KeyError):
        build_model("NoSuchModel", {})


def test_reset_parameters_is_seeded_torch_default():
    layers = [TorchLinear(40, 16) for _ in range(2)]
    for layer in layers:
        layer.reset_parameters(torch.Generator().manual_seed(5))
    assert torch.equal(layers[0].weight, layers[1].weight)
    assert torch.equal(layers[0].bias, layers[1].bias)
    bound = 1.0 / np.sqrt(40)
    assert float(layers[0].weight.detach().abs().max()) <= bound
    assert float(layers[0].bias.detach().abs().max()) <= bound
