"""The port's training slice against the JAX package, on the CPU.

Weights start in JAX and are carried across with state_dict_from_flax;
JAX grads share the params tree, so the same function maps them to torch
names. Rays, targets and cotangents are made with numpy from a seed.
Tolerances:
- f32 nn.Module path, deterministic settings (perturb off, sigma noise
  0): loss rtol 1e-5, each grad within 1e-4 of its max — the fine samples
  move continuously with the coarse weights, summed in other orders.
- bf16 fused path (JAX: Pallas forward and backward interpreted; port:
  the plain versions): worst relative grad error < 5e-2, the bar of
  tests/test_fused_mlp.py:65.
- Schedules and Adam against optax: float32 rounding (rtol 1e-6).
Grads are compared, not post-Adam parameters: Adam's first step moves
every element by about +-lr, so a grad at rounding level can flip sign.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerfmeshes_tpu.config import CfgNode, get_default_cfg, load_config
from nerfmeshes_tpu.ops.math import img2mse as j_img2mse
from nerfmeshes_tpu.train import optim as j_optim
from nerfmeshes_tpu.train import render as j_render
from nerfmeshes_tpu.train import step as j_step
from nerfmeshes_tpu.train import system as j_system
from nerfmeshes_tpu_torch import config as t_config
from nerfmeshes_tpu_torch.data.blender import train_arrays
from nerfmeshes_tpu_torch.data.blender_poses import read_blender_poses
from nerfmeshes_tpu_torch.models.transplant import state_dict_from_flax
from nerfmeshes_tpu_torch.ops.kernels import fused_mlp as fm
from nerfmeshes_tpu_torch.train import optim as t_optim
from nerfmeshes_tpu_torch.train import render as t_render
from nerfmeshes_tpu_torch.train import step as t_step
from nerfmeshes_tpu_torch.train import system as t_system

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SCENE = REPO / "data" / "hard_blender"
SMALL = dict(num_layers=4, hidden_size=128, skip_step=2, num_encoding_fn_xyz=4,
             num_encoding_fn_dir=2)


def small_cfg(compute_dtype: str, fused: bool, perturb: bool = False, noise: float = 0.0,
              samples: int = 16):
    cfg = get_default_cfg()
    for node in (cfg.models.coarse, cfg.models.fine):
        node.update(SMALL)
    cfg.nerf.train.num_coarse = samples
    cfg.nerf.train.num_fine = samples
    cfg.nerf.train.perturb = perturb
    cfg.nerf.train.radiance_field_noise_std = noise
    cfg.experiment.compute_dtype = compute_dtype
    cfg.experiment.use_fused_kernel = fused
    return cfg


def scene_batch(R, seed=0):
    """Rays from the camera sphere at the centre, and random targets."""
    rng = np.random.default_rng(seed)
    o = rng.standard_normal((R, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = -o + rng.uniform(-1.5, 1.5, (R, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t = rng.uniform(0.0, 1.0, (R, 3))
    return [a.astype(np.float32) for a in (o, d, t)]


def both_models(cfg):
    jc, jf = j_system.create_models(cfg)
    params = j_system.init_params(cfg, jc, jf, jax.random.key(0))
    tc, tf = t_system.create_models(cfg)
    for model, name, node in ((tc, "coarse", cfg.models.coarse), (tf, "fine", cfg.models.fine)):
        model.load_state_dict(state_dict_from_flax(
            jax.tree_util.tree_map(np.asarray, params[name]), dict(node)))
    return (jc, jf, params), (tc, tf)


def jax_loss_and_grads(cfg, jc, jf, params, o, d, t):
    settings = j_render.RenderSettings.from_cfg(cfg, train=True)

    def loss_fn(p):
        c, f = j_render.render_rays(jc, jf, p, jnp.asarray(o), jnp.asarray(d), 2.0, 6.0,
                                    settings, train=True)
        return j_img2mse(c.rgb_map, jnp.asarray(t)) + j_img2mse(f.rgb_map, jnp.asarray(t))

    loss, grads = jax.value_and_grad(loss_fn)(params)
    named = {}
    for name, node in (("coarse", cfg.models.coarse), ("fine", cfg.models.fine)):
        sd = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, grads[name]), dict(node))
        named.update({f"{name}.{k}": v for k, v in sd.items()})
    return float(loss), named


def port_loss_and_grads(cfg, tc, tf, o, d, t):
    loss, metrics = t_step.train_loss(cfg, tc, tf, torch.from_numpy(o), torch.from_numpy(d),
                                      torch.from_numpy(t), 2.0, 6.0)
    loss.backward()
    named = {f"{tag}.{k}": p.grad for tag, m in (("coarse", tc), ("fine", tf))
             for k, p in m.named_parameters()}
    return float(loss.detach()), metrics, named


# -- satellite 1: two faults of the port's render against JAX's ------------------

def test_training_render_requires_a_generator():
    cfg = small_cfg("float32", fused=False, perturb=True)
    _, (tc, tf) = both_models(cfg)
    o, d, _ = scene_batch(8)
    for settings in (t_render.RenderSettings.from_cfg(cfg, train=True),
                     t_render.RenderSettings.from_cfg(cfg, train=True)._replace(
                         perturb=False, radiance_field_noise_std=0.2)):
        with pytest.raises(ValueError, match="generator"):
            t_render.render_rays(tc, tf, torch.from_numpy(o), torch.from_numpy(d), 2.0, 6.0,
                                 settings, train=True)
    # Nothing random: no generator needed.
    det = t_render.RenderSettings.from_cfg(small_cfg("float32", fused=False), train=True)
    t_render.render_rays(tc, tf, torch.from_numpy(o), torch.from_numpy(d), 2.0, 6.0, det,
                         train=True)


def test_eval_render_follows_perturb():
    """JAX passes settings.perturb as it is (render.py:129,156): an eval
    render with perturb draws jittered samples; without a generator from
    a seed-0 stream, as JAX falls back to key(0)."""
    cfg = small_cfg("float32", fused=False)
    _, (tc, tf) = both_models(cfg)
    o, d = (torch.from_numpy(a) for a in scene_batch(8)[:2])
    settings = t_render.RenderSettings.from_cfg(cfg, train=False)._replace(perturb=True)

    def render(generator=None):
        with torch.no_grad():
            return t_render.render_rays(tc, tf, o, d, 2.0, 6.0, settings, train=False,
                                        generator=generator)[1].rgb_map

    a = render(torch.Generator().manual_seed(1))
    b = render(torch.Generator().manual_seed(2))
    assert not torch.equal(a, b), "eval render ignored settings.perturb"
    assert torch.equal(render(), render(torch.Generator().manual_seed(0)))
    with torch.no_grad():
        plain = t_render.render_rays(tc, tf, o, d, 2.0, 6.0, settings._replace(perturb=False),
                                     train=False)[1].rgb_map
    assert not torch.equal(a, plain)


# -- loss and grads against jax.grad ---------------------------------------------

def test_f32_module_loss_and_grads_match_jax():
    cfg = small_cfg("float32", fused=False)
    (jc, jf, params), (tc, tf) = both_models(cfg)
    o, d, t = scene_batch(64)
    want_loss, want = jax_loss_and_grads(cfg, jc, jf, params, o, d, t)
    got_loss, metrics, got = port_loss_and_grads(cfg, tc, tf, o, d, t)
    assert got_loss == pytest.approx(want_loss, rel=1e-5)
    assert set(got) == set(want)
    for name in want:
        scale = float(want[name].abs().max())
        err = float((got[name] - want[name]).abs().max())
        assert err <= 1e-4 * scale, f"{name}: {err} vs max {scale}"
    assert set(metrics) == {"train/coarse_loss", "train/coarse_psnr", "train/rgb_sum",
                            "train/fine_loss", "train/fine_psnr", "train/loss"}


def test_bf16_fused_grads_match_jax_fused():
    """4 rays x (8 + 8) samples: at most 64 points per interpreted Pallas
    call. At so few points one ReLU mask within ~1e-5 of zero, flipped by
    the two stacks' sines, moves a first-layer grad by several percent in
    either stack (batch seed 1 does: 0.11 on fine.layers_xyz.0, with both
    stacks equally far from the f32 path); the suite's seed 0 has none."""
    cfg = small_cfg("bfloat16", fused=True, samples=8)
    (jc, jf, params), (tc, tf) = both_models(cfg)
    o, d, t = scene_batch(4, seed=0)
    _, want = jax_loss_and_grads(cfg, jc, jf, params, o, d, t)
    before = (fm.launches, fm.bwd_launches)
    _, _, got = port_loss_and_grads(cfg, tc, tf, o, d, t)
    assert (fm.launches, fm.bwd_launches) == before
    worst = max(float((got[k] - want[k]).abs().max() / (want[k].abs().max() + 1e-6))
                for k in want)
    assert worst < 5e-2, f"worst grad rel err {worst}"


# -- ray batches ---------------------------------------------------------------------

@pytest.mark.parametrize("sample_all,per_image_bounds,use_ndc", [
    (False, False, False), (True, False, False), (False, True, True), (True, True, False)])
def test_ray_batch_from_jax_indices(sample_all, per_image_bounds, use_ndc):
    """_sample_ray_batch fed the indices JAX draws (the key split of
    step.py:230 and :64) gives JAX's rays, targets and bounds."""
    rng = np.random.default_rng(0)
    N, H, W, R, focal = 3, 5, 7, 16, 6.5
    poses = read_blender_poses(SCENE, "test")[0][:N]
    data = {
        "targets": rng.uniform(0, 1, (N, H, W, 3)).astype(np.float32),
        "poses": poses,
        "bounds": (rng.uniform(1, 5, (N, 2)).astype(np.float32) if per_image_bounds
                   else np.array([2.0, 6.0], np.float32)),
        "target_depth": rng.uniform(0, 6, (N, H, W)).astype(np.float32),
    }
    _, k_sample, _ = jax.random.split(jax.random.key(7), 3)
    want = j_step._sample_ray_batch({k: jnp.asarray(v) for k, v in data.items()}, k_sample,
                                    H=H, W=W, focal=focal, num_rays=R, use_ndc=use_ndc,
                                    sample_all_images=sample_all)
    k_img, k_pix = jax.random.split(k_sample)
    img = jax.random.randint(k_img, (R,) if sample_all else (), 0, N)
    pix = jax.random.randint(k_pix, (R,), 0, H * W)
    got = t_step.rays_from_indices(
        {k: torch.from_numpy(v) for k, v in data.items()},
        torch.from_numpy(np.asarray(img, np.int64)), torch.from_numpy(np.asarray(pix, np.int64)),
        H=H, W=W, focal=focal, use_ndc=use_ndc)
    names = ("origins", "directions", "targets", "near", "far", "depth")
    for name, g, w in zip(names, got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape, name
        if name in ("origins", "directions"):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_draw_ray_indices_shapes_and_ranges():
    gen = torch.Generator().manual_seed(0)
    img, pix = t_step.draw_ray_indices(gen, 3, 5, 7, 64)
    assert img.shape == () and pix.shape == (64,)
    img, pix = t_step.draw_ray_indices(gen, 3, 5, 7, 64, sample_all_images=True)
    assert img.shape == (64,) and 0 <= int(img.min()) and int(img.max()) < 3
    assert 0 <= int(pix.min()) and int(pix.max()) < 35


def test_depth_loss_metrics_match_jax():
    rng = np.random.default_rng(0)
    rgb_o, rgb_t = rng.uniform(0, 1, (2, 32, 3)).astype(np.float32)
    d_o = rng.uniform(0, 6, 32).astype(np.float32)
    d_t = np.where(rng.uniform(size=32) < 0.3, 0.0, rng.uniform(2, 6, 32)).astype(np.float32)
    want = j_step.depth_loss_metrics("train", *(jnp.asarray(a) for a in (rgb_o, rgb_t, d_o, d_t)))
    got = t_step.depth_loss_metrics("train", *(torch.from_numpy(a) for a in (rgb_o, rgb_t, d_o, d_t)))
    assert set(got) == set(want)
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-6), k


# -- optimizer and schedules -----------------------------------------------------------

SCHEDULES = [
    ("DefaultScheduler", {"gamma": 0.1, "step_size": 450}),
    ("StepLR", {"gamma": 0.5, "step_size": 100}),
    ("ExponentialLR", {"gamma": 0.999}),
    ("MultiStepLR", {"gamma": 0.3, "milestones": [7, 1000]}),
    ("CosineAnnealingLR", {"T_max": 1000, "eta_min": 1e-5}),
    ("ConstantLR", {}),
    ("LambdaLR", {}),
]


def sched_cfg(kind, options, lr=5e-4, accum=1):
    cfg = get_default_cfg()
    cfg.optimizer.lr = lr
    cfg.optimizer.accumulate_steps = accum
    cfg.scheduler.type = kind
    cfg.scheduler.options = CfgNode(options)
    return cfg


@pytest.mark.parametrize("kind,options", SCHEDULES, ids=[k for k, _ in SCHEDULES])
def test_schedules_match_optax(kind, options):
    cfg = sched_cfg(kind, options)
    want, got = j_optim.build_schedule(cfg), t_optim.build_schedule(cfg)
    for step in (0, 1, 6, 7, 8, 99, 100, 101, 999, 1000, 1001, 5000):
        assert got(step) == pytest.approx(float(want(step)), rel=1e-6), step


def _params(rng):
    return {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "b": rng.standard_normal(4).astype(np.float32)}


def test_adam_updates_match_optax():
    """Three Adam updates from identical grads, with a schedule that moves."""
    rng = np.random.default_rng(0)
    init = _params(rng)
    grads = [_params(rng) for _ in range(3)]
    cfg = sched_cfg("DefaultScheduler", {"gamma": 0.1, "step_size": 2})
    opt = j_optim.build_optimizer(cfg)
    p_j = {k: jnp.asarray(v) for k, v in init.items()}
    state = opt.init(p_j)
    p_t = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    port = t_optim.build_optimizer(list(p_t.values()), cfg)
    for g in grads:
        upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, state, p_j)
        p_j = optax.apply_updates(p_j, upd)
        for k, p in p_t.items():
            p.grad = torch.from_numpy(g[k])
        port.step()
        for k in init:
            np.testing.assert_allclose(p_t[k].detach().numpy(), np.asarray(p_j[k]),
                                       rtol=1e-6, atol=1e-9)
            assert p_t[k].grad is None


def test_accumulation_equals_double_batch():
    """accumulate_steps=2: params hold after the first micro-batch, then
    move as one update with the mean grad (tests/test_train.py:148)."""
    rng = np.random.default_rng(1)
    init = _params(rng)
    g1, g2 = _params(rng), _params(rng)
    p_a = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    p_b = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt_a = t_optim.build_optimizer(list(p_a.values()),
                                    sched_cfg("DefaultScheduler", {"gamma": 0.1, "step_size": 10},
                                              accum=2))
    opt_b = t_optim.build_optimizer(list(p_b.values()),
                                    sched_cfg("DefaultScheduler", {"gamma": 0.1, "step_size": 10}))
    for k, p in p_a.items():
        p.grad = torch.from_numpy(g1[k])
    opt_a.step()
    for k, p in p_a.items():
        np.testing.assert_array_equal(p.detach().numpy(), init[k])
        p.grad = torch.from_numpy(g2[k])
    opt_a.step()
    for k, p in p_b.items():
        p.grad = torch.from_numpy((g1[k] + g2[k]) / 2)
    opt_b.step()
    for k in init:
        np.testing.assert_allclose(p_a[k].detach().numpy(), p_b[k].detach().numpy(), rtol=1e-6)
    assert opt_a.lr_at(3) == opt_b.lr_at(1)


@pytest.mark.parametrize("kind", ["AdamW", "Adamax", "SGD", "RMSprop", "Adagrad"])
def test_other_optimizers_are_not_ported_yet(kind):
    cfg = get_default_cfg()
    cfg.optimizer.type = kind
    with pytest.raises(NotImplementedError, match=kind):
        t_optim.build_optimizer([torch.nn.Parameter(torch.zeros(2))], cfg)


# -- configs -----------------------------------------------------------------------------

def test_port_default_cfg_is_the_jax_schema():
    assert t_config.get_default_cfg().to_dict() == get_default_cfg().to_dict()
    cfg = t_config.get_default_cfg()
    cfg.models.fine.hidden_size = 128
    assert cfg.models.fine["hidden_size"] == 128
    with pytest.raises(AttributeError):
        cfg.models.no_such_key


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_cfg_is_hard_blender():
    """The in-code hard-blender settings of chip_smoke.py equal
    configs/hard-blender.yml, field by field, where they define the
    workload; validate_every, steps_per_call and print_every are the
    smoke's own."""
    got = _chip_smoke().hard_blender_cfg()
    want = load_config(str(REPO / "configs" / "hard-blender.yml"))
    for section in ("models", "optimizer", "scheduler", "dataset"):
        g, w = got[section].to_dict(), want[section].to_dict()
        if section == "dataset":
            for d in (g, w):
                d["basedir"] = (REPO / d["basedir"]).resolve()
                d["caching"]["cache_dir"] = (REPO / d["caching"]["cache_dir"]).resolve()
        assert g == w, section
    assert got.nerf.train.to_dict() == want.nerf.train.to_dict()
    assert got.experiment.validate_every == 0
    for key in ("randomseed", "compute_dtype", "use_early_stopping", "use_fused_kernel"):
        assert got.experiment[key] == want.experiment[key], key


# -- the system ----------------------------------------------------------------------------

def tiny_train_cfg(fused: bool):
    cfg = small_cfg("bfloat16", fused=fused, perturb=True, noise=0.2, samples=8)
    cfg.dataset.basedir = str(SCENE)
    cfg.nerf.train.num_random_rays = 32
    cfg.experiment.validate_every = 0
    cfg.experiment.steps_per_call = 2
    cfg.experiment.print_every = 2
    cfg.optimizer.lr = 5e-4
    return cfg


@pytest.mark.parametrize("fused", [True, False])
def test_nerf_system_setup_and_fit(fused, capsys):
    cfg = tiny_train_cfg(fused)
    data = train_arrays(cfg, torch.device("cpu"), split="val")
    system = t_system.NeRFSystem(cfg, device="cpu").setup(data)
    before = [p.detach().clone() for p in system.fine.parameters()]
    launches = (fm.launches, fm.bwd_launches)
    metrics = system.fit(4)
    assert system.state.step == 4
    assert (fm.launches, fm.bwd_launches) == launches
    assert np.isfinite(metrics["train/loss"]) and metrics["train/rays_per_sec"] > 0
    assert metrics["train/lr"] == pytest.approx(5e-4 * 0.1 ** (3 / 450000))
    assert set(metrics) == {"train/coarse_loss", "train/coarse_psnr", "train/fine_loss",
                            "train/fine_psnr", "train/loss", "train/lr", "train/rays_per_sec"}
    assert any(not torch.equal(a, b) for a, b in zip(before, system.fine.parameters()))
    assert "step 4:" in capsys.readouterr().out
    # The same seed draws the same steps.
    again = t_system.NeRFSystem(cfg, device="cpu").setup(data)
    assert again.fit(4)["train/loss"] == metrics["train/loss"]


def test_fit_refuses_what_is_not_ported():
    cfg = tiny_train_cfg(fused=True)
    data = train_arrays(cfg, torch.device("cpu"), split="val")
    with pytest.raises(RuntimeError, match="setup"):
        t_system.NeRFSystem(cfg, device="cpu").fit(2)
    cfg.experiment.validate_every = 100
    with pytest.raises(NotImplementedError, match="validate_every"):
        t_system.NeRFSystem(cfg, device="cpu").setup(data).fit(2)
