"""The port's optimizers (nerfmeshes_tpu_torch/train/optim.py) against optax.

Each of the six names of the JAX package's build_optimizer takes 20
updates of the same grads (drawn from a numpy seed) under a
DefaultScheduler that moves, with accumulate_steps 1 and 2 (optax.MultiSteps
against the port's running mean), on parameters of three shapes. One leaf
is all zeros with zero grads, where Adagrad's accumulator and RMSprop's
scale meet their edge cases.

Tolerance: rtol 1e-5, atol 1e-7 on the parameters after every update
(the same f32 arithmetic in another order, 20 steps deep).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerfmeshes_tpu.config import CfgNode, get_default_cfg
from nerfmeshes_tpu.train import optim as j_optim
from nerfmeshes_tpu_torch.train import optim as t_optim

torch.set_num_threads(1)

KINDS = ["Adam", "AdamW", "Adamax", "SGD", "RMSprop", "Adagrad"]
RTOL, ATOL = 1e-5, 1e-7
UPDATES = 20


def _cfg(kind, accum):
    cfg = get_default_cfg()
    cfg.optimizer.type = kind
    cfg.optimizer.lr = 1e-2
    cfg.optimizer.accumulate_steps = accum
    cfg.scheduler.type = "DefaultScheduler"
    cfg.scheduler.options = CfgNode({"gamma": 0.1, "step_size": 7})
    return cfg


def _leaves(rng):
    return {"w": rng.standard_normal((5, 4)).astype(np.float32),
            "b": rng.standard_normal(4).astype(np.float32),
            "z": np.zeros(3, np.float32)}


def _grads(rng, n):
    out = []
    for _ in range(n):
        g = _leaves(rng)
        g["w"] *= np.float32(0.3)
        out.append(g)
    return out


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("kind", KINDS)
def test_updates_match_optax(kind, accum):
    rng = np.random.default_rng(7)
    init = _leaves(rng)
    grads = _grads(rng, UPDATES * accum)
    cfg = _cfg(kind, accum)
    opt = j_optim.build_optimizer(cfg)
    p_j = {k: jnp.asarray(v) for k, v in init.items()}
    state = opt.init(p_j)
    update = jax.jit(opt.update)
    p_t = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    port = t_optim.build_optimizer(list(p_t.values()), cfg)
    moved = False
    for i, g in enumerate(grads):
        upd, state = update({k: jnp.asarray(v) for k, v in g.items()}, state, p_j)
        p_j = optax.apply_updates(p_j, upd)
        for k, p in p_t.items():
            p.grad = torch.from_numpy(g[k])
        port.step()
        for k in init:
            np.testing.assert_allclose(p_t[k].detach().numpy(), np.asarray(p_j[k]),
                                       rtol=RTOL, atol=ATOL, err_msg=f"{kind} update {i} {k}")
            assert p_t[k].grad is None
        moved |= not np.array_equal(p_t["w"].detach().numpy(), init["w"])
    assert moved
    # The zero leaf with zero grads: only AdamW's decay could move it, and 0 stays 0.
    np.testing.assert_array_equal(p_t["z"].detach().numpy(), 0.0)
    assert port.lr_at(UPDATES * accum) == pytest.approx(float(j_optim.build_schedule(cfg)(UPDATES)),
                                                        rel=1e-6)


@pytest.mark.parametrize("kind", KINDS)
def test_state_dict_resumes_bit_for_bit(kind):
    """Ten updates, state_dict into a fresh optimizer over copies of the
    parameters, ten more: equal to twenty in one go, bit for bit (with a
    partial accumulator carried across)."""
    rng = np.random.default_rng(3)
    init = _leaves(rng)
    grads = _grads(rng, 21)
    cfg = _cfg(kind, 2)

    def params(values):
        return [torch.nn.Parameter(torch.from_numpy(v.copy())) for v in values]

    def run(ps, opt, gs):
        for g in gs:
            for p, k in zip(ps, init):
                p.grad = torch.from_numpy(g[k].copy())
            opt.step()

    whole = params(init.values())
    run(whole, w_opt := t_optim.build_optimizer(whole, cfg), grads)
    first = params(init.values())
    f_opt = t_optim.build_optimizer(first, cfg)
    run(first, f_opt, grads[:11])
    saved = f_opt.state_dict()
    assert saved["type"] == kind and saved["micro"] == 1
    second = params([p.detach().numpy() for p in first])
    s_opt = t_optim.build_optimizer(second, cfg)
    s_opt.load_state_dict(saved)
    run(second, s_opt, grads[11:])
    for a, b in zip(whole, second):
        assert torch.equal(a, b)
    assert s_opt.lr_scheduler.last_epoch == w_opt.lr_scheduler.last_epoch == 10


def test_rmsprop_and_adagrad_are_optax_rules_not_torch_defaults():
    """One update from a known grad, worked by hand: RMSprop decay 0.9 with
    eps inside the root from a zero scale, Adagrad from 0.1 with eps 1e-7
    inside the root."""
    g = np.float32(0.5)
    for kind, want in (("RMSprop", -g / np.sqrt(0.1 * g * g + 1e-8)),
                       ("Adagrad", -g / np.sqrt(0.1 + g * g + 1e-7))):
        cfg = _cfg(kind, 1)
        cfg.scheduler.type = "ConstantLR"
        p = torch.nn.Parameter(torch.zeros(1))
        opt = t_optim.build_optimizer([p], cfg)
        p.grad = torch.full((1,), float(g))
        opt.step()
        assert float(p.detach()) == pytest.approx(float(1e-2 * want), rel=1e-6), kind


def test_unknown_optimizer_raises_as_jax():
    cfg = _cfg("Lion", 1)
    with pytest.raises(ValueError, match="Lion"):
        j_optim.build_optimizer(cfg)
    with pytest.raises(ValueError, match="Lion"):
        t_optim.build_optimizer([torch.nn.Parameter(torch.zeros(2))], cfg)


def test_checkpoint_with_the_adam_key_restores():
    """A state written before the rules were named ({"adam": ...}) loads
    into an Adam optimizer and continues as the original."""
    rng = np.random.default_rng(5)
    init = _leaves(rng)
    grads = _grads(rng, 6)
    cfg = _cfg("Adam", 1)

    def step(ps, opt, g):
        for p, k in zip(ps, init):
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()

    a = [torch.nn.Parameter(torch.from_numpy(v.copy())) for v in init.values()]
    a_opt = t_optim.build_optimizer(a, cfg)
    for g in grads[:3]:
        step(a, a_opt, g)
    new = a_opt.state_dict()
    old = copy.deepcopy({"adam": new["rule"], "schedule_step": new["schedule_step"],
                         "micro": new["micro"], "mean": new["mean"]})
    b = [torch.nn.Parameter(p.detach().clone()) for p in a]
    b_opt = t_optim.build_optimizer(b, cfg)
    b_opt.load_state_dict(old)
    for g in grads[3:]:
        step(a, a_opt, g)
        step(b, b_opt, g)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="Adam"):
        t_optim.build_optimizer(b, _cfg("SGD", 1)).load_state_dict(old)
