"""Optimizer and LR schedule from the config (counterpart of
nerfmeshes_tpu/train/optim.py).

The schedules are optax's formulas written as plain functions of the
update count, in float32 as optax evaluates them, driving
`torch.optim.lr_scheduler.LambdaLR` over a base lr of 1, so the lr an
update uses is the schedule at the update count before the increment,
as optax reads it. `build_optimizer` takes the six optimizer names of
the JAX package with optax's (0.2.6) defaults:
- Adam: b1 0.9, b2 0.999, eps 1e-8 outside the square root, the bias
  corrections taken as optax takes them (`OptaxAdam`);
- AdamW: Adam with weight decay 1e-4 on every parameter, decoupled and
  scaled by the lr (`OptaxAdam` with weight_decay=1e-4);
- Adamax: nu = max(b2 nu, |g| + eps), eps 1e-8 (torch.optim.Adamax);
- SGD: no momentum (torch.optim.SGD);
- RMSprop: decay 0.9, eps 1e-8 inside the square root, initial scale 0,
  no bias correction (`OptaxRMSprop`; torch's alpha is 0.99 and its eps
  outside the root);
- Adagrad: initial accumulator 0.1, eps 1e-7 inside the square root, 0
  where the accumulator is 0 (`OptaxAdagrad`; torch starts at 0 and adds
  eps outside the root).

Gradient accumulation follows optax.MultiSteps: the running mean of k
micro-batch grads, then one update and one schedule tick per k calls.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import numpy as np
import torch


def build_schedule(cfg) -> Callable[[int], float]:
    """cfg.scheduler -> the absolute lr at an update count (optax's
    schedules as nerfmeshes_tpu/train/optim.py:18-57 builds them)."""
    f32 = np.float32
    lr = f32(cfg.optimizer.lr)
    kind = cfg.scheduler.type
    opts = dict(cfg.scheduler.options)

    if kind in ("DefaultScheduler", "StepLR", "ExponentialLR"):
        # optax.exponential_decay: lr * gamma ** (step / transition_steps),
        # floored under staircase (StepLR). DefaultScheduler is continuous.
        steps = 1 if kind == "ExponentialLR" else int(opts["step_size"])
        gamma = f32(opts.get("gamma", 0.1) if kind == "StepLR" else opts["gamma"])
        staircase = kind == "StepLR"

        def exponential(step):
            p = f32(step) / f32(steps)
            return float(lr * gamma ** (np.floor(p) if staircase else p))

        return exponential
    if kind == "MultiStepLR":
        gamma = f32(opts.get("gamma", 0.1))
        milestones = sorted(int(m) for m in opts["milestones"])

        def piecewise(step):
            # optax.piecewise_constant_schedule: scaled from the boundary on.
            v = lr
            for m in milestones:
                if step >= m:
                    v = v * gamma
            return float(v)

        return piecewise
    if kind == "CosineAnnealingLR":
        decay_steps = f32(int(opts["T_max"]))
        alpha = f32(float(opts.get("eta_min", 0.0)) / float(lr) if lr else 0.0)

        def cosine(step):
            frac = min(f32(step), decay_steps) / decay_steps
            decay = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * frac))
            return float(lr * ((f32(1) - alpha) * decay + alpha))

        return cosine
    if kind in ("ConstantLR", "LambdaLR"):
        return lambda step: float(lr)
    raise ValueError(f"Unknown scheduler type {kind!r}")


def accumulation_steps(cfg) -> int:
    """cfg.optimizer.accumulate_steps (>= 1); 1 = no accumulation."""
    return max(1, int(cfg.optimizer.get("accumulate_steps", 1)))


class OptaxAdam(torch.optim.Optimizer):
    """optax.adam(lr) (scale_by_adam, then scale_by_learning_rate), and with
    `weight_decay` optax.adamw(lr) (the decayed weights added to the Adam
    direction before the lr scales it):
    mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu, then
    p -= lr (mu / c1) / (sqrt(nu / c2) + eps) (+ lr weight_decay p),
    with c = 1 - b^t taken in the parameters' dtype, as optax takes it.

    torch.optim.Adam takes c in float64 on the host. In float32, b2 = 0.999
    rounds to 0.99900001, so optax's 1 - b2^t stands 1.3e-5 below the exact
    one and every update of the first thousands is about 6.5e-6 shorter
    than torch's; over a run the parameters drift apart by that step size
    bias (tests/test_torch_trajectory.py holds the trajectories). The state
    keeps torch.optim.Adam's names (step, exp_avg, exp_avg_sq), so a
    checkpoint of either loads into the other."""

    def __init__(self, params, lr: float = 1.0, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2 = group["betas"]
            grads = [p.grad for p in params]
            states = [self.state[p] for p in params]
            for p, state in zip(params, states):
                if not state:
                    state["step"] = 0
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
            mu = [s["exp_avg"] for s in states]
            nu = [s["exp_avg_sq"] for s in states]
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, grads, alpha=1.0 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
            # One count for the group: every parameter steps together.
            t = int(states[0]["step"]) + 1
            for s in states:
                s["step"] = t
            kind = np.float32 if params[0].dtype != torch.float64 else np.float64
            c1 = float(kind(1) - kind(b1) ** kind(t))
            c2 = float(kind(1) - kind(b2) ** kind(t))
            denom = torch._foreach_div(nu, c2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, group["eps"])
            update = torch._foreach_div(mu, c1)
            torch._foreach_div_(update, denom)
            if group["weight_decay"]:
                torch._foreach_add_(update, params, alpha=group["weight_decay"])
            torch._foreach_add_(params, update, alpha=-group["lr"])


class OptaxRMSprop(torch.optim.Optimizer):
    """optax.rmsprop(lr) with its defaults: nu = decay nu + (1 - decay) g^2
    from nu = initial_scale, and p -= lr g / sqrt(nu + eps)
    (optax/_src/transform.py:scale_by_rms, eps_in_sqrt=True, no bias
    correction, no momentum)."""

    def __init__(self, params, lr: float = 1.0, decay: float = 0.9, eps: float = 1e-8,
                 initial_scale: float = 0.0):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps, initial_scale=initial_scale))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["nu"] = torch.full_like(p, group["initial_scale"])
                nu = state["nu"]
                nu.mul_(group["decay"]).add_((1.0 - group["decay"]) * p.grad * p.grad)
                p.add_(p.grad * torch.rsqrt(nu + group["eps"]), alpha=-group["lr"])


class OptaxAdagrad(torch.optim.Optimizer):
    """optax.adagrad(lr) with its defaults: s = s + g^2 from s =
    initial_accumulator_value, and p -= lr g / sqrt(s + eps) where s > 0,
    0 elsewhere (optax/_src/transform.py:scale_by_rss)."""

    def __init__(self, params, lr: float = 1.0, initial_accumulator_value: float = 0.1,
                 eps: float = 1e-7):
        super().__init__(params, dict(lr=lr, initial_accumulator_value=initial_accumulator_value,
                                      eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["sum_of_squares"] = torch.full_like(
                        p, group["initial_accumulator_value"])
                s = state["sum_of_squares"]
                s.add_(p.grad * p.grad)
                scale = torch.where(s > 0, torch.rsqrt(s + group["eps"]), torch.zeros_like(s))
                p.add_(scale * p.grad, alpha=-group["lr"])


def make_rule(kind: str, params: list) -> torch.optim.Optimizer:
    """The update rule of optimizer `kind` at a base lr of 1 (the schedule
    scales it), with optax's defaults."""
    if kind == "Adam":
        return OptaxAdam(params, lr=1.0)
    if kind == "AdamW":
        return OptaxAdam(params, lr=1.0, weight_decay=1e-4)
    if kind == "Adamax":
        return torch.optim.Adamax(params, lr=1.0, betas=(0.9, 0.999), eps=1e-8)
    if kind == "SGD":
        return torch.optim.SGD(params, lr=1.0)
    if kind == "RMSprop":
        return OptaxRMSprop(params, lr=1.0)
    if kind == "Adagrad":
        return OptaxAdagrad(params, lr=1.0)
    raise ValueError(f"Unknown optimizer type {kind!r}")


class Optimizer:
    """cfg.optimizer.type's update rule + LambdaLR with optax.MultiSteps
    accumulation.

    `step()` takes the grads now in the parameters' .grad as one
    micro-batch: it folds them into the running mean, and on every k-th
    call applies one update with that mean and ticks the schedule. A
    parameter without a grad takes a zero grad, as optax updates every
    leaf. It leaves .grad cleared."""

    def __init__(self, params: Iterable[torch.nn.Parameter], cfg):
        self.params = [p for p in params]
        self.schedule = build_schedule(cfg)
        self.accum = accumulation_steps(cfg)
        self.kind = cfg.optimizer.type
        self.rule = make_rule(self.kind, self.params)
        self.lr_scheduler = torch.optim.lr_scheduler.LambdaLR(self.rule, self.schedule)
        self._mean: Optional[list] = None
        self._micro = 0

    def step(self) -> None:
        if self.accum > 1:
            # optax.MultiSteps' running mean: acc + (g - acc) / (i + 1).
            if self._mean is None:
                self._mean = [torch.zeros_like(p) for p in self.params]
            for acc, p in zip(self._mean, self.params):
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                acc.add_((g - acc) / (self._micro + 1))
            self._micro += 1
            if self._micro < self.accum:
                self.zero_grad()
                return
            for p, acc in zip(self.params, self._mean):
                p.grad = acc.clone()
                acc.zero_()
            self._micro = 0
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.rule.step()
        self.lr_scheduler.step()
        self.zero_grad()

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def state_dict(self) -> dict:
        """The rule's name and state, the schedule's position
        (LambdaLR.last_epoch; its lambda is rebuilt from the config) and
        the MultiSteps accumulator, as tensors and plain containers."""
        return {"type": self.kind, "rule": self.rule.state_dict(),
                "schedule_step": self.lr_scheduler.last_epoch,
                "micro": self._micro, "mean": self._mean}

    def load_state_dict(self, state: dict) -> None:
        """Load a state_dict(); a checkpoint written before the rules were
        named holds Adam's state under "adam"."""
        kind = state.get("type", "Adam")
        if kind != self.kind:
            raise ValueError(f"the checkpoint's optimizer is {kind}, the config's {self.kind}")
        self.rule.load_state_dict(state["rule"] if "rule" in state else state["adam"])
        self.lr_scheduler.last_epoch = int(state["schedule_step"])
        self.lr_scheduler._last_lr = [g["lr"] for g in self.rule.param_groups]
        self._micro = int(state["micro"])
        self._mean = (None if state["mean"] is None else
                      [m.to(p.device) for m, p in zip(state["mean"], self.params)])

    def lr_at(self, step: int) -> float:
        """The schedule at a micro-step count (the train/lr metric)."""
        return self.schedule(step // self.accum)


def build_optimizer(params: Iterable[torch.nn.Parameter], cfg) -> Optimizer:
    """cfg.optimizer (+ cfg.scheduler) -> the optimizer over `params`."""
    return Optimizer(params, cfg)
