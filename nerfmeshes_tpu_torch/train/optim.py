"""Optimizer and LR schedule from the config (counterpart of
nerfmeshes_tpu/train/optim.py).

The schedules are optax's formulas written as plain functions of the
update count, in float32 as optax evaluates them, driving
`torch.optim.lr_scheduler.LambdaLR` over a base lr of 1, so the lr an
update uses is the schedule at the update count before the increment,
as optax reads it. `build_optimizer` takes Adam
with optax's defaults (b1 0.9, b2 0.999, eps 1e-8 outside the square
root), which torch.optim.Adam shares. The other optimizer names of the
JAX package raise NotImplementedError: optax's defaults for them differ
from torch.optim's (AdamW's weight decay, RMSprop's decay, Adagrad's
initial accumulator) and are queued in ROADMAP.md.

Gradient accumulation follows optax.MultiSteps: the running mean of k
micro-batch grads, then one update and one schedule tick per k calls.
"""

from __future__ import annotations

from typing import Callable, Iterable

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


class Optimizer:
    """torch.optim.Adam + LambdaLR with optax.MultiSteps accumulation.

    `step()` takes the grads now in the parameters' .grad as one
    micro-batch: it folds them into the running mean, and on every k-th
    call applies one Adam update with that mean and ticks the schedule.
    It leaves .grad cleared."""

    def __init__(self, params: Iterable[torch.nn.Parameter], cfg):
        self.params = [p for p in params]
        self.schedule = build_schedule(cfg)
        self.accum = accumulation_steps(cfg)
        kind = cfg.optimizer.type
        if kind != "Adam":
            raise NotImplementedError(
                f"optimizer {kind!r} is not ported yet: only Adam is (optax's defaults for "
                "the others differ from torch.optim's; queued in ROADMAP.md)")
        self.adam = torch.optim.Adam(self.params, lr=1.0, betas=(0.9, 0.999), eps=1e-8)
        self.lr_scheduler = torch.optim.lr_scheduler.LambdaLR(self.adam, self.schedule)
        self._mean = None
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
        self.adam.step()
        self.lr_scheduler.step()
        self.zero_grad()

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def state_dict(self) -> dict:
        """Adam's state, the schedule's position (LambdaLR.last_epoch; its
        lambda is rebuilt from the config) and the MultiSteps accumulator,
        as tensors and plain containers."""
        return {"adam": self.adam.state_dict(), "schedule_step": self.lr_scheduler.last_epoch,
                "micro": self._micro, "mean": self._mean}

    def load_state_dict(self, state: dict) -> None:
        self.adam.load_state_dict(state["adam"])
        self.lr_scheduler.last_epoch = int(state["schedule_step"])
        self.lr_scheduler._last_lr = [g["lr"] for g in self.adam.param_groups]
        self._micro = int(state["micro"])
        self._mean = (None if state["mean"] is None else
                      [m.to(p.device) for m, p in zip(state["mean"], self.params)])

    def lr_at(self, step: int) -> float:
        """The schedule at a micro-step count (the train/lr metric)."""
        return self.schedule(step // self.accum)


def build_optimizer(params: Iterable[torch.nn.Parameter], cfg) -> Optimizer:
    """cfg.optimizer (+ cfg.scheduler) -> the optimizer over `params`."""
    return Optimizer(params, cfg)
