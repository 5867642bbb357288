"""The system under test: nerfmeshes_tpu_torch's NeRFSystem, built from a
cell's config and loaded with the benchmark's weights, and the probes
that read what it did. The only module of the harness, with the kinds of
cell, that imports the program."""

from __future__ import annotations

import torch


def build_system(cfg_dict: dict, weights: dict, device, train_data: dict | None = None):
    """NeRFSystem(cfg).setup(train_data) (or .setup_eval() without data),
    its two fields' parameters overwritten in place by `weights`
    ("coarse.<leaf>", "fine.<leaf>")."""
    from nerfmeshes_tpu_torch.config import CfgNode, get_default_cfg
    from nerfmeshes_tpu_torch.train.system import NeRFSystem

    cfg = get_default_cfg()
    cfg.merge_from_other_cfg(CfgNode(cfg_dict))
    system = NeRFSystem(cfg, device=device)
    if train_data is not None:
        system.setup(train_dataset=train_data)
    else:
        system.setup_eval()
    load_weights(system, weights)
    return system


@torch.no_grad()
def load_weights(system, weights: dict) -> None:
    fields = {"coarse": system.coarse, "fine": system.fine}
    seen = set()
    for prefix, model in fields.items():
        for name, p in model.named_parameters():
            key = f"{prefix}.{name}"
            if key not in weights or tuple(weights[key].shape) != tuple(p.shape):
                raise ValueError(f"the benchmark has no weight {key} of shape {tuple(p.shape)}")
            p.copy_(weights[key])
            seen.add(key)
    if seen != set(weights):
        raise ValueError(f"the program has no parameters {sorted(set(weights) - seen)}")


def named_params(system) -> dict:
    return {f"{prefix}.{name}": p for prefix, model in (("coarse", system.coarse),
                                                        ("fine", system.fine))
            for name, p in model.named_parameters()}


class _DrawLog:
    """Records every random draw made through torch with a `generator`
    argument while it is on: (kind, a copy of what was drawn), kind as
    reference.DRAW_KINDS names it. A torch function mode, so it sees a
    draw wherever the program makes it."""

    def __init__(self, kinds: dict):
        from torch.overrides import TorchFunctionMode

        log = self

        class Mode(TorchFunctionMode):
            def __torch_function__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                name = getattr(func, "__name__", "")
                if log.on and kwargs.get("generator") is not None and name in kinds:
                    log.records.append((kinds[name], out.detach().clone()))
                return out

        self.on = True
        self.records: list = []
        self.mode = Mode()


class StepProbe:
    """Reads the first `steps` training steps of the program's own call,
    as they happen: each step's random draws (_DrawLog), each step's loss
    (from train/step.py's train_loss, the loss the step differentiates),
    the first step's coarse and fine rgb maps (from its render_rays), the
    first step's gradient as the optimizer got it (Adam's first moment
    after one step over 1 - b1), and the parameters after the last. The
    program's code is called as it is; the probe only keeps copies.
    close() puts the program's functions back."""

    def __init__(self, system, steps: int = 3):
        from harness.reference import DRAW_KINDS
        from nerfmeshes_tpu_torch.train import step as step_module

        self.system = system
        self.steps = steps
        self.losses: list = []
        self.draws: list = []  # each step's [(kind, tensor)], in the order drawn
        self.first_maps: tuple | None = None  # the first step's (coarse, fine) rgb maps
        self.first_moment: dict | None = None
        self.params_after: dict | None = None
        self._module = step_module
        self._train_loss = step_module.train_loss
        self._render_rays = step_module.render_rays
        self._opt_step = system.optimizer.step
        self._updates = 0
        self._log = _DrawLog(DRAW_KINDS)
        step_module.train_loss = self._loss
        step_module.render_rays = self._render
        system.optimizer.step = self._step
        self._log.mode.__enter__()

    def _loss(self, *args, **kwargs):
        loss, metrics = self._train_loss(*args, **kwargs)
        if len(self.losses) < self.steps:
            self.losses.append(loss.detach().clone())
        return loss, metrics

    def _render(self, *args, **kwargs):
        coarse, fine = self._render_rays(*args, **kwargs)
        if self.first_maps is None:
            self.first_maps = (coarse.rgb_map.detach().clone(), fine.rgb_map.detach().clone())
        return coarse, fine

    def _step(self):
        self._opt_step()
        self._updates += 1
        if self._updates <= self.steps:
            self.draws.append(self._log.records)
            self._log.records = []
            self._log.on = self._updates < self.steps
        params = named_params(self.system)
        if self._updates == 1:
            state = self.system.optimizer.rule.state
            self.first_moment = {k: state[p]["exp_avg"].detach().clone() if "exp_avg" in state[p]
                                 else torch.zeros_like(p) for k, p in params.items()}
            self.b1 = float(self.system.optimizer.rule.param_groups[0]["betas"][0])
        if self._updates == self.steps:
            self.params_after = {k: p.detach().clone() for k, p in params.items()}

    def close(self) -> None:
        self._log.mode.__exit__(None, None, None)
        self._module.train_loss = self._train_loss
        self._module.render_rays = self._render_rays
        del self.system.optimizer.step
        if (len(self.losses) < self.steps or len(self.draws) < self.steps
                or self.params_after is None or self.first_maps is None):
            raise RuntimeError(f"the probe saw {len(self.losses)} losses and {self._updates} "
                               f"updates of the program's first call, not {self.steps}")

    def first_grads(self) -> dict:
        return {k: m / (1.0 - self.b1) for k, m in self.first_moment.items()}


def load_kernels(device) -> bool:
    """Loads the program's CUDA kernel library, building it where this
    checkout has no build of its sources; True where it was built."""
    if torch.device(device).type != "cuda":
        return False
    from nerfmeshes_tpu_torch.ops.kernels import build

    built = not build.library_path().exists()
    build.load_library()
    return built


def launch_counts() -> dict:
    """The program's launch counters of the fused kernels."""
    from nerfmeshes_tpu_torch.ops.kernels import fused_mlp as fm

    return {"forward": fm.launches, "backward": fm.bwd_launches, "sigma": fm.sigma_launches}
