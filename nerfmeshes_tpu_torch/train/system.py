"""NeRFSystem (counterpart of nerfmeshes_tpu/train/system.py).

Builds the coarse/fine models from a config, initialises them from the
config's seed, trains them (`setup` + `fit`), renders rays at
validation settings and answers mesh extraction's queries
(`density_points`, `sample_points`, `query_rgb`). `validate`,
checkpoints and early stopping are not ported yet (ROADMAP.md); `fit`
raises NotImplementedError when the config asks for them, so nothing
trains without what it asked for.
"""

from __future__ import annotations

import math
import time
from typing import Optional

import numpy as np
import torch

from nerfmeshes_tpu_torch.models import build_model
from nerfmeshes_tpu_torch.models.layers import TorchLinear
from nerfmeshes_tpu_torch.ops.kernels.fused_mlp import (
    PackedMLP,
    fused_flexible_apply,
    fused_sigma_points,
    pack_weights,
    supports_fused,
)
from nerfmeshes_tpu_torch.train.optim import build_optimizer
from nerfmeshes_tpu_torch.train.step import (
    init_train_state,
    make_render_chunk,
    make_train_step,
    render_image,
    round_chunk,
)


def compute_dtype_from_cfg(cfg) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}[
        str(cfg.experiment.compute_dtype)
    ]


def create_models(cfg, device: Optional[torch.device] = None):
    """(coarse, fine | None) from cfg.models.*."""
    dtype = compute_dtype_from_cfg(cfg)
    coarse = build_model(cfg.models.coarse_type, dict(cfg.models.coarse),
                         compute_dtype=dtype, device=device)
    fine = None
    if "fine" in cfg.models and cfg.models.use_fine:
        fine = build_model(cfg.models.fine_type, dict(cfg.models.fine),
                           compute_dtype=dtype, device=device)
    return coarse, fine


def init_params(coarse, fine, generator: torch.Generator) -> None:
    """Redraw every layer of the coarse, then the fine model from
    `generator` (torch's default init), in place. The generator and the
    models must be on one device."""
    for model in (coarse, fine):
        if model is None:
            continue
        for module in model.modules():
            if isinstance(module, TorchLinear):
                module.reset_parameters(generator)


class NeRFSystem:
    """Owns the coarse/fine models, their optimizer and train state; trains
    them and serves renders and point queries."""

    def __init__(self, cfg, device: Optional[torch.device] = None):
        self.cfg = cfg
        self.device = torch.device("cpu") if device is None else torch.device(device)
        # Drawn on the CPU so a seed gives the same weights on every device.
        self.coarse, self.fine = create_models(cfg)
        seed = int(cfg.experiment.randomseed)
        init_params(self.coarse, self.fine, torch.Generator().manual_seed(seed))
        models = [m for m in (self.coarse, self.fine) if m is not None]
        for model in models:
            model.to(self.device).eval()
        self.optimizer = build_optimizer([p for m in models for p in m.parameters()], cfg)
        self.state = init_train_state(self.coarse, self.fine, self.optimizer, seed, self.device)
        self._render_chunk = None
        self._train_fn = None
        self._data = None
        self._sigma_cache = None

    # -- setup ----------------------------------------------------------------
    def setup(self, train_data: dict) -> "NeRFSystem":
        """Take the training arrays (data/blender.py:train_arrays: targets,
        poses, bounds on this system's device, hwf) and build the train step
        and the chunk renderer."""
        H, W, focal = train_data["hwf"]
        self._data = train_data
        self._train_fn = make_train_step(self.cfg, H=int(H), W=int(W), focal=float(focal))
        return self.setup_eval()

    def setup_eval(self) -> "NeRFSystem":
        """Build the chunk renderer at validation settings."""
        self._render_chunk = make_render_chunk(self.cfg, self.coarse, self.fine)
        return self

    def _on_device(self, x) -> torch.Tensor:
        """A host array or a tensor as f32 on this system's device (as JAX
        puts host arrays on its device)."""
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    @property
    def finest_model(self):
        return self.fine if self.fine is not None else self.coarse

    def _fused(self) -> bool:
        return (bool(self.cfg.experiment.get("use_fused_kernel", True))
                and supports_fused(self.finest_model))

    def query_rays(self, origins, directions, near, far, chunk: Optional[int] = None,
                   fields: Optional[tuple] = None, as_numpy: bool = True):
        """Render rays with the finest model at validation settings, on this
        system's device whatever the rays' (host arrays included); see
        render_image for `fields` and `as_numpy`."""
        if self._render_chunk is None:
            raise RuntimeError("call setup_eval() before query_rays()")
        chunk = round_chunk(chunk or self.cfg.nerf.validation.chunksize)
        coarse, fine = render_image(
            self._render_chunk, self._on_device(origins), self._on_device(directions),
            float(near), float(far), chunk_size=chunk, fields=fields, as_numpy=as_numpy,
        )
        return fine if fine is not None else coarse

    def query_rgb(self, origins, directions, near, far, chunk: int = 65536,
                  as_uint8: bool = False) -> np.ndarray:
        """The finest rgb map of query_rays as a host array: (R, 3) f32, or
        with `as_uint8` JAX's quantization round(clip(rgb, 0, 1) * 255) as
        uint8 (nerfmeshes_tpu/train/step.py:421-424), taken on the device.
        JAX batches every chunk into one program for its TPU link; here one
        chunk at a time goes to the card, with one fetch at the end."""
        rgb = self.query_rays(origins, directions, near, far, chunk=chunk,
                              fields=("rgb_map",), as_numpy=False).rgb_map
        if as_uint8:
            rgb = torch.round(rgb.clamp(0.0, 1.0) * 255.0).to(torch.uint8)
        return rgb.cpu().numpy()

    @torch.inference_mode()
    def sample_points(self, points, directions=None) -> torch.Tensor:
        """Point query of the finest field -> (..., 4), on this system's
        device."""
        points = self._on_device(points)
        if directions is not None:
            directions = self._on_device(directions)
            if self._fused():
                return fused_flexible_apply(self.finest_model, points, directions)
        return self.finest_model(points, directions)

    @torch.inference_mode()
    def density_points(self, points) -> torch.Tensor:
        """Raw sigma of the finest field at (..., 3) points -> (...,) f32,
        on this system's device: the sigma-only kernel when the fused
        kernels are on and the model is in their bound, else channel 3 of
        the nn.Module (nerfmeshes_tpu/train/system.py:242-268). JAX splits
        this into density_apply(params, points) + finest_params only so
        that XLA compiles the grid program once per shape; eager PyTorch
        needs no such split. The kernel's weight packing is made once and
        reused until a parameter changes (_sigma_pack), so the tiles of a
        grid share one, as JAX's tiles share finest_params."""
        points = self._on_device(points)
        if self._fused():
            return fused_sigma_points(self._sigma_pack(), points)
        return self.finest_model(points, points)[..., 3].float()

    def _sigma_pack(self) -> PackedMLP:
        """pack_weights(finest_model), cached on the parameters' storage and
        version counters: an optimizer step, load_state_dict or any other
        in-place update bumps a version, a move to another device gives new
        storage, and either makes a new packing."""
        key = tuple((p.data_ptr(), p._version) for p in self.finest_model.parameters())
        if self._sigma_cache is None or self._sigma_cache[0] != key:
            self._sigma_cache = (key, pack_weights(self.finest_model))
        return self._sigma_cache[1]

    # -- fit loop ----------------------------------------------------------------
    def fit(self, max_steps: Optional[int] = None) -> dict:
        """Run the train step to `max_steps` (default: experiment.train_iters)
        in calls of experiment.steps_per_call steps. At the print cadence
        (and at the end) the last step's metrics come to the host, with
        train/rays_per_sec, and a non-finite loss stops the run
        (nerfmeshes_tpu/train/system.py:427-500). Returns the last host
        metrics."""
        cfg = self.cfg
        exp = cfg.experiment
        if self._train_fn is None:
            raise RuntimeError("call setup(train_data) before fit()")
        if int(exp.validate_every) > 0 or bool(exp.use_early_stopping):
            raise NotImplementedError(
                "validation, checkpoints and early stopping are not ported yet (ROADMAP.md); "
                "set experiment.validate_every = 0 and use_early_stopping = False")
        max_steps = max_steps or int(exp.train_iters)
        print_every = int(exp.print_every)
        steps_per_call = int(exp.steps_per_call)
        rays_per_step = int(cfg.nerf.train.num_random_rays)

        last_metrics: dict = {}
        t0 = time.perf_counter()
        rays_done = 0
        step = self.state.step
        while step < max_steps:
            self.state, metrics = self._train_fn(self.state, self._data)
            step = self.state.step
            rays_done += steps_per_call * rays_per_step
            self.on_step(step, metrics)
            if step % print_every < steps_per_call or step >= max_steps:
                host = {k: float(v) for k, v in metrics.items() if k != "train/rgb_sum"}
                host["train/rays_per_sec"] = rays_done / max(time.perf_counter() - t0, 1e-9)
                loss = host.get("train/loss")
                if loss is not None and not math.isfinite(loss):
                    raise RuntimeError(
                        f"Training diverged: train/loss={loss} at step {step} "
                        f"(lr={host.get('train/lr')}). Restart with a lower lr, fewer rays, "
                        "or sigma noise enabled.")
                last_metrics = host
                print(f"step {step}: " + " ".join(f"{k}={v:.6g}" for k, v in host.items()),
                      flush=True)
        return last_metrics

    def on_step(self, step: int, metrics: dict) -> None:
        """Hook called after every call of the train step with its device
        metrics (subclasses; nothing here waits for the device)."""
