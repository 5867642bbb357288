"""NeRFSystem (counterpart of nerfmeshes_tpu/train/system.py).

Builds the coarse/fine models from a config, initialises them from the
config's seed, trains them (`setup` + `fit`) with validation, checkpoints
and the early-collapse check at the config's cadence, renders rays at
validation settings and answers mesh extraction's queries
(`density_points`, `sample_points`, `query_rgb`). With an ExperimentPaths
it logs to <run>/events and checkpoints to <run>/checkpoints.

The train step never reads from the device: the print cadence, a
validation, a checkpoint save and the early-stopping step are the only
places the host waits for it.

With a DataGroup (parallel/mesh.py) of several ranks, or a forced one,
every rank holds the whole system; the train step, the chunk renderer and
so validation, query_rays and query_rgb split their rays over the group.
Every rank sees the same reduced metrics and gathered renders, so every
rank takes the same decisions; rank 0 alone logs, prints and writes
checkpoints, with a barrier after each save.
"""

from __future__ import annotations

import math
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from nerfmeshes_tpu_torch.data.datasets import DatasetType, build_dataset
from nerfmeshes_tpu_torch.models import build_model
from nerfmeshes_tpu_torch.models.nerf_models import field_of
from nerfmeshes_tpu_torch.ops.kernels.fused_mlp import (
    PackedMLP,
    fused_flexible_apply,
    fused_sigma_points,
    pack_weights,
    supports_fused,
)
from nerfmeshes_tpu_torch.ops.math import img2mse
from nerfmeshes_tpu_torch.parallel.mesh import DataGroup, broadcast_params, round_chunk, single
from nerfmeshes_tpu_torch.train.checkpoint import CheckpointManager
from nerfmeshes_tpu_torch.train.optim import build_optimizer
from nerfmeshes_tpu_torch.train.step import (
    init_train_state,
    make_render_chunk,
    make_train_step,
    render_image,
)
from nerfmeshes_tpu_torch.utils.images import cast_to_disparity_image
from nerfmeshes_tpu_torch.utils.loggers import DepthProjectionLogger
from nerfmeshes_tpu_torch.utils.logging import MetricsLogger, progress_bar


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


def _host_psnr(mse: float) -> float:
    """mse2psnr on a host float (zero taken as 1e-5)."""
    return -10.0 * math.log10(mse if mse > 0 else 1e-5)


def _rgb_u8(rgb: torch.Tensor, H: int, W: int) -> np.ndarray:
    """(H*W, 3) [0, 1] -> (H, W, 3) uint8, quantised on the device."""
    return (rgb.reshape(H, W, 3).clamp(0.0, 1.0) * 255.0).to(torch.uint8).cpu().numpy()


def init_params(coarse, fine, generator: torch.Generator) -> None:
    """Redraw every layer of the coarse, then the fine model from
    `generator`, in place, each with its own init (models/layers.py;
    TorchLinear: torch's default). The generator and the models must be on
    one device."""
    for model in (coarse, fine):
        if model is None:
            continue
        for module in model.modules():
            reset = getattr(module, "reset_parameters", None)
            if reset is not None:
                reset(generator)


class NeRFSystem:
    """Owns the coarse/fine models, their optimizer and train state; trains
    them and serves renders and point queries."""

    def __init__(self, cfg, paths=None, device: Optional[torch.device] = None,
                 group: Optional[DataGroup] = None):
        """`paths`: an ExperimentPaths for the logger and the checkpoints
        (None: neither). `device`: where the models, the train state, the
        datasets and every render live; None means the CUDA card (an error
        without one). `group`: the data-parallel group this system is a
        rank of (None: one rank on `device`); its device is the system's.
        Rank 0's parameters are broadcast to every rank here and after
        restore()."""
        self.cfg = cfg
        self.paths = paths
        if group is None:
            group = single(device)
        elif device is not None and torch.device(device) != group.device:
            raise ValueError(f"device {device} is not the group's {group.device}")
        self.group = group
        self.device = group.device
        # Drawn on the CPU so a seed gives the same weights on every device.
        self.coarse, self.fine = create_models(cfg)
        seed = int(cfg.experiment.randomseed)
        init_params(self.coarse, self.fine, torch.Generator().manual_seed(seed))
        models = [m for m in (self.coarse, self.fine) if m is not None]
        for model in models:
            model.to(self.device).eval()
        self.optimizer = build_optimizer([p for m in models for p in m.parameters()], cfg)
        self.state = init_train_state(self.coarse, self.fine, self.optimizer, seed, self.device)
        broadcast_params(self.optimizer.params, group)
        self.train_dataset = None
        self.val_dataset = None
        self._render_chunk = None
        self._train_fn = None
        self._data = None
        self._hwf = None
        self._intrinsics = None
        self._sigma_cache = None
        self._proj_logger = DepthProjectionLogger(step_size=1)
        self.logger = (MetricsLogger(paths.events_dir, use_acronyms=bool(cfg.logging.use_acronyms))
                       if paths is not None and group.is_main else None)
        self.ckpt = CheckpointManager(paths.checkpoint_dir) if paths is not None else None

    # -- setup ----------------------------------------------------------------
    def setup(self, train_dataset=None, val_dataset=None) -> "NeRFSystem":
        """Build the train step and the chunk renderer. `train_dataset`: a
        RayDataset, the arrays of RayDataset.device_arrays (or
        data/blender.py:train_arrays) on this system's device, or None to
        build the config's training split. `val_dataset`: a RayDataset, or
        None to build the config's validation split at the first
        validate().

        The train rays follow the dataset's `intrinsics()` (ScanNet's +z,
        image-down y and principal point, as JAX's system passes them,
        nerfmeshes_tpu/train/system.py:141). A dict of arrays has no
        dataset: its optional "intrinsics" entry, a CameraIntrinsics, is
        used, and without one CameraIntrinsics.from_hwf(hwf)."""
        if isinstance(train_dataset, dict):
            self._data = train_dataset
            self._intrinsics = train_dataset.get("intrinsics")
        else:
            self.train_dataset = train_dataset or build_dataset(
                self.cfg, DatasetType.TRAIN, self.device)
            self._data = self.train_dataset.device_arrays(self.device)
            self._intrinsics = self.train_dataset.intrinsics()
        self._hwf = tuple(self._data["hwf"])
        self._build_train_fn()
        return self.setup_eval(val_dataset)

    def _build_train_fn(self) -> None:
        H, W, focal = self._hwf
        self._train_fn = make_train_step(self.cfg, H=int(H), W=int(W), focal=float(focal),
                                         intrinsics=self._intrinsics, group=self.group)

    def setup_eval(self, val_dataset=None) -> "NeRFSystem":
        """Build the chunk renderer at validation settings (and take
        `val_dataset` for validate, when given)."""
        if val_dataset is not None:
            self.val_dataset = val_dataset
        self._render_chunk = make_render_chunk(self.cfg, self.coarse, self.fine,
                                               group=self.group)
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
        chunk = round_chunk(chunk or self.cfg.nerf.validation.chunksize, self.group.world)
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
        device (the field alone of a model that returns (field, aux))."""
        points = self._on_device(points)
        if directions is not None:
            directions = self._on_device(directions)
            if self._fused():
                return fused_flexible_apply(self.finest_model, points, directions)
        return field_of(self.finest_model(points, directions))

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
        return field_of(self.finest_model(points, points))[..., 3].float()

    def _sigma_pack(self) -> PackedMLP:
        """pack_weights(finest_model), cached on the parameters' storage and
        version counters: an optimizer step, load_state_dict or any other
        in-place update bumps a version, a move to another device gives new
        storage, and either makes a new packing."""
        key = tuple((p.data_ptr(), p._version) for p in self.finest_model.parameters())
        if self._sigma_cache is None or self._sigma_cache[0] != key:
            self._sigma_cache = (key, pack_weights(self.finest_model))
        return self._sigma_cache[1]

    # -- validation --------------------------------------------------------------
    def validate(self, max_images: Optional[int] = None, log_images: bool = True,
                 step: Optional[int] = None) -> dict:
        """Render nerf.validation.num_samples validation views (all with
        -1) and return the coarse/fine MSE and PSNR and their summed loss,
        with the chamfer term when the config asks for it. Views are drawn
        with replacement from a generator seeded by the step (by 0 under
        nerf.validation.fixed_views). Rays and targets stay on the device;
        the losses come to the host in one fetch after the loop, and with
        `log_images` each view's renders go to the logger as PNGs. Under a
        sharded group every rank renders its share of each view and holds
        the gathered maps, so every rank computes the same losses and takes
        the same checkpoint and early-stopping decisions; rank 0 logs."""
        cfg_val = self.cfg.nerf.validation
        if self.val_dataset is None:
            self.val_dataset = build_dataset(self.cfg, DatasetType.VALIDATION, self.device)
        val = self.val_dataset
        num = cfg_val.num_samples if max_images is None else max_images
        n_total = len(val)
        cur_step = self.state.step if step is None else int(step)
        if num == -1 or num is None:
            indices = list(range(n_total))
        else:
            seed = 0 if bool(cfg_val.get("fixed_views", False)) else cur_step
            indices = np.random.default_rng(seed).integers(
                0, n_total, size=max(1, min(num, n_total))).tolist()
        self._last_val_indices = indices

        H, W, _ = (int(v) for v in val.hwf)
        # The maps to gather are the same on every rank; rank 0 logs them.
        gather_disp = log_images and self.paths is not None
        log = log_images and self.logger is not None
        losses, fine_losses = [], []
        vbar = progress_bar(len(indices), desc="val", position=1, show=self.group.is_main)
        for i, idx in enumerate(indices):
            origins, directions = val.image_rays(idx)
            near, far = np.asarray(val._bounds_for(idx)).reshape(-1)[:2]
            target = val.image_targets(idx)
            coarse, fine = render_image(
                self._render_chunk, origins, directions, float(near), float(far),
                chunk_size=round_chunk(cfg_val.chunksize, self.group.world),
                fields=("rgb_map", "disp_map") if gather_disp else ("rgb_map",),
                as_numpy=False)
            losses.append(img2mse(coarse.rgb_map, target))
            finest = coarse
            if fine is not None:
                fine_losses.append(img2mse(fine.rgb_map, target))
                finest = fine
            if log:
                kind = "fine" if fine is not None else "coarse"
                self.logger.log_image(f"validation/rgb_{kind}/{i}",
                                      _rgb_u8(finest.rgb_map, H, W), cur_step)
                if fine is not None:
                    self.logger.log_image(f"validation/rgb_coarse/{i}",
                                          _rgb_u8(coarse.rgb_map, H, W), cur_step)
                disp = cast_to_disparity_image(
                    finest.disp_map.reshape(H, W).cpu().numpy(),
                    white_background=bool(self.cfg.dataset.white_background))
                self.logger.log_image(f"validation/disparity/{i}",
                                      disp[..., None].repeat(3, -1), cur_step)
                self.logger.log_image(f"validation/img_target/{i}", _rgb_u8(target, H, W),
                                      cur_step)
            vbar.update(1)
        vbar.close()

        fetched = torch.stack(losses + fine_losses).cpu().tolist()  # the one fetch
        coarse_loss = float(np.mean(fetched[:len(losses)]))
        metrics = {"validation/coarse_loss": coarse_loss,
                   "validation/coarse_psnr": _host_psnr(coarse_loss)}
        loss = coarse_loss
        if fine_losses:
            fine_loss = float(np.mean(fetched[len(losses):]))
            loss = loss + fine_loss
            metrics["validation/fine_loss"] = fine_loss
            metrics["validation/fine_psnr"] = _host_psnr(fine_loss)
        metrics["validation/loss"] = loss
        chamfer = self._chamfer_validation()
        if chamfer is not None:
            metrics["validation/chamfer_loss"] = chamfer
        return metrics

    def _chamfer_validation(self) -> Optional[float]:
        """With experiment.chamfer_loss, the chamfer distance between the
        field's iso-surface at 64^3 and <basedir>/model.obj, both
        normalised and sampled at experiment.chamfer_sampling_size points;
        None without the file or when the surface is empty."""
        cfg = self.cfg
        if not cfg.experiment.chamfer_loss:
            return None
        target_path = Path(cfg.dataset.basedir) / "model.obj"
        if not target_path.exists():
            return None
        from nerfmeshes_tpu_torch.mesh import (
            MeshArgs,
            chamfer_distance,
            extract_geometry,
            import_obj,
            normalize_mesh,
            sample_points_from_mesh,
        )

        n_samples = int(cfg.experiment.chamfer_sampling_size)
        verts_t, faces_t, _, _ = import_obj(str(target_path))
        verts, faces, _, _ = extract_geometry(
            self.sample_points, MeshArgs(res=64, limit=1.2, iso_level=32),
            density_fn=self.density_points, device=self.device)
        if len(faces) == 0:
            return None
        pts_a = sample_points_from_mesh(normalize_mesh(verts_t), faces_t, n_samples)
        pts_b = sample_points_from_mesh(normalize_mesh(verts), faces, n_samples)
        return float(chamfer_distance(pts_a, pts_b))

    # -- fit loop ----------------------------------------------------------------
    def fit(self, max_steps: Optional[int] = None) -> dict:
        """Run the train step to `max_steps` (default: experiment.train_iters)
        in calls of experiment.steps_per_call steps. At the print cadence
        (and at the end) the last step's metrics come to the host, with
        train/rays_per_sec, go to the logger and the console, and a
        non-finite loss stops the run. Every experiment.validate_every
        steps (and at the end) the system validates and, with paths,
        checkpoints. With logging.use_projection, a logger and a dataset
        (not a dict of arrays), every logging.projection_step_size steps
        the depth point cloud of train view 0 goes to the event file
        (_log_depth_projection). Returns the last host metrics,
        validation's included."""
        cfg = self.cfg
        exp = cfg.experiment
        if self._train_fn is None:
            raise RuntimeError("call setup() before fit()")
        max_steps = max_steps or int(exp.train_iters)
        validate_every = int(exp.validate_every)
        print_every = int(exp.print_every)
        steps_per_call = int(exp.steps_per_call)
        rays_per_step = int(cfg.nerf.train.num_random_rays)
        proj_every = max(1, int(cfg.logging.projection_step_size))
        # Every rank renders the projection (a sharded render); rank 0 logs it.
        use_projection = (bool(cfg.logging.use_projection) and self.paths is not None
                          and self.train_dataset is not None)

        last_metrics: dict = {}
        t0 = time.perf_counter()
        rays_done = 0
        step = self.state.step
        # The bar moves at the print cadence, from the host's step count: no
        # fetch of its own.
        pbar = progress_bar(max_steps, desc="train", initial=step, show=self.group.is_main)
        shown = step
        while step < max_steps:
            self.state, metrics = self._train_fn(self.state, self._data)
            step = self.state.step
            rays_done += steps_per_call * rays_per_step
            self.on_step(step, metrics)
            self._check_early_stopping(metrics, step)
            if use_projection and step >= proj_every and step % proj_every < steps_per_call:
                self._log_depth_projection(step)
            if step % print_every < steps_per_call or step >= max_steps:
                host = {k: float(v) for k, v in metrics.items() if k != "train/rgb_sum"}
                host["train/rays_per_sec"] = rays_done / max(time.perf_counter() - t0, 1e-9)
                loss = host.get("train/loss")
                if loss is not None and not math.isfinite(loss):
                    raise RuntimeError(
                        f"Training diverged: train/loss={loss} at step {step} "
                        f"(lr={host.get('train/lr')}). Restart from the last checkpoint with "
                        "a lower lr, fewer rays, or sigma noise enabled.")
                last_metrics = host
                pbar.update(step - shown)
                shown = step
                pbar.set_postfix_str(f"loss={host.get('train/loss', float('nan')):.4g} "
                                     f"rps={host['train/rays_per_sec']:.3g}", refresh=False)
                self._report(host, step)
            if validate_every > 0 and (step % validate_every < steps_per_call
                                       or step >= max_steps):
                val_metrics = self.validate(step=step)
                last_metrics.update(val_metrics)
                self._report(val_metrics, step)
                if self.ckpt is not None:
                    self.save(val_loss=val_metrics["validation/loss"])
        pbar.update(step - shown)
        pbar.close()
        return last_metrics

    def _report(self, metrics: dict, step: int) -> None:
        """Log host metrics (metrics.jsonl and the console line), or print
        them without a logger; on rank 0 only."""
        if not self.group.is_main:
            return
        if self.logger is not None:
            self.logger.log_scalars(metrics, step)
            print(self.logger.console_line(metrics, step), flush=True)
        else:
            print(f"step {step}: " + " ".join(f"{k}={v:.6g}" for k, v in metrics.items()),
                  flush=True)

    def _log_depth_projection(self, step: int, max_rays: int = 2048) -> None:
        """The predicted (and, where the dataset has one, the target) depth
        point cloud of a probe of train view 0 as a "Point Cloud" mesh
        (reference: LoggerDepthProjection, src/nerf/loggers.py:7-31).

        As in the JAX package, the probe is every stride-th ray of the view,
        about `max_rays` of them, rendered at validation settings (which
        draw nothing from the train generator) in one chunk: the train step
        keeps its batch on the device."""
        dataset = self.train_dataset
        origins, directions = dataset.image_rays(0)
        stride = max(1, int(directions.shape[0]) // max_rays)
        o, d = origins[::stride], directions[::stride]
        near, far = np.asarray(dataset._bounds_for(0)).reshape(-1)[:2]
        depth = self.query_rays(
            o, d, near, far, fields=("depth_map",),
            chunk=min(int(self.cfg.nerf.validation.chunksize), d.shape[0])).depth_map
        depth_target = None
        if dataset.bundle.target_depth is not None:
            depth_target = np.asarray(dataset.bundle.target_depth[0]).reshape(-1)[::stride]
        if self.logger is not None:
            self._proj_logger.tick(self.logger._tb, step, o.cpu().numpy(), d.cpu().numpy(),
                                   depth, depth_target)

    def on_step(self, step: int, metrics: dict) -> None:
        """Hook called after every call of the train step with its device
        metrics (subclasses; nothing here waits for the device)."""

    def _check_early_stopping(self, metrics: dict, step: int) -> None:
        """With experiment.use_early_stopping, exit(-1) on colour collapse
        (the finest render's rgb sum under 1e-12) at the call that reaches
        experiment.early_stopping_step: one host read, at that step only."""
        exp = self.cfg.experiment
        if not exp.use_early_stopping:
            return
        if abs(step - int(exp.early_stopping_step)) < int(exp.steps_per_call):
            rgb_sum = float(metrics["train/rgb_sum"])
            if rgb_sum < 1e-12:
                print(f"Model is stuck in local minima, collapsing to {rgb_sum}; exiting.",
                      flush=True)
                sys.exit(-1)

    # -- persistence -----------------------------------------------------------------
    def checkpoint_state(self) -> dict:
        """What a checkpoint holds: the step, both models' parameters, the
        optimizer (Adam, the schedule's position, the accumulator), the
        train generator's state and checkpoint_extra()."""
        return {"step": self.state.step, "coarse": self.coarse.state_dict(),
                "fine": None if self.fine is None else self.fine.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "generator": self.state.generator.get_state(),
                "extra": self.checkpoint_extra()}

    def save(self, val_loss: Optional[float] = None) -> None:
        """Checkpoint the state (rank 0 writes; every rank waits for it)."""
        if self.group.is_main:
            self.ckpt.save(self.checkpoint_state(), self.state.step, val_loss=val_loss)
        self.group.barrier()

    def restore(self, step: Optional[int] = None, last: bool = False) -> "NeRFSystem":
        """Load checkpoint `step` (or `last`, or the latest kept) into the
        models, the optimizer and the train state, in place. The generator
        takes its state back on the device type it was saved from. Every
        rank reads the same files, whatever the world size that wrote
        them, and then takes rank 0's parameters."""
        saved = self.ckpt.restore(step=step, last=last)
        self.coarse.load_state_dict(saved["coarse"])
        if self.fine is not None:
            self.fine.load_state_dict(saved["fine"])
        self.optimizer.load_state_dict(saved["optimizer"])
        self.state.generator.set_state(saved["generator"])
        self.state.step = int(saved["step"])
        self.load_checkpoint_extra(saved["extra"])
        broadcast_params(self.optimizer.params, self.group)
        return self

    def checkpoint_extra(self) -> dict:
        """Subclass state that rides along in a checkpoint."""
        return {}

    def load_checkpoint_extra(self, extra: dict) -> None:
        pass
