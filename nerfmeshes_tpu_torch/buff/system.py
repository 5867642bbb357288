"""BuFFSystem: training, rendering and meshing of a single radiance field
whose depth samples come from the adaptive voxel tree (counterpart of
nerfmeshes_tpu/buff/system.py).

Rays that cross active voxels are sampled along their chords
(buff/tree.py:ray_voxel_intersect, through the chord-compaction kernel);
the others fall back to stratified samples. Each train step folds its
rendered weights into the tree past the integration offset, and at the
consolidation boundaries the host prunes and subdivides the tree. Nothing
between a ray batch and the integration waits for the device: the
dropped-chords counter reaches the host by a non-blocking copy that is
read a call later, and consolidation is the one place that reads memm.
"""

from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np
import torch

from nerfmeshes_tpu_torch.buff.tree import (
    AUTO_CHORD_CAP,
    TreeSampling,
    TreeState,
    integrate,
    ray_voxel_intersect,
)
from nerfmeshes_tpu_torch.config.paths import save_hparams
from nerfmeshes_tpu_torch.ops.kernels.chords import compact_chords
from nerfmeshes_tpu_torch.ops.math import img2mse, mse2psnr
from nerfmeshes_tpu_torch.ops.rays import CameraIntrinsics
from nerfmeshes_tpu_torch.ops.render import volume_render
from nerfmeshes_tpu_torch.ops.sampling import ray_sample_interval
from nerfmeshes_tpu_torch.parallel.mesh import DataGroup
from nerfmeshes_tpu_torch.train.render import RenderSettings, _apply_field, draws_in_training
from nerfmeshes_tpu_torch.train.step import (
    TrainState,
    all_mean_grads,
    all_mean_metrics,
    batch_source,
    depth_loss_metrics,
    shard_render_chunk,
)
from nerfmeshes_tpu_torch.train.system import NeRFSystem
from nerfmeshes_tpu_torch.utils.loggers import TreeLogger, TreeWeightsLogger


def buff_render_rays(model, tree_state: TreeState, origins: torch.Tensor,
                     directions: torch.Tensor, near, far, settings: RenderSettings, *,
                     train: bool, use_random_sampling: bool = False,
                     generator: Optional[torch.Generator] = None, max_chords: int = 0,
                     compact=compact_chords):
    """Tree-sampled render of a ray batch (nerfmeshes_tpu/buff/system.py:
    43-106). Returns (bundle, voxel_idx, ray_mask, dropped).

    Samples come from the tree where the ray crosses an active voxel and
    are stratified elsewhere, picked per ray on the device. The fallback
    is jittered only in training (`settings.perturb and train`, as JAX's
    BuFF render does, unlike its hierarchical render). A render that draws
    random numbers (the jitter, sigma noise, a DropModel's dropout in
    training, or the random voxel sampler, in eval too) without a
    generator draws from one seeded 0 on the rays' device, as JAX's falls
    back to `jax.random.key(0)`. `compact` overrides the chord compaction
    (see ray_voxel_intersect)."""
    R = directions.shape[0]
    perturb = settings.perturb and train
    noise_std = settings.radiance_field_noise_std if train else 0.0
    draws = (perturb or noise_std > 0.0 or use_random_sampling
             or (train and draws_in_training(model)))
    if draws and generator is None:
        generator = torch.Generator(directions.device).manual_seed(0)
    origins = torch.reshape(origins, (-1, 3)).expand(R, 3)
    stratified = ray_sample_interval(
        settings.num_coarse, R, near, far, lindisp=settings.lindisp, perturb=perturb,
        generator=generator, dtype=directions.dtype, device=directions.device)
    z_tree, voxel_idx, ray_mask, dropped = ray_voxel_intersect(
        tree_state.voxels, tree_state.active, origins, directions, near, far,
        samples_count=settings.num_coarse, use_random_sampling=use_random_sampling,
        max_chords=max_chords, compact=compact, generator=generator)
    intervals = torch.where(ray_mask[:, None], z_tree, stratified)
    field = _apply_field(model, origins, directions, intervals,
                         use_fused=settings.use_fused_kernel, inference=not train,
                         generator=generator)
    bundle = volume_render(
        field, intervals, directions, train=train, radiance_field_noise_std=noise_std,
        white_background=settings.white_background,
        attenuation_threshold=settings.attenuation_threshold, generator=generator,
        channels_first=True)
    return bundle, voxel_idx, ray_mask, dropped


def buff_train_loss(cfg, model, tree_state: TreeState, origins, directions, targets, near,
                    far, depth_tgt=None, *, generator: Optional[torch.Generator] = None,
                    settings: Optional[RenderSettings] = None, max_chords: int = 0):
    """(loss, metrics, aux) of one batch: the MSE of the tree-sampled render
    (nerfmeshes_tpu/buff/system.py:160-202). Metrics are detached device
    scalars; aux holds what integration reads (weights, mask_weights,
    voxel_idx, ray_mask), detached."""
    if settings is None:
        settings = RenderSettings.from_cfg(cfg, train=True)
    bundle, voxel_idx, ray_mask, dropped = buff_render_rays(
        model, tree_state, origins, directions, near, far, settings, train=True,
        use_random_sampling=bool(cfg.tree.use_random_sampling), generator=generator,
        max_chords=max_chords)
    loss = img2mse(bundle.rgb_map, targets)
    metrics = {
        "train/loss": loss,
        "train/psnr": mse2psnr(loss),
        "train/rgb_sum": bundle.rgb_map.sum(),
        # Chords past the per-ray cap this step; non-zero means the sampler
        # loses geometry, and BuFFSystem doubles the cap.
        "train/dropped_chords": dropped.sum().float(),
    }
    if depth_tgt is not None:
        metrics.update(depth_loss_metrics("train", bundle.rgb_map, targets, bundle.depth_map,
                                          depth_tgt))
    aux = {"weights": bundle.weights.detach(), "mask_weights": bundle.mask_weights.detach(),
           "voxel_idx": voxel_idx, "ray_mask": ray_mask}
    return loss, {k: v.detach() for k, v in metrics.items()}, aux


def make_buff_train_step(cfg, *, H: int, W: int, focal: float,
                         steps_per_call: Optional[int] = None,
                         intrinsics: Optional[CameraIntrinsics] = None,
                         group: Optional[DataGroup] = None):
    """fn(state, tree_state, data, rays=None) -> (state, tree_state,
    metrics): `steps_per_call` steps of sample rays (under `intrinsics`;
    None: CameraIntrinsics.from_hwf) -> tree-sampled render -> MSE ->
    Adam, each followed, from step step_size_integration_offset on, by the
    integration of its weights into the tree. Metrics are the last step's,
    except train/dropped_chords, summed over the call's steps (a cap that
    binds on one step of a call is seen). Nothing waits for the device.

    With a sharded `group`, the hierarchical step's split
    (train/step.py:batch_source, make_train_step): the rank's own pixels
    and render draws, grads averaged before each optimizer micro-step,
    the voxel accumulators summed over the group inside `integrate`, and
    the metrics averaged once per call (train/dropped_chords: the mean over
    ranks of each rank's batch sum, nerfmeshes_tpu/buff/system.py:181-185).
    `rays` replaces the drawn batch, as in make_train_step."""
    settings = RenderSettings.from_cfg(cfg, train=True)
    max_chords = int(cfg.tree.get("max_chords_per_ray", 0))
    offset = int(cfg.tree.step_size_integration_offset)
    if steps_per_call is None:
        steps_per_call = int(cfg.experiment.steps_per_call)
    source = batch_source(cfg, H=H, W=W, focal=focal, intrinsics=intrinsics, group=group)
    sharded = group is not None and group.sharded

    def one_step(state: TrainState, tree_state: TreeState, data: dict, rays):
        (origins, directions, targets, near, far, depth_tgt), generator = source(
            state, data, rays)
        loss, metrics, aux = buff_train_loss(
            cfg, state.coarse, tree_state, origins, directions, targets, near, far, depth_tgt,
            generator=generator, settings=settings, max_chords=max_chords)
        loss.backward()
        if sharded:
            all_mean_grads(state.optimizer.params, group)
        state.optimizer.step()
        metrics["train/lr"] = state.optimizer.lr_at(state.step)
        if state.step >= offset:
            tree_state = integrate(tree_state, aux["voxel_idx"], aux["weights"],
                                   aux["mask_weights"], aux["ray_mask"],
                                   group=group if sharded else None)
        state.step += 1
        return tree_state, metrics

    def multi_step(state: TrainState, tree_state: TreeState, data: dict, rays=None):
        dropped = None
        for _ in range(steps_per_call):
            tree_state, metrics = one_step(state, tree_state, data, rays)
            d = metrics["train/dropped_chords"]
            dropped = d if dropped is None else dropped + d
        metrics["train/dropped_chords"] = dropped
        if sharded:
            metrics = all_mean_metrics(metrics, group)
        return state, tree_state, metrics

    return multi_step


class BuFFSystem(NeRFSystem):
    """NeRFSystem with tree sampling; build_system picks it for
    cfg.experiment.model == 'BuFFModel'. One model: cfg.models.use_fine is
    forced off on a copy of the config, as the reference's BuFFModel builds
    only the coarse network. Validation renders through the tree; a
    checkpoint carries the tree (TreeSampling.serialize) and the steps it
    was consolidated after, and a grown chord cap is written back to the
    run's hparams.yaml."""

    def __init__(self, cfg, paths=None, device: Optional[torch.device] = None,
                 group: Optional[DataGroup] = None):
        cfg = cfg.clone()
        cfg.models.use_fine = False
        super().__init__(cfg, paths, device, group)
        self.tree = TreeSampling(cfg)
        self.tree_state = self.tree.device_state(self.device)
        self.consolidation_steps: list[int] = []  # steps after which the tree was rebuilt
        self._dropped_pending: deque = deque()
        self._warned_capped = False

    # -- setup ----------------------------------------------------------------
    def setup_eval(self, val_dataset=None) -> "BuFFSystem":
        """Build the chunk renderer at validation settings. It reads the
        tree state and the chord cap at call time, so a consolidation or a
        grown cap never leaves it stale."""
        if val_dataset is not None:
            self.val_dataset = val_dataset
        settings = RenderSettings.from_cfg(self.cfg, train=False)

        @torch.inference_mode()
        def render_chunk(origins, directions, near, far, fields=None):
            bundle, _, _, _ = buff_render_rays(
                self.coarse, self.tree_state, origins, directions, near, far, settings,
                train=False, use_random_sampling=bool(self.cfg.tree.use_random_sampling),
                max_chords=int(self.cfg.tree.get("max_chords_per_ray", 0)))
            return bundle, None

        self._render_chunk = shard_render_chunk(render_chunk, self.group)
        return self

    def _build_train_fn(self) -> None:
        H, W, focal = self._hwf
        buff_fn = make_buff_train_step(self.cfg, H=int(H), W=int(W), focal=float(focal),
                                       intrinsics=self._intrinsics, group=self.group)

        def train_fn(state, data):
            state, self.tree_state, metrics = buff_fn(state, self.tree_state, data)
            self._send_dropped(metrics["train/dropped_chords"], state.step)
            return state, metrics

        self._train_fn = train_fn

    # -- the dropped-chords counter, pipelined to the host --------------------------
    def _send_dropped(self, dropped: torch.Tensor, step: int) -> None:
        """Start the counter's copy to the host without waiting for it (the
        JAX system's copy_to_host_async). On the card: into pinned memory,
        behind an event that on_step polls."""
        if dropped.is_cuda:
            host = torch.empty((), dtype=dropped.dtype, pin_memory=True)
            host.copy_(dropped, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        else:
            host, done = dropped, None
        self._dropped_pending.append((host, done, step))

    def _read_dropped(self, wait: bool = False) -> None:
        """Note the dropped-chords counters whose copies have landed, in
        order; with `wait`, every pending one. Under a sharded group every
        rank must grow the cap at the same step, so each counter (the same
        on every rank after the all-reduce) is read one call after it was
        sent, waiting for it, whatever else has landed."""
        in_step = self.group.sharded and not wait
        while len(self._dropped_pending) > (1 if in_step else 0):
            host, done, at = self._dropped_pending[0]
            if done is not None and not (wait or in_step) and not done.query():
                break
            if done is not None:
                done.synchronize()
            self._dropped_pending.popleft()
            self._note_dropped(float(host), at)

    def on_step(self, step: int, metrics: dict) -> None:
        """Read the dropped-chords counters whose copies have landed (on the
        card, the earlier calls'; nothing waits), then consolidate the tree
        when a boundary fell inside this call, logging it before and after
        (_log_tree). Under a sharded group every rank consolidates from the
        same memm (integrate sums the accumulators over the group), so the
        trees stay equal without a broadcast."""
        self._read_dropped()
        spc = int(self.cfg.experiment.steps_per_call)
        boundary = self.tree.integration_offset + self.tree.step_size_tree
        if step >= boundary and (step - self.tree.integration_offset) % self.tree.step_size_tree < spc:
            self._log_tree(step)
            memm = self.tree_state.memm.cpu().numpy()  # the one read of memm
            self.tree_state = self.tree.consolidate(memm, self.device)
            self.consolidation_steps.append(step)
            self._log_tree(step + 1)

    def _log_tree(self, step: int) -> None:
        """The active voxels as a "Tree" mesh and their sorted memm as the
        "Tree Memm" image, to the event file (the reference logs these every
        train step, src/models/model_buff.py:100-107; here, as in the JAX
        package, around each consolidation, where the host reads the tree
        anyway)."""
        if self.logger is None:
            return
        active = self.tree_state.active.cpu().numpy()
        TreeLogger().tick(self.logger._tb, step, self.tree_state.voxels.cpu().numpy(), active)
        TreeWeightsLogger().tick(self.logger._tb, step, self.tree_state.memm.cpu().numpy(),
                                 active)

    # -- chord cap --------------------------------------------------------------------
    def _effective_max_chords(self) -> int:
        configured = int(self.cfg.tree.get("max_chords_per_ray", 0))
        return configured if configured > 0 else AUTO_CHORD_CAP

    def _chord_cap_ceiling(self) -> int:
        """The doubling stops at the tree's capacity (K is clamped to V, so
        no chord is dropped there) or at tree.max_chord_cap."""
        return min(self.tree.capacity, int(self.cfg.tree.get("max_chord_cap", 256)))

    def _note_dropped(self, dropped: float, step: int) -> None:
        """Warn and double the cap on a non-zero counter."""
        if dropped <= 0:
            return
        if self._effective_max_chords() >= self._chord_cap_ceiling():
            if not self._warned_capped:
                self._warned_capped = True
                print(f"WARNING: BuFF dropped {dropped:.0f} chords at step {step} with the cap "
                      f"at its ceiling ({self._chord_cap_ceiling()}); not growing further - "
                      "raise tree.max_chord_cap to keep every chord.", flush=True)
            return
        print(f"WARNING: BuFF chord cap binding at step {step}: {dropped:.0f} ray/voxel "
              f"chords dropped (max_chords_per_ray={self._effective_max_chords()}); "
              "doubling the cap now.", flush=True)
        self._grow_chord_cap()

    def _grow_chord_cap(self) -> None:
        """Double tree.max_chords_per_ray, up to the ceiling, and rebuild the
        train step. Counters taken under the old cap are dropped, so they
        cannot double it again."""
        self._dropped_pending.clear()
        cur = self._effective_max_chords()
        ceiling = self._chord_cap_ceiling()
        if cur >= ceiling:
            print(f"BuFF: chord cap {cur} at its ceiling ({ceiling}); further drops will not "
                  "grow it.", flush=True)
            return
        new = min(2 * cur, ceiling)
        print(f"BuFF: raising tree.max_chords_per_ray {cur} -> {new} (dropped chords "
              "observed).", flush=True)
        self.cfg.tree.max_chords_per_ray = new
        if self.paths is not None and self.group.is_main:
            # A later resume, eval or mesh reads the cap from hparams.yaml.
            save_hparams(self.cfg, self.paths)
        if self._hwf is not None:
            self._build_train_fn()

    # -- persistence ------------------------------------------------------------------
    def save(self, val_loss: Optional[float] = None) -> None:
        """Checkpoint after reading every pending dropped-chords counter, so
        a cap the run has outgrown grows (and reaches hparams.yaml) before
        the checkpoint, in a resumed run as in an uninterrupted one."""
        self._read_dropped(wait=True)
        super().save(val_loss)

    def checkpoint_extra(self) -> dict:
        tree = {k: torch.as_tensor(v) for k, v in self.tree.serialize(self.tree_state).items()}
        return {"tree": tree, "consolidation_steps": list(self.consolidation_steps)}

    def load_checkpoint_extra(self, extra: dict) -> None:
        tree = {k: v.numpy() for k, v in extra["tree"].items()}
        self.tree_state = self.tree.deserialize(tree, self.device)
        self.consolidation_steps = list(extra["consolidation_steps"])

    # -- mesh -----------------------------------------------------------------------
    def mesh_mask_aabbs(self) -> np.ndarray:
        """(V, 2, 3) active-leaf boxes, the field's supervised support: mesh
        extraction (mesh/extract.py) keeps only what lies inside them."""
        return np.stack([np.stack([leaf.lo, leaf.hi]) for leaf in self.tree.leaves])
