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
from nerfmeshes_tpu_torch.ops.kernels.chords import compact_chords
from nerfmeshes_tpu_torch.ops.math import img2mse, mse2psnr
from nerfmeshes_tpu_torch.ops.render import volume_render
from nerfmeshes_tpu_torch.ops.sampling import ray_sample_interval
from nerfmeshes_tpu_torch.train.render import RenderSettings, _apply_field
from nerfmeshes_tpu_torch.train.step import (
    TrainState,
    _sample_ray_batch,
    depth_loss_metrics,
)
from nerfmeshes_tpu_torch.train.system import NeRFSystem


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
    BuFF render does, unlike its hierarchical render). A training render
    that needs random numbers and has no generator raises. `compact`
    overrides the chord compaction (see ray_voxel_intersect)."""
    R = directions.shape[0]
    perturb = settings.perturb and train
    noise_std = settings.radiance_field_noise_std if train else 0.0
    if (perturb or noise_std > 0.0) and generator is None:
        raise ValueError("training render with perturb/noise requires a generator")
    origins = torch.reshape(origins, (-1, 3)).expand(R, 3)
    stratified = ray_sample_interval(
        settings.num_coarse, R, near, far, lindisp=settings.lindisp, perturb=perturb,
        generator=generator, dtype=directions.dtype, device=directions.device)
    z_tree, voxel_idx, ray_mask, dropped = ray_voxel_intersect(
        tree_state.voxels, tree_state.active, origins, directions, near, far,
        samples_count=settings.num_coarse, use_random_sampling=use_random_sampling,
        max_chords=max_chords, compact=compact)
    intervals = torch.where(ray_mask[:, None], z_tree, stratified)
    field = _apply_field(model, origins, directions, intervals,
                         use_fused=settings.use_fused_kernel, inference=not train)
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
                         steps_per_call: Optional[int] = None):
    """fn(state, tree_state, data) -> (state, tree_state, metrics):
    `steps_per_call` steps of sample rays -> tree-sampled render -> MSE ->
    Adam, each followed, from step step_size_integration_offset on, by the
    integration of its weights into the tree. Metrics are the last step's,
    except train/dropped_chords, summed over the call's steps (a cap that
    binds on one step of a call is seen). Nothing waits for the device."""
    settings = RenderSettings.from_cfg(cfg, train=True)
    num_rays = int(cfg.nerf.train.num_random_rays)
    use_ndc = bool(cfg.dataset.use_ndc)
    sample_all = bool(cfg.nerf.train.get("sample_all_images", False))
    max_chords = int(cfg.tree.get("max_chords_per_ray", 0))
    offset = int(cfg.tree.step_size_integration_offset)
    if steps_per_call is None:
        steps_per_call = int(cfg.experiment.steps_per_call)

    def one_step(state: TrainState, tree_state: TreeState, data: dict):
        origins, directions, targets, near, far, depth_tgt = _sample_ray_batch(
            data, state.generator, H=H, W=W, focal=focal, num_rays=num_rays,
            use_ndc=use_ndc, sample_all_images=sample_all)
        loss, metrics, aux = buff_train_loss(
            cfg, state.coarse, tree_state, origins, directions, targets, near, far, depth_tgt,
            generator=state.generator, settings=settings, max_chords=max_chords)
        loss.backward()
        state.optimizer.step()
        metrics["train/lr"] = state.optimizer.lr_at(state.step)
        if state.step >= offset:
            tree_state = integrate(tree_state, aux["voxel_idx"], aux["weights"],
                                   aux["mask_weights"], aux["ray_mask"])
        state.step += 1
        return tree_state, metrics

    def multi_step(state: TrainState, tree_state: TreeState, data: dict):
        dropped = None
        for _ in range(steps_per_call):
            tree_state, metrics = one_step(state, tree_state, data)
            d = metrics["train/dropped_chords"]
            dropped = d if dropped is None else dropped + d
        metrics["train/dropped_chords"] = dropped
        return state, tree_state, metrics

    return multi_step


class BuFFSystem(NeRFSystem):
    """NeRFSystem with tree sampling; build_system picks it for
    cfg.experiment.model == 'BuFFModel'. One model: cfg.models.use_fine is
    forced off on a copy of the config, as the reference's BuFFModel builds
    only the coarse network.

    Not ported yet (ROADMAP.md): checkpoints (so a grown chord cap is not
    written back to hparams, and `serialize` is not yet called), validation,
    TensorBoard tree logging and the random voxel sampler."""

    def __init__(self, cfg, device: Optional[torch.device] = None):
        cfg = cfg.clone()
        cfg.models.use_fine = False
        super().__init__(cfg, device)
        self.tree = TreeSampling(cfg)
        self.tree_state = self.tree.device_state(self.device)
        self.consolidation_steps: list[int] = []  # steps after which the tree was rebuilt
        self._dropped_pending: deque = deque()
        self._warned_capped = False
        self._hwf = None

    # -- setup ----------------------------------------------------------------
    def setup(self, train_data: dict) -> "BuFFSystem":
        """Take the training arrays (data/blender.py:train_arrays) and build
        the train step and the chunk renderer."""
        self._data = train_data
        self._hwf = tuple(train_data["hwf"])
        self._build_train_fn()
        return self.setup_eval()

    def setup_eval(self) -> "BuFFSystem":
        """Build the chunk renderer at validation settings. It reads the
        tree state and the chord cap at call time, so a consolidation or a
        grown cap never leaves it stale."""
        settings = RenderSettings.from_cfg(self.cfg, train=False)

        @torch.inference_mode()
        def render_chunk(origins, directions, near, far):
            bundle, _, _, _ = buff_render_rays(
                self.coarse, self.tree_state, origins, directions, near, far, settings,
                train=False, use_random_sampling=bool(self.cfg.tree.use_random_sampling),
                max_chords=int(self.cfg.tree.get("max_chords_per_ray", 0)))
            return bundle, None

        self._render_chunk = render_chunk
        return self

    def _build_train_fn(self) -> None:
        H, W, focal = self._hwf
        buff_fn = make_buff_train_step(self.cfg, H=int(H), W=int(W), focal=float(focal))

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

    def on_step(self, step: int, metrics: dict) -> None:
        """Read the dropped-chords counters whose copies have landed (on the
        card, the earlier calls'; nothing waits), then consolidate the tree
        when a boundary fell inside this call."""
        while self._dropped_pending:
            host, done, at = self._dropped_pending[0]
            if done is not None and not done.query():
                break
            self._dropped_pending.popleft()
            self._note_dropped(float(host), at)
        spc = int(self.cfg.experiment.steps_per_call)
        boundary = self.tree.integration_offset + self.tree.step_size_tree
        if step >= boundary and (step - self.tree.integration_offset) % self.tree.step_size_tree < spc:
            memm = self.tree_state.memm.cpu().numpy()  # the one read of memm
            self.tree_state = self.tree.consolidate(memm, self.device)
            self.consolidation_steps.append(step)

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
        if self._hwf is not None:
            self._build_train_fn()

    # -- mesh -----------------------------------------------------------------------
    def mesh_mask_aabbs(self) -> np.ndarray:
        """(V, 2, 3) active-leaf boxes, the field's supervised support: mesh
        extraction (mesh/extract.py) keeps only what lies inside them."""
        return np.stack([np.stack([leaf.lo, leaf.hi]) for leaf in self.tree.leaves])
