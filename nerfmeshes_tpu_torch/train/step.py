"""The training step and the full-image render path (counterpart of
nerfmeshes_tpu/train/step.py).

One device, no mesh: multi-GPU training and rendering are queued in
ROADMAP.md. Where the JAX step is one jitted program (lax.scan over
`steps_per_call` steps), here a Python loop runs the steps eagerly; the
loop never waits for the device (metrics stay device tensors), so the
host enqueues ahead of the card. Random numbers come from one
torch.Generator on the data's device, carried in the TrainState.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from nerfmeshes_tpu_torch.device import resolve_device
from nerfmeshes_tpu_torch.ops.math import img2mse, mse2psnr
from nerfmeshes_tpu_torch.ops.rays import CameraIntrinsics, ndc_rays, pixel_directions
from nerfmeshes_tpu_torch.ops.render import RenderOutput
from nerfmeshes_tpu_torch.train.optim import Optimizer
from nerfmeshes_tpu_torch.train.render import RenderSettings, render_rays


@dataclass
class TrainState:
    """What one train step advances: the models (their parameters), the
    optimizer, the micro-step count and the random stream. The models and
    the optimizer are updated in place."""

    coarse: torch.nn.Module
    fine: Optional[torch.nn.Module]
    optimizer: Optimizer
    step: int
    generator: torch.Generator


def init_train_state(coarse, fine, optimizer: Optimizer, seed: int,
                     device=None) -> TrainState:
    """Step 0, with a generator on `device` (the data's; None means the
    CUDA card) seeded `seed`."""
    generator = torch.Generator(resolve_device(device))
    return TrainState(coarse, fine, optimizer, 0, generator.manual_seed(int(seed)))


def draw_ray_indices(generator: torch.Generator, num_images: int, H: int, W: int,
                     num_rays: int, *, sample_all_images: bool = False, device=None):
    """The random half of `_sample_ray_batch`: (img, pix). One image
    (a 0-dim img) and `num_rays` of its pixels, or with
    `sample_all_images` an (image, pixel) pair per ray from the global
    pool (nerfmeshes_tpu/train/step.py:67-90)."""
    shape = (num_rays,) if sample_all_images else ()
    img = torch.randint(0, num_images, shape, generator=generator, device=device)
    pix = torch.randint(0, H * W, (num_rays,), generator=generator, device=device)
    return img, pix


def rays_from_indices(data: dict, img: torch.Tensor, pix: torch.Tensor, *, H: int, W: int,
                      focal: float, use_ndc: bool):
    """The deterministic half of `_sample_ray_batch`: world rays, targets
    and bounds of the pixels `pix` of images `img` (0-dim: one image; (R,):
    one per ray). Returns (origins (R, 3), directions (R, 3), targets
    (R, 3), near, far, depth or None); near/far are 0-dim, or (R,) for
    per-image bounds (N, 2) in the global pool."""
    # Flat gathers and index_select only: a 0-dim device tensor used as an
    # index would be read back to the host, a sync in every step.
    num_images = data["poses"].shape[0]
    one_image = img.dim() == 0
    flat = img * (H * W) + pix
    targets = data["targets"].reshape(num_images * H * W, -1)[flat]
    depth = None
    if "target_depth" in data:
        depth = data["target_depth"].reshape(num_images * H * W)[flat]
    pose = data["poses"].index_select(0, img.reshape(-1)).float()
    if one_image:
        pose = pose[0]

    x = (pix % W).float()
    y = torch.div(pix, W, rounding_mode="floor").float()
    dirs_cam = pixel_directions(x, y, CameraIntrinsics.from_hwf(H, W, focal))
    if pose.dim() == 3:  # one pose per ray
        directions = torch.einsum("rij,rj->ri", pose[:, :3, :3], dirs_cam)
        origins = pose[:, :3, 3]
    else:
        directions = torch.einsum("ij,rj->ri", pose[:3, :3], dirs_cam)
        origins = pose[:3, 3].expand(directions.shape)

    bounds = data["bounds"]
    if bounds.dim() == 2:  # per image: (1, 2) or (R, 2) rows
        bounds = bounds.index_select(0, img.reshape(-1))
        bounds = bounds[0] if one_image else bounds.t()
    near, far = bounds[0], bounds[1]
    if use_ndc:
        origins, directions = ndc_rays(H, W, focal, 1.0, origins, directions)
    return origins, directions, targets, near, far, depth


def _sample_ray_batch(data: dict, generator: torch.Generator, *, H: int, W: int,
                      focal: float, num_rays: int, use_ndc: bool,
                      sample_all_images: bool = False):
    """One training batch drawn on the data's device
    (nerfmeshes_tpu/train/step.py:44-111)."""
    img, pix = draw_ray_indices(generator, data["poses"].shape[0], H, W, num_rays,
                                sample_all_images=sample_all_images,
                                device=data["targets"].device)
    return rays_from_indices(data, img, pix, H=H, W=W, focal=focal, use_ndc=use_ndc)


def depth_loss_metrics(scope: str, rgb_out, rgb_tgt, depth_out, depth_tgt,
                       empty: float = 0.0) -> dict:
    """Masked surface/void depth and rgb losses of one batch, as device
    scalars (nerfmeshes_tpu/train/step.py:114-136)."""
    mask = depth_tgt > empty
    n_s = torch.clamp(mask.sum(), min=1)
    n_v = torch.clamp((~mask).sum(), min=1)
    d2 = (depth_out - depth_tgt) ** 2
    rgb2 = (rgb_out - rgb_tgt) ** 2
    zero = torch.zeros_like(d2)
    return {
        f"{scope}/depth_loss": d2.mean(),
        f"{scope}/depth_empty": torch.where(mask, zero, d2).sum() / n_v,
        f"{scope}/depth_space": torch.where(mask, d2, zero).sum() / n_s,
        f"{scope}/depth_l1": torch.where(mask, depth_out - depth_tgt, zero).sum() / n_s,
        f"{scope}/rgb_surface_loss": torch.where(mask[:, None], rgb2, torch.zeros_like(rgb2)
                                                 ).sum() / (n_s * rgb2.shape[-1]),
        f"{scope}/rgb_void_loss": torch.where(mask[:, None], torch.zeros_like(rgb2), rgb2
                                              ).sum() / (n_v * rgb2.shape[-1]),
    }


def train_loss(cfg, coarse_model, fine_model, origins, directions, targets, near, far,
               depth_tgt=None, *, generator: Optional[torch.Generator] = None,
               settings: Optional[RenderSettings] = None):
    """(loss, metrics) of one batch: the MSE of the coarse and the fine
    render against the targets (nerfmeshes_tpu/train/step.py:181-215).
    The metrics are detached device scalars."""
    if settings is None:
        settings = RenderSettings.from_cfg(cfg, train=True)
    coarse_bundle, fine_bundle = render_rays(
        coarse_model, fine_model, origins, directions, near, far, settings,
        train=True, generator=generator,
    )
    coarse_loss = img2mse(coarse_bundle.rgb_map, targets)
    loss = coarse_loss
    finest = fine_bundle if fine_bundle is not None else coarse_bundle
    metrics = {
        "train/coarse_loss": coarse_loss,
        "train/coarse_psnr": mse2psnr(coarse_loss),
        "train/rgb_sum": finest.rgb_map.sum(),
    }
    if fine_bundle is not None:
        fine_loss = img2mse(fine_bundle.rgb_map, targets)
        loss = loss + fine_loss
        metrics["train/fine_loss"] = fine_loss
        metrics["train/fine_psnr"] = mse2psnr(fine_loss)
    if depth_tgt is not None:
        metrics.update(depth_loss_metrics("train", finest.rgb_map, targets,
                                          finest.depth_map, depth_tgt))
    metrics["train/loss"] = loss
    return loss, {k: v.detach() for k, v in metrics.items()}


def make_train_step(cfg, *, H: int, W: int, focal: float,
                    steps_per_call: Optional[int] = None) -> Callable:
    """fn(state, data) -> (state, metrics): `steps_per_call` optimizer
    steps (micro-steps under gradient accumulation), metrics of the last.
    Nothing in the loop waits for the device."""
    settings = RenderSettings.from_cfg(cfg, train=True)
    num_rays = int(cfg.nerf.train.num_random_rays)
    use_ndc = bool(cfg.dataset.use_ndc)
    sample_all = bool(cfg.nerf.train.get("sample_all_images", False))
    if steps_per_call is None:
        steps_per_call = int(cfg.experiment.steps_per_call)

    def one_step(state: TrainState, data: dict) -> dict:
        origins, directions, targets, near, far, depth_tgt = _sample_ray_batch(
            data, state.generator, H=H, W=W, focal=focal, num_rays=num_rays,
            use_ndc=use_ndc, sample_all_images=sample_all,
        )
        loss, metrics = train_loss(cfg, state.coarse, state.fine, origins, directions,
                                   targets, near, far, depth_tgt,
                                   generator=state.generator, settings=settings)
        loss.backward()
        state.optimizer.step()
        metrics["train/lr"] = state.optimizer.lr_at(state.step)
        state.step += 1
        return metrics

    def multi_step(state: TrainState, data: dict):
        for _ in range(steps_per_call):
            metrics = one_step(state, data)
        return state, metrics

    return multi_step


def round_chunk(chunk: int, devices: int = 1) -> int:
    """Smallest chunk >= `chunk` divisible by the device count."""
    return max(devices, -(-int(chunk) // devices) * devices)


def make_render_chunk(cfg, coarse_model, fine_model, *, train: bool = False) -> Callable:
    """Ray-slab renderer for validation / eval: (origins, directions, near,
    far) -> (coarse, fine) RenderOutputs, run without autograd. The
    settings come from cfg.nerf.train or cfg.nerf.validation; the render is
    always an eval render (deterministic at validation settings)."""
    settings = RenderSettings.from_cfg(cfg, train=train)

    @torch.inference_mode()
    def render_chunk(origins, directions, near, far):
        return render_rays(
            coarse_model, fine_model, origins, directions, near, far, settings,
            train=False,
        )

    return render_chunk


def make_pose_rays(H: int, W: int, focal: float, *, use_ndc: bool = False,
                   intrinsics: Optional[CameraIntrinsics] = None,
                   device: Optional[torch.device] = None) -> Callable:
    """Full-image ray generation from a 4x4 camera pose, on `device`:
    pose -> (origins (H*W, 3), directions (H*W, 3)), pixels row-major."""
    if intrinsics is None:
        intrinsics = CameraIntrinsics.from_hwf(H, W, focal)

    def pose_rays(pose):
        pix = torch.arange(H * W, device=device)
        x = (pix % W).float()
        y = torch.div(pix, W, rounding_mode="floor").float()
        dirs_cam = pixel_directions(x, y, intrinsics)
        pose = torch.as_tensor(pose, dtype=torch.float32, device=device)
        directions = torch.einsum("ij,rj->ri", pose[:3, :3], dirs_cam)
        origins = pose[:3, 3].expand(directions.shape)
        if use_ndc:
            origins, directions = ndc_rays(H, W, focal, 1.0, origins, directions)
        return origins, directions

    return pose_rays


def render_image(
    render_chunk: Callable,
    origins,
    directions,
    near,
    far,
    *,
    chunk_size: int,
    fields: Optional[tuple] = None,
    as_numpy: bool = True,
):
    """Render any number of rays through the fixed-size chunk renderer.

    origins: (R, 3) or (3,), directions: (R, 3), tensors or numpy arrays
    (numpy goes to the CPU). The tail chunk is padded to `chunk_size` by
    repeating the last ray, so every chunk has one shape. Returns (coarse,
    fine) RenderOutputs of the concatenated maps; `fields` limits which
    maps are kept (the others are None), `as_numpy=False` keeps tensors on
    the device."""
    directions = torch.as_tensor(directions, dtype=torch.float32)
    origins = torch.as_tensor(origins, dtype=torch.float32, device=directions.device)
    R = directions.shape[0]
    origins = torch.reshape(origins, (-1, 3)).expand(R, 3)
    names = [n for n in RenderOutput._fields if fields is None or n in fields]

    def keep(bundle):
        """The chunk's wanted maps only: the per-sample weights of every
        chunk of a million-ray query would not fit the card."""
        if bundle is None:
            return None
        return {name: getattr(bundle, name) for name in names}

    pending = []
    for start in range(0, R, chunk_size):
        o = origins[start:start + chunk_size]
        d = directions[start:start + chunk_size]
        pad = chunk_size - o.shape[0]
        if pad:
            o = torch.cat([o, o[-1:].expand(pad, 3)], dim=0)
            d = torch.cat([d, d[-1:].expand(pad, 3)], dim=0)
        coarse, fine = render_chunk(o.contiguous(), d.contiguous(), near, far)
        pending.append((keep(coarse), keep(fine)))

    def gather(bundles):
        if not bundles or bundles[0] is None:
            return None
        out = dict.fromkeys(RenderOutput._fields)
        for name in names:
            arr = torch.cat([b[name] for b in bundles], dim=0)[:R]
            out[name] = arr.cpu().numpy() if as_numpy else arr
        return RenderOutput(**out)

    return gather([c for c, _ in pending]), gather([f for _, f in pending])
