"""The training step and the full-image render path (counterpart of
nerfmeshes_tpu/train/step.py).

Where the JAX step is one jitted program (lax.scan over
`steps_per_call` steps), here a Python loop runs the steps eagerly; the
loop never waits for the device (metrics stay device tensors), so the
host enqueues ahead of the card. Random numbers come from one
torch.Generator on the data's device, carried in the TrainState.

With a sharded DataGroup (parallel/mesh.py) each rank draws and renders
its `num_random_rays / world` rays of the step's image, averages the
grads over the group in one flat all-reduce per micro-step, and the
metrics once per call; the render chunk splits every chunk's rays over
the ranks and gathers the maps back in ray order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from nerfmeshes_tpu_torch.device import resolve_device
from nerfmeshes_tpu_torch.ops.math import img2mse, mse2psnr
from nerfmeshes_tpu_torch.ops.rays import CameraIntrinsics, ndc_rays, pixel_directions
from nerfmeshes_tpu_torch.ops.render import RenderOutput
from nerfmeshes_tpu_torch.parallel.mesh import (
    DataGroup,
    RankStream,
    all_mean_,
    gather_rows,
    round_chunk,  # noqa: F401  (its old home; parallel/mesh.py holds it now)
)
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
                     num_rays: int, *, sample_all_images: bool = False, device=None,
                     pixel_generator: Optional[torch.Generator] = None):
    """The random half of `_sample_ray_batch`: (img, pix). One image
    (a 0-dim img) and `num_rays` of its pixels, or with
    `sample_all_images` an (image, pixel) pair per ray from the global
    pool (nerfmeshes_tpu/train/step.py:67-90). The pixels come from
    `pixel_generator` when given (a sharded step: the image choice is the
    same on every rank, the pixels are the rank's own)."""
    shape = (num_rays,) if sample_all_images else ()
    img = torch.randint(0, num_images, shape, generator=generator, device=device)
    pix = torch.randint(0, H * W, (num_rays,), generator=pixel_generator or generator,
                        device=device)
    return img, pix


def rays_from_indices(data: dict, img: torch.Tensor, pix: torch.Tensor, *, H: int, W: int,
                      focal: float, use_ndc: bool,
                      intrinsics: Optional[CameraIntrinsics] = None):
    """The deterministic half of `_sample_ray_batch`: world rays, targets
    and bounds of the pixels `pix` of images `img` (0-dim: one image; (R,):
    one per ray), the pixel directions under `intrinsics` (None:
    CameraIntrinsics.from_hwf). Returns (origins (R, 3), directions (R, 3),
    targets (R, 3), near, far, depth or None); near/far are 0-dim, or (R,)
    for per-image bounds (N, 2) in the global pool."""
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
    if intrinsics is None:
        intrinsics = CameraIntrinsics.from_hwf(H, W, focal)
    dirs_cam = pixel_directions(x, y, intrinsics)
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
                      intrinsics: Optional[CameraIntrinsics] = None,
                      sample_all_images: bool = False,
                      pixel_generator: Optional[torch.Generator] = None):
    """One training batch drawn on the data's device
    (nerfmeshes_tpu/train/step.py:44-111)."""
    img, pix = draw_ray_indices(generator, data["poses"].shape[0], H, W, num_rays,
                                sample_all_images=sample_all_images,
                                device=data["targets"].device,
                                pixel_generator=pixel_generator)
    return rays_from_indices(data, img, pix, H=H, W=W, focal=focal, use_ndc=use_ndc,
                             intrinsics=intrinsics)


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


def local_ray_count(num_rays: int, group: Optional[DataGroup]) -> int:
    """The rays each rank of `group` draws per step; JAX's error when the
    batch does not split evenly."""
    world = group.world if group is not None else 1
    if num_rays % world != 0:
        raise ValueError(
            f"num_random_rays {num_rays} must be divisible by the mesh size {world}")
    return num_rays // world


def all_mean_grads(params, group: DataGroup) -> None:
    """The micro-step's grads averaged over the group (JAX's pmean before
    the optimizer), as one flat bucket: one concatenation, one all_reduce,
    and each .grad set to its view of the bucket. A parameter without a
    grad takes a zero grad, as the optimizer would give it."""
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    flat = all_mean_(torch.cat([g.reshape(-1) for g in grads]), group)
    for p, g in zip(params, flat.split([p.numel() for p in params])):
        p.grad = g.view_as(p)


def all_mean_metrics(metrics: dict, group: DataGroup) -> dict:
    """Device-scalar metrics averaged over the group in one all_reduce
    (host floats, such as train/lr, are the same on every rank)."""
    keys = sorted(k for k, v in metrics.items() if isinstance(v, torch.Tensor))
    if not keys:
        return metrics
    values = all_mean_(torch.stack([metrics[k].float() for k in keys]), group)
    return {**metrics, **dict(zip(keys, values.unbind()))}


def batch_source(cfg, *, H: int, W: int, focal: float,
                 intrinsics: Optional[CameraIntrinsics] = None,
                 group: Optional[DataGroup] = None) -> Callable:
    """fn(state, data, rays) -> (rays, generator): a train step's batch,
    drawn from `data` under `intrinsics` unless `rays` (origins,
    directions, targets, near, far, depth or None) are given, and the
    generator its render draws from. Unsharded both come from the state's
    generator. With a sharded `group` (nerfmeshes_tpu/train/step.py:
    225-245) the image is drawn from the state's generator, the same on
    every rank, and the rank's num_random_rays / world pixels and its
    render draws from its RankStream."""
    num_rays = int(cfg.nerf.train.num_random_rays)
    use_ndc = bool(cfg.dataset.use_ndc)
    sample_all = bool(cfg.nerf.train.get("sample_all_images", False))
    local_rays = local_ray_count(num_rays, group)
    streams = (RankStream(int(cfg.experiment.randomseed), group.rank, group.device)
               if group is not None and group.sharded else None)

    def source(state: TrainState, data: dict, rays):
        own = None if streams is None else streams.at(state.step)
        if rays is None:
            rays = _sample_ray_batch(
                data, state.generator, H=H, W=W, focal=focal, num_rays=local_rays,
                use_ndc=use_ndc, intrinsics=intrinsics, sample_all_images=sample_all,
                pixel_generator=own)
        return rays, state.generator if own is None else own

    return source


def make_train_step(cfg, *, H: int, W: int, focal: float,
                    steps_per_call: Optional[int] = None,
                    intrinsics: Optional[CameraIntrinsics] = None,
                    group: Optional[DataGroup] = None) -> Callable:
    """fn(state, data, rays=None) -> (state, metrics): `steps_per_call`
    optimizer steps (micro-steps under gradient accumulation), metrics of
    the last, the rays drawn under `intrinsics` (None:
    CameraIntrinsics.from_hwf). Nothing in the loop waits for the device.

    With a sharded `group` (nerfmeshes_tpu/train/step.py:225-276) each
    rank draws its own share of the step's rays (batch_source), the grads
    are averaged over the group before every optimizer micro-step and the
    last step's metrics once per call. `rays`, this rank's (origins,
    directions, targets, near, far, depth or None), replaces the drawn
    batch in every step of the call."""
    settings = RenderSettings.from_cfg(cfg, train=True)
    if steps_per_call is None:
        steps_per_call = int(cfg.experiment.steps_per_call)
    source = batch_source(cfg, H=H, W=W, focal=focal, intrinsics=intrinsics, group=group)
    sharded = group is not None and group.sharded

    def one_step(state: TrainState, data: dict, rays) -> dict:
        (origins, directions, targets, near, far, depth_tgt), generator = source(
            state, data, rays)
        loss, metrics = train_loss(cfg, state.coarse, state.fine, origins, directions,
                                   targets, near, far, depth_tgt,
                                   generator=generator, settings=settings)
        loss.backward()
        if sharded:
            all_mean_grads(state.optimizer.params, group)
        state.optimizer.step()
        metrics["train/lr"] = state.optimizer.lr_at(state.step)
        state.step += 1
        return metrics

    def multi_step(state: TrainState, data: dict, rays=None):
        for _ in range(steps_per_call):
            metrics = one_step(state, data, rays)
        if sharded:
            metrics = all_mean_metrics(metrics, group)
        return state, metrics

    return multi_step


def make_render_chunk(cfg, coarse_model, fine_model, *, train: bool = False,
                      group: Optional[DataGroup] = None) -> Callable:
    """Ray-slab renderer for validation / eval: (origins, directions, near,
    far, fields=None) -> (coarse, fine) RenderOutputs, run without
    autograd. The settings come from cfg.nerf.train or
    cfg.nerf.validation; the render is always an eval render
    (deterministic at validation settings). With a sharded `group` the
    chunk's rays are split over the ranks (shard_render_chunk)."""
    settings = RenderSettings.from_cfg(cfg, train=train)

    @torch.inference_mode()
    def render_chunk(origins, directions, near, far, fields=None):
        return render_rays(
            coarse_model, fine_model, origins, directions, near, far, settings,
            train=False,
        )

    return shard_render_chunk(render_chunk, group)


def shard_render_chunk(render_chunk: Callable, group: Optional[DataGroup]) -> Callable:
    """`render_chunk` over a sharded group: each rank renders its chunk /
    world rays of the chunk and the maps named by `fields` (all when None;
    the others come back None) are gathered back in ray order in one
    all_reduce (JAX's P(DATA_AXIS) out-spec, nerfmeshes_tpu/train/
    step.py:300-339). Unsharded, `render_chunk` itself."""
    if group is None or not group.sharded:
        return render_chunk

    def sharded_chunk(origins, directions, near, far, fields=None):
        rows = group.local_rows(directions.shape[0])
        bundles = render_chunk(origins[rows], directions[rows], near, far)
        names = [n for n in RenderOutput._fields if fields is None or n in fields]
        kept = [getattr(b, n) for b in bundles if b is not None for n in names]
        gathered = iter(gather_rows(kept, group))

        def rebuild(bundle):
            if bundle is None:
                return None
            return RenderOutput(**{n: next(gathered) if n in names else None
                                   for n in RenderOutput._fields})

        return tuple(rebuild(b) for b in bundles)

    return sharded_chunk


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
    maps are kept (the others are None) and is passed on to the chunk
    renderer (a sharded one gathers only those), `as_numpy=False` keeps
    tensors on the device."""
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
        coarse, fine = render_chunk(o.contiguous(), d.contiguous(), near, far,
                                    fields=tuple(names))
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
