"""Full-image render path (the render half of nerfmeshes_tpu/train/step.py).

One device, no mesh: multi-GPU rendering is queued in ROADMAP.md. The
training step comes with slice 2.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from nerfmeshes_tpu_torch.ops.rays import CameraIntrinsics, ndc_rays, pixel_directions
from nerfmeshes_tpu_torch.ops.render import RenderOutput
from nerfmeshes_tpu_torch.train.render import RenderSettings, render_rays


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

    pending = []
    for start in range(0, R, chunk_size):
        o = origins[start:start + chunk_size]
        d = directions[start:start + chunk_size]
        pad = chunk_size - o.shape[0]
        if pad:
            o = torch.cat([o, o[-1:].expand(pad, 3)], dim=0)
            d = torch.cat([d, d[-1:].expand(pad, 3)], dim=0)
        pending.append(render_chunk(o.contiguous(), d.contiguous(), near, far))

    def gather(bundles):
        if not bundles or bundles[0] is None:
            return None
        out = {}
        for name in RenderOutput._fields:
            if fields is not None and name not in fields:
                out[name] = None
                continue
            arr = torch.cat([getattr(b, name) for b in bundles], dim=0)[:R]
            out[name] = arr.cpu().numpy() if as_numpy else arr
        return RenderOutput(**out)

    return gather([c for c, _ in pending]), gather([f for _, f in pending])
