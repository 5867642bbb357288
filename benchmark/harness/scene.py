"""The benchmark's inputs, made on the device from the run's seed: the
training views (poses and target images), the views to render and their
rays, and the initial weights. One generator for every configuration
and traffic mix; what differs is the data in their files.

A scene's "kind" says how its cameras are placed: "blender", on the
sphere around the object, looking at its centre (NeRF's synthetic
scenes); "llff", forward-facing, near the identity pose, rendered along a
spiral (LLFF captures, NeRF's render path). Target images are uniform
noise: the work of a step does not depend on their content.
"""

from __future__ import annotations

import hashlib
import math

import torch

from harness import reference


ALPHA_BIAS = 1.0


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed of its own for each stream the run draws."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2 ** 63 - 1)


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device).manual_seed(sub_seed(seed, tag))


def hwf(scene: dict) -> tuple[int, int, float]:
    H, W = int(scene["height"]), int(scene["width"])
    if "focal" in scene:
        return H, W, float(scene["focal"])
    return H, W, 0.5 * W / math.tan(0.5 * float(scene["camera_angle_x"]))


def look_at(eye: torch.Tensor, target: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """Camera-to-world (N, 4, 4) of cameras at eye (N, 3) looking at
    target (N, 3) or (3,): columns right, up, back (-view), position."""
    back = eye - target
    back = back / torch.linalg.norm(back, dim=-1, keepdim=True)
    right = torch.linalg.cross(up.expand(back.shape), back, dim=-1)
    right = right / torch.linalg.norm(right, dim=-1, keepdim=True)
    cam_up = torch.linalg.cross(back, right, dim=-1)
    pose = torch.zeros(eye.shape[0], 4, 4, device=eye.device)
    pose[:, :3, 0], pose[:, :3, 1], pose[:, :3, 2], pose[:, :3, 3] = right, cam_up, back, eye
    pose[:, 3, 3] = 1.0
    return pose


def sphere_poses(n: int, scene: dict, gen: torch.Generator, device) -> torch.Tensor:
    """n cameras at scene["radius"] from the origin, azimuth uniform,
    elevation uniform in scene["elevation_deg"], up +z."""
    lo, hi = (math.radians(v) for v in scene["elevation_deg"])
    u = torch.rand((n, 2), generator=gen, device=device)
    az = 2.0 * math.pi * u[:, 0]
    el = lo + (hi - lo) * u[:, 1]
    eye = float(scene["radius"]) * torch.stack(
        [torch.cos(el) * torch.cos(az), torch.cos(el) * torch.sin(az), torch.sin(el)], dim=-1)
    return look_at(eye, torch.zeros(3, device=device), torch.tensor([0.0, 0.0, 1.0],
                                                                   device=device))


def forward_poses(n: int, scene: dict, gen: torch.Generator, device) -> torch.Tensor:
    """n forward-facing cameras: positions uniform in the box
    +-scene["jitter"], each looking at a point on the -z axis at
    scene["focus_depth"] moved by up to a tenth of the jitter, up +y."""
    jitter = torch.tensor(scene["jitter"], device=device)
    u = torch.rand((n, 5), generator=gen, device=device) * 2.0 - 1.0
    eye = u[:, :3] * jitter
    target = torch.zeros(n, 3, device=device)
    target[:, :2] = u[:, 3:] * jitter[:2] * 0.1
    target[:, 2] = -float(scene["focus_depth"])
    return look_at(eye, target, torch.tensor([0.0, 1.0, 0.0], device=device))


def spiral_poses(n: int, scene: dict, device) -> torch.Tensor:
    """NeRF's LLFF render path: n cameras on a spiral of radii
    scene["jitter"] (two turns), all looking at the focus point."""
    t = torch.linspace(0.0, 4.0 * math.pi, n + 1, device=device)[:-1]
    radii = torch.tensor(scene["jitter"], device=device)
    eye = torch.stack([torch.cos(t), -torch.sin(t), -torch.sin(0.5 * t)], dim=-1) * radii
    target = torch.tensor([0.0, 0.0, -float(scene["focus_depth"])], device=device)
    return look_at(eye, target, torch.tensor([0.0, 1.0, 0.0], device=device))


def train_data(scene: dict, seed: int, device) -> dict:
    """The training split as the program takes it (data/blender.py's
    train_arrays): targets (N, H, W, 3) f32, poses (N, 4, 4), bounds (2,),
    hwf. Forward-facing scenes are trained in NDC, on [0, 1]."""
    H, W, focal = hwf(scene)
    n = int(scene["train_views"])
    gen = generator(seed, "train-views", device)
    if scene["kind"] == "blender":
        poses = sphere_poses(n, scene, gen, device)
    elif scene["kind"] == "llff":
        poses = forward_poses(n, scene, gen, device)
    else:
        raise ValueError(f"unknown scene kind {scene['kind']!r}")
    targets = torch.rand((n, H, W, 3), generator=gen, device=device)
    bounds = torch.tensor([float(v) for v in scene["bounds"]], device=device)
    return {"targets": targets, "poses": poses, "bounds": bounds, "hwf": (H, W, focal)}


def view_poses(scene: dict, seed: int, device) -> torch.Tensor:
    """The poses of the views to render: scene["test_views"] of them."""
    n = int(scene["test_views"])
    if scene["kind"] == "blender":
        return sphere_poses(n, scene, generator(seed, "test-views", device), device)
    if scene["kind"] == "llff":
        return spiral_poses(n, scene, device)
    raise ValueError(f"unknown scene kind {scene['kind']!r}")


def view_rays(scene: dict, poses: torch.Tensor, use_ndc: bool) -> list:
    """Each view's (origins, directions), (H*W, 3) each, pixels row-major:
    what a user hands to the renderer."""
    H, W, focal = hwf(scene)
    device = poses.device
    pix = torch.arange(H * W, device=device)
    x = (pix % W).float()
    y = torch.div(pix, W, rounding_mode="floor").float()
    cam = reference.camera_directions(x, y, H, W, focal)
    out = []
    for pose in poses:
        d = cam @ pose[:3, :3].t()
        o = pose[:3, 3].expand(d.shape)
        if use_ndc:
            o, d = reference.to_ndc(H, W, focal, o, d)
        out.append((o, d.contiguous()))
    return out


def initial_weights(models: dict, seed: int, device) -> dict:
    """Both fields' initial parameters, "coarse.<leaf>" and "fine.<leaf>",
    from one uniform draw: weights U(+-sqrt(6 / fan in)) (He's uniform,
    which keeps a ReLU stack's activations at scale, so the field has
    density and colour everywhere), biases U(+-1 / sqrt(fan in)). Torch's
    default init, U(+-1 / sqrt(fan in)) for both, often leaves sigma's ReLU
    off on every point of a deep field: an empty scene, every map 0. The
    alpha heads' bias is ALPHA_BIAS, so that sigma is positive at most
    points of every seed's field. The weights on the positional encoding
    of band l (frequency 2^l) are scaled by 2^(-l/2), a 1/sqrt(frequency)
    spectrum: undamped, a field of random weights varies on the scale of
    2^-9 of the scene, and a sample moved by a rounding error reads
    another colour."""
    leaves, damping = [], {}
    for prefix in ("coarse", "fine"):
        shapes = dict(reference.leaf_shapes(models[prefix]))
        for name, shape in shapes.items():
            fan_in = shapes[f"{name.rsplit('.', 1)[0]}.weight"][1]
            gain = 6.0 if name.endswith(".weight") else 1.0
            leaves.append((f"{prefix}.{name}", shape, math.sqrt(gain / fan_in)))
        damping[prefix] = pe_damping(models[prefix], device)
    total = sum(math.prod(s) for _, s, _ in leaves)
    flat = torch.empty(total, device=device).uniform_(-1.0, 1.0,
                                                      generator=generator(seed, "weights", device))
    out, at = {}, 0
    for name, shape, bound in leaves:
        n = math.prod(shape)
        out[name] = (flat[at:at + n] * bound).reshape(shape)
        at += n
        if name.endswith("fc_alpha.bias"):
            out[name] = torch.full(shape, ALPHA_BIAS, device=device)
    for prefix, model in models.items():
        if prefix not in damping:
            continue
        scale = damping[prefix]
        w = out[f"{prefix}.layer1.weight"]
        out[f"{prefix}.layer1.weight"] = w * scale
        for i in range(model["num_layers"] - 1):
            if reference.is_skip(model, i):
                key = f"{prefix}.layers_xyz.{i}.weight"
                H = model["hidden_size"]
                out[key] = torch.cat([out[key][:, :H], out[key][:, H:] * scale], dim=1)
    return out


def pe_damping(model: dict, device) -> torch.Tensor:
    """Each positional-encoding column's weight scale: 1 for the raw
    coordinates, 2^(-l/2) for band l (reference.positional_encoding's
    layout: [x, sin of each dim's bands, cos of each dim's bands])."""
    L = model["num_encoding_fn_xyz"]
    band = (torch.arange(3 * L, device=device) % L).float()
    parts = [torch.ones(3, device=device)] if model["include_input_xyz"] else []
    return torch.cat(parts + [2.0 ** (-0.5 * band)] * 2)
