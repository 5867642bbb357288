"""Plain PyTorch reference of what the cells run, in float32: the
FlexibleNeRF field, stratified and inverse-CDF depth sampling, alpha
compositing, the two-pass MSE loss, optax's Adam, pinhole and NDC rays
(Mildenhall et al., NeRF, ECCV 2020; the model's conventions are the
JAX package's: no activation after the first layer, the alpha head off
the trunk, the d-major positional encoding, +1e-5 on the weights before
the PDF, the 1e-10 in the transmittance).

It imports torch and numpy only: nothing of the program. A training
step's random numbers (its image and pixels, the strata's jitter, the
PDF's uniforms, the sigma noise) are what the program drew, as the
probe recorded them (program.StepProbe), each known by its role
(assign_draws): by its distribution and shape, not by where, in which
order, dtype or stream the program drew it. The reference works out from
them everything else: rays, targets, depths, fields, maps, the loss,
gradients and updates. seeded_draws() makes draws of its own, for the
control and the tests.

`precision="fp8"` is the control: every product's operands rounded to
float8 e4m3 with a per-tensor scale, the gradients reaching a product to
e5m2, the nearest precision below the configurations' bfloat16.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

F8_VALUES = torch.float8_e4m3fn
F8_GRADS = torch.float8_e5m2


def _round_scaled(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to `dtype` under a per-tensor scale that maps its largest
    magnitude to the format's largest finite value."""
    top = torch.finfo(dtype).max
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = top / amax
    return (x.float() * scale).to(dtype).float() / scale


class _Fp8Operand(torch.autograd.Function):
    """Forward: the value in e4m3. Backward: the gradient passes as it is
    (the product's own rounding of its gradient is _Fp8Grad's)."""

    @staticmethod
    def forward(ctx, x):
        return _round_scaled(x, F8_VALUES)

    @staticmethod
    def backward(ctx, g):
        return g


class _Fp8Grad(torch.autograd.Function):
    """Forward: identity. Backward: the gradient rounded to e5m2."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _round_scaled(g, F8_GRADS)


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """x @ w.T + b: in float32 (TF32 off), or with fp8 operands and grads."""
    if precision == "f32":
        return x @ w.t() + b
    if precision == "fp8":
        y = _Fp8Operand.apply(x) @ _Fp8Operand.apply(w).t()
        return _Fp8Grad.apply(y) + b
    raise ValueError(f"unknown precision {precision!r}")


def set_true_f32() -> None:
    """float32 products in float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# -- the field -------------------------------------------------------------------

def pe_width(num_fn: int, include_input: bool) -> int:
    return 6 * num_fn + (3 if include_input else 0)


def is_skip(model: dict, i: int) -> bool:
    """Trunk layer i takes [x, PE(xyz)]."""
    return i % model["skip_step"] == 0 and i > 0 and i != model["num_layers"] - 1


def leaf_shapes(model: dict) -> list[tuple[str, tuple[int, ...]]]:
    """(name, shape) of every parameter of a FlexibleNeRF with view
    directions, named as torch's nn.Linear layers of the model."""
    H = model["hidden_size"]
    dx = pe_width(model["num_encoding_fn_xyz"], model["include_input_xyz"])
    dd = pe_width(model["num_encoding_fn_dir"], model["include_input_dir"])
    layers = [("layer1", dx, H)]
    layers += [(f"layers_xyz.{i}", H + (dx if is_skip(model, i) else 0), H)
               for i in range(model["num_layers"] - 1)]
    layers += [("fc_feat", H, H), ("fc_alpha", H, 1), ("layers_dir.0", H + dd, H // 2),
               ("fc_rgb", H // 2, 3)]
    out = []
    for name, k, n in layers:
        out += [(f"{name}.weight", (n, k)), (f"{name}.bias", (n,))]
    return out


def positional_encoding(x: torch.Tensor, num_fn: int, include_input: bool,
                        log_sampling: bool) -> torch.Tensor:
    """[x, sin(x_d f_l), cos(x_d f_l)], the L bands of one input dim
    contiguous; bands 2^0..2^(L-1), or evenly spaced from 1 to 2^(L-1)."""
    if log_sampling:
        bands = 2.0 ** torch.linspace(0.0, num_fn - 1, num_fn, device=x.device)
    else:
        bands = torch.linspace(1.0, 2.0 ** (num_fn - 1), num_fn, device=x.device)
    scaled = (x[..., :, None] * bands).flatten(-2)
    parts = [x] if include_input else []
    return torch.cat(parts + [torch.sin(scaled), torch.cos(scaled)], dim=-1)


def field(params: dict, model: dict, points: torch.Tensor, dirs: torch.Tensor,
          precision: str = "f32") -> tuple[torch.Tensor, torch.Tensor]:
    """(rgb (N, 3), raw sigma (N,)) of the field at points (N, 3) seen
    along dirs (N, 3). `params` maps leaf_shapes' names to tensors."""
    def lin(name, x):
        return linear(x, params[f"{name}.weight"], params[f"{name}.bias"], precision)

    pe_x = positional_encoding(points, model["num_encoding_fn_xyz"],
                               model["include_input_xyz"], model["log_sampling_xyz"])
    x = lin("layer1", pe_x)
    for i in range(model["num_layers"] - 1):
        if is_skip(model, i):
            x = torch.cat([x, pe_x], dim=-1)
        x = torch.relu(lin(f"layers_xyz.{i}", x))
    sigma = lin("fc_alpha", x)[:, 0]
    pe_d = positional_encoding(dirs, model["num_encoding_fn_dir"], model["include_input_dir"],
                               model["log_sampling_dir"])
    feat = torch.relu(lin("fc_feat", x))
    h = torch.relu(lin("layers_dir.0", torch.cat([feat, pe_d], dim=-1)))
    return torch.sigmoid(lin("fc_rgb", h)), sigma


# -- sampling and compositing ------------------------------------------------------

class Draws(NamedTuple):
    """The random numbers of one hierarchical render (None: not drawn)."""

    strata: Optional[torch.Tensor]  # (R, Sc) U(0, 1): jitter inside each bin
    noise_coarse: Optional[torch.Tensor]  # (R, Sc) N(0, 1) on raw sigma
    pdf: Optional[torch.Tensor]  # (R, Nf) U(0, 1), sorted along each ray
    noise_fine: Optional[torch.Tensor]  # (R, Sc + Nf)


def stratified(near, far, R: int, S: int, lindisp: bool, jitter: Optional[torch.Tensor],
               device) -> torch.Tensor:
    t = torch.linspace(0.0, 1.0, S, device=device)[None, :]
    if lindisp:
        z = 1.0 / (1.0 / near * (1.0 - t) + 1.0 / far * t)
    else:
        z = near * (1.0 - t) + far * t
    z = z.expand(R, S)
    if jitter is not None:
        mids = 0.5 * (z[:, 1:] + z[:, :-1])
        upper = torch.cat([mids, z[:, -1:]], dim=-1)
        lower = torch.cat([z[:, :1], mids], dim=-1)
        z = lower + (upper - lower) * jitter
    return z


def composite(rgb: torch.Tensor, sigma: torch.Tensor, z: torch.Tensor,
              directions: torch.Tensor, noise: Optional[torch.Tensor], noise_std: float,
              white_background: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """(rgb map (R, 3), weights (R, S)) from rgb (R, S, 3) and raw sigma
    (R, S) at depths z (R, S)."""
    dists = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)], dim=-1)
    dists = dists * torch.linalg.norm(directions, dim=-1)[:, None]
    if noise is not None:
        sigma = sigma + noise * noise_std
    alpha = 1.0 - torch.exp(-torch.relu(sigma) * dists)
    keep = 1.0 - alpha + 1e-10
    trans = torch.cumprod(torch.cat([torch.ones_like(keep[:, :1]), keep[:, :-1]], dim=-1),
                          dim=-1)
    weights = alpha * trans
    rgb_map = (weights[..., None] * rgb).sum(dim=1)
    if white_background:
        rgb_map = rgb_map + (1.0 - weights.sum(dim=1))[:, None]
    return rgb_map, weights


def inverse_cdf(bins: torch.Tensor, weights: torch.Tensor, n: int,
                u: Optional[torch.Tensor]) -> torch.Tensor:
    """n depths per ray drawn from the piecewise-constant density that
    `weights` (R, B - 1) put on the intervals of `bins` (R, B): at the
    sorted uniforms u (R, n), or at evenly spaced ones."""
    w = weights.detach() + 1e-5
    cdf = torch.cumsum(w / w.sum(dim=-1, keepdim=True), dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)
    if u is None:
        u = torch.linspace(0.0, 1.0, n, device=bins.device).expand(bins.shape[0], n)
    idx = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    lo = (idx - 1).clamp(min=0)
    hi = idx.clamp(max=cdf.shape[-1] - 1)
    c_lo, c_hi = cdf.gather(-1, lo), cdf.gather(-1, hi)
    b_lo, b_hi = bins.gather(-1, lo), bins.gather(-1, hi)
    span = c_hi - c_lo
    span = torch.where(span < 1e-5, torch.ones_like(span), span)
    return b_lo + (u - c_lo) / span * (b_hi - b_lo)


def render(params: dict, cfg: dict, origins: torch.Tensor, directions: torch.Tensor,
           near, far, draws: Optional[Draws], *, train: bool,
           precision: str = "f32") -> tuple[torch.Tensor, torch.Tensor]:
    """(coarse rgb map, fine rgb map) of rays (R, 3): coarse samples,
    the coarse field, compositing, the fine samples from its weights
    merged with the coarse ones, the fine field, compositing. `params`
    holds "coarse." and "fine." leaves; `cfg` is the program's config as
    nested dicts; `draws` None means a render that draws nothing."""
    mode = cfg["nerf"]["train" if train else "validation"]
    models = cfg["models"]
    Sc, Nf = mode["num_coarse"], mode["num_fine"]
    noise_std = mode["radiance_field_noise_std"] if train else 0.0
    white = bool(cfg["dataset"]["white_background"])
    draws = draws or Draws(None, None, None, None)
    R = directions.shape[0]
    origins = origins.expand(R, 3)

    def run_field(prefix, model, z):
        pts = origins[:, None, :] + directions[:, None, :] * z[..., None]
        dirs = directions[:, None, :].expand(pts.shape)
        sub = {k[len(prefix):]: v for k, v in params.items() if k.startswith(prefix)}
        rgb, sigma = field(sub, model, pts.reshape(-1, 3), dirs.reshape(-1, 3), precision)
        return rgb.reshape(R, -1, 3), sigma.reshape(R, -1)

    z = stratified(near, far, R, Sc, bool(mode["lindisp"]), draws.strata, directions.device)
    rgb, sigma = run_field("coarse.", models["coarse"], z)
    coarse_map, weights = composite(rgb, sigma, z, directions, draws.noise_coarse, noise_std,
                                    white)
    mids = 0.5 * (z[:, 1:] + z[:, :-1])
    fine_z = inverse_cdf(mids, weights[:, 1:-1], Nf, draws.pdf)
    z_all = torch.sort(torch.cat([z.detach(), fine_z], dim=-1), dim=-1).values
    rgb, sigma = run_field("fine.", models["fine"], z_all)
    fine_map, _ = composite(rgb, sigma, z_all, directions, draws.noise_fine, noise_std, white)
    return coarse_map, fine_map


# -- rays ---------------------------------------------------------------------------

def camera_directions(x: torch.Tensor, y: torch.Tensor, H: int, W: int,
                      focal: float) -> torch.Tensor:
    """Unit camera-space directions of pixel coordinates: principal point
    at the centre, y up, looking down -z."""
    d = torch.stack([(x - W * 0.5) / focal, -(y - H * 0.5) / focal, -torch.ones_like(x)],
                    dim=-1)
    return d / torch.linalg.norm(d, dim=-1, keepdim=True)


def to_ndc(H: int, W: int, focal: float, origins: torch.Tensor,
           directions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Rays moved to the near plane z = -1 and mapped to normalised device
    coordinates (NeRF's appendix C, near 1)."""
    t = -(1.0 + origins[:, 2]) / directions[:, 2]
    o = origins + t[:, None] * directions
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = directions.unbind(-1)
    ax, ay = -2.0 * focal / W, -2.0 * focal / H
    o_ndc = torch.stack([ax * ox / oz, ay * oy / oz, 1.0 + 2.0 / oz], dim=-1)
    d_ndc = torch.stack([ax * (dx / dz - ox / oz), ay * (dy / dz - oy / oz), -2.0 / oz], dim=-1)
    return o_ndc, d_ndc


# -- training ---------------------------------------------------------------------

def _draw_shapes(cfg: dict, rays: int) -> dict:
    mode = cfg["nerf"]["train"]
    Sc, Nf = mode["num_coarse"], mode["num_fine"]
    return {"strata": (rays, Sc), "noise_coarse": (rays, Sc), "pdf": (rays, Nf),
            "noise_fine": (rays, Sc + Nf)}


def seeded_draws(gen: torch.Generator, cfg: dict, num_images: int, H: int, W: int,
                 rays: int, device) -> tuple[torch.Tensor, torch.Tensor, Draws]:
    """One training step's (image, pixels, render draws) from `gen`: the
    benchmark's own, for the control and the tests."""
    mode = cfg["nerf"]["train"]
    shapes = _draw_shapes(cfg, rays)
    perturb = bool(mode["perturb"])
    noisy = mode["radiance_field_noise_std"] > 0.0
    img = torch.randint(0, num_images, (), generator=gen, device=device)
    pix = torch.randint(0, H * W, (rays,), generator=gen, device=device)

    def draw(kind, role, on):
        if not on:
            return None
        fn = torch.rand if kind == "uniform" else torch.randn
        return fn(shapes[role], generator=gen, device=device)

    pdf = draw("uniform", "pdf", perturb)
    return img, pix, Draws(draw("uniform", "strata", perturb),
                           draw("normal", "noise_coarse", noisy),
                           None if pdf is None else torch.sort(pdf, dim=-1).values,
                           draw("normal", "noise_fine", noisy))


# The distribution of each random function a program may draw with: its
# name (torch.rand, Tensor.uniform_, ...) -> "int", "uniform", "normal" or
# "exponential".
DRAW_KINDS = {"randint": "int", "random_": "int", "rand": "uniform", "rand_like": "uniform",
              "uniform_": "uniform", "randn": "normal", "randn_like": "normal",
              "normal_": "normal", "normal": "normal", "exponential_": "exponential"}


def assign_draws(records: list, cfg: dict, rays: int) -> tuple[torch.Tensor, torch.Tensor, Draws]:
    """One training step's (image, pixels, render draws) from the program's
    random draws of that step, `records` [(kind, tensor)] in the order
    drawn: the image is the 0-dim integer draw, the pixels the (rays,)
    one; the strata's jitter a (rays, Sc) uniform draw, the PDF's uniforms
    a (rays, Nf) one (sorted here; or the n + 1 exponential spacings of
    the sort-free construction, normalised cumulative sums), the coarse
    and fine noise (rays, Sc) and (rays, Sc + Nf) normal draws. Where two
    roles share a kind and shape (Sc == Nf), the earlier draw is the
    strata's: the PDF's depend on the coarse pass."""
    mode = cfg["nerf"]["train"]
    shapes = _draw_shapes(cfg, rays)
    perturb = bool(mode["perturb"])
    noisy = mode["radiance_field_noise_std"] > 0.0
    pool = [(kind, t) for kind, t in records]

    def take(kinds, shape, role):
        for i, (kind, t) in enumerate(pool):
            if kind in kinds and tuple(t.shape) == tuple(shape):
                return pool.pop(i)[1]
        raise ValueError(f"the program drew no {role} ({'/'.join(kinds)} of shape {shape}); "
                         f"it drew {[(k, tuple(t.shape)) for k, t in records]}")

    img = take(("int",), (), "image")
    pix = take(("int",), (rays,), "pixels")
    strata = take(("uniform",), shapes["strata"], "strata jitter").float() if perturb else None
    noise_c = take(("normal",), shapes["noise_coarse"], "coarse noise").float() if noisy else None
    pdf = None
    if perturb:
        Nf = shapes["pdf"][1]
        found = [k for k, t in pool if (k == "uniform" and tuple(t.shape) == shapes["pdf"])
                 or (k == "exponential" and tuple(t.shape) == (rays, Nf + 1))]
        if found and found[0] == "exponential":
            cums = torch.cumsum(take(("exponential",), (rays, Nf + 1), "PDF spacings").double(),
                                dim=-1)
            pdf = (cums[:, :-1] / cums[:, -1:]).float()
        else:
            pdf = torch.sort(take(("uniform",), shapes["pdf"], "PDF uniforms").float(),
                             dim=-1).values
    noise_f = take(("normal",), shapes["noise_fine"], "fine noise").float() if noisy else None
    return img.long(), pix.long(), Draws(strata, noise_c, pdf, noise_f)


def batch_rays(data: dict, img: torch.Tensor, pix: torch.Tensor, use_ndc: bool):
    """(origins, directions, targets) of pixels `pix` of image `img`."""
    H, W, focal = data["hwf"]
    pose = data["poses"][img].float()
    x = (pix % W).float()
    y = torch.div(pix, W, rounding_mode="floor").float()
    dirs = camera_directions(x, y, H, W, focal) @ pose[:3, :3].t()
    origins = pose[:3, 3].expand(dirs.shape)
    if use_ndc:
        origins, dirs = to_ndc(H, W, focal, origins, dirs)
    targets = data["targets"][img].reshape(-1, 3)[pix]
    return origins, dirs, targets


class Adam:
    """optax.adam over a dict of leaves, with the config's exponential
    decay: mu, nu, then p -= lr_t (mu / c1) / (sqrt(nu / c2) + eps) with
    c = 1 - b^t in float32, lr_t = lr gamma^(t / step_size) at the count
    before the update."""

    def __init__(self, params: dict, cfg: dict, b1=0.9, b2=0.999, eps=1e-8):
        self.lr = float(cfg["optimizer"]["lr"])
        opts = cfg["scheduler"]["options"]
        if cfg["scheduler"]["type"] != "DefaultScheduler" or cfg["optimizer"]["type"] != "Adam":
            raise ValueError("the reference implements Adam under DefaultScheduler only")
        self.gamma, self.decay_steps = float(opts["gamma"]), int(opts["step_size"])
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    def lr_at(self, count: int) -> float:
        f32 = np.float32
        return float(f32(self.lr) * f32(self.gamma) ** (f32(count) / f32(self.decay_steps)))

    @torch.no_grad()
    def update(self, params: dict, grads: dict) -> None:
        f32 = np.float32
        lr = self.lr_at(self.count)
        self.count += 1
        c1 = float(f32(1) - f32(self.b1) ** f32(self.count))
        c2 = float(f32(1) - f32(self.b2) ** f32(self.count))
        for k, p in params.items():
            g = grads[k]
            self.mu[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.nu[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            step = (self.mu[k] / c1) / (torch.sqrt(self.nu[k] / c2) + self.eps)
            p.sub_(lr * step)


class TrainReadings(NamedTuple):
    losses: list  # the loss of each step, host floats
    first_maps: tuple  # the first step's (coarse, fine) rgb maps
    first_grads: dict  # leaf -> the first step's gradient
    params: dict  # leaf -> the parameters after the steps
    first_targets: torch.Tensor  # the first step's targets (rays, 3)


def train_steps(params0: dict, cfg: dict, data: dict, draws: list, *,
                precision: str = "f32", block: int = 4096) -> TrainReadings:
    """One training step from params0 on `data` (targets (N, H, W, 3),
    poses (N, 4, 4), bounds (2,), hwf) for each step's (image, pixels,
    Draws) in `draws`. Each step's loss and gradient are summed over
    blocks of `block` rays."""
    params = {k: v.detach().clone().float() for k, v in params0.items()}
    opt = Adam(params, cfg)
    rays = int(cfg["nerf"]["train"]["num_random_rays"])
    use_ndc = bool(cfg["dataset"]["use_ndc"])
    near, far = (float(v) for v in data["bounds"].tolist())
    losses, first, maps, first_targets = [], None, None, None
    for img, pix, step_draws in draws:
        origins, dirs, targets = batch_rays(data, img, pix, use_ndc)
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        grads = {k: torch.zeros_like(v) for k, v in params.items()}
        total, step_maps = 0.0, ([], [])
        for s in range(0, rays, block):
            e = min(rays, s + block)
            part = Draws(*(None if d is None else d[s:e] for d in step_draws))
            coarse, fine = render(leaves, cfg, origins[s:e], dirs[s:e], near, far, part,
                                  train=True, precision=precision)
            sq = ((coarse - targets[s:e]) ** 2).sum() + ((fine - targets[s:e]) ** 2).sum()
            loss = sq / (rays * 3)
            block_grads = torch.autograd.grad(loss, list(leaves.values()))
            step_maps[0].append(coarse.detach())
            step_maps[1].append(fine.detach())
            for k, g in zip(leaves, block_grads):
                grads[k] += g
            total += float(loss.detach())
        losses.append(total)
        if first is None:
            first = {k: g.clone() for k, g in grads.items()}
            maps = tuple(torch.cat(m, dim=0) for m in step_maps)
            first_targets = targets.detach().float()
        opt.update(params, grads)
    return TrainReadings(losses, maps, first, params, first_targets)


def map_loss(maps: tuple, targets: torch.Tensor) -> float:
    """The two-pass MSE of (coarse, fine) rgb maps against `targets`, in
    float64: the loss a step of those maps takes; nan where the shapes
    differ."""
    if any(m.shape != targets.shape for m in maps):
        return math.nan
    t = targets.double()
    return float(sum(((m.double() - t) ** 2).mean() for m in maps))


def render_rays(params: dict, cfg: dict, origins: torch.Tensor, directions: torch.Tensor,
                near: float, far: float, *, precision: str = "f32",
                block: int = 32768) -> torch.Tensor:
    """The fine rgb map (R, 3) of rays at validation settings, in blocks."""
    out = []
    with torch.no_grad():
        for s in range(0, directions.shape[0], block):
            o = origins[s:s + block] if origins.shape[0] > 1 else origins
            _, fine = render(params, cfg, o, directions[s:s + block], near, far, None,
                             train=False, precision=precision)
            out.append(fine)
    return torch.cat(out, dim=0)


def relative_gap(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def map_gaps(program: tuple, reference: tuple) -> dict:
    """The median and the 90th percentile of |program - reference| over
    every channel of every ray of the coarse and of the fine map; inf
    where the shapes differ."""
    out = {}
    for name, p, r in zip(("coarse", "fine"), program, reference):
        if p.shape != r.shape:
            out[f"{name}_median_gap"] = out[f"{name}_p90_gap"] = math.inf
            continue
        gap = (p.float() - r.float()).abs().reshape(-1).cpu().numpy()
        out[f"{name}_median_gap"] = float(np.median(gap))
        out[f"{name}_p90_gap"] = float(np.quantile(gap, 0.9))
    return out


def leaf_gaps(program: dict, reference: dict, keep=None) -> dict:
    """Each leaf's gap between the program's norm and the reference's,
    over the larger of the reference's norm of that leaf and of the
    median leaf. `keep`: the leaves compared (all when None)."""
    names = [k for k in reference if keep is None or k in keep]
    ref = {k: float(torch.linalg.vector_norm(reference[k].float())) for k in names}
    prog = {k: float(torch.linalg.vector_norm(program[k].float())) for k in names}
    median = float(np.median(list(ref.values())))
    gaps = {}
    for k in names:
        gap = abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30)
        gaps[k] = gap if math.isfinite(gap) else math.inf
    return gaps
