"""Small numeric primitives (counterpart of nerfmeshes_tpu/ops/math.py).

The JAX package spells its scans as log-step passes to dodge serial loops
on the TPU; torch's own cumprod/cumsum kernels take their place here.
`ssim` is the eval CLI's image metric.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch
import torch.nn.functional as F


def cumprod_exclusive(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """TF-style exclusive cumulative product along `dim`:
    out[..., i] = prod(x[..., :i]), out[..., 0] = 1."""
    x = x.movedim(dim, -1)
    shifted = torch.cat([torch.ones_like(x[..., :1]), x[..., :-1]], dim=-1)
    return torch.cumprod(shifted, dim=-1).movedim(-1, dim)


class _CumprodPositive(torch.autograd.Function):
    """torch.cumprod along the last dim for inputs with no zeros. Its
    backward is torch's own formula for that case, reversed_cumsum(out *
    grad) / x, without the check for zeros that torch's cumprod backward
    reads back to the host (a device sync in every training step)."""

    @staticmethod
    def forward(ctx, x):
        out = torch.cumprod(x, dim=-1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        return (out * grad).flip(-1).cumsum(-1).flip(-1) / x


def cumprod_exclusive_positive(x: torch.Tensor) -> torch.Tensor:
    """cumprod_exclusive along the last dim of an input with no zeros
    (the transmittance factors 1 - alpha + 1e-10 of compositing)."""
    shifted = torch.cat([torch.ones_like(x[..., :1]), x[..., :-1]], dim=-1)
    return _CumprodPositive.apply(shifted)


def img2mse(src: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean squared error between two images / ray batches."""
    return torch.mean((src - target) ** 2)


def mse2psnr(mse: torch.Tensor) -> torch.Tensor:
    """PSNR for signals in [0, 1]; zero MSE is clamped to 1e-5."""
    mse = torch.as_tensor(mse)
    mse = torch.where(mse == 0, torch.full_like(mse, 1e-5), mse)
    return -10.0 * torch.log10(mse)


@contextmanager
def _true_f32_convs():
    """cuDNN convolutions in true f32 (no TF32) inside the block."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def ssim(img1: torch.Tensor, img2: torch.Tensor, *, max_val: float = 1.0,
         window_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Structural similarity (Wang et al. 2004) of two (H, W, C) images, a
    0-dim tensor on their device: Gaussian window 11x11, sigma 1.5, 'valid'
    separable convolutions in true f32 (the blur(x^2) - mu^2 cancellation
    would lose C2 = 9e-4 to TF32's 10-bit mantissa), C1 = (0.01 L)^2,
    C2 = (0.03 L)^2, mean over pixels and channels."""
    x = torch.as_tensor(img1, dtype=torch.float32)
    y = torch.as_tensor(img2, dtype=torch.float32, device=x.device)
    half = window_size // 2
    g = torch.exp(-0.5 * ((torch.arange(window_size, device=x.device) - half) / sigma) ** 2)
    g = g / torch.sum(g)

    def blur(z):  # (H, W, C) -> (H', W', C)
        z = z.permute(2, 0, 1)[:, None]  # (C, 1, H, W)
        z = F.conv2d(z, g.reshape(1, 1, -1, 1))
        z = F.conv2d(z, g.reshape(1, 1, 1, -1))
        return z[:, 0].permute(1, 2, 0)

    with _true_f32_convs():
        mu_x, mu_y = blur(x), blur(y)
        sxx = blur(x * x) - mu_x * mu_x
        syy = blur(y * y) - mu_y * mu_y
        sxy = blur(x * y) - mu_x * mu_y
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    num = (2 * mu_x * mu_y + c1) * (2 * sxy + c2)
    den = (mu_x ** 2 + mu_y ** 2 + c1) * (sxx + syy + c2)
    return torch.mean(num / den)
