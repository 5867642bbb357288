"""Small numeric primitives (counterpart of nerfmeshes_tpu/ops/math.py).

The JAX package spells its scans as log-step passes to dodge serial loops
on the TPU; torch's own cumprod/cumsum kernels take their place here.
"""

from __future__ import annotations

import torch


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
