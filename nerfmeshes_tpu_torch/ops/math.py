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


def img2mse(src: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean squared error between two images / ray batches."""
    return torch.mean((src - target) ** 2)


def mse2psnr(mse: torch.Tensor) -> torch.Tensor:
    """PSNR for signals in [0, 1]; zero MSE is clamped to 1e-5."""
    mse = torch.as_tensor(mse)
    mse = torch.where(mse == 0, torch.full_like(mse, 1e-5), mse)
    return -10.0 * torch.log10(mse)
