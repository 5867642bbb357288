"""NeRF sin/cos positional encoding (counterpart of
nerfmeshes_tpu/ops/encoding.py).

Layout is d-major, exactly as the JAX package and the reference lay it
out: [x?, sin(x*f0..x*fL-1, y*f.., z*f..), cos(same)]. Transplanted
`layer1` weight columns depend on this order.
"""

from __future__ import annotations

import numpy as np
import torch


def frequency_bands(
    num_functions: int, log_sampling: bool = True, dtype=np.float32
) -> np.ndarray:
    """2^linspace(0, L-1, L) (log) or linspace(1, 2^(L-1), L) (linear)."""
    if num_functions == 0:
        return np.zeros((0,), dtype=dtype)
    if log_sampling:
        return (2.0 ** np.linspace(0.0, num_functions - 1, num_functions)).astype(dtype)
    return np.linspace(1.0, 2.0 ** (num_functions - 1), num_functions).astype(dtype)


def positional_encoding(
    x: torch.Tensor,
    num_functions: int = 6,
    include_input: bool = True,
    log_sampling: bool = True,
) -> torch.Tensor:
    """(..., D) -> (..., 2*D*L (+D if include_input))."""
    bands = torch.as_tensor(
        frequency_bands(num_functions, log_sampling), dtype=x.dtype, device=x.device
    )
    # (..., D, L) -> (..., D*L): the frequencies of one input dim are contiguous.
    scaled = (x[..., None] * bands).reshape(*x.shape[:-1], x.shape[-1] * bands.shape[0])
    parts = [x] if include_input else []
    parts += [torch.sin(scaled), torch.cos(scaled)]
    return torch.cat(parts, dim=-1)


def positional_encoding_output_size(
    num_functions: int, include_input: bool = True, in_dim: int = 3
) -> int:
    return 2 * in_dim * num_functions + (in_dim if include_input else 0)
