"""Shared layers (counterpart of nerfmeshes_tpu/models/layers.py).

`TorchLinear` is `nn.Linear` itself (the JAX package's TorchLinear
imitates its init), plus the compute dtype of the JAX layer: at bf16 the
product takes bf16 operands with f32 accumulation, the f32 bias is added
to the f32 sum, and the activation is stored in bf16 (layers.py:47-53).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from nerfmeshes_tpu_torch.ops.encoding import (
    positional_encoding,
    positional_encoding_output_size,
)


def matmul_f32_acc(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x @ w.T with both operands rounded to `dtype` and the sum kept in f32.

    The product of two bf16 values is exact in f32, so upcasting the
    rounded operands and multiplying in f32 is the tensor core's bf16 x bf16
    -> f32 product on any device. (On CUDA this relies on TF32 being off for
    f32 matmuls, torch's default.)"""
    return F.linear(x.to(dtype).float(), w.to(dtype).float())


class TorchLinear(nn.Linear):
    """nn.Linear with the JAX layer's compute dtype. Parameters stay f32."""

    def __init__(self, in_features: int, out_features: int, *,
                 compute_dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None):
        super().__init__(in_features, out_features, device=device)
        self.compute_dtype = compute_dtype

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """torch's default init, U(+-1/sqrt(fan_in)) for weight and bias,
        drawn from `generator` when one is given."""
        bound = 1.0 / math.sqrt(self.in_features) if self.in_features > 0 else 0.0
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype == torch.float32:
            return F.linear(x.float(), self.weight, self.bias)
        y = matmul_f32_acc(x, self.weight, self.compute_dtype) + self.bias
        return y.to(self.compute_dtype)


class PositionalEncoding(nn.Module):
    """Classic NeRF sin/cos encoding; holds no parameters."""

    def __init__(self, num_encoding_functions: int = 6, include_input: bool = True,
                 log_sampling: bool = True):
        super().__init__()
        self.num_encoding_functions = num_encoding_functions
        self.include_input = include_input
        self.log_sampling = log_sampling

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return positional_encoding(
            x, self.num_encoding_functions, self.include_input, self.log_sampling
        )

    def output_size(self, in_dim: int = 3) -> int:
        return positional_encoding_output_size(
            self.num_encoding_functions, self.include_input, in_dim
        )
