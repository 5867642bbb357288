"""Shared layers and encodings of the model zoo (counterpart of
nerfmeshes_tpu/models/layers.py).

`TorchLinear` is `nn.Linear` itself (the JAX package's TorchLinear
imitates its init), plus the compute dtype of the JAX layer: at bf16 the
product takes bf16 operands with f32 accumulation, the f32 bias is added
to the f32 sum, and the activation is stored in bf16 (layers.py:47-53).

The other layers keep the JAX layers' dtype rules, which differ by layer:
- `SimpleModule` applies its activation to TorchLinear's output, in the
  compute dtype;
- the spatial embeddings (`SpatialEmbedding`, `SimpleSpatialEmbedding`,
  `FastRotPos`) round x and B to the compute dtype, sum in f32 and return
  f32;
- the Siren family adds the f32 bias to the f32 sum and takes sin / cos
  in f32;
- `FlexiblePositionalEncoding` and `Embbed2` take their product in the
  input's dtype, with no cast;
- `MultiSkipModule` concatenates a bf16 value with an f32 skip as
  `jnp.concatenate` does, promoting to f32.

Parameters stay f32. Every layer that holds parameters or buffers
draws them in `reset_parameters(generator)` with the JAX initialiser's
distribution; the draws themselves differ from jax.random's (the weights
of a JAX run are carried over by models/transplant.py). Submodules are
registered in the order the flax modules create theirs, which is what
`state_dict_from_flax` relies on.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
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


def _cat_promoted(parts: list) -> torch.Tensor:
    """torch.cat of tensors of mixed dtypes, promoted as jnp.concatenate
    promotes them (bf16 with f32 gives f32)."""
    dtype = parts[0].dtype
    for t in parts[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    return torch.cat([t.to(dtype) for t in parts], dim=-1)


class SimpleModule(nn.Module):
    """TorchLinear + activation, the activation in the compute dtype
    (layers.py:74-83)."""

    def __init__(self, in_features: int, features: int,
                 activation: Callable = torch.relu, *,
                 compute_dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.linear = TorchLinear(in_features, features, compute_dtype=compute_dtype,
                                  device=device)
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.activation(self.linear(x))


class MultiSkipModule(nn.Module):
    """`layer_count` groups, each re-fed the skip value: [value, skip] ->
    SimpleModule, then `skip_step` more SimpleModules (layers.py:86-103).
    `layers` holds them flat, in call order."""

    def __init__(self, in_features: int, skip_features: int, hidden_size: int,
                 layer_count: int, skip_step: int = 1, *,
                 compute_dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.layer_count = layer_count
        self.skip_step = skip_step

        def module(i):
            return SimpleModule(i, hidden_size, compute_dtype=compute_dtype, device=device)

        layers = []
        width = in_features
        for _ in range(layer_count):
            layers.append(module(width + skip_features))
            layers += [module(hidden_size) for _ in range(skip_step)]
            width = hidden_size
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor, skip_value: torch.Tensor) -> torch.Tensor:
        value = x
        group = 1 + self.skip_step
        for g in range(self.layer_count):
            value = _cat_promoted([value, skip_value])
            for layer in self.layers[g * group:(g + 1) * group]:
                value = layer(value)
        return value


class ResBlock(nn.Module):
    """Two-layer bottleneck residual block, y + x (layers.py:106-117)."""

    def __init__(self, hidden: int, hidden_mid: int, *,
                 compute_dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.down = SimpleModule(hidden, hidden_mid, compute_dtype=compute_dtype, device=device)
        self.up = SimpleModule(hidden_mid, hidden, compute_dtype=compute_dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.up(self.down(x)) + x


# ---------------------------------------------------------------------------
# Learned / random-Fourier encodings (layers.py:120-226)
# ---------------------------------------------------------------------------


class SpatialEmbedding(nn.Module):
    """Trainable random-Fourier embedding [a sin(xB), a cos(xB)]: B ~
    2^(N(0, 1) * mult) - 1 of shape (in, out), amplitude a = 1
    (layers.py:125-146). x and B are rounded to the compute dtype, the
    product summed in f32; the output is f32."""

    amplitude = True

    def __init__(self, in_features: int, out_features: int, weight_multiplier: float = 1.0, *,
                 compute_dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.out_features = out_features
        self.weight_multiplier = weight_multiplier
        self.compute_dtype = compute_dtype
        self.b = nn.Parameter(torch.empty(in_features, out_features, device=device))
        if self.amplitude:
            self.a = nn.Parameter(torch.empty(out_features, device=device))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.b.normal_(generator=generator)
            self.b.copy_(torch.exp2(self.b * self.weight_multiplier) - 1.0)
            if self.amplitude:
                self.a.fill_(1.0)

    def projection(self, x: torch.Tensor) -> torch.Tensor:
        """x @ B with operands in the compute dtype, summed in f32."""
        return matmul_f32_acc(x, self.b.t(), self.compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        proj = self.projection(x)
        if self.amplitude:
            return torch.cat([self.a * torch.sin(proj), self.a * torch.cos(proj)], dim=-1)
        return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)

    def output_size(self) -> int:
        return 2 * self.out_features


class SimpleSpatialEmbedding(SpatialEmbedding):
    """SpatialEmbedding without the amplitude (layers.py:149-169)."""

    amplitude = False


class FastRotPos(SimpleSpatialEmbedding):
    """Fixed random-direction Fourier features [sin(xB), cos(xB)]: unit
    N(0, 1) columns scaled by 2^(U(0, 1) * mult) - 1 (layers.py:172-200).

    B is a buffer, not a parameter: no optimizer sees it (AdamW's decay
    would move a parameter without a gradient), and a checkpoint carries
    it. JAX derives it from jax.random.PRNGKey(0) at every call;
    models/transplant.py takes that B as an explicit input."""

    def __init__(self, in_features: int, out_features: int, weight_multiplier: float = 1.0, *,
                 compute_dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None):
        nn.Module.__init__(self)
        self.out_features = out_features
        self.weight_multiplier = weight_multiplier
        self.compute_dtype = compute_dtype
        self.register_buffer("b", torch.empty(in_features, out_features, device=device))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        in_features, out_features = self.b.shape
        with torch.no_grad():
            b = torch.empty_like(self.b).normal_(generator=generator)
            b = b / torch.linalg.vector_norm(b, dim=0, keepdim=True)
            u = torch.empty(1, out_features, device=b.device).uniform_(generator=generator)
            self.b.copy_(b * (torch.exp2(u * self.weight_multiplier) - 1.0))


def _exp2_linspace(stop: float, num: int) -> np.ndarray:
    """2 ** jnp.linspace(0, stop, num) in f32: JAX's linspace with start 0
    is stop * (i / (num - 1)) in f32, the last point `stop`."""
    if num == 1:
        t = np.zeros(1, np.float32)
    else:
        t = np.float32(stop) * (np.arange(num, dtype=np.float32) / np.float32(num - 1))
        t[-1] = np.float32(stop)
    return np.exp2(t).astype(np.float32)


class FlexiblePositionalEncoding(nn.Module):
    """[x, sin(x f), cos(x f)] with `out_features` bands 2^linspace(0,
    mult) per input dim, d-major (layers.py:203-220). No parameters; the
    product is taken in x's dtype, as JAX's dot with the one-hot band
    matrix (one non-zero term per column, so the same value)."""

    def __init__(self, in_features: int, out_features: int, weight_multiplier: float = 1.0, *,
                 compute_dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.bands = _exp2_linspace(weight_multiplier, out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bands = torch.as_tensor(self.bands, device=x.device).to(x.dtype)
        proj = (x[..., None] * bands).reshape(*x.shape[:-1], x.shape[-1] * bands.shape[0])
        return torch.cat([x, torch.sin(proj), torch.cos(proj)], dim=-1)

    def output_size(self, in_dim: int = 3) -> int:
        return 2 * in_dim * self.out_features + in_dim


class Embbed2(nn.Module):
    """Trainable diagonal-frequency Fourier embedding [a sin(xB), a
    cos(xB)], B initialised to bands 2^linspace(0, mult) - 1 on the
    diagonal blocks (layers.py:362-383); the product in x's dtype."""

    def __init__(self, in_features: int, out_features: int, weight_multiplier: float = 1.0, *,
                 compute_dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight_multiplier = weight_multiplier
        self.b = nn.Parameter(torch.empty(in_features, out_features, device=device))
        self.a = nn.Parameter(torch.empty(out_features, device=device))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        n = self.in_features
        bands = _exp2_linspace(self.weight_multiplier, self.out_features // n) - np.float32(1.0)
        b = (np.eye(n, dtype=np.float32) * bands[:, None, None]).reshape(self.out_features, n).T
        with torch.no_grad():
            self.b.copy_(torch.from_numpy(np.ascontiguousarray(b)))
            self.a.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = torch.promote_types(x.dtype, self.b.dtype)
        proj = torch.matmul(x.to(dtype), self.b.to(dtype))
        return torch.cat([self.a * torch.sin(proj), self.a * torch.cos(proj)], dim=-1)

    def output_size(self) -> int:
        return 2 * self.out_features


def get_encoding(name: str):
    """Encoding registry (layers.py:223-229). Each takes (in_features,
    out_features, weight_multiplier, *, compute_dtype, device)."""
    return {
        "fastrot": FastRotPos,
        "spatial": SpatialEmbedding,
        "positional": FlexiblePositionalEncoding,
    }[name]


# ---------------------------------------------------------------------------
# Siren-style layers (layers.py:237-421)
# ---------------------------------------------------------------------------


class _SirenBase(nn.Module):
    """f(x W^T + b): the product with operands in the compute dtype and an
    f32 sum, the f32 bias added, f in f32. weight (width, in), bias
    U(+-1/sqrt(in)); subclasses set the weight's init and f."""

    cosine = False  # [sin, cos] of width out_features // 2 each

    def __init__(self, in_features: int, out_features: int, weight_multiplier: float = 1.0, *,
                 compute_dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.in_features = in_features
        self.weight_multiplier = weight_multiplier
        self.compute_dtype = compute_dtype
        width = out_features // 2 if self.cosine else out_features
        self.weight = nn.Parameter(torch.empty(width, in_features, device=device))
        self.bias = nn.Parameter(torch.empty(width, device=device))
        self.reset_parameters()

    def init_weight(self, generator: Optional[torch.Generator]) -> None:
        raise NotImplementedError

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        bound = 1.0 / math.sqrt(self.in_features)
        with torch.no_grad():
            self.init_weight(generator)
            self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        proj = matmul_f32_acc(x, self.weight, self.compute_dtype) + self.bias
        if self.cosine:
            return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)
        return torch.sin(proj)


class SirenModule(_SirenBase):
    """sin(linear(x)), kernel U(+-sqrt(6 / in) * mult)."""

    def init_weight(self, generator):
        bound = math.sqrt(6.0 / self.in_features) * self.weight_multiplier
        self.weight.uniform_(-bound, bound, generator=generator)


class SirenModuleNormal(_SirenBase):
    """sin(linear(x)), kernel N(0, 1) * mult."""

    def init_weight(self, generator):
        self.weight.normal_(generator=generator).mul_(self.weight_multiplier)


class SirenModuleExp(_SirenBase):
    """sin(linear(x)), kernel 2^U(-mult, mult)."""

    def init_weight(self, generator):
        m = self.weight_multiplier
        self.weight.copy_(torch.exp2(self.weight.uniform_(-m, m, generator=generator)))


class PotCoSirenModule(SirenModuleExp):
    """[sin, cos](linear(x)), kernel 2^U(-mult, mult) of width out // 2."""

    cosine = True


class CoSirenModule(_SirenBase):
    """[sin, cos](linear(x)) - pi / 4, kernel U(+-sqrt(24 / in) * mult) of
    width out // 2."""

    cosine = True

    def init_weight(self, generator):
        bound = math.sqrt(24.0 / self.in_features) * self.weight_multiplier
        self.weight.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x) - (math.pi / 4)


# ---------------------------------------------------------------------------
# Luminance combination functions (layers.py:424-431)
# ---------------------------------------------------------------------------


def get_luminance_function(name: str) -> Callable:
    return {
        "simple": lambda color, lum: color + lum,
        "disabled": lambda color, lum: color,
        "multiply": lambda color, lum: color * (1.0 + lum),
        "fillup": lambda color, lum: color + (1.0 - color) * lum,
        "min1": lambda color, lum: torch.clamp(color + lum, max=1.0),
    }[name]
