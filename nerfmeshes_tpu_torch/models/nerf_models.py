"""The radiance-field model zoo (counterpart of
nerfmeshes_tpu/models/nerf_models.py).

Every model maps (ray_points (..., 3), ray_directions (..., 3) | None) to a
radiance field (..., 4) f32 = [rgb in [0, 1], raw sigma];
SpecularSimpleModel returns (field, specular), as JAX's does. The
FlexibleNeRFModel's submodule names are the reference's (`layer1`,
`layers_xyz.{i}`, `fc_feat`, `fc_alpha`, `layers_dir.0`, `fc_rgb`), the
names that nerfmeshes_tpu/cli/import_checkpoint.py:70-79 maps, so a
reference state dict loads as it is. Every model registers its
submodules in the order its flax counterpart creates them
(models/transplant.py reads that order).

`build_model` picks a model by its config name, as
`getattr(models, cfg.models.coarse_type)(**cfg.models.coarse)` does in
the reference.
"""

from __future__ import annotations

import inspect
from typing import Optional

import torch
import torch.nn as nn

from nerfmeshes_tpu_torch.models.layers import (
    FastRotPos,
    MultiSkipModule,
    PositionalEncoding,
    ResBlock,
    SimpleModule,
    SimpleSpatialEmbedding,
    SpatialEmbedding,
    TorchLinear,
    get_encoding,
    get_luminance_function,
)


class _SkipTrunkField(nn.Module):
    """encode_xyz -> `num_layers-1` ReLU layers with an encoding-concat
    skip every `skip_step` -> view-conditioned sigmoid rgb head and a raw
    sigma head; FlexibleNeRFModel and RotFlexibleNeRFModel differ only in
    the xyz encoding."""

    def _build(self, encode_xyz: nn.Module, dim_xyz: int, *, compute_dtype, device) -> None:
        hidden_size = self.hidden_size

        def linear(i, o):
            return TorchLinear(i, o, compute_dtype=compute_dtype, device=device)

        self.encode_xyz = encode_xyz
        self.layer1 = linear(dim_xyz, hidden_size)
        self.layers_xyz = nn.ModuleList(
            linear(hidden_size + (dim_xyz if self.is_skip(i) else 0), hidden_size)
            for i in range(self.num_layers - 1)
        )
        if self.use_viewdirs:
            self.encode_dir = PositionalEncoding(
                self.num_encoding_fn_dir, self.include_input_dir, self.log_sampling_dir
            )
            dim_dir = self.encode_dir.output_size()
            self.fc_feat = linear(hidden_size, hidden_size)
            self.fc_alpha = linear(hidden_size, 1)
            self.layers_dir = nn.ModuleList([linear(hidden_size + dim_dir, hidden_size // 2)])
            self.fc_rgb = linear(hidden_size // 2, 3)
        else:
            self.fc_out = linear(hidden_size, 4)

    def is_skip(self, i: int) -> bool:
        """Whether trunk layer i takes [x, encoding(xyz)] (nerf_models.py:66)."""
        return i % self.skip_step == 0 and i > 0 and i != self.num_layers - 1

    def forward(self, ray_points: torch.Tensor,
                ray_directions: Optional[torch.Tensor] = None) -> torch.Tensor:
        relu = torch.relu
        xyz = self.encode_xyz(ray_points)
        x = self.layer1(xyz)
        for i, layer in enumerate(self.layers_xyz):
            if self.is_skip(i):
                x = torch.cat([x.float(), xyz], dim=-1)  # x first, then the encoding
            x = relu(layer(x))
        if self.use_viewdirs:
            view = self.encode_dir(ray_directions)
            feat = relu(self.fc_feat(x))
            alpha = self.fc_alpha(x)  # off the trunk, not off feat
            x = relu(self.layers_dir[0](torch.cat([feat.float(), view], dim=-1)))
            rgb = torch.sigmoid(self.fc_rgb(x))
            return torch.cat([rgb.float(), alpha.float()], dim=-1)
        out = self.fc_out(x).float()
        return torch.cat([torch.sigmoid(out[..., :3]), out[..., 3:]], dim=-1)


class FlexibleNeRFModel(_SkipTrunkField):
    """PE(xyz) -> `num_layers-1` ReLU layers with a PE-concat skip every
    `skip_step` -> view-conditioned sigmoid rgb head and a raw sigma head.
    Maps points (..., 3) and directions (..., 3) to (..., 4) f32."""

    def __init__(
        self,
        num_layers: int = 4,
        hidden_size: int = 128,
        skip_step: int = 4,
        num_encoding_fn_xyz: int = 6,
        num_encoding_fn_dir: int = 4,
        include_input_xyz: bool = True,
        include_input_dir: bool = True,
        log_sampling_xyz: bool = True,
        log_sampling_dir: bool = True,
        use_viewdirs: bool = True,
        *,
        compute_dtype: torch.dtype = torch.float32,
        device: Optional[torch.device] = None,
    ):
        super().__init__()
        self.num_layers = num_layers
        self.hidden_size = hidden_size
        self.skip_step = skip_step
        self.num_encoding_fn_xyz = num_encoding_fn_xyz
        self.num_encoding_fn_dir = num_encoding_fn_dir
        self.include_input_xyz = include_input_xyz
        self.include_input_dir = include_input_dir
        self.log_sampling_xyz = log_sampling_xyz
        self.log_sampling_dir = log_sampling_dir
        self.use_viewdirs = use_viewdirs
        self.compute_dtype = compute_dtype
        encode_xyz = PositionalEncoding(num_encoding_fn_xyz, include_input_xyz, log_sampling_xyz)
        self._build(encode_xyz, encode_xyz.output_size(), compute_dtype=compute_dtype,
                    device=device)


class RotFlexibleNeRFModel(_SkipTrunkField):
    """FlexibleNeRFModel with a learned xyz encoding from get_encoding,
    at weight multiplier 8 (nerf_models.py:240-284). Outside the fused
    kernels' bound: it runs as the nn.Module."""

    def __init__(
        self,
        num_layers: int = 4,
        hidden_size: int = 128,
        skip_step: int = 4,
        num_encoding_fn_xyz: int = 64,
        num_encoding_fn_dir: int = 4,
        include_input_dir: bool = True,
        log_sampling_dir: bool = True,
        use_viewdirs: bool = True,
        encoding: str = "spatial",
        *,
        compute_dtype: torch.dtype = torch.float32,
        device: Optional[torch.device] = None,
    ):
        super().__init__()
        self.num_layers = num_layers
        self.hidden_size = hidden_size
        self.skip_step = skip_step
        self.num_encoding_fn_xyz = num_encoding_fn_xyz
        self.num_encoding_fn_dir = num_encoding_fn_dir
        self.include_input_dir = include_input_dir
        self.log_sampling_dir = log_sampling_dir
        self.use_viewdirs = use_viewdirs
        self.encoding = encoding
        self.compute_dtype = compute_dtype
        encode_xyz = get_encoding(encoding)(3, num_encoding_fn_xyz, 8,
                                            compute_dtype=compute_dtype, device=device)
        self._build(encode_xyz, encode_xyz.output_size(), compute_dtype=compute_dtype,
                    device=device)


class SimpleModel(nn.Module):
    """Learned-encoding trunk with separate colour and sigma heads and an
    optional view branch (nerf_models.py:87-125):

    enc(xyz) -> SimpleModule -> MultiSkipModule(num_layers, skip_step, skip
    enc(xyz)) -> sigma = TorchLinear(1); with directions and num_layers_view
    >= 0, MultiSkipModule(num_layers_view, skip [enc(xyz), PE(dir)]); rgb =
    sigmoid SimpleModule(3)."""

    drop_rate = 0.0  # dropout on the trunk's output in training renders

    def __init__(
        self,
        num_layers: int = 4,
        num_layers_view: int = 2,
        hidden_size: int = 128,
        num_encoding_fn_xyz: int = 128,
        num_encoding_fn_dir: int = 4,
        include_input_dir: bool = True,
        log_sampling_dir: bool = True,
        skip_step: int = 1,
        encoding: str = "spatial",
        *,
        compute_dtype: torch.dtype = torch.float32,
        device: Optional[torch.device] = None,
    ):
        super().__init__()
        self.num_layers = num_layers
        self.num_layers_view = num_layers_view
        self.hidden_size = hidden_size
        self.compute_dtype = compute_dtype
        kw = dict(compute_dtype=compute_dtype, device=device)
        self.encode_xyz = get_encoding(encoding)(3, num_encoding_fn_xyz, 8, **kw)
        self.encode_dir = PositionalEncoding(num_encoding_fn_dir, include_input_dir,
                                             log_sampling_dir)
        dim_xyz = self.encode_xyz.output_size()
        dim_dir = self.encode_dir.output_size()
        self.trunk_in = SimpleModule(dim_xyz, hidden_size, **kw)
        self.trunk = MultiSkipModule(hidden_size, dim_xyz, hidden_size, num_layers,
                                     skip_step=skip_step, **kw)
        self.fc_depth = TorchLinear(hidden_size, 1, **kw)
        self._build_heads(dim_xyz + dim_dir, kw)

    def _build_heads(self, dim_skip_view: int, kw: dict) -> None:
        h = self.hidden_size
        self.color = SimpleModule(h, 3, torch.sigmoid, **kw)
        if self.num_layers_view >= 0:
            self.view = MultiSkipModule(h, dim_skip_view, h, self.num_layers_view, **kw)

    def _trunk(self, ray_points: torch.Tensor, deterministic: bool = True,
               generator: Optional[torch.Generator] = None):
        xyz = self.encode_xyz(ray_points)
        x = self.trunk(self.trunk_in(xyz), xyz)
        if self.drop_rate and not deterministic:
            x = dropout(x, self.drop_rate, generator)
        return xyz, x

    def _view(self, xyz, x, ray_directions):
        """The view branch's output, or None without one."""
        if self.num_layers_view >= 0 and ray_directions is not None:
            xyzdir = torch.cat([xyz, self.encode_dir(ray_directions)], dim=-1)
            return self.view(x, xyzdir)
        return None

    def forward(self, ray_points: torch.Tensor,
                ray_directions: Optional[torch.Tensor] = None) -> torch.Tensor:
        xyz, x = self._trunk(ray_points)
        return self._heads(xyz, x, ray_directions)

    def _heads(self, xyz, x, ray_directions) -> torch.Tensor:
        depth = self.fc_depth(x)
        v = self._view(xyz, x, ray_directions)
        color = self.color(x if v is None else v)
        return torch.cat([color, depth], dim=-1).float()


class DropModel(SimpleModel):
    """SimpleModel with dropout at rate 0.5 on the trunk's output
    (nerf_models.py:212-237). `deterministic=False` (a training render)
    draws the keep mask from `generator` and scales the kept values by 2,
    as flax's nn.Dropout does; the mode is an argument, never
    nn.Module.training."""

    drop_rate = 0.5

    def forward(self, ray_points: torch.Tensor,
                ray_directions: Optional[torch.Tensor] = None, *,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        xyz, x = self._trunk(ray_points, deterministic, generator)
        return self._heads(xyz, x, ray_directions)


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax nn.Dropout in training: keep each value with probability 1 -
    rate, drawn from `generator` (F.dropout takes none), and divide the
    kept ones by 1 - rate, in x's dtype."""
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


class SpecularSimpleModel(SimpleModel):
    """SimpleModel with a spatial embedding, plus a specular scalar relu(tanh
    SimpleModule(1)) off the view branch, folded into the colour by a
    luminance function; returns (field, specular) (nerf_models.py:128-165).
    The specular is in the compute dtype, zeros without a view branch."""

    def __init__(
        self,
        num_layers: int = 4,
        num_layers_view: int = 2,
        hidden_size: int = 128,
        num_encoding_fn_xyz: int = 128,
        num_encoding_fn_dir: int = 4,
        include_input_dir: bool = True,
        log_sampling_dir: bool = True,
        skip_step: int = 1,
        luminance_function: str = "min1",
        *,
        compute_dtype: torch.dtype = torch.float32,
        device: Optional[torch.device] = None,
    ):
        self.luminance_function = luminance_function
        super().__init__(num_layers, num_layers_view, hidden_size, num_encoding_fn_xyz,
                         num_encoding_fn_dir, include_input_dir, log_sampling_dir, skip_step,
                         "spatial", compute_dtype=compute_dtype, device=device)

    def _build_heads(self, dim_skip_view: int, kw: dict) -> None:
        super()._build_heads(dim_skip_view, kw)
        if self.num_layers_view >= 0:
            self.specular = SimpleModule(self.hidden_size, 1, torch.tanh, **kw)

    def _heads(self, xyz, x, ray_directions):
        depth = self.fc_depth(x)
        color = self.color(x)
        specular = torch.zeros_like(depth)
        v = self._view(xyz, x, ray_directions)
        if v is not None:
            specular = torch.relu(self.specular(v))
            color = get_luminance_function(self.luminance_function)(color, specular)
        return torch.cat([color, depth], dim=-1).float(), specular


class FlatModel(nn.Module):
    """Fixed FastRotPos embedding (mult 10) -> SimpleModule -> num_layers
    SimpleModules -> relu sigma and sigmoid rgb heads (nerf_models.py:168-184)."""

    def __init__(self, hidden_size: int = 256, num_layers: int = 2,
                 num_encoding_fn_xyz: int = 128, *,
                 compute_dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.compute_dtype = compute_dtype
        kw = dict(compute_dtype=compute_dtype, device=device)
        self.encode_xyz = FastRotPos(3, num_encoding_fn_xyz, 10, **kw)
        dim = self.encode_xyz.output_size()
        self.layers = nn.ModuleList(
            [SimpleModule(dim, hidden_size, **kw)]
            + [SimpleModule(hidden_size, hidden_size, **kw) for _ in range(num_layers)])
        self.depth = SimpleModule(hidden_size, 1, **kw)
        self.color = SimpleModule(hidden_size, 3, torch.sigmoid, **kw)

    def forward(self, ray_points: torch.Tensor,
                ray_directions: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.encode_xyz(ray_points)
        for layer in self.layers:
            x = layer(x)
        return torch.cat([self.color(x), self.depth(x)], dim=-1).float()


class ResModel(nn.Module):
    """SimpleSpatialEmbedding (mult 8) -> SimpleModule -> num_layers
    bottleneck ResBlocks -> relu sigma and sigmoid rgb heads
    (nerf_models.py:187-209)."""

    def __init__(self, hidden_size: int = 128, num_layers: int = 2,
                 num_encoding_fn_xyz: int = 128, *,
                 compute_dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.compute_dtype = compute_dtype
        kw = dict(compute_dtype=compute_dtype, device=device)
        self.encode_xyz = SimpleSpatialEmbedding(3, num_encoding_fn_xyz, 8, **kw)
        self.trunk_in = SimpleModule(self.encode_xyz.output_size(), hidden_size, **kw)
        self.blocks = nn.ModuleList(ResBlock(hidden_size, hidden_size // 2, **kw)
                                    for _ in range(num_layers))
        self.depth = SimpleModule(hidden_size, 1, **kw)
        self.color = SimpleModule(hidden_size, 3, torch.sigmoid, **kw)

    def forward(self, ray_points: torch.Tensor,
                ray_directions: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.trunk_in(self.encode_xyz(ray_points))
        for block in self.blocks:
            x = block(x)
        return torch.cat([self.color(x), self.depth(x)], dim=-1).float()


MODEL_REGISTRY = {
    "FlexibleNeRFModel": FlexibleNeRFModel,
    "SimpleModel": SimpleModel,
    "SpecularSimpleModel": SpecularSimpleModel,
    "FlatModel": FlatModel,
    "ResModel": ResModel,
    "DropModel": DropModel,
    "RotFlexibleNeRFModel": RotFlexibleNeRFModel,
}


def field_of(out) -> torch.Tensor:
    """The radiance field of a model's output: the first of a (field, aux)
    tuple (SpecularSimpleModel's), else the output itself."""
    return out[0] if isinstance(out, tuple) else out


def build_model(type_name: str, model_cfg: dict, *,
                compute_dtype: torch.dtype = torch.float32,
                device: Optional[torch.device] = None) -> nn.Module:
    """Instantiate a model by config name, ignoring cfg keys the
    architecture does not take (as the JAX build_model does). An unknown
    name raises KeyError, as JAX's registry lookup does."""
    cls = MODEL_REGISTRY[type_name]
    params = inspect.signature(cls.__init__).parameters
    fields = {name for name, p in params.items()
              if p.kind == p.POSITIONAL_OR_KEYWORD and name != "self"}
    kwargs = {k: v for k, v in dict(model_cfg).items() if k in fields}
    return cls(**kwargs, compute_dtype=compute_dtype, device=device)
