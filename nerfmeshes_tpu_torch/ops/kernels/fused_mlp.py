"""Fused FlexibleNeRF MLP, forward, backward and sigma-only: the CUDA
kernels, their plain PyTorch versions, the weight packing all of them
read, the autograd Function of the training path, and the dispatch
between them.

Forward: replaces the Pallas TPU kernel `_fwd_kernel`
(nerfmeshes_tpu/ops/pallas/fused_mlp.py:387). Backward: replaces
`_bwd_kernel` (:397), the custom-vjp backward of `fused_mlp_train`
(:623-629). Both are reached through `fused_flexible_apply_rays` /
`fused_flexible_apply`. Sigma-only: replaces `_sigma_kernel` (:675), the
mesh grid's density query, reached through `fused_sigma_points`; it
reads the forward's packed weights and runs its trunk and alpha head.
The kernels are `nerfmeshes_tpu_torch/csrc/fused_mlp_{fwd,bwd}.cu` and
`csrc/fused_sigma.cu`: CUDA C++ for sm_90a, bound through ctypes
(ops/kernels/build.py).

What bounds the forward on an H100: ~1.2 MFLOP per point at lego width
(595,844 parameters per MLP) against ~44 bytes of input and output per
point, so the tensor cores and not device memory set the pace, and only
wgmma reaches their rate; next come the weights (1.19 MB in bf16, more
than a block's shared memory), read from L2 once per tile. The forward
and sigma kernels share one design (csrc/fused_field.cuh): one persistent
block per SM walks 128-point tiles; a producer warp streams every layer's
weights by TMA, in 64-column K-slabs of the packed layout, into a ring in
shared memory; two warpgroups of 64 points run each layer as wgmma on
those slabs with the sums in registers (at H = 384 and 512 both share a
64-point tile, each with half the columns; at H = 640 to 1024 a cluster of
two blocks shares it, each warpgroup with a quarter of the columns, on
32-column slabs), keep PE and activations in shared
memory and the epilogues and heads in registers. No points, PE or
activation tensor is ever written to device memory. The backward
contracts the weight grads over all points, which needs a stash of each
layer's input and output cotangent in device memory and a fixed-order
reduction: its tile kernel, which recomputes the forward and runs the dX
chain, is that same design with each activation tile sent on to the stash
by TMA stores; the dW products over the stash follow (the .cu file
describes both; `stash_layout` and `stash_store_boxes` mirror the stash
and the stores).

Numerics, shared by kernels and plain versions: bf16 operands, f32
accumulation, f32 bias/ReLU/sigmoid; an activation is rounded to bf16
only as the next product's operand (the TPU kernel's numerics). The
backward stashes activations in bf16, takes ReLU masks from the stash,
multiplies bf16 cotangents, and sums bias grads in f32.

Two routes on the card (`field_route`): the fused kernels above at the
widths of FUSED_WIDTHS (128, 256, 384) where their shared-memory plans
hold the model ("fused": at most MAX_BANDS bands and MAX_LAYERS layers, a
field_plan for each kernel), else the layer route ("layers":
ops/kernels/field_layers.py, csrc/field_layers.cu, one product kernel
launch a layer over slabs of points), which takes every model
supports_fused admits, as JAX's Pallas kernels do. The fused kernels are
instantiated at every width of HIDDEN_SIZES (up to 1024, the 2-CTA pair
plan from 640) and still take 512 to 1024 when called directly; the
route sends those widths to the layer route, which beat both plans there
(see field_route).

Dispatch: CPU tensors take `fused_mlp_plain` / `fused_mlp_bwd_plain` /
`fused_sigma_plain`, the plain versions of both routes; CUDA tensors
launch the route's kernels or raise. `launches`, `bwd_launches` and
`sigma_launches` count the fused kernels' launches and nothing else.

Training: `FusedMLPTrain` takes the f32 packed weights and biases, built
from the model's parameters by differentiable cat/pad (`pack_params`), and
casts them to bf16 inside its forward, so the weight grads reach the
f32 parameters unrounded, as JAX's custom_vjp passes them.

The TPU kernel's 128-lane layouts (comb_width, d_off, the (8, N) packed
input, the transposed heads) are TPU constraints and are not carried
over: here the PE widths are padded to multiples of 16 with zero weight
columns, and the kernels read rays directly.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from nerfmeshes_tpu_torch.models.layers import matmul_f32_acc
from nerfmeshes_tpu_torch.models.nerf_models import FlexibleNeRFModel
from nerfmeshes_tpu_torch.ops.encoding import frequency_bands, positional_encoding
from nerfmeshes_tpu_torch.ops.kernels import build

# Kernel launches since the last reset (callers may set them to 0).
launches = 0  # forward kernel
bwd_launches = 0  # backward kernel
sigma_launches = 0  # sigma-only kernel

# What the fused kernels take (csrc/fused_mlp_{fwd,bwd}.cu,
# fused_sigma.cu): a hidden width they are instantiated for (384 and 512
# run on 64-point tiles split in N, 640 to 1024 on 64-point tiles split
# across a pair of blocks as well, see csrc/fused_field.cuh), at most
# MAX_BANDS PE bands per encoding and MAX_LAYERS trunk layers (the
# descriptor holds MAX_LAYERS + 2 products), and a shared-memory plan
# (field_plan) for each of the three kernels. The route takes them at
# FUSED_WIDTHS; the layer route takes the rest (field_route).
HIDDEN_SIZES = (128, 256, 384, 512, 640, 768, 896, 1024)
# The widths field_route sends to the fused kernels: the rest of
# HIDDEN_SIZES ran faster on the layer route in every read (field_route).
FUSED_WIDTHS = (128, 256, 384)
MAX_BANDS = 24
MAX_LAYERS = 14
# Descriptor: 13 fixed ints (N_DESC_FIXED in the .cu), then the weight
# and the bias offset of each of the num_layers + 2 products.
_DESC_FIXED = 13


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclass(frozen=True)
class MLPSpec:
    """Static architecture + PE config of a viewdir FlexibleNeRFModel."""

    num_layers: int
    hidden: int
    skip_step: int
    L_x: int
    L_d: int
    include_x: bool
    include_d: bool
    log_x: bool
    log_d: bool

    @property
    def pe_x(self) -> int:
        return 6 * self.L_x + (3 if self.include_x else 0)

    @property
    def pe_d(self) -> int:
        return 6 * self.L_d + (3 if self.include_d else 0)

    @property
    def pxp(self) -> int:  # xyz PE width padded to the 16-deep product step
        return _round_up(self.pe_x, 16)

    @property
    def pdp(self) -> int:
        return _round_up(self.pe_d, 16)

    @property
    def skip_layers(self) -> tuple[int, ...]:
        return tuple(
            i for i in range(self.num_layers - 1)
            if i % self.skip_step == 0 and i > 0 and i != self.num_layers - 1
        )

    def gemm_shapes(self) -> list[tuple[int, int]]:
        """(out, in_padded) of each product: layer1, trunk 0..L-2, feat, dir."""
        H = self.hidden
        trunk = [(H, H + (self.pxp if i in self.skip_layers else 0))
                 for i in range(self.num_layers - 1)]
        return [(H, self.pxp), *trunk, (H, H), (H // 2, H + self.pdp)]


def spec_from_model(model: FlexibleNeRFModel) -> MLPSpec:
    return MLPSpec(
        num_layers=model.num_layers,
        hidden=model.hidden_size,
        skip_step=model.skip_step,
        L_x=model.num_encoding_fn_xyz,
        L_d=model.num_encoding_fn_dir,
        include_x=model.include_input_xyz,
        include_d=model.include_input_dir,
        log_x=model.log_sampling_xyz,
        log_d=model.log_sampling_dir,
    )


# field_layout's constants (csrc/fused_field.cuh, fused_mlp_bwd.cu), in
# bytes: the shared memory a block of an H100 may opt into, a swizzled
# 64-row x 64-column bf16 atom, a ring slab's K-columns, the ring's most
# stages, one warpgroup's part of the wide models' head exchange, a PeCol
# and a Desc.
SMEM_LIMIT = 232448
_ATOM = 64 * 128
_SLAB_K = 64
_MAX_STAGES = 8
_XCH_WG = 4 * 64 * 4
_PE_COL = 8
_DESC = 4 * (13 + 2 * 16 + 2 * 24)


class FieldPlan(NamedTuple):
    """A kernel's shared-memory plan: ring stages, PE tiles a warpgroup's
    arena holds, dynamic shared bytes (per block), the K-columns of a ring
    slab, and the blocks (a cluster) that share each tile."""

    stages: int
    pe_slots: int
    bytes: int
    slab_k: int = _SLAB_K
    cluster: int = 1


def params_bytes(spec: MLPSpec) -> int:
    """csrc/fused_field.cuh:params_bytes: the register design's resident
    parameters in shared memory, every packed f32 bias (the products', the
    alpha and rgb heads') and the heads' 5 H/2 bf16 weights, each part on
    16 B."""
    n_biases = sum(n for n, _ in spec.gemm_shapes()) + 4
    return _round_up(4 * n_biases, 16) + _round_up(5 * spec.hidden, 16)


def field_plan(spec: MLPSpec, kernel: str, smem_limit: int = SMEM_LIMIT) -> FieldPlan | None:
    """The plan csrc/fused_field.cuh:field_layout makes at launch for
    `kernel` ("fwd", "sigma" or "bwd", whose tile kernel adds its column
    partials), or None where it refuses: fewer than 2 ring stages. A
    mirror of the C++ (keep the two alike), so that the gate never admits
    what a launch would refuse. The forward and sigma at H <= 256 take the
    register design (field_body_regs): no activation tiles, slots of slabs
    alone, the resident parameters (params_bytes) and the PE slots' four
    barriers."""
    H = spec.hidden
    split = H > 256  # split_n: one 64-row tile that both consumer warpgroups share
    pair = H > 512  # pair_n: ... and both blocks of a cluster
    regs = not split and kernel != "bwd"
    cluster, slab_k = (2, 32) if pair else (1, _SLAB_K)
    tiles = 1 if split else 2
    params = 0 if regs else (2048 if H <= 256 else _round_up(6 * H, 1024))
    slot = slab_k * (H // cluster) * 2 + params
    pe_cols = spec.pxp + (spec.pdp if kernel != "sigma" else 0)
    act = 0 if regs else tiles * (H // 64) * _ATOM
    wg_cols = H // (2 * cluster) if split else H
    extra = (params_bytes(spec) if regs
             else 2 * 4 * (wg_cols + 4) * 4 if kernel == "bwd" else 0)
    xch = 2 * cluster * _XCH_WG if split else 0
    bars = (2 * _MAX_STAGES + (2 if pair else 0) + (4 if regs else 0)) * 8
    aux = xch + bars + pe_cols * _PE_COL + _DESC
    for pe_slots in (2, 1):
        pe = tiles * (_round_up(pe_slots * pe_cols, 64) // 64) * _ATOM
        # a pair with one PE tile keeps the backward's column partials in it
        own = 0 if pair and pe_slots == 1 and 0 < extra <= pe else extra
        stages = (smem_limit - act - pe - own - aux) // slot
        if stages >= pe_slots + 1:
            stages = min(stages, _MAX_STAGES)
            return FieldPlan(stages, pe_slots, stages * slot + act + pe + own + aux, slab_k,
                             cluster)
    return None


def supports_fused(model) -> bool:
    """JAX's predicate (nerfmeshes_tpu/ops/pallas/fused_mlp.py:750-761):
    the viewdir FlexibleNeRF models of a hidden width that is a multiple
    of 128 with at least one PE band per encoding. The card runs each
    through hand-written kernels, fused or a layer at a time
    (field_route); other models run through the nn.Module."""
    return (
        isinstance(model, FlexibleNeRFModel)
        and model.use_viewdirs
        and model.hidden_size % 128 == 0
        and model.num_encoding_fn_xyz > 0
        and model.num_encoding_fn_dir > 0
    )


@functools.cache
def field_route(spec: MLPSpec) -> str:
    """"fused" where the fused kernels take the model and beat the layer
    route (a width of FUSED_WIDTHS, at most MAX_BANDS bands per encoding
    and MAX_LAYERS layers, and a shared-memory plan for each of the
    forward, sigma and backward kernels), else "layers"
    (csrc/field_layers.cu).

    Why 512 to 1024 go to the layer route although the fused kernels take
    them: timed in turns on one card (scripts/torch_route_compare.py, 8
    layers at L 10/4; NVIDIA H100 80GB HBM3, 700.00 W), the layer route
    was faster in every read, the forward at 2048 x 64 and 2048 x 192, the
    backward at 2048 x 192 and sigma at 262,144 points: 1.12-1.32x the
    split plan at 512, 1.46-1.57x the pair plan at 640, 1.68-1.93x at 768,
    1.92-2.47x at 896 and 2.04-2.51x at 1024. At 384 the split plan won
    the forward (1.22-1.29x) and sigma (1.19x), the layer route only the
    backward (1.10x), so 384 stays fused (there a layer's product moves
    its activations through device memory at H/2 = 192 FLOP a byte, under
    the card's ~295: bytes bound)."""
    if (spec.hidden in FUSED_WIDTHS and spec.L_x <= MAX_BANDS and spec.L_d <= MAX_BANDS
            and spec.num_layers <= MAX_LAYERS
            and all(field_plan(spec, k) is not None for k in ("fwd", "sigma", "bwd"))):
        return "fused"
    return "layers"


class PackedMLP(NamedTuple):
    """A model's weights in the kernel's layout, plus its descriptor.

    weights: flat, per product (layer1, trunk 0..L-2, feat, dir) the
    (out, in_padded) matrix row-major, then the alpha row and the rgb
    matrix; bf16 for the kernels (pack_weights), f32 for training
    (pack_params). biases: flat f32 in the same order. desc/freqs: host
    arrays the C entry points read (layout in csrc/fused_mlp_common.cuh)."""

    spec: MLPSpec
    weights: torch.Tensor
    biases: torch.Tensor
    desc: np.ndarray
    freqs: np.ndarray

    def gemm(self, g: int, n: int, k: int, weights: torch.Tensor | None = None,
             biases: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """(weight (n, k), bias (n,)) of product g, as views of this pack's
        buffers or of `weights` / `biases` laid out alike (grads)."""
        weights = self.weights if weights is None else weights
        biases = self.biases if biases is None else biases
        n_gemms = self.spec.num_layers + 2
        w_off = int(self.desc[_DESC_FIXED + g])
        b_off = int(self.desc[_DESC_FIXED + n_gemms + g])
        return weights[w_off:w_off + n * k].view(n, k), biases[b_off:b_off + n]

    def segments(self, weights: torch.Tensor | None = None,
                 biases: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
        """Every weight and bias of the pack by name ("w0", "b0", ... per
        product, then "wa", "ba", "wr", "br"), views as in `gemm`."""
        out = {}
        for g, (n, k) in enumerate(self.spec.gemm_shapes()):
            out[f"w{g}"], out[f"b{g}"] = self.gemm(g, n, k, weights, biases)
        out["wa"], out["ba"], out["wr"], out["br"] = self.heads(weights, biases)
        return out

    def heads(self, weights: torch.Tensor | None = None, biases: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """(alpha weight (1, H), alpha bias (1,), rgb weight (3, H/2), rgb
        bias (3,)), views as in `gemm`."""
        weights = self.weights if weights is None else weights
        biases = self.biases if biases is None else biases
        H = self.spec.hidden
        wa_off, ba_off, wr_off, br_off = (int(v) for v in self.desc[9:13])
        return (weights[wa_off:wa_off + H].view(1, H),
                biases[ba_off:ba_off + 1],
                weights[wr_off:wr_off + 3 * (H // 2)].view(3, H // 2),
                biases[br_off:br_off + 3])


def _pad_cols(w: torch.Tensor, width: int) -> torch.Tensor:
    return F.pad(w, (0, width - w.shape[1]))


def pack_params(model: FlexibleNeRFModel) -> PackedMLP:
    """Pack an eligible model's nn.Linear parameters into the kernel
    layout (both routes read it), in f32 and on the model's device. Built
    by cat/pad, so under autograd the packed buffers' grads flow back to
    the parameters (the padding columns' grads are dropped)."""
    if not supports_fused(model):
        raise ValueError("model is outside the fused kernel's bound (supports_fused)")
    spec = spec_from_model(model)
    H = spec.hidden
    mats = [_pad_cols(model.layer1.weight, spec.pxp)]
    vecs = [model.layer1.bias]
    for i, layer in enumerate(model.layers_xyz):
        w = layer.weight
        if i in spec.skip_layers:  # [x | PE(xyz)] columns, PE part padded
            w = torch.cat([w[:, :H], _pad_cols(w[:, H:], spec.pxp)], dim=1)
        mats.append(w)
        vecs.append(layer.bias)
    mats.append(model.fc_feat.weight)
    vecs.append(model.fc_feat.bias)
    wd = model.layers_dir[0].weight  # [feat | PE(dir)] columns
    mats.append(torch.cat([wd[:, :H], _pad_cols(wd[:, H:], spec.pdp)], dim=1))
    vecs.append(model.layers_dir[0].bias)

    w_offs = np.cumsum([0] + [m.numel() for m in mats]).tolist()
    b_offs = np.cumsum([0] + [v.numel() for v in vecs]).tolist()
    wa_off, ba_off = w_offs[-1], b_offs[-1]
    wr_off, br_off = wa_off + H, ba_off + 1
    weights = torch.cat(
        [m.reshape(-1) for m in mats]
        + [model.fc_alpha.weight.reshape(-1), model.fc_rgb.weight.reshape(-1)]
    ).float()
    biases = torch.cat(vecs + [model.fc_alpha.bias, model.fc_rgb.bias]).float()
    # The fused kernels' skip bits (at most MAX_LAYERS layers); the layer
    # route reads each product's K off the offsets instead.
    skip_mask = sum(1 << i for i in spec.skip_layers if i < 31)
    desc = np.asarray(
        [spec.num_layers, H, skip_mask, spec.L_x, spec.L_d, int(spec.include_x),
         int(spec.include_d), spec.pxp, spec.pdp, wa_off, ba_off, wr_off, br_off]
        + w_offs[:-1] + b_offs[:-1],
        dtype=np.int32,
    )
    freqs = np.concatenate(
        [frequency_bands(spec.L_x, spec.log_x), frequency_bands(spec.L_d, spec.log_d)]
    ).astype(np.float32)
    return PackedMLP(spec, weights.contiguous(), biases.contiguous(), desc, freqs)


@torch.no_grad()
def pack_weights(model: FlexibleNeRFModel) -> PackedMLP:
    """The kernels' packing: pack_params with the weights in bf16."""
    packed = pack_params(model)
    return packed._replace(weights=packed.weights.to(torch.bfloat16).contiguous())


def _padded_pe(x: torch.Tensor, L: int, include: bool, log: bool, width: int) -> torch.Tensor:
    return _pad_cols(positional_encoding(x, L, include, log), width)


def _check_rays(origins, directions, z_vals):
    if z_vals.dim() != 2:
        raise ValueError(f"z_vals must be (R, S), got {tuple(z_vals.shape)}")
    R = z_vals.shape[0]
    for name, t in (("origins", origins), ("directions", directions)):
        if tuple(t.shape) != (R, 3):
            raise ValueError(f"{name} must be ({R}, 3), got {tuple(t.shape)}")
        if t.device != z_vals.device:
            raise ValueError(f"{name} on {t.device}, z_vals on {z_vals.device}")


def _layout(out_n4: torch.Tensor, R: int, S: int, channels_first: bool) -> torch.Tensor:
    if channels_first:
        return out_n4.t().reshape(4, R, S)
    return out_n4.reshape(R, S, 4)


def _layer(packed: PackedMLP, a: torch.Tensor, g: int, n: int, relu: bool) -> torch.Tensor:
    """Product g on bf16 operands with an f32 sum, then f32 bias (+ ReLU)."""
    w, b = packed.gemm(g, n, a.shape[1])
    y = matmul_f32_acc(a, w, torch.bfloat16) + b
    return y.clamp_min(0.0) if relu else y


def _trunk_alpha_plain(packed: PackedMLP, pe_x: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """layer1 + trunk on the padded PE(xyz), then the alpha head: (trunk
    output (N, H) f32, raw sigma (N, 1) f32). The forward and the sigma
    plain versions share it, as the kernels share trunk_forward."""
    spec = packed.spec
    bf16 = torch.bfloat16
    x = _layer(packed, pe_x, 0, spec.hidden, relu=False)
    for i in range(spec.num_layers - 1):
        a = torch.cat([x.to(bf16), pe_x.to(bf16)], dim=1) if i in spec.skip_layers else x
        x = _layer(packed, a, 1 + i, spec.hidden, relu=True)
    wa, ba, _, _ = packed.heads()
    return x, matmul_f32_acc(x, wa, bf16) + ba


def fused_mlp_plain(packed: PackedMLP, origins: torch.Tensor, directions: torch.Tensor,
                    z_vals: torch.Tensor, *, channels_first: bool = True) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on the same packed weights and
    with the same numerics. o, d (R, 3), z (R, S) -> (4, R, S) or (R, S, 4)."""
    _check_rays(origins, directions, z_vals)
    spec = packed.spec
    H, L = spec.hidden, spec.num_layers
    bf16 = torch.bfloat16
    R, S = z_vals.shape
    o, d, z = origins.float(), directions.float(), z_vals.float()
    pts = (o[:, None, :] + d[:, None, :] * z[..., None]).reshape(-1, 3)
    dirs = d[:, None, :].expand(R, S, 3).reshape(-1, 3)
    pe_x = _padded_pe(pts, spec.L_x, spec.include_x, spec.log_x, spec.pxp)
    pe_d = _padded_pe(dirs, spec.L_d, spec.include_d, spec.log_d, spec.pdp)

    x, alpha = _trunk_alpha_plain(packed, pe_x)
    _, _, wr, br = packed.heads()
    feat = _layer(packed, x, L, H, relu=True)
    h = _layer(packed, torch.cat([feat.to(bf16), pe_d.to(bf16)], dim=1), L + 1, H // 2,
               relu=True)
    rgb = torch.sigmoid(matmul_f32_acc(h, wr, bf16) + br)
    return _layout(torch.cat([rgb, alpha], dim=1), R, S, channels_first)


def fused_mlp_cuda(packed: PackedMLP, origins: torch.Tensor, directions: torch.Tensor,
                   z_vals: torch.Tensor, *, channels_first: bool = True,
                   lib=None) -> torch.Tensor:
    """Launch the CUDA kernel. o, d (R, 3), z (R, S) f32 on one CUDA device
    -> (4, R, S) or (R, S, 4) f32. `lib`: the kernel library (default this
    tree's build; another checkout's build has the same C contract)."""
    global launches
    _check_rays(origins, directions, z_vals)
    device = z_vals.device
    if device.type != "cuda":
        raise ValueError(f"fused_mlp_cuda needs CUDA tensors, got {device}")
    for name, t in (("weights", packed.weights), ("biases", packed.biases)):
        if t.device != device:
            raise ValueError(f"packed {name} on {t.device}, rays on {device}")
    R, S = z_vals.shape
    o = origins.float().contiguous()
    d = directions.float().contiguous()
    z = z_vals.float().contiguous()
    # Contiguous (4, R, S) / (R, S, 4): the kernel's (4, N) / (N, 4) rows.
    out = torch.empty((4, R, S) if channels_first else (R, S, 4),
                      dtype=torch.float32, device=device)
    if R * S == 0:
        return out
    lib = lib or build.load_library()
    with torch.cuda.device(device):
        rc = lib.nm_fused_mlp_fwd(
            o.data_ptr(), d.data_ptr(), z.data_ptr(), R, S,
            packed.weights.data_ptr(), packed.biases.data_ptr(),
            packed.desc.ctypes.data, packed.desc.size,
            packed.freqs.ctypes.data, packed.freqs.size,
            out.data_ptr(), int(channels_first),
            torch.cuda.current_stream(device).cuda_stream,
        )
    build.check(lib, rc, "fused_mlp_fwd launch")
    launches += 1
    return out


def _layers():
    # The layer route's module imports this one.
    from nerfmeshes_tpu_torch.ops.kernels import field_layers

    return field_layers


def fused_mlp_rays(packed: PackedMLP, origins: torch.Tensor, directions: torch.Tensor,
                   z_vals: torch.Tensor, *, channels_first: bool = True) -> torch.Tensor:
    """The field of the packed MLP at o + d*z: CPU tensors take the plain
    version, CUDA tensors the kernels of the model's route."""
    kind = z_vals.device.type
    if kind == "cpu":
        return fused_mlp_plain(packed, origins, directions, z_vals,
                               channels_first=channels_first)
    if kind == "cuda":
        launch = (fused_mlp_cuda if field_route(packed.spec) == "fused"
                  else _layers().layers_mlp_cuda)
        return launch(packed, origins, directions, z_vals, channels_first=channels_first)
    raise ValueError(f"no fused MLP for {kind} tensors")


def _check_points(points: torch.Tensor) -> None:
    if points.dim() != 2 or points.shape[1] != 3:
        raise ValueError(f"points must be (N, 3), got {tuple(points.shape)}")


def fused_sigma_plain(packed: PackedMLP, points: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the sigma kernel: the forward's trunk and
    alpha head on PE(points), with the forward's numerics. (N, 3) -> (N,)
    f32 raw sigma (before any ReLU)."""
    _check_points(points)
    spec = packed.spec
    pe_x = _padded_pe(points.float(), spec.L_x, spec.include_x, spec.log_x, spec.pxp)
    return _trunk_alpha_plain(packed, pe_x)[1][:, 0]


def fused_sigma_cuda(packed: PackedMLP, points: torch.Tensor, *, lib=None) -> torch.Tensor:
    """Launch the sigma kernel (csrc/fused_sigma.cu). (N, 3) f32 on one CUDA
    device -> (N,) f32. `lib` as fused_mlp_cuda's."""
    global sigma_launches
    _check_points(points)
    device = points.device
    if device.type != "cuda":
        raise ValueError(f"fused_sigma_cuda needs CUDA tensors, got {device}")
    for name, t in (("weights", packed.weights), ("biases", packed.biases)):
        if t.device != device:
            raise ValueError(f"packed {name} on {t.device}, points on {device}")
    if packed.weights.dtype != torch.bfloat16:
        raise ValueError(f"packed weights must be bf16, got {packed.weights.dtype}")
    p = points.float().contiguous()
    out = torch.empty(p.shape[0], dtype=torch.float32, device=device)
    if p.shape[0] == 0:
        return out
    lib = lib or build.load_library()
    with torch.cuda.device(device):
        rc = lib.nm_fused_sigma(
            p.data_ptr(), p.shape[0], packed.weights.data_ptr(), packed.biases.data_ptr(),
            packed.desc.ctypes.data, packed.desc.size,
            packed.freqs.ctypes.data, packed.freqs.size,
            out.data_ptr(), torch.cuda.current_stream(device).cuda_stream,
        )
    build.check(lib, rc, "fused_sigma launch")
    sigma_launches += 1
    return out


@torch.no_grad()
def fused_sigma_points(packed_or_model: PackedMLP | FlexibleNeRFModel,
                       points: torch.Tensor) -> torch.Tensor:
    """Raw sigma of the field at (..., 3) points -> (...,) f32, the
    counterpart of JAX's fused_sigma_points (inference only: JAX stops the
    gradient, here no graph is built). CPU tensors take the plain version,
    CUDA tensors the kernels of the model's route."""
    packed = (packed_or_model if isinstance(packed_or_model, PackedMLP)
              else pack_weights(packed_or_model))
    flat = points.reshape(-1, 3)
    kind = flat.device.type
    if kind == "cpu":
        out = fused_sigma_plain(packed, flat)
    elif kind == "cuda":
        launch = (fused_sigma_cuda if field_route(packed.spec) == "fused"
                  else _layers().layers_sigma_cuda)
        out = launch(packed, flat)
    else:
        raise ValueError(f"no fused sigma for {kind} tensors")
    return out.reshape(points.shape[:-1])


def _check_grad(grad: torch.Tensor, z_vals: torch.Tensor) -> None:
    want = (4, *z_vals.shape)
    if tuple(grad.shape) != want:
        raise ValueError(f"grad must be {want} (channels-first), got {tuple(grad.shape)}")
    if grad.device != z_vals.device:
        raise ValueError(f"grad on {grad.device}, z_vals on {z_vals.device}")


def fused_mlp_bwd_plain(packed: PackedMLP, origins: torch.Tensor, directions: torch.Tensor,
                        z_vals: torch.Tensor, grad: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernel, with _bwd_kernel's
    numerics (nerfmeshes_tpu/ops/pallas/fused_mlp.py:397-529), not
    autograd's: activations stashed in bf16, ReLU masks from the stash,
    every product on bf16 operands (the cotangents too) with f32 sums,
    bias grads summed in f32 from the f32 cotangent, sigmoid' from the
    recomputed rgb.

    grad: the (4, R, S) cotangent of the channels-first forward output.
    Returns f32 grads (dW, dB) laid out as packed.weights / packed.biases."""
    _check_rays(origins, directions, z_vals)
    _check_grad(grad, z_vals)
    spec = packed.spec
    H, L = spec.hidden, spec.num_layers
    bf16 = torch.bfloat16
    R, S = z_vals.shape

    def rnd(t):  # the bf16 operand, in f32 (bf16 x bf16 products are exact in f32)
        return t.to(bf16).float()

    def dw(dy, x):  # dY^T X over points: the (out, in) weight grad
        return rnd(dy).t() @ rnd(x)

    def dx(dy, w):  # dY W: the grad of the layer's input
        return rnd(dy) @ rnd(w)

    o, d, z = origins.float(), directions.float(), z_vals.float()
    pts = (o[:, None, :] + d[:, None, :] * z[..., None]).reshape(-1, 3)
    dirs = d[:, None, :].expand(R, S, 3).reshape(-1, 3)
    pe_x = rnd(_padded_pe(pts, spec.L_x, spec.include_x, spec.log_x, spec.pxp))
    pe_d = rnd(_padded_pe(dirs, spec.L_d, spec.include_d, spec.log_d, spec.pdp))

    # Forward recompute; xs[i] is trunk layer i's input (bf16 stash), xs[-1]
    # the trunk output.
    def skip_input(x, i):
        return torch.cat([x, pe_x], dim=1) if i in spec.skip_layers else x

    xs = [rnd(_layer(packed, pe_x, 0, H, relu=False))]
    for i in range(L - 1):
        xs.append(rnd(_layer(packed, skip_input(xs[-1], i), 1 + i, H, relu=True)))
    trunk_out = xs[-1]
    feat = rnd(_layer(packed, trunk_out, L, H, relu=True))
    dir_in = torch.cat([feat, pe_d], dim=1)
    h = rnd(_layer(packed, dir_in, L + 1, H // 2, relu=True))
    wa, _, wr, br = packed.heads()
    rgb = torch.sigmoid(matmul_f32_acc(h, wr, bf16) + br)

    dW = torch.zeros(packed.weights.shape, dtype=torch.float32, device=z.device)
    dB = torch.zeros(packed.biases.shape, dtype=torch.float32, device=z.device)
    g = grad.float().reshape(4, -1).t()
    drgb = g[:, :3] * rgb * (1.0 - rgb)
    dalpha = g[:, 3:]
    dwa, dba, dwr, dbr = packed.heads(dW, dB)
    dwr.copy_(dw(drgb, h))
    dbr.copy_(drgb.sum(0))
    dwa.copy_(dw(dalpha, trunk_out))
    dba.copy_(dalpha.sum(0))

    def grads_of(gi, dy, x):
        w_grad, b_grad = packed.gemm(gi, dy.shape[1], x.shape[1], dW, dB)
        w_grad.copy_(dw(dy, x))
        b_grad.copy_(dy.sum(0))
        return packed.gemm(gi, dy.shape[1], x.shape[1])[0][:, :H]  # the x part of W

    dh = dx(drgb, wr) * (h > 0)
    df = dx(dh, grads_of(L + 1, dh, dir_in)) * (feat > 0)
    dy = dx(df, grads_of(L, df, trunk_out)) + dx(dalpha, wa)
    if L >= 2:
        dy = dy * (trunk_out > 0)
    for i in reversed(range(L - 1)):
        dy = dx(dy, grads_of(1 + i, dy, skip_input(xs[i], i)))
        if i > 0:
            dy = dy * (xs[i] > 0)
    grads_of(0, dy, pe_x)
    return dW, dB


def fused_mlp_bwd_cuda(packed: PackedMLP, origins: torch.Tensor, directions: torch.Tensor,
                       z_vals: torch.Tensor, grad: torch.Tensor, *, lib=None,
                       workspace: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the backward kernel (csrc/fused_mlp_bwd.cu). o, d (R, 3),
    z (R, S), grad (4, R, S) f32 on one CUDA device -> f32 (dW, dB).
    `lib`: the kernel library (default this tree's build; another
    checkout's build has the same C contract). `workspace`: uint8 device
    memory of at least bwd_workspace_bytes, which the call leaves holding
    the stash (stash_layout), else a fresh one."""
    global bwd_launches
    _check_rays(origins, directions, z_vals)
    _check_grad(grad, z_vals)
    device = z_vals.device
    if device.type != "cuda":
        raise ValueError(f"fused_mlp_bwd_cuda needs CUDA tensors, got {device}")
    for name, t in (("weights", packed.weights), ("biases", packed.biases)):
        if t.device != device:
            raise ValueError(f"packed {name} on {t.device}, rays on {device}")
    if packed.weights.dtype != torch.bfloat16:
        raise ValueError(f"packed weights must be bf16, got {packed.weights.dtype}")
    R, S = z_vals.shape
    dW = torch.zeros(packed.weights.shape, dtype=torch.float32, device=device)
    dB = torch.zeros(packed.biases.shape, dtype=torch.float32, device=device)
    if R * S == 0:
        return dW, dB
    o = origins.float().contiguous()
    d = directions.float().contiguous()
    z = z_vals.float().contiguous()
    g = grad.float().contiguous()
    lib = lib or build.load_library()
    nbytes = bwd_workspace_bytes(packed, R * S, lib)
    if workspace is None:
        workspace = torch.empty(nbytes, dtype=torch.uint8, device=device)
    elif (workspace.device != device or workspace.dtype != torch.uint8
          or not workspace.is_contiguous() or workspace.numel() < nbytes):
        raise ValueError(f"workspace must be {nbytes} contiguous uint8 bytes on {device}")
    with torch.cuda.device(device):
        rc = lib.nm_fused_mlp_bwd(
            o.data_ptr(), d.data_ptr(), z.data_ptr(), R, S, g.data_ptr(),
            packed.weights.data_ptr(), packed.biases.data_ptr(),
            packed.desc.ctypes.data, packed.desc.size,
            packed.freqs.ctypes.data, packed.freqs.size,
            workspace.data_ptr(), workspace.numel(), dW.data_ptr(), dB.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    build.check(build.load_library(), rc, "fused_mlp_bwd launch")
    bwd_launches += 1
    return dW, dB


def bwd_workspace_bytes(packed: PackedMLP, n_pts: int, lib=None) -> int:
    """Bytes of device workspace the backward kernel takes for n_pts
    points (nm_fused_mlp_bwd_workspace of `lib`, default this tree's)."""
    lib = lib or build.load_library()
    nbytes = ctypes.c_longlong(0)
    rc = lib.nm_fused_mlp_bwd_workspace(packed.desc.ctypes.data, packed.desc.size,
                                        packed.freqs.ctypes.data, packed.freqs.size,
                                        n_pts, ctypes.byref(nbytes))
    build.check(build.load_library(), rc, "fused_mlp_bwd workspace")
    return nbytes.value


def stash_layout(spec: MLPSpec, n_pad: int) -> dict[str, int]:
    """The backward's bf16 stash (csrc/fused_mlp_bwd.cuh:stash_layout):
    each region's offset in bf16 elements from the workspace's start, and
    "end". Row-major regions of n_pad rows: pe (pxp + pdp columns), act (L
    x H: layer1's and the trunk layers' outputs), feat (H), h (H/2), dy
    ((L + 1) x H: the output cotangents of layer1, the trunk and feat),
    dy_dir (H/2), dy_a and dy_rgb (16 each)."""
    H, L = spec.hidden, spec.num_layers
    widths = {"pe": spec.pxp + spec.pdp, "act": H * L, "feat": H, "h": H // 2,
              "dy": H * (L + 1), "dy_dir": H // 2, "dy_a": 16, "dy_rgb": 16}
    out, at = {}, 0
    for name, width in widths.items():
        out[name] = at
        at += n_pad * width
    out["end"] = at
    return out


def stash_maps(spec: MLPSpec, n_pad: int) -> dict[str, tuple[int, int, int]]:
    """The tile kernel's tensor maps over the stash that its TMA stores
    write (csrc/fused_mlp_bwd.cuh:launch_tiles): name -> (first element,
    row width, rows). "act" covers act and feat, whose rows follow act's."""
    H, L = spec.hidden, spec.num_layers
    st = stash_layout(spec, n_pad)
    return {"act": (st["act"], H, (L + 1) * n_pad), "dy": (st["dy"], H, (L + 1) * n_pad),
            "dy_dir": (st["dy_dir"], H // 2, n_pad)}


def stash_store_boxes(spec: MLPSpec, n_pad: int, tile: int) -> list[tuple[str, int, int]]:
    """The TMA stores bwd_tile_kernel issues for tile `tile` (of 128 points
    at H <= 256, else 64) as (map of stash_maps, first column, first row)
    of 64 x 64 boxes, one per 128 B swizzled atom of the activation tile,
    each sending thread's in the order it issues them: after each forward
    epilogue the tile's H columns to act[g] (feat at g = L), after the dir
    layer's the H/2 of dy_dir, after each dX epilogue the H to dy[g], g = L
    down to 0. Each warpgroup sends its own 64 rows; where the warpgroups
    share a 64-row tile one thread sends it, and in a pair (H > 512) each
    block its half of the atoms."""
    H, L = spec.hidden, spec.num_layers
    split, pair = H > 256, H > 512
    rows = 64 if split else 128
    boxes = []
    for row0 in range(tile * rows, (tile + 1) * rows, 64):
        for rank in range(2 if pair else 1):
            def atoms(n):
                share = (n + 1) // 2 if pair else n
                return range(rank * share, min(n, (rank + 1) * share))

            for g in range(L + 1):
                boxes += [("act", 64 * i, g * n_pad + row0) for i in atoms(H // 64)]
            boxes += [("dy_dir", 64 * i, row0) for i in atoms(H // 128)]
            for g in reversed(range(L + 1)):
                boxes += [("dy", 64 * i, g * n_pad + row0) for i in atoms(H // 64)]
    return boxes


def fused_mlp_bwd(packed: PackedMLP, origins: torch.Tensor, directions: torch.Tensor,
                  z_vals: torch.Tensor, grad: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Weight and bias grads of the packed MLP's field at o + d*z for the
    cotangent `grad`: CPU tensors take the plain version, CUDA tensors the
    kernels of the model's route."""
    kind = z_vals.device.type
    if kind == "cpu":
        return fused_mlp_bwd_plain(packed, origins, directions, z_vals, grad)
    if kind == "cuda":
        launch = (fused_mlp_bwd_cuda if field_route(packed.spec) == "fused"
                  else _layers().layers_bwd_cuda)
        return launch(packed, origins, directions, z_vals, grad)
    raise ValueError(f"no fused MLP backward for {kind} tensors")


class FusedMLPTrain(torch.autograd.Function):
    """The training field: forward through the forward kernels, backward
    through the backward kernels of the model's route (the counterpart of
    JAX's custom-vjp `fused_mlp_train`). Differentiable in the f32 packed
    weights and biases only; rays get no grad (samples are detached
    upstream)."""

    @staticmethod
    def forward(ctx, weights, biases, meta, origins, directions, z_vals):
        spec, desc, freqs = meta
        packed = PackedMLP(spec, weights.to(torch.bfloat16).contiguous(),
                           biases.contiguous(), desc, freqs)
        ctx.meta = meta
        ctx.save_for_backward(packed.weights, packed.biases, origins, directions, z_vals)
        return fused_mlp_rays(packed, origins, directions, z_vals)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        weights, biases, origins, directions, z_vals = ctx.saved_tensors
        spec, desc, freqs = ctx.meta
        packed = PackedMLP(spec, weights, biases, desc, freqs)
        dW, dB = fused_mlp_bwd(packed, origins, directions, z_vals, grad)
        return dW, dB, None, None, None, None


def fused_flexible_apply_rays(model: FlexibleNeRFModel, origins: torch.Tensor,
                              directions: torch.Tensor, z_vals: torch.Tensor, *,
                              inference: bool = False) -> torch.Tensor:
    """The field straight from rays: o, d (R, 3), z (R, S) ->
    CHANNELS-FIRST (4, R, S) (feed volume_render(channels_first=True)).
    `inference=True` runs the forward kernel without autograd; the default
    is the training Function, differentiable in the model's parameters."""
    if inference:
        with torch.no_grad():
            return fused_mlp_rays(pack_weights(model), origins, directions, z_vals)
    packed = pack_params(model)
    return FusedMLPTrain.apply(packed.weights, packed.biases,
                               (packed.spec, packed.desc, packed.freqs),
                               origins, directions, z_vals)


@torch.no_grad()
def fused_flexible_apply(model: FlexibleNeRFModel, ray_points: torch.Tensor,
                         ray_directions: torch.Tensor) -> torch.Tensor:
    """Inference drop-in for model(points, dirs) -> (..., 4). Directions may
    have one fewer batch dim than the points (one per ray). Each point is
    a ray with origin at the point and one sample at z = 0."""
    pts = ray_points.reshape(-1, 3)
    if ray_directions.dim() == ray_points.dim() - 1:
        dirs = ray_directions[..., None, :].expand(ray_points.shape)
    else:
        dirs = ray_directions
    dirs = dirs.reshape(-1, 3)
    z = torch.zeros((pts.shape[0], 1), dtype=torch.float32, device=pts.device)
    out = fused_mlp_rays(pack_weights(model), pts, dirs, z, channels_first=False)
    return out.reshape(*ray_points.shape[:-1], 4)
