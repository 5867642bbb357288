"""The FlexibleNeRF field a layer at a time: the route the card takes for
every model that supports_fused admits and fused_mlp.field_route does not
send to the fused kernels (hidden widths from 512 on, where this route
beat the fused plans in turns on an H100; more than 24 bands, more than 14
layers; a 128-384-wide field whose fused plans refuse it). JAX runs such
models through its Pallas kernels `_fwd_kernel`
(nerfmeshes_tpu/ops/pallas/fused_mlp.py:387), `_sigma_kernel` (:675) and
`_bwd_kernel` (:397); this module's wrappers launch their counterparts,
csrc/field_layers.cu (CUDA C++ for sm_90a, bound through ctypes): a PE
kernel, one product kernel launch per layer (persistent, warp-specialised
wgmma on TMA-staged tiles, bias / ReLU / mask epilogues staged in shared
memory and stored by TMA; `product_plan` mirrors its shared-memory plan,
`product_tiles` its tile walk), a heads kernel, and for the backward its
own heads kernel (one pass over h a block of points), a persistent dW
kernel (a CTA per SM over the 128 x 256 blocks of dW a point range,
range by range: the whole waves at 256 columns, the last wave's blocks in
128- or 64-column pieces across the SMs, so that dW keeps its bits:
`dw_groups` mirrors its ranges, `dw_plan` / `dw_walk` its launches and
walk) with the fixed-order reduction of its range partials
(csrc/dw_leg.cuh), and one reduction of every bias grad a slab
(`bias_segments`, `bias_scratch`).

What bounds it on an H100: each product moves its bf16 activations
through device memory, H/2 FLOP per byte, above the card's ~295 FLOP/B
from H ~ 600 on, so the tensor cores can still set the pace where the
fused design's 64 x H activation tile no longer fits a block; the heads
and the reductions move bytes and do next to no arithmetic.

Points go through in slabs (`slab_points`) whose workspace stays under
LAYER_WORKSPACE_BOUND (`workspace_layout` / `workspace_bytes`, a mirror
of the C layout: keep the two alike), whatever R x S is: at 2048 wide a
mesh appearance chunk of 65,536 x 192 points would need 51.5 GB for one
activation buffer. `slab_launches` / `call_launches` mirror the launches
a slab and a call make, kernel by kernel.

The plain versions are fused_mlp's (`fused_mlp_plain`, `fused_sigma_plain`,
`fused_mlp_bwd_plain`): the same packed weights and numerics. The
wrappers here take CUDA tensors only and raise on others; fused_mlp's
dispatch sends CPU tensors to the plain versions. `launches`,
`sigma_launches` and `bwd_launches` count calls of the route's forward,
sigma and backward; `kernel_launches` each of its kernels' launches in
those calls; a list put in `call_log` records each call's spec, kind and
points (against which `call_launches` predicts kernel_launches). The PE,
product, backward heads, bias-grad and dW kernels alone (`layers_pe_cuda`,
`layers_product_cuda`, `layers_heads_bwd_cuda`, `layers_bias_cuda`,
`layers_dw_cuda` on a weight matrix's jobs, `route_dw_jobs`) are for their
checks, beside their plain versions (`layers_bias_launcher`,
`layers_dw_launcher`: a launch alone, to time it).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from nerfmeshes_tpu_torch.models.layers import matmul_f32_acc
from nerfmeshes_tpu_torch.ops.kernels import build
from nerfmeshes_tpu_torch.ops.kernels.fused_mlp import (
    SMEM_LIMIT,
    MLPSpec,
    PackedMLP,
    _check_grad,
    _check_points,
    _check_rays,
    _padded_pe,
)

# Calls of the route's forward, sigma and backward since the last reset
# (callers may set them to 0), and each kernel's launches in those calls.
launches = 0
sigma_launches = 0
bwd_launches = 0
# "heads" is the forward's and sigma's heads kernel, "heads_bwd" the
# backward's (csrc/field_layers.cu:Counter, in its order).
KERNELS = ("pe", "product", "heads", "dw", "reduce", "bias", "heads_bwd")
kernel_launches = dict.fromkeys(KERNELS, 0)
# A list to record (spec, kind, points) of every route call in, or None.
call_log = None

# The workspace a call may take: its slabs of points are planned under it.
LAYER_WORKSPACE_BOUND = 2 << 30
KINDS = {"fwd": 0, "sigma": 1, "bwd": 2}

# csrc/field_layers.cu's constants: points per product tile (the slab's
# step), points per heads block, the heads' cotangent rows, a PE column's
# table entry, the dW units a weight matrix's point ranges aim at and its
# most ranges (csrc/fused_mlp_bwd.cuh:DW_RANGES), a dW unit's columns and
# its last wave's narrowest piece; and the SMs dw_plan assumes (an
# H100's).
_ROWS = 128
_HEAD_ROWS = 64
_HEAD_LD = 16
_PE_COL = 8
_DW_UNITS = 264
_DW_RANGES = 24
_DW_COLS = 256
_DW_MIN_PIECE = 64
SMS = 132
_MAX_SLAB = 65535 * _ROWS  # nm_field_layers' largest slab, in 128-point tiles


def _blocks(x: int, b: int) -> int:
    return -(-x // b)


def _round_up(x: int, m: int) -> int:
    return _blocks(x, m) * m


def _job_units(m: int, n: int) -> int:
    """dW units (128-row x 256-column blocks) of one point range of an m x n
    job."""
    return _blocks(m, 128) * _blocks(n, 256)


def _ranges_for(units: int) -> int:
    return max(1, min(_DW_RANGES, _blocks(_DW_UNITS, units)))


def _group_jobs(spec: MLPSpec) -> list[list[tuple[int, int]]]:
    """(rows computed, columns) of each job of each dW launch, in
    field_layers.cu's order: layer1, the trunk and feat products ([x | PE]
    at skips), dir with the heads (16 cotangent rows each)."""
    H, pxp, pdp = spec.hidden, spec.pxp, spec.pdp
    ks = [k for _, k in spec.gemm_shapes()]
    out = [[(H, pxp)]]
    out += [[(H, H)] + ([(H, pxp)] if ks[g] > H else []) for g in range(1, spec.num_layers + 1)]
    out.append([(H // 2, H), (H // 2, pdp), (_HEAD_LD, H), (_HEAD_LD, H // 2)])
    return out


def dw_groups(spec: MLPSpec) -> list[tuple[int, int]]:
    """The backward's dW launches (field_layers.cu:dw_groups): per weight
    matrix (layer1, trunk and feat products, then dir with the heads),
    (grads it writes, point ranges)."""
    H, pdp = spec.hidden, spec.pdp
    cols = [n * k for n, k in spec.gemm_shapes()[:-1]]
    cols.append((H // 2) * (H + pdp) + H + 3 * (H // 2))
    return [(c, _ranges_for(sum(_job_units(m, n) for m, n in jobs)))
            for c, jobs in zip(cols, _group_jobs(spec))]


class DwPlan(NamedTuple):
    """A dW launch over m points: its point ranges (the points of each but
    the last, a multiple of 64), units a range and in all, the units of
    whole waves (at 256 columns), the column pieces a unit of the last wave
    takes, and the kernel launches."""

    ranges: int
    range_pts: int
    per_range: int
    units: int
    whole: int
    pieces: int
    launches: int


def _range_split(m: int, ranges: int) -> tuple[int, int]:
    """(points a range, ranges) of m points split into `ranges`: a multiple
    of 64 points a range, so a short slab may take fewer."""
    n_pad = _round_up(m, 64)
    range_pts = _round_up(_blocks(n_pad, ranges), 64)
    return range_pts, _blocks(n_pad, range_pts)


def dw_pieces(left: int, sms: int = SMS) -> int:
    """field_layers.cu:dw_pieces: column pieces a unit of the last wave
    takes, the most of 1, 2 and 4 (256, 128, 64 columns) whose pieces the
    SMs hold at once."""
    pieces = 1
    while pieces * _DW_MIN_PIECE < _DW_COLS and left * pieces * 2 <= sms:
        pieces *= 2
    return pieces


def dw_plan(jobs: list[tuple[int, int]], m: int, ranges: int, sms: int = SMS,
            plain: bool = False) -> DwPlan:
    """field_layers.cu:launch_layer_dw's plan for jobs of (rows computed,
    columns) over m points split into `ranges` ranges (a group's, from
    dw_groups): the units of whole waves of `sms` SMs at 256 columns, in
    one launch, then the rest in pieces of 128 or 64 columns (dw_pieces)
    in a second (`plain`, the timing probe's variant: every unit at 256
    columns, one launch)."""
    range_pts, used = _range_split(m, ranges)
    per_range = sum(_job_units(r, c) for r, c in jobs)
    units = per_range * used
    whole = units if plain else units // sms * sms
    pieces = dw_pieces(units - whole, sms) if units > whole else 1
    return DwPlan(used, range_pts, per_range, units, whole, pieces,
                  int(whole > 0) + int(units > whole))


def dw_walk(jobs: list[tuple[int, int]], plan: DwPlan, sms: int = SMS
            ) -> list[list[list[tuple[int, int, int, int, int]]]]:
    """layer_dw_kernel's walk: per launch, per CTA (one per SM, at most one
    an item), in order, the (range, job, first column, first row, columns)
    of each piece of a 128 x 256 block of a job over a point range it sums:
    units go range by range, within a range job by job, each job's
    256-column blocks, each block's 128-row blocks; the first launch's
    whole units at 256 columns, the second's units in plan.pieces pieces
    (none past a block's columns)."""
    blocks = [(j, c0, r0, min(_DW_COLS, cols - c0)) for j, (rows, cols) in enumerate(jobs)
              for c0 in range(0, cols, _DW_COLS) for r0 in range(0, rows, 128)]
    assert len(blocks) == plan.per_range
    out = []
    for first, units, pieces in ((0, plan.whole, 1),
                                 (plan.whole, plan.units - plan.whole, plan.pieces)):
        if units == 0:
            continue
        items, width = units * pieces, _DW_COLS // pieces
        ctas = min(items, sms)
        launch = []
        for cta in range(ctas):
            parts = []
            for i in range(cta, items, ctas):
                u, q = first + i // pieces, i % pieces
                j, c0, r0, n = blocks[u % plan.per_range]
                if q * width < n:
                    parts.append((u // plan.per_range, j, c0 + q * width, r0,
                                  min(width, n - q * width)))
            launch.append(parts)
        out.append(launch)
    return out


# csrc/field_layers.cu's product plan: a slab's A bytes (128 rows x 64
# bf16), the ring's most stages, the barriers' bytes (full and empty per
# stage, out_free), the tile widths it picks from.
_LP_A_BYTES = _ROWS * 64 * 2
_LP_MAX_STAGES = 8
_LP_BAR_BYTES = (2 * _LP_MAX_STAGES + 1) * 8
_LP_WIDTHS = (256, 192, 128, 64)


class ProductPlan(NamedTuple):
    """A product launch's shared-memory plan: the tile's columns, the
    ring's stages, column tiles, and the dynamic shared bytes per block."""

    bn: int
    stages: int
    col_tiles: int
    bytes: int


def product_bn(n: int) -> int:
    """field_layers.cu:product_bn: the tile width for n output columns,
    of 256, 192, 128 and 64 the one with the least tiles x (width + 64),
    a tie to the wider."""
    return min(_LP_WIDTHS, key=lambda bn: _blocks(n, bn) * (bn + 64))


def product_plan(n: int, smem_limit: int = SMEM_LIMIT) -> ProductPlan | None:
    """The plan csrc/field_layers.cu:product_plan makes at launch for a
    product into n columns (whatever its K: every slab is 64 columns of A
    and W), or None where it refuses: fewer than 2 ring stages. A mirror
    of the C++: keep the two alike."""
    bn = product_bn(n)
    stage = _LP_A_BYTES + bn * 64 * 2
    fixed = _ROWS * bn * 2 + 8 * bn * 4 + _LP_BAR_BYTES  # staging, partials, barriers
    stages = (smem_limit - fixed) // stage
    if stages < 2:
        return None
    stages = min(stages, _LP_MAX_STAGES)
    return ProductPlan(bn, stages, _blocks(n, bn), stages * stage + fixed)


def product_tiles(m: int, n: int, sms: int) -> list[list[tuple[int, int]]]:
    """The product kernel's tile walk: per CTA (one per SM, at most one
    per tile), the (first row, first column) of each 128 x bn output tile
    it computes, in order: tiles u = cta, cta + ctas, ... with N fastest."""
    bn = product_bn(n)
    ct = _blocks(n, bn)
    tiles = _blocks(m, _ROWS) * ct
    ctas = min(tiles, sms)
    return [[(u // ct * _ROWS, u % ct * bn) for u in range(cta, tiles, ctas)]
            for cta in range(ctas)]


def route_products(spec: MLPSpec, kind: str) -> list[tuple[int, int, int, bool]]:
    """(k1, k2, n, nn) of each product launch a slab of `kind` ("fwd",
    "sigma", "bwd") makes, in order, as nm_field_layers issues them."""
    H, L = spec.hidden, spec.num_layers
    ks = [k for _, k in spec.gemm_shapes()]
    out = [(spec.pxp, 0, H, False)]
    out += [(H, ks[g] - H, H, False) for g in range(1, L)]
    if kind == "sigma":
        return out
    out += [(H, 0, H, False), (H, spec.pdp, H // 2, False)]
    if kind == "bwd":
        out += [(H // 2, 0, H, True)] + [(H, 0, H, True)] * L
    return out


# csrc/field_layers.cu's bias-grad reduction (bias_grads_kernel): partial
# rows and columns a unit sums, and the most segments (bias vectors) a
# launch takes.
_BIAS_GROUP = 64
_BIAS_COLS = 128
_MAX_BIAS_SEGS = 32


def bias_segments(spec: MLPSpec, m: int) -> list[tuple[int, int]]:
    """(partial rows, columns) of each bias vector a backward slab of m
    points reduces, in field_layers.cu's order: the L + 1 dX products'
    column sums per 128 points (dir's, then the feat and trunk products'
    down to layer1's), then the heads' per 64 points: the dir layer's H/2
    and [alpha, r, g, b]."""
    H, mt, hb = spec.hidden, _blocks(m, _ROWS), _blocks(m, _HEAD_ROWS)
    return [(mt, H)] * (spec.num_layers + 1) + [(hb, H // 2), (hb, 4)]


def bias_scratch(segments: list[tuple[int, int]]) -> tuple[int, int]:
    """(level-1 floats, counters) the bias-grad reduction takes for these
    (rows, columns) segments: a row per 64-row group, a counter per
    128-column chunk (field_layers.cu:launch_bias)."""
    return (sum(_blocks(r, _BIAS_GROUP) * c for r, c in segments),
            sum(_blocks(c, _BIAS_COLS) for _, c in segments))


def workspace_layout(spec: MLPSpec, kind: str, slab: int) -> dict[str, tuple[int, int]]:
    """The workspace of a call of `kind` ("fwd", "sigma", "bwd") in slabs of
    `slab` points, region by region as field_layers.cu:layers_layout lays
    it out: name -> (byte offset, bytes), each on a 256 B boundary; "total"
    -> (bytes of the whole, 0)."""
    H, L, pxp, pdp, P = spec.hidden, spec.num_layers, spec.pxp, spec.pdp, slab
    regions = [("tab", (pxp + pdp) * _PE_COL), ("pe_x", P * pxp * 2)]
    if kind != "sigma":
        regions.append(("pe_d", P * pdp * 2))
    if kind == "bwd":
        level1, counters = bias_scratch(bias_segments(spec, P))
        regions += [("act", L * P * H * 2), ("feat", P * H * 2), ("h", P * (H // 2) * 2),
                    ("dy_rgb", P * _HEAD_LD * 2), ("dy_a", P * _HEAD_LD * 2),
                    ("dy_dir", P * (H // 2) * 2), ("dy0", P * H * 2), ("dy1", P * H * 2),
                    ("colsum", (L + 1) * (P // _ROWS) * H * 4),
                    ("hpart", P // _HEAD_ROWS * (H // 2 + 4) * 4), ("bpart", level1 * 4),
                    ("bcount", counters * 4),
                    ("dwpart", max(r * _round_up(c, 64) for c, r in dw_groups(spec)) * 4)]
    else:
        regions += [("buf0", P * H * 2), ("buf1", P * H * 2)]
        regions += [("h", P * (H // 2) * 2)] if kind == "fwd" else []
    out, off = {}, 0
    for name, nbytes in regions:
        out[name] = (off, nbytes)
        off += _round_up(nbytes, 256)
    out["total"] = (off, 0)
    return out


def workspace_bytes(spec: MLPSpec, kind: str, slab: int) -> int:
    """Bytes of workspace a call of `kind` takes in slabs of `slab` points
    (workspace_layout's total)."""
    return workspace_layout(spec, kind, slab)["total"][0]


def slab_launches(spec: MLPSpec, kind: str, m: int) -> dict[str, int]:
    """Each kernel's launches (KERNELS) in one slab of m points of a call of
    `kind`, as nm_field_layers launches them: a PE, the route's products
    (route_products), a heads launch (the forward's and sigma's heads
    kernel, or the backward's); in the backward per weight matrix
    (dw_groups) a dW launch for its units of whole waves and one for the
    rest (dw_plan, on an H100's SMs), a reduction of its range partials
    where the slab splits into more than one range, and the slab's bias
    grads in a launch per 32 bias vectors."""
    out = dict.fromkeys(KERNELS, 0)
    out.update(pe=1, product=len(route_products(spec, kind)))
    if kind == "bwd":
        plans = [dw_plan(jobs, m, r) for (_, r), jobs in zip(dw_groups(spec), _group_jobs(spec))]
        out.update(heads_bwd=1, dw=sum(p.launches for p in plans),
                   reduce=sum(p.ranges > 1 for p in plans),
                   bias=_blocks(len(bias_segments(spec, m)), _MAX_BIAS_SEGS))
    else:
        out.update(heads=1)
    return out


def call_launches(spec: MLPSpec, kind: str, n_pts: int) -> dict[str, int]:
    """Each kernel's launches in one call of `kind` over n_pts points: its
    slabs' (slab_points under LAYER_WORKSPACE_BOUND), none for no points."""
    out = dict.fromkeys(KERNELS, 0)
    if n_pts <= 0:
        return out
    slab = slab_points(spec, kind, n_pts, LAYER_WORKSPACE_BOUND)
    for row0 in range(0, n_pts, slab):
        for k, v in slab_launches(spec, kind, min(slab, n_pts - row0)).items():
            out[k] += v
    return out


def slab_points(spec: MLPSpec, kind: str, n_pts: int,
                bound: int = LAYER_WORKSPACE_BOUND) -> int:
    """Points per slab for n_pts points: all of them (rounded up to the
    128-point tile, at most 65,535 tiles) where their workspace fits
    `bound`, else the most whole tiles that fit (at least one)."""
    whole = min(_round_up(max(n_pts, 1), _ROWS), _MAX_SLAB)
    if workspace_bytes(spec, kind, whole) <= bound:
        return whole
    fixed = workspace_bytes(spec, kind, 0)
    step = 1024 * _ROWS
    per_point = (workspace_bytes(spec, kind, step) - fixed) / step
    slab = max(_ROWS, int((bound - fixed) // per_point) // _ROWS * _ROWS)
    while slab > _ROWS and workspace_bytes(spec, kind, slab) > bound:
        slab -= _ROWS
    return slab


def _check_packed(packed: PackedMLP, device: torch.device, what: str) -> None:
    if device.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {device}")
    for name, t in (("weights", packed.weights), ("biases", packed.biases)):
        if t.device != device:
            raise ValueError(f"packed {name} on {t.device}, inputs on {device}")
    if packed.weights.dtype != torch.bfloat16:
        raise ValueError(f"packed weights must be bf16, got {packed.weights.dtype}")


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def card_sms(device: torch.device) -> int:
    """The SMs of the CUDA card `device`, which the C plans the dW leg on."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _run(kind: str, packed: PackedMLP, src: torch.Tensor, dirs: torch.Tensor | None,
         z: torch.Tensor | None, n_rays: int, samples: int, *, grad=None, out=None,
         channels_first: bool = True, dW=None, dB=None, lib=None) -> None:
    """One call of nm_field_layers (of `lib`, default this tree's build) on
    the current stream of src's device."""
    device = src.device
    spec = packed.spec
    slab = slab_points(spec, kind, n_rays * samples, LAYER_WORKSPACE_BOUND)
    nbytes = workspace_bytes(spec, kind, slab)
    workspace = torch.empty(nbytes, dtype=torch.uint8, device=device)
    counts = (ctypes.c_int * len(KERNELS))()
    lib = lib or build.load_library()
    with torch.cuda.device(device):
        rc = lib.nm_field_layers(
            KINDS[kind], src.data_ptr(), _ptr(dirs), _ptr(z), n_rays, samples, _ptr(grad),
            packed.weights.data_ptr(), packed.biases.data_ptr(),
            packed.desc.ctypes.data, packed.desc.size, packed.freqs.ctypes.data,
            packed.freqs.size, workspace.data_ptr(), nbytes, slab, _ptr(out),
            int(channels_first), _ptr(dW), _ptr(dB), ctypes.addressof(counts),
            torch.cuda.current_stream(device).cuda_stream,
        )
    build.check(build.load_library(), rc, f"field_layers {kind} launch")
    for name, n in zip(KERNELS, counts):
        kernel_launches[name] += n
    if call_log is not None:
        call_log.append((spec, kind, n_rays * samples))


def layers_mlp_cuda(packed: PackedMLP, origins: torch.Tensor, directions: torch.Tensor,
                    z_vals: torch.Tensor, *, channels_first: bool = True,
                    lib=None) -> torch.Tensor:
    """The forward on the layer route. o, d (R, 3), z (R, S) f32 on one
    CUDA device -> (4, R, S) or (R, S, 4) f32, as fused_mlp_cuda. `lib`:
    another build of csrc/ to launch (scripts/torch_layer_product_ab.py),
    default this tree's."""
    global launches
    _check_rays(origins, directions, z_vals)
    _check_packed(packed, z_vals.device, "layers_mlp_cuda")
    R, S = z_vals.shape
    out = torch.empty((4, R, S) if channels_first else (R, S, 4), dtype=torch.float32,
                      device=z_vals.device)
    if R * S == 0:
        return out
    _run("fwd", packed, origins.float().contiguous(), directions.float().contiguous(),
         z_vals.float().contiguous(), R, S, out=out, channels_first=channels_first, lib=lib)
    launches += 1
    return out


def layers_sigma_cuda(packed: PackedMLP, points: torch.Tensor, *, lib=None) -> torch.Tensor:
    """Sigma on the layer route: the forward's PE, trunk and alpha head
    kernels. (N, 3) f32 on one CUDA device -> (N,) f32 raw sigma. `lib`:
    another build of csrc/ to launch, default this tree's."""
    global sigma_launches
    _check_points(points)
    _check_packed(packed, points.device, "layers_sigma_cuda")
    p = points.float().contiguous()
    out = torch.empty(p.shape[0], dtype=torch.float32, device=p.device)
    if p.shape[0] == 0:
        return out
    _run("sigma", packed, p, None, None, p.shape[0], 1, out=out, lib=lib)
    sigma_launches += 1
    return out


def layers_bwd_cuda(packed: PackedMLP, origins: torch.Tensor, directions: torch.Tensor,
                    z_vals: torch.Tensor, grad: torch.Tensor, *, lib=None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The backward on the layer route: o, d (R, 3), z (R, S), grad
    (4, R, S) f32 on one CUDA device -> f32 (dW, dB) in the packed layout,
    as fused_mlp_bwd_cuda."""
    global bwd_launches
    _check_rays(origins, directions, z_vals)
    _check_grad(grad, z_vals)
    _check_packed(packed, z_vals.device, "layers_bwd_cuda")
    R, S = z_vals.shape
    device = z_vals.device
    dW = torch.zeros(packed.weights.shape, dtype=torch.float32, device=device)
    dB = torch.zeros(packed.biases.shape, dtype=torch.float32, device=device)
    if R * S == 0:
        return dW, dB
    _run("bwd", packed, origins.float().contiguous(), directions.float().contiguous(),
         z_vals.float().contiguous(), R, S, grad=grad.float().contiguous(), dW=dW, dB=dB,
         lib=lib)
    bwd_launches += 1
    return dW, dB


def layers_pe_plain(packed: PackedMLP, src: torch.Tensor, directions: torch.Tensor | None = None,
                    z_vals: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Plain version of the PE kernel: bf16 PE(xyz) (N, pxp) and PE(dir)
    (N, pdp) of the rays (src origins, directions, z (R, S)), or PE(xyz)
    and None of the points src (N, 3)."""
    spec = packed.spec
    if directions is None:
        pts, dirs = src.float(), None
    else:
        R, S = z_vals.shape
        o, d, z = src.float(), directions.float(), z_vals.float()
        pts = (o[:, None, :] + d[:, None, :] * z[..., None]).reshape(-1, 3)
        dirs = d[:, None, :].expand(R, S, 3).reshape(-1, 3)
    pe_x = _padded_pe(pts, spec.L_x, spec.include_x, spec.log_x, spec.pxp).to(torch.bfloat16)
    pe_d = (None if dirs is None else
            _padded_pe(dirs, spec.L_d, spec.include_d, spec.log_d, spec.pdp).to(torch.bfloat16))
    return pe_x, pe_d


def layers_pe_cuda(packed: PackedMLP, src: torch.Tensor, directions: torch.Tensor | None = None,
                   z_vals: torch.Tensor | None = None, *, lib=None
                   ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The PE kernel alone (nm_field_layers_pe, of `lib`, default this
    tree's build), as layers_pe_plain."""
    device = src.device
    if device.type != "cuda":
        raise ValueError(f"layers_pe_cuda needs CUDA tensors, got {device}")
    spec = packed.spec
    if directions is None:
        _check_points(src)
        n_rays, samples = src.shape[0], 1
    else:
        _check_rays(src, directions, z_vals)
        n_rays, samples = z_vals.shape
    n = n_rays * samples
    pe_x = torch.empty((n, spec.pxp), dtype=torch.bfloat16, device=device)
    pe_d = (None if directions is None else
            torch.empty((n, spec.pdp), dtype=torch.bfloat16, device=device))
    table = torch.empty((spec.pxp + spec.pdp) * _PE_COL, dtype=torch.uint8, device=device)
    src = src.float().contiguous()
    dirs = None if directions is None else directions.float().contiguous()
    z = None if z_vals is None else z_vals.float().contiguous()
    lib = lib or build.load_library()
    with torch.cuda.device(device):
        rc = lib.nm_field_layers_pe(
            src.data_ptr(), _ptr(dirs), _ptr(z), n_rays, samples,
            packed.desc.ctypes.data, packed.desc.size, packed.freqs.ctypes.data,
            packed.freqs.size, table.data_ptr(), pe_x.data_ptr(), _ptr(pe_d),
            torch.cuda.current_stream(device).cuda_stream,
        )
    build.check(build.load_library(), rc, "field_layers PE launch")
    return pe_x, pe_d


def layers_product_plain(a1: torch.Tensor, a2: torch.Tensor | None, w: torch.Tensor, n: int, *,
                         nn: bool = False, bias: torch.Tensor | None = None,
                         relu: bool = False, mask: torch.Tensor | None = None,
                         colsum: bool = True
                         ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Plain version of the product kernel: (bf16 (m, n) epilogue([a1 |
    a2] B + bias), f32 (ceil(m / 128), n) column sums per 128 rows of the
    f32 values, or None without `colsum`), B = w^T for w (n, K) (nn
    False), w[:, :n] for w (K, ldw) (nn True)."""
    a = a1 if a2 is None else torch.cat([a1, a2], dim=1)
    k = a.shape[1]
    b = w[:k, :n].t() if nn else w[:n, :k]
    y = matmul_f32_acc(a, b, torch.bfloat16)
    if bias is not None:
        y = y + bias
    if relu:
        y = y.clamp_min(0.0)
    if mask is not None:
        y = torch.where(mask.float() > 0, y, torch.zeros_like(y))
    if not colsum:
        return y.to(torch.bfloat16), None
    m = y.shape[0]
    rows = torch.nn.functional.pad(y, (0, 0, 0, _round_up(m, _ROWS) - m))
    return y.to(torch.bfloat16), rows.view(-1, _ROWS, n).sum(dim=1)


def layers_product_cuda(a1: torch.Tensor, a2: torch.Tensor | None, w: torch.Tensor, n: int, *,
                        nn: bool = False, bias: torch.Tensor | None = None,
                        relu: bool = False, mask: torch.Tensor | None = None,
                        colsum: bool = True, lib=None
                        ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The product kernel alone (nm_field_layers_product, of `lib`, default
    this tree's build), as layers_product_plain, on contiguous bf16 CUDA
    tensors."""
    device = a1.device
    if device.type != "cuda":
        raise ValueError(f"layers_product_cuda needs CUDA tensors, got {device}")
    m, k1 = a1.shape
    k2 = 0 if a2 is None else a2.shape[1]
    out = torch.empty((m, n), dtype=torch.bfloat16, device=device)
    sums = (torch.empty((_blocks(m, _ROWS), n), dtype=torch.float32, device=device)
            if colsum else None)
    lib = lib or build.load_library()
    with torch.cuda.device(device):
        rc = lib.nm_field_layers_product(
            a1.data_ptr(), k1, _ptr(a2), k2, m, w.data_ptr(), w.shape[1], n, int(nn),
            _ptr(bias), int(relu), _ptr(mask), out.data_ptr(), _ptr(sums),
            torch.cuda.current_stream(device).cuda_stream,
        )
    build.check(build.load_library(), rc, "field_layers product launch")
    return out, sums


def layers_heads_bwd_plain(packed: PackedMLP, h: torch.Tensor, grad: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward's heads kernel, for h (m, H/2) bf16
    (the dir layer's output) and its points' cotangent grad (4, m) f32:
    (dy_rgb (m, 16) bf16, drgb through the rgb head's sigmoid in columns
    0-2; dy_a (m, 16) bf16, grad's alpha channel in column 0; dy_dir (m,
    H/2) bf16 = (bf16(drgb) wr) where h > 0; part (ceil(m / 64), H/2 + 4)
    f32, per 64 points the column sums of dy_dir's f32 values, then of
    [dalpha, dr, dg, db])."""
    H2 = packed.spec.hidden // 2
    _, _, wr, br = packed.heads()
    m = h.shape[0]
    rgb = torch.sigmoid(matmul_f32_acc(h, wr, torch.bfloat16) + br)
    g = grad.float()
    drgb = g[:3].t() * rgb * (1.0 - rgb)
    dalpha = g[3]
    dy_rgb = torch.zeros((m, _HEAD_LD), dtype=torch.bfloat16, device=h.device)
    dy_a = torch.zeros_like(dy_rgb)
    dy_rgb[:, :3] = drgb.to(torch.bfloat16)
    dy_a[:, 0] = dalpha.to(torch.bfloat16)
    v = drgb.to(torch.bfloat16).float() @ wr.float()
    v = torch.where(h.float() > 0, v, torch.zeros_like(v))
    cols = torch.cat([v, dalpha[:, None], drgb], dim=1)
    pad = _round_up(m, _HEAD_ROWS) - m
    part = torch.nn.functional.pad(cols, (0, 0, 0, pad)).view(-1, _HEAD_ROWS, H2 + 4).sum(dim=1)
    return dy_rgb, dy_a, v.to(torch.bfloat16), part


def layers_heads_bwd_cuda(packed: PackedMLP, h: torch.Tensor, grad: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward's heads kernel alone (nm_field_layers_heads_bwd), as
    layers_heads_bwd_plain, on CUDA tensors."""
    device = h.device
    if device.type != "cuda":
        raise ValueError(f"layers_heads_bwd_cuda needs CUDA tensors, got {device}")
    H2 = packed.spec.hidden // 2
    m = h.shape[0]
    if m == 0 or tuple(h.shape) != (m, H2) or tuple(grad.shape) != (4, m):
        raise ValueError(f"h must be (m, {H2}) and grad (4, m), m > 0, got "
                         f"{tuple(h.shape)}, {tuple(grad.shape)}")
    _, _, wr, br = packed.heads()
    h = h.to(torch.bfloat16).contiguous()
    g = grad.float().contiguous()
    dy_rgb = torch.empty((m, _HEAD_LD), dtype=torch.bfloat16, device=device)
    dy_a = torch.empty_like(dy_rgb)
    dy_dir = torch.empty((m, H2), dtype=torch.bfloat16, device=device)
    part = torch.empty((_blocks(m, _HEAD_ROWS), H2 + 4), dtype=torch.float32, device=device)
    lib = build.load_library()
    with torch.cuda.device(device):
        rc = lib.nm_field_layers_heads_bwd(
            h.data_ptr(), g.data_ptr(), m, packed.spec.hidden, wr.data_ptr(), br.data_ptr(),
            dy_rgb.data_ptr(), dy_a.data_ptr(), dy_dir.data_ptr(), part.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    build.check(lib, rc, "field_layers heads backward launch")
    return dy_rgb, dy_a, dy_dir, part


def layers_bias_plain(parts: list[torch.Tensor], outs: list[torch.Tensor]) -> list[torch.Tensor]:
    """Plain version of the bias-grad reduction: out + parts' column sums
    (f32), per (rows, cols) partials and (cols,) running grads."""
    return [out + part.float().sum(dim=0) for part, out in zip(parts, outs)]


def layers_bias_launcher(parts: list[torch.Tensor], outs: list[torch.Tensor]):
    """A launch of the bias-grad reduction alone (nm_field_layers_bias) on
    f32 contiguous CUDA partials (rows, cols), cols a multiple of 4, adding
    their column sums into the f32 (cols,) tensors outs in place: its host
    arrays and scratch made once, so the returned function launches the
    kernel and nothing else (the scratch's counters come back to zero)."""
    device = parts[0].device
    if device.type != "cuda":
        raise ValueError(f"layers_bias_cuda needs CUDA tensors, got {device}")
    scratch = torch.zeros(sum(bias_scratch([tuple(p.shape) for p in parts])),
                          dtype=torch.float32, device=device)
    arr = [np.asarray(v, dtype=dtype) for v, dtype in (
        ([p.data_ptr() for p in parts], np.int64), ([p.shape[1] for p in parts], np.int64),
        ([p.shape[0] for p in parts], np.int32), ([p.shape[1] for p in parts], np.int32),
        ([o.data_ptr() for o in outs], np.int64))]
    lib = build.load_library()

    def launch() -> None:
        with torch.cuda.device(device):
            rc = lib.nm_field_layers_bias(len(parts), *(a.ctypes.data for a in arr),
                                          scratch.data_ptr(), scratch.numel() * 4,
                                          torch.cuda.current_stream(device).cuda_stream)
        build.check(lib, rc, "field_layers bias launch")
    return launch


def layers_bias_cuda(parts: list[torch.Tensor], outs: list[torch.Tensor]) -> list[torch.Tensor]:
    """The bias-grad reduction alone (nm_field_layers_bias), as
    layers_bias_plain: f32 CUDA partials (rows, cols), cols a multiple of
    4; the sums added to copies of outs."""
    parts = [p.float().contiguous() for p in parts]
    outs = [o.float().clone() for o in outs]
    layers_bias_launcher(parts, outs)()
    return outs


class DwJob(NamedTuple):
    """One product of a dW launch: dy (P, rows) and x (P, cols) bf16, each
    a view with unit column stride of a row-major array (its rows 16 B
    aligned), whose (rows, cols) grads dy^T x are added at
    out[w_off + col_off + row * ldw + col] of a flat f32 out."""

    dy: torch.Tensor
    x: torch.Tensor
    w_off: int
    ldw: int
    col_off: int


# launch_layer_dw's variants (field_layers.cu:DwVariant), for timing
# probes: the route's kernel, the fused backward's dw_kernel on its
# job-major units, every range reading the first range's points, every
# unit at 256 columns (no pieces).
DW_VARIANTS = {"route": 0, "fused": 1, "same_points": 2, "plain": 3}


def route_dw_jobs(packed: PackedMLP, g: int, dy: torch.Tensor, x: torch.Tensor,
                  pe: torch.Tensor | None = None, heads: tuple | None = None
                  ) -> tuple[list[DwJob], int, int]:
    """The jobs of the route's dW launch for weight matrix g (0 layer1, 1..L
    the trunk and feat products, L + 1 dir with the heads) over one slab,
    as nm_field_layers makes them: (jobs, offset of the group's grads in
    the packed weights, their count). dy: the matrix's output cotangent
    (P, n_g); x its input (P, H), or PE(xyz) for layer1; pe the PE part of
    [x | PE] (a skip's PE(xyz), dir's PE(dir)); heads, for dir: (dy_a
    (P, 16), trunk (P, H), dy_rgb (P, 16), h (P, H/2)), the alpha and rgb
    heads' cotangents (their first 1 and 3 columns kept) and inputs."""
    spec = packed.spec
    n, k = spec.gemm_shapes()[g]
    base = int(packed.desc[13 + g])
    jobs = [DwJob(dy, x, 0, k, 0)]
    if pe is not None:
        jobs.append(DwJob(dy, pe, 0, k, k - pe.shape[1]))
    cols = n * k
    if g == spec.num_layers + 1:
        dy_a, trunk, dy_rgb, h = heads
        wa_off, _, wr_off, _ = (int(v) for v in packed.desc[9:13])
        H = spec.hidden
        jobs += [DwJob(dy_a[:, :1], trunk, wa_off - base, H, 0),
                 DwJob(dy_rgb[:, :3], h, wr_off - base, H // 2, 0)]
        cols = wr_off + 3 * (H // 2) - base
    return jobs, base, cols


def _dw_maps(jobs: list[DwJob]) -> list[tuple[int, int, int]]:
    """The distinct operands of the jobs, as nm_field_layers_dw maps them:
    (address, columns, row pitch)."""
    return list(dict.fromkeys((t.data_ptr(), t.shape[1], t.stride(0))
                              for j in jobs for t in (j.dy, j.x)))


def _dw_ranges_of(jobs: list[DwJob]) -> int:
    """The point ranges nm_field_layers_dw plans for these jobs
    (ranges_for)."""
    return _ranges_for(sum(_job_units(j.dy.shape[1], j.x.shape[1]) for j in jobs))


def layers_dw_plain(jobs: list[DwJob], out: torch.Tensor, *, ranges: int = 0) -> torch.Tensor:
    """Plain version of the dW leg (layer_dw_kernel and its range
    reduction): out (flat f32) plus the jobs' grads dy^T x in f32 (bf16
    products are exact in f32), taken per point range of the kernel's plan
    (or `ranges`), the ranges added to out in order."""
    m = jobs[0].dy.shape[0]
    range_pts, used = _range_split(m, ranges or _dw_ranges_of(jobs))
    result = out.float().clone()
    for r in range(used):
        rows = slice(r * range_pts, min(m, (r + 1) * range_pts))
        part = torch.zeros_like(result)
        for j in jobs:
            block = j.dy[rows].float().t() @ j.x[rows].float()
            part.as_strided(block.shape, (j.ldw, 1), j.w_off + j.col_off).copy_(block)
        result += part
    return result


def layers_dw_launcher(jobs: list[DwJob], out: torch.Tensor, *, ranges: int = 0,
                       variant: str = "route", lib=None):
    """A launch of the dW leg alone (nm_field_layers_dw, of `lib`, default
    this tree's build) on CUDA bf16 jobs over one slab of points, adding
    their grads into the flat f32 CUDA tensor out in place: its host
    arrays and scratch made once, so the returned function launches the
    kernel (and its reduction) and nothing else; it returns (point ranges,
    units, kernel launches, the last wave's pieces a unit). ranges 0: the
    plan's (ranges_for); variant: a key of DW_VARIANTS."""
    device = out.device
    if device.type != "cuda" or any(t.device.type != "cuda" for j in jobs for t in (j.dy, j.x)):
        raise ValueError(f"layers_dw_cuda needs CUDA tensors, got {device}")
    m = jobs[0].dy.shape[0]
    for t in (t for j in jobs for t in (j.dy, j.x)):
        if t.dtype != torch.bfloat16 or t.dim() != 2 or t.shape[0] != m or t.stride(1) != 1:
            raise ValueError(f"dW operands must be (m, cols) bf16 row views, got {tuple(t.shape)}"
                             f" {t.dtype} strides {t.stride()}")
    maps = _dw_maps(jobs)
    index = {key: i for i, key in enumerate(maps)}

    def map_of(t: torch.Tensor) -> int:
        return index[(t.data_ptr(), t.shape[1], t.stride(0))]

    rows = [(map_of(j.dy), 0, map_of(j.x), 0, j.dy.shape[1], j.dy.shape[1], j.x.shape[1],
             j.w_off, j.ldw, j.col_off) for j in jobs]
    cols = out.numel()
    used = _range_split(m, ranges or _dw_ranges_of(jobs))[1]
    scratch = torch.empty(used * _round_up(cols, 64), dtype=torch.float32, device=device)
    arr = [np.asarray(v, dtype=dtype) for v, dtype in (
        ([k[0] for k in maps], np.int64), ([k[1] for k in maps], np.int32),
        ([k[2] for k in maps], np.int64), ([v for r in rows for v in r], np.int32))]
    info = (ctypes.c_int * 4)()
    lib = lib or build.load_library()

    def launch() -> tuple[int, int, int, int]:
        with torch.cuda.device(device):
            rc = lib.nm_field_layers_dw(len(maps), arr[0].ctypes.data, arr[1].ctypes.data,
                                        arr[2].ctypes.data, m, len(rows), arr[3].ctypes.data,
                                        cols, ranges, DW_VARIANTS[variant], out.data_ptr(),
                                        scratch.data_ptr(), scratch.numel(),
                                        ctypes.addressof(info),
                                        torch.cuda.current_stream(device).cuda_stream)
        build.check(build.load_library(), rc, "field_layers dW launch")
        return info[0], info[1], info[2], info[3]
    return launch


def layers_dw_cuda(jobs: list[DwJob], out: torch.Tensor, *, ranges: int = 0,
                   variant: str = "route", lib=None) -> torch.Tensor:
    """The dW leg alone (nm_field_layers_dw), as layers_dw_plain with the
    ranges the kernel plans on this card (or `ranges`): out plus the jobs'
    grads, in a copy of out."""
    result = out.float().clone()
    layers_dw_launcher(jobs, result, ranges=ranges, variant=variant, lib=lib)()
    return result


def layers_workspace_c(packed: PackedMLP, kind: str, slab: int) -> int:
    """nm_field_layers_workspace: the C layout's bytes, which
    workspace_bytes mirrors (its checks compare the two on the card)."""
    lib = build.load_library()
    nbytes = ctypes.c_longlong(0)
    rc = lib.nm_field_layers_workspace(KINDS[kind], packed.desc.ctypes.data, packed.desc.size,
                                       packed.freqs.ctypes.data, packed.freqs.size, slab,
                                       ctypes.byref(nbytes))
    build.check(lib, rc, "field_layers workspace")
    return int(nbytes.value)


def layers_product_plan_c(n: int) -> ProductPlan:
    """nm_field_layers_product_plan: the C plan on the current card, which
    product_plan mirrors (its checks compare the two on the card)."""
    lib = build.load_library()
    out = (ctypes.c_int * 4)()
    build.check(lib, lib.nm_field_layers_product_plan(n, ctypes.addressof(out)),
                "field_layers product plan")
    return ProductPlan(*out)

