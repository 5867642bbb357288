"""The fused MLP CUDA kernels (forward and backward) against their plain
versions, on the card: every architecture at the ragged edges of the
128-point tiles and past two persistent waves, skips the models do not
make (after layer1, after the last trunk layer), a backward workspace
full of NaN, bitwise repeats, launches refused for their shared memory,
the forward's and sigma kernel's output bits and the backward's grad
and stash bits on seeded cases; the backward's dW leg alone
(nm_dw_product) against torch.mm: one MN-major wgmma product, then the
edges of its 64-point stages, 128-row blocks and point ranges; and the
layer route (csrc/field_layers.cu): its product kernel, its backward's
heads kernel, bias-grad reduction and dW leg alone, its PE kernel bit for
bit the fused kernels' PE, and the route's forward, sigma and backward at
every shape field_route sends it (512-1024 wide among them), in slabs,
with its bits.

A CUDA kernel has no CPU mode, so these tests carry the `gpu` marker and
skip without a card. On a GPU host:

    python -m pytest tests/test_torch_fused_mlp_gpu.py -m gpu --noconftest -q

(`--noconftest`: tests/conftest.py imports jax, which the GPU host does
not need.) Tolerances: forward atol = rtol = 2e-2, the bf16 bar of
tests/test_fused_mlp.py:37; backward worst relative error per weight or
bias < 5e-2, the bar of tests/test_fused_mlp.py:65. Kernel and plain
version share numerics but sum in other orders, so a bf16 rounding of a
cotangent can fall the other way; where the 14-layer packs from 640 wide
on miss the bar against plain (two plain runs already differ by up to
0.061 there), they are held to a float64 truth instead (`_hold_grads`).
The dW leg alone: bf16 products are exact in f32, so it differs from an
f32 torch.mm of the same operands
only by the order of its f32 sums, within 1e-4 of the sum of the
products' magnitudes (a wrong operand layout misses by O(1)).
"""

import ctypes
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from nerfmeshes_tpu_torch.models import FlexibleNeRFModel
from nerfmeshes_tpu_torch.ops.encoding import frequency_bands
from nerfmeshes_tpu_torch.ops.kernels import build
from nerfmeshes_tpu_torch.ops.kernels import field_layers as fl
from nerfmeshes_tpu_torch.ops.kernels import fused_mlp as fm

pytestmark = pytest.mark.gpu

LEGO = dict(num_layers=8, hidden_size=256, skip_step=4, num_encoding_fn_xyz=10,
            num_encoding_fn_dir=4)
ARCHS = [
    LEGO,
    dict(num_layers=4, hidden_size=128, skip_step=2, num_encoding_fn_xyz=4, num_encoding_fn_dir=2),
    dict(num_layers=10, hidden_size=128, skip_step=3, num_encoding_fn_xyz=4,
         num_encoding_fn_dir=2, include_input_xyz=False, include_input_dir=False),
    dict(LEGO, num_layers=4, skip_step=2, num_encoding_fn_xyz=11, log_sampling_xyz=False,
         log_sampling_dir=False),
    # the edge of supports_fused: most layers and bands the kernel takes
    dict(LEGO, num_layers=fm.MAX_LAYERS, num_encoding_fn_xyz=fm.MAX_BANDS,
         num_encoding_fn_dir=fm.MAX_BANDS),
    # the wide widths, on 64-point tiles split in N across the warpgroups
    dict(LEGO, hidden_size=384),
    dict(LEGO, hidden_size=512),
    # the widest edge the gate admits at 512: most layers, 128 PE columns
    dict(LEGO, hidden_size=512, num_layers=fm.MAX_LAYERS, num_encoding_fn_xyz=15),
    # 640 to 1024 wide, each tile split across a pair of CTAs as well
    dict(LEGO, hidden_size=640),
    dict(LEGO, hidden_size=768),
    dict(LEGO, hidden_size=896),
    dict(LEGO, hidden_size=1024),
    # the widest edge the gate admits at 1024: most layers, 128 PE columns
    dict(LEGO, hidden_size=1024, num_layers=fm.MAX_LAYERS, num_encoding_fn_xyz=15),
]
ARCH_IDS = ["lego", "small", "deep-linear", "linear-11", "edge", "w384", "w512", "w512-edge",
            "w640", "w768", "w896", "w1024", "w1024-edge"]
WIDE = ARCHS[5:]
PAIRED = [kw for kw in ARCHS if kw["hidden_size"] > 512]
PAIRED_IDS = [i for kw, i in zip(ARCHS, ARCH_IDS) if kw["hidden_size"] > 512]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _rays(R, S, device, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-4.0, 4.0, (R, 3))
    d = rng.standard_normal((R, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    z = np.sort(rng.uniform(2.0, 6.0, (R, S)), axis=1)
    return [torch.from_numpy(a.astype(np.float32)).to(device) for a in (o, d, z)]


@pytest.mark.parametrize("kw", ARCHS, ids=ARCH_IDS)
@pytest.mark.parametrize("R,S,channels_first", [(2048, 64, True), (37, 5, False)])
def test_kernel_matches_plain(cuda, kw, R, S, channels_first):
    torch.manual_seed(0)
    model = FlexibleNeRFModel(**kw, compute_dtype=torch.bfloat16, device=cuda)
    packed = fm.pack_weights(model)
    o, d, z = _rays(R, S, cuda)
    before = fm.launches
    got = fm.fused_mlp_cuda(packed, o, d, z, channels_first=channels_first)
    torch.cuda.synchronize()
    assert fm.launches == before + 1
    ref = fm.fused_mlp_plain(packed, o, d, z, channels_first=channels_first)
    assert got.shape == ref.shape and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, ref, atol=2e-2, rtol=2e-2)


# Ragged edges of the 128-point tiles the persistent CTAs walk (64-point
# at H > 256), more tiles than two waves of one CTA per SM (132 SMs x
# 128 x 2 = 33,792), and 8513 points: 134 tiles of 64, so that at H > 512
# two of the (at most 66) pairs walk a third tile, the last one 63 rows
# short, while the others stop after two.
RAGGED = [1, 63, 65, 127, 128, 129, 257, 8513, 40000]


@pytest.mark.parametrize("kw", ARCHS, ids=ARCH_IDS)
@pytest.mark.parametrize("n", RAGGED)
def test_kernel_tile_edges(cuda, kw, n):
    """n points as n rays of one sample: tail rows of the last tile must
    read zeros and never be written, and a CTA's second and third tiles
    must see the same weights."""
    torch.manual_seed(0)
    model = FlexibleNeRFModel(**kw, compute_dtype=torch.bfloat16, device=cuda)
    packed = fm.pack_weights(model)
    o, d, z = _rays(n, 1, cuda, seed=n)
    got = fm.fused_mlp_cuda(packed, o, d, z)
    torch.cuda.synchronize()
    ref = fm.fused_mlp_plain(packed, o, d, z)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, ref, atol=2e-2, rtol=2e-2)
    # Tail rows are never written: the C entry point's (N, 4) rows into a
    # buffer one row longer leave that row as it was.
    lib = build.load_library()
    out = torch.full((n + 1, 4), float("nan"), device=cuda)
    rc = lib.nm_fused_mlp_fwd(
        o.data_ptr(), d.data_ptr(), z.data_ptr(), n, 1, packed.weights.data_ptr(),
        packed.biases.data_ptr(), packed.desc.ctypes.data, packed.desc.size,
        packed.freqs.ctypes.data, packed.freqs.size, out.data_ptr(), 0,
        torch.cuda.current_stream().cuda_stream)
    build.check(lib, rc, "fused_mlp_fwd launch")
    torch.cuda.synchronize()
    assert bool(torch.isnan(out[n]).all())
    torch.testing.assert_close(out[:n], ref.reshape(4, n).t(), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("channels_first", [True, False])
def test_kernel_is_deterministic(cuda, channels_first):
    """Two launches on the same inputs agree bit for bit (no atomics; each
    tile's sums run in one fixed order, whichever CTA takes the tile)."""
    torch.manual_seed(0)
    packed = fm.pack_weights(FlexibleNeRFModel(**LEGO, compute_dtype=torch.bfloat16,
                                               device=cuda))
    o, d, z = _rays(2048, 37, cuda)
    first = fm.fused_mlp_cuda(packed, o, d, z, channels_first=channels_first)
    second = fm.fused_mlp_cuda(packed, o, d, z, channels_first=channels_first)
    assert torch.equal(first, second)


def test_kernel_refuses_what_its_shared_memory_cannot_hold(cuda):
    """A descriptor whose PE tiles leave no room for two weight stages is
    refused at launch and raises from the wrapper; nothing is launched."""
    packed = fm.pack_weights(FlexibleNeRFModel(**LEGO, compute_dtype=torch.bfloat16,
                                               device=cuda))
    desc = packed.desc.copy()
    desc[7] = 1024  # pxp: PE(xyz) 1024 columns wide, 256 KB of PE tiles
    o, d, z = _rays(64, 2, cuda)
    before = fm.launches
    with pytest.raises(RuntimeError, match="fused_mlp_fwd launch failed"):
        fm.fused_mlp_cuda(packed._replace(desc=desc), o, d, z)
    assert fm.launches == before


def test_kernel_points_entry_and_empty_input(cuda):
    model = FlexibleNeRFModel(**LEGO, compute_dtype=torch.bfloat16, device=cuda)
    o, d, _ = _rays(50, 1, cuda)
    got = fm.fused_flexible_apply(model, o, d)
    z = torch.zeros((50, 1), device=cuda)
    ref = fm.fused_mlp_plain(fm.pack_weights(model), o, d, z, channels_first=False)
    torch.testing.assert_close(got, ref.reshape(50, 4), atol=2e-2, rtol=2e-2)
    before = fm.launches
    empty = fm.fused_mlp_cuda(fm.pack_weights(model), o[:0], d[:0], z[:0])
    assert empty.shape == (4, 0, 1) and fm.launches == before


GRAD_BAR = 5e-2


def _grad_case(kw, R, S, device, seed=0):
    torch.manual_seed(seed)
    model = FlexibleNeRFModel(**kw, compute_dtype=torch.bfloat16, device=device)
    packed = fm.pack_weights(model)
    o, d, z = _rays(R, S, device, seed)
    rng = np.random.default_rng(seed + 1)
    cot = torch.from_numpy(rng.standard_normal((4, R, S)).astype(np.float32)).to(device)
    return packed, (o, d, z, cot)


def _worst_rel(packed, got, want):
    g, w = packed.segments(*got), packed.segments(*want)
    return max(float((g[k] - w[k]).abs().max() / (w[k].abs().max() + 1e-6)) for k in w)


def _truth_grads(packed, o, d, z, cot):
    """Float64 grads of sum(field * cot) in the packed layout: the field of
    the packed weights (skips as the spec says) in float64 with no bf16
    rounding, through autograd."""
    spec = packed.spec
    H, L = spec.hidden, spec.num_layers
    w = packed.weights.double().requires_grad_()
    b = packed.biases.double().requires_grad_()
    pts = (o[:, None, :] + d[:, None, :] * z[..., None]).reshape(-1, 3).double()
    dirs = d[:, None, :].expand(z.shape[0], z.shape[1], 3).reshape(-1, 3).double()
    pe_x = fm._padded_pe(pts, spec.L_x, spec.include_x, spec.log_x, spec.pxp).double()
    pe_d = fm._padded_pe(dirs, spec.L_d, spec.include_d, spec.log_d, spec.pdp).double()

    def layer(g, a, n):
        wg, bg = packed.gemm(g, n, a.shape[1], w, b)
        return torch.nn.functional.linear(a, wg, bg)

    x = layer(0, pe_x, H)
    for i in range(L - 1):
        x = torch.relu(layer(1 + i, torch.cat([x, pe_x], 1) if i in spec.skip_layers else x, H))
    wa, ba, wr, br = packed.heads(w, b)
    alpha = torch.nn.functional.linear(x, wa, ba)
    feat = torch.relu(layer(L, x, H))
    h = torch.relu(layer(L + 1, torch.cat([feat, pe_d], 1), H // 2))
    rgb = torch.sigmoid(torch.nn.functional.linear(h, wr, br))
    out = torch.cat([rgb, alpha], 1).t()
    (out * cot.reshape(4, -1).double()).sum().backward()
    return w.grad.float(), b.grad.float()


def _hold_grads(packed, args, got, want):
    """The backward kernel's grads against its plain version's: worst
    relative error per weight or bias under GRAD_BAR. Only the deepest
    packs from 640 wide on (MAX_LAYERS layers) may miss it, because there
    two plain runs that differ only in the order of their f32 sums (the
    card's and the host CPU's) already differ by up to 0.061 at 129,087
    points (scripts/torch_bwd_noise_floor.py, evenly over the pair's four
    column quarters); those are judged as tests/test_fused_mlp.py:127-166
    judges its edge cases: against a float64 truth of the same weights, no
    worse than twice the plain version or within GRAD_BAR."""
    worst = _worst_rel(packed, got, want)
    if worst < GRAD_BAR:
        return
    spec = packed.spec
    assert spec.hidden > 512 and spec.num_layers == fm.MAX_LAYERS, (
        f"worst grad rel err {worst}")
    truth = _truth_grads(packed, *args)
    err_kernel, err_plain = _worst_rel(packed, got, truth), _worst_rel(packed, want, truth)
    assert err_kernel < max(2.0 * err_plain, GRAD_BAR), (
        f"worst grad rel err {worst} vs plain; vs float64 {err_kernel} (plain {err_plain})")


@pytest.mark.parametrize("kw", [LEGO, ARCHS[4]], ids=["lego", "edge"])
@pytest.mark.parametrize("R,S", [(2048, 64), (2048, 192), (37, 5), (1000, 7)])
def test_bwd_kernel_matches_plain(cuda, kw, R, S):
    """Lego width at the train shapes, the edge of supports_fused (14
    layers, 24 bands), and ragged point counts (185: under one 128-point
    tile; 7000: four of the dW leg's point ranges, the last one short)."""
    if kw is not LEGO and R * S > 10000:
        pytest.skip("the edge architecture is checked at the ragged shapes")
    packed, args = _grad_case(kw, R, S, cuda)
    before = fm.bwd_launches
    got = fm.fused_mlp_bwd(packed, *args)
    torch.cuda.synchronize()
    assert fm.bwd_launches == before + 1
    want = fm.fused_mlp_bwd_plain(packed, *args)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert bool(torch.isfinite(g).all())
    worst = _worst_rel(packed, got, want)
    assert worst < GRAD_BAR, f"worst grad rel err {worst}"


# The wide backward's points: at fewer, its worst relative error against
# plain is rounding noise of the order of the bar. At 7000 points and 512
# wide it read 0.027-0.060 over three seeds (256 wide: 0.013-0.018;
# scripts/torch_bwd_stash_diff.py on an H100): every
# difference of the stashed activations a bf16 ulp or a ReLU mask flipped
# at |x| < 3e-4, evenly over both warpgroups' columns; a wider product sums
# more terms in another order and has more units near zero.
WIDE_BWD_SHAPES = [(2048, 64), (2048, 192), (2049, 63)]


@pytest.mark.parametrize("kw", WIDE, ids=ARCH_IDS[5:])
@pytest.mark.parametrize("R,S", WIDE_BWD_SHAPES)
def test_wide_bwd_kernel_matches_plain(cuda, kw, R, S):
    """384 to 1024 wide and the 14-layer edges at 512 and 1024, at the
    train shapes and at 129,087 points: the last 64-point tile 63 rows
    short and one more of tail rows only (n_pad 129,152), over 24 of the dW
    leg's ranges."""
    packed, args = _grad_case(kw, R, S, cuda)
    before = fm.bwd_launches
    got = fm.fused_mlp_bwd_cuda(packed, *args)
    torch.cuda.synchronize()
    assert fm.bwd_launches == before + 1
    want = fm.fused_mlp_bwd_plain(packed, *args)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    _hold_grads(packed, args, got, want)


@pytest.mark.parametrize("kw", [LEGO, *PAIRED[:4]], ids=["lego", *PAIRED_IDS[:4]])
def test_bwd_kernel_is_deterministic(cuda, kw):
    """No float atomics: two launches on the same inputs agree bit for bit
    (at H > 512 too, where a pair of CTAs exchanges its columns and head
    sums)."""
    packed, args = _grad_case(kw, 2048, 64, cuda)
    first = fm.fused_mlp_bwd_cuda(packed, *args)
    second = fm.fused_mlp_bwd_cuda(packed, *args)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


# At most this many point ranges split the dW leg's sums (DW_RANGES in
# csrc/fused_mlp_bwd.cu): the scratch nm_dw_product takes, per element.
DW_RANGES = 24


def _dw_product(dy, x, m, n):
    """The dW leg alone (nm_dw_product): (m, n) f32 = dy[:, :m]^T x[:, :n]."""
    n_pts, ldy = dy.shape
    lib = build.load_library()
    partial = torch.empty(DW_RANGES * (-(-m * n // 64) * 64), dtype=torch.float32,
                          device=dy.device)
    out = torch.empty((m, n), dtype=torch.float32, device=dy.device)
    rc = lib.nm_dw_product(dy.data_ptr(), ldy, m, x.data_ptr(), x.shape[1], n, n_pts,
                           partial.data_ptr(), partial.numel(), out.data_ptr(),
                           torch.cuda.current_stream().cuda_stream)
    build.check(lib, rc, "dw_product")
    return out


@pytest.mark.parametrize("n_pts,m,ldy,n,ldx", [
    (16, 64, 64, 256, 256),       # one m64n256k16 product per warpgroup
    (1, 64, 64, 256, 256),        # one point, 63 rows of TMA's zeros
    (64, 16, 16, 256, 256),       # a head: 16 dY columns, the rest zeros
    (65, 300, 304, 40, 48),       # 3 row blocks, a narrow X, a ragged stage
    (2047, 128, 128, 96, 96),     # under one point range
    (2048 + 64, 256, 256, 256, 256),  # one range and one stage
    (49280, 128, 128, 64, 96),    # 24 ranges of 2112 points, the last 704
    (4097, 512, 512, 384, 384),   # H = 384's columns: a 256-column job and a 128
    (6144, 512, 512, 512, 512),   # H = 512: 4 row blocks x 2 column jobs
])
def test_dw_leg_matches_torch_mm(cuda, n_pts, m, ldy, n, ldx):
    """The dW leg's MN-major operands (the stash's rows are the points,
    the contraction axis) through TMA and wgmma's transpose immediates,
    checked first on a single product, then at the edges of its stages,
    row blocks and point ranges."""
    g = torch.Generator(cuda).manual_seed(n_pts)
    dy = torch.randn((n_pts, ldy), generator=g, device=cuda).to(torch.bfloat16)
    x = torch.randn((n_pts, ldx), generator=g, device=cuda).to(torch.bfloat16)
    got = _dw_product(dy, x, m, n)
    torch.cuda.synchronize()
    a, b = dy[:, :m].float(), x[:, :n].float()
    want = a.t() @ b
    scale = a.abs().t() @ b.abs()
    assert bool(torch.isfinite(got).all())
    assert bool(((got - want).abs() <= 1e-4 * scale + 1e-6).all()), \
        float(((got - want).abs() / (scale + 1e-6)).max())


@pytest.mark.parametrize("kw,R,S", [
    (kw, R, S)
    for kw in (LEGO, ARCHS[1], ARCHS[4])
    for R, S in ((1000, 2), (2049, 1), (385, 128))
    # At 2000 points the edge architecture's worst relative error against
    # plain (0.0602) is a matter of which bf16 roundings of its cotangents
    # (the tile kernel's) fall the other way, as at 129 x 3 in
    # test_bwd_kernel_every_architecture: the wmma dW leg this kernel
    # replaced missed the bar there by the same amount.
    # test_dw_leg_matches_torch_mm holds the dW leg itself under one range.
    if not (kw is ARCHS[4] and R * S < 2048)
])
def test_bwd_kernel_dw_point_ranges(cuda, kw, R, S):
    """The backward at the dW leg's point-range edges: 2000 points (under
    one range), 2049 (one range and one 128-point tile), 49,280 (24 ranges,
    the last one short); H = 128 and 256, PE widths that are not multiples
    of 64 (small: 32 + 16, edge: 160 + 160)."""
    packed, args = _grad_case(kw, R, S, cuda, seed=R)
    got = fm.fused_mlp_bwd_cuda(packed, *args)
    torch.cuda.synchronize()
    want = fm.fused_mlp_bwd_plain(packed, *args)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    worst = _worst_rel(packed, got, want)
    assert worst < GRAD_BAR, f"worst grad rel err {worst}"


def test_training_function_launches_both_kernels(cuda):
    model = FlexibleNeRFModel(**LEGO, compute_dtype=torch.bfloat16, device=cuda)
    o, d, z = _rays(256, 16, cuda)
    before = (fm.launches, fm.bwd_launches)
    out = fm.fused_flexible_apply_rays(model, o, d, z)
    out.square().sum().backward()
    torch.cuda.synchronize()
    assert (fm.launches, fm.bwd_launches) == (before[0] + 1, before[1] + 1)
    for name, p in model.named_parameters():
        assert p.grad is not None and p.grad.dtype == torch.float32, name
        assert bool(torch.isfinite(p.grad).all()), name


def test_train_step_never_waits_for_the_device(cuda):
    """A call of the train step (sampling, both passes through both
    kernels, Adam) enqueues without one device-to-host sync."""
    from nerfmeshes_tpu_torch.config import get_default_cfg
    from nerfmeshes_tpu_torch.train.system import NeRFSystem

    cfg = get_default_cfg()
    cfg.nerf.train.num_random_rays = 256
    cfg.nerf.train.perturb = True
    cfg.experiment.steps_per_call = 2
    rng = np.random.default_rng(0)
    poses = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    poses[:, 2, 3] = 4.0
    data = {"targets": torch.from_numpy(rng.uniform(0, 1, (3, 8, 8, 3)).astype(np.float32)).to(cuda),
            "poses": torch.from_numpy(poses).to(cuda),
            "bounds": torch.tensor([2.0, 6.0], device=cuda), "hwf": (8, 8, 10.0)}
    system = NeRFSystem(cfg, device=cuda).setup(data)
    system.state, _ = system._train_fn(system.state, data)  # first call: allocations
    torch.cuda.synchronize()
    launches = (fm.launches, fm.bwd_launches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        system.state, metrics = system._train_fn(system.state, data)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert (fm.launches - launches[0], fm.bwd_launches - launches[1]) == (4, 4)
    assert np.isfinite(float(metrics["train/loss"]))


@pytest.mark.parametrize("kw", [LEGO, ARCHS[1]], ids=["lego", "small"])
@pytest.mark.parametrize("R,S", [(1, 1), (127, 1), (128, 1), (129, 1), (2049, 64)])
def test_bwd_kernel_tile_edges(cuda, kw, R, S):
    """Point counts at the edges of the tile kernel's 128-point tiles (and
    of its warpgroups' 64-point halves): tail rows take the point 0 and a
    zero cotangent and must add nothing to any grad."""
    if kw is not LEGO and R * S > 10000:
        pytest.skip("the small architecture is checked at the single-sample edges")
    packed, args = _grad_case(kw, R, S, cuda, seed=R)
    got = fm.fused_mlp_bwd_cuda(packed, *args)
    torch.cuda.synchronize()
    want = fm.fused_mlp_bwd_plain(packed, *args)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    worst = _worst_rel(packed, got, want)
    assert worst < GRAD_BAR, f"worst grad rel err {worst}"


def _bwd_into(packed, args, workspace):
    """The kernel on a workspace the caller made."""
    return fm.fused_mlp_bwd_cuda(packed, *args, workspace=workspace)


@pytest.mark.parametrize("R,S", [(37, 5), (1000, 7)])
def test_bwd_kernel_writes_every_row_it_reads(cuda, R, S):
    """A workspace full of NaN: the tile kernel must write every stash row
    and every bias partial the dW products and reductions read, the tail
    rows of the last tile included (finite activations, zero cotangents)."""
    packed, args = _grad_case(LEGO, R, S, cuda, seed=3)
    nbytes = fm.bwd_workspace_bytes(packed, R * S)
    assert nbytes % 4 == 0
    workspace = torch.full((nbytes // 4,), float("nan"), device=cuda).view(torch.uint8)
    got = _bwd_into(packed, args, workspace)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(g).all()) for g in got)
    want = fm.fused_mlp_bwd_plain(packed, *args)
    worst = _worst_rel(packed, got, want)
    assert worst < GRAD_BAR, f"worst grad rel err {worst}"
    again = fm.fused_mlp_bwd_cuda(packed, *args)  # on a fresh torch.empty workspace
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    with pytest.raises(ValueError, match="workspace"):
        fm.fused_mlp_bwd_cuda(packed, *args, workspace=workspace[:nbytes - 1])


@dataclasses.dataclass(frozen=True)
class _SkipSpec(fm.MLPSpec):
    """A spec whose skips are given, not derived from skip_step: the
    kernels take any skip mask, the models make only some."""

    skips: tuple = ()

    @property
    def skip_layers(self) -> tuple:
        return self.skips


def _pack_with_skips(hidden, num_layers, skips, device, seed=0, L_x=6, L_d=3):
    """A pack of seeded weights laid out as pack_params lays them out, with
    PE(xyz) fed into the trunk layers in `skips`; L_x and L_d bands (a pack
    that supports_fused may refuse)."""
    spec = _SkipSpec(num_layers=num_layers, hidden=hidden, skip_step=1, L_x=L_x, L_d=L_d,
                     include_x=True, include_d=True, log_x=True, log_d=True,
                     skips=tuple(skips))
    rng = np.random.default_rng(seed)
    shapes = spec.gemm_shapes() + [(1, hidden), (3, hidden // 2)]
    mats = [rng.standard_normal((n, k)) / np.sqrt(k) for n, k in shapes]
    vecs = [0.1 * rng.standard_normal(n) for n, _ in shapes]
    w_offs = np.cumsum([0] + [m.size for m in mats]).tolist()
    b_offs = np.cumsum([0] + [v.size for v in vecs]).tolist()
    n_gemms = num_layers + 2
    desc = np.asarray(
        [num_layers, hidden, sum(1 << i for i in skips), spec.L_x, spec.L_d, 1, 1, spec.pxp,
         spec.pdp, w_offs[n_gemms], b_offs[n_gemms], w_offs[n_gemms + 1], b_offs[n_gemms + 1]]
        + w_offs[:n_gemms] + b_offs[:n_gemms], dtype=np.int32)
    freqs = np.concatenate([frequency_bands(spec.L_x, True),
                            frequency_bands(spec.L_d, True)]).astype(np.float32)
    weights = torch.from_numpy(np.concatenate([m.ravel() for m in mats]).astype(np.float32))
    biases = torch.from_numpy(np.concatenate(vecs).astype(np.float32))
    return fm.PackedMLP(spec, weights.to(device=device, dtype=torch.bfloat16), biases.to(device),
                        desc, freqs)


@pytest.mark.parametrize("hidden", fm.HIDDEN_SIZES)
def test_kernels_take_skips_after_layer1_and_the_last_trunk_layer(cuda, hidden):
    """Skips the models never make (trunk layer 0, right after layer1, and
    the last trunk layer) through the forward and the backward."""
    packed = _pack_with_skips(hidden, 6, (0, 4), cuda)
    assert packed.spec.gemm_shapes()[1][1] == hidden + packed.spec.pxp
    o, d, z = _rays(2048, 8, cuda, seed=5)
    got = fm.fused_mlp_cuda(packed, o, d, z)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, fm.fused_mlp_plain(packed, o, d, z), atol=2e-2, rtol=2e-2)
    rng = np.random.default_rng(6)
    cot = torch.from_numpy(rng.standard_normal((4, 2048, 8)).astype(np.float32)).to(cuda)
    got = fm.fused_mlp_bwd_cuda(packed, o, d, z, cot)
    torch.cuda.synchronize()
    want = fm.fused_mlp_bwd_plain(packed, o, d, z, cot)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    worst = _worst_rel(packed, got, want)
    assert worst < GRAD_BAR, f"worst grad rel err {worst}"


# (H, L_x, L_d) around the wide kernels' shared-memory edge: PE widths
# pxp + pdp of 128 (512 and 1024: every kernel fits), 144 (512: the
# backward refused; 1024: the forward and the backward), 192 (512: the
# backward; 1024: all three, sigma's 160 columns too), 320 (512 and 896:
# only sigma fits; 384, 640 and 768: every kernel).
PLAN_EDGE = [(512, 15, 4), (512, 15, 5), (512, 24, 4), (512, 24, 24), (384, 24, 24),
             (640, 24, 24), (768, 24, 24), (896, 24, 24), (1024, 15, 4), (1024, 15, 5),
             (1024, 24, 4)]


@pytest.mark.parametrize("hidden,L_x,L_d", PLAN_EDGE)
def test_launches_refuse_exactly_what_the_plan_refuses(cuda, hidden, L_x, L_d):
    """The route's mirror of the shared-memory plan (fm.field_plan) against
    the launches themselves: each of the three fused kernels runs (and
    matches its plain version) where the mirror has a plan, and is refused
    without a launch where it has none; field_route sends the architecture
    to the fused kernels only at FUSED_WIDTHS and where all three run
    (supports_fused admits it either way)."""
    packed = _pack_with_skips(hidden, fm.MAX_LAYERS, (4, 8), cuda, L_x=L_x, L_d=L_d)
    spec = packed.spec
    R, S = WIDE_BWD_SHAPES[-1]
    o, d, z = _rays(R, S, cuda, seed=7)
    cot = torch.from_numpy(np.random.default_rng(8).standard_normal((4, R, S))
                           .astype(np.float32)).to(cuda)
    pts = (o[:, None] + d[:, None] * z[..., None]).reshape(-1, 3)
    cases = {
        "fwd": (lambda: fm.fused_mlp_cuda(packed, o, d, z),
                lambda: fm.fused_mlp_plain(packed, o, d, z), "launches"),
        "sigma": (lambda: fm.fused_sigma_cuda(packed, pts),
                  lambda: fm.fused_sigma_plain(packed, pts), "sigma_launches"),
        "bwd": (lambda: fm.fused_mlp_bwd_cuda(packed, o, d, z, cot),
                lambda: fm.fused_mlp_bwd_plain(packed, o, d, z, cot), "bwd_launches"),
    }
    model = FlexibleNeRFModel(num_layers=fm.MAX_LAYERS, hidden_size=hidden,
                              num_encoding_fn_xyz=L_x, num_encoding_fn_dir=L_d)
    assert fm.supports_fused(model)
    fused = all(fm.field_plan(spec, k) is not None for k in cases)
    assert fm.field_route(fm.spec_from_model(model)) == (
        "fused" if fused and hidden in fm.FUSED_WIDTHS else "layers")
    for kernel, (run, plain, counter) in cases.items():
        before = getattr(fm, counter)
        if fm.field_plan(spec, kernel) is None:
            with pytest.raises(RuntimeError, match="launch failed"):
                run()
            assert getattr(fm, counter) == before, kernel
            continue
        got = run()
        torch.cuda.synchronize()
        want = plain()
        if kernel == "bwd":
            _hold_grads(packed, (o, d, z, cot), got, want)
        else:
            torch.testing.assert_close(got, want, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("kw", ARCHS, ids=ARCH_IDS)
def test_bwd_kernel_every_architecture(cuda, kw):
    """Every architecture of the forward's tests, 1000 rays x 7 samples: H =
    128 to 1024, no include_input, the 24-band 14-layer edge (one PE tile,
    two ring slots) and the 14-layer edges at 512 and 1024. Fewer points
    make the worst relative error a matter of which bf16 roundings fall the
    other way: at 129 x 3 the lego and edge grads of this kernel and of its
    wmma predecessor both miss the bar against plain, by the same amount;
    the wide ones are held at WIDE_BWD_SHAPES' ragged count."""
    R, S = (1000, 7) if kw["hidden_size"] <= 256 else WIDE_BWD_SHAPES[-1]
    packed, args = _grad_case(kw, R, S, cuda)
    got = fm.fused_mlp_bwd_cuda(packed, *args)
    torch.cuda.synchronize()
    want = fm.fused_mlp_bwd_plain(packed, *args)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    _hold_grads(packed, args, got, want)


def test_bwd_kernel_refuses_what_its_shared_memory_cannot_hold(cuda):
    """As the forward: a descriptor whose PE tiles leave no room for two
    weight stages is refused before any of the backward's launches."""
    packed, (o, d, z, cot) = _grad_case(LEGO, 64, 2, cuda)
    desc = packed.desc.copy()
    desc[7] = 1024  # pxp: PE(xyz) 1024 columns wide
    before = fm.bwd_launches
    with pytest.raises(RuntimeError, match="fused_mlp_bwd launch failed"):
        fm.fused_mlp_bwd_cuda(packed._replace(desc=desc), o, d, z, cot)
    assert fm.bwd_launches == before


def _digest_script():
    path = Path(__file__).resolve().parents[1] / "scripts" / "torch_field_digest.py"
    spec = importlib.util.spec_from_file_location("torch_field_digest", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# SHA-256 of the forward's (4, 2048, 64) output and the sigma kernel's
# (65536,) output on scripts/torch_field_digest.py's seeded lego case, as
# the kernels of fused_field.cuh gave them before the backward came to
# share that file; and of the backward's f32 bias grads on that case, as
# the tile kernel gave them before the dW leg moved to wgmma (the script's
# output on the card, NVIDIA H100 80GB HBM3).
FIELD_DIGESTS = {"fwd": "8d7ba437dfa4bddc37a1d4a483f17ba1d1a72746f68e286be08dcedee5fdaa14",
                 "sigma": "b411031d57dc210ff8db8d732c2429f4fe3ece1333c18ce59cacdb31f45300c6"}
BWD_DB_DIGEST = "3773569aeb78333ab97512fd843f273ef5211dea8d9ddedbb71da113df686ae7"


@pytest.fixture(scope="module")
def field_digests():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return _digest_script().digests(torch.device("cuda"))


# SHA-256 per width of scripts/torch_field_digest.py's BWD_WIDTHS (`--fwd`:
# 8 layers at L 10/4, the forward on 1999 x 64 rays, a ragged last tile,
# and sigma on 65,536 points) of the forward's and the sigma kernel's
# outputs, as the kernels gave them while the 128- and 256-wide fields kept
# their activations in shared memory (the script through `--fwd --tree` on
# that tree; NVIDIA H100 80GB HBM3). The register design runs the same
# products in the same K order on the same bf16 values, so each stays.
FWD_DIGESTS = {
    "w128": {"fwd": "49d0229fb281aab61a4a6173b60bda54b7cf1a2c080ea9366da2d03fd759cb55",
             "sigma": "cdb4644595a51c98803760c76e0c8ba349ea1f243ba13f06df696b1868c2dbc3"},
    "w256": {"fwd": "ed2492db93520193fcdc94321f0151bbc6fe2625b3a022b55f5d5dcc7c1e2ebf",
             "sigma": "ac8fb9f8e4de18abf971713aaa445d1752df70424d80b7432fbe458b7a348e17"},
    "w384": {"fwd": "c03488eafdc8ac6b9d5d8fcb75a12884d393441adc9aa2f7049d34d23752b3a0",
             "sigma": "ec681584b518998fd8411acb615485ed53f09fdcf90bb4d7ffc3c697d25a001e"}}


def test_forward_and_sigma_keep_their_bits_at_each_width(cuda):
    """At 128, 256 (the register design) and 384 wide (the split design),
    the forward's and the sigma kernel's outputs stay bit for bit what
    they were."""
    assert _digest_script().fwd_digests(cuda) == FWD_DIGESTS


# The register design's widths (csrc/fused_field.cuh:field_body_regs):
# lego's 8x256 and hard-llff.yml's 8x128 at L 10/4, and the 24-band,
# 14-layer edge of the gate at both (one PE slot at 256, so the PE warps
# build a tile only once the consumers are done with the last).
REGS_ARCHS = [LEGO, dict(LEGO, hidden_size=128),
              dict(LEGO, num_layers=fm.MAX_LAYERS, num_encoding_fn_xyz=fm.MAX_BANDS,
                   num_encoding_fn_dir=fm.MAX_BANDS),
              dict(LEGO, hidden_size=128, num_layers=fm.MAX_LAYERS,
                   num_encoding_fn_xyz=fm.MAX_BANDS, num_encoding_fn_dir=fm.MAX_BANDS)]
REGS_IDS = ["lego", "llff", "edge", "edge-w128"]


@pytest.mark.parametrize("kw", REGS_ARCHS, ids=REGS_IDS)
@pytest.mark.parametrize("R,S", [(1, 1), (1, 7), (1024, 64), (333, 77), (8191, 3), (2500, 40)])
def test_register_design_matches_plain(cuda, kw, R, S):
    """The forward and the sigma kernel at 128 and 256 wide against their
    plain versions (atol = rtol = 2e-2) at point counts off the 128-point
    tile: one point, one ray, fewer tiles than SMs (1024 x 64: 512 tiles,
    1 x 7: one tile of 7 rows), CTAs that walk two tiles and more (25,641,
    24,573 and 100,000 points), so that the PE slots' barriers turn over;
    sigma bit for bit the forward's channel 3 at the same points."""
    torch.manual_seed(0)
    model = FlexibleNeRFModel(**kw, compute_dtype=torch.bfloat16, device=cuda)
    packed = fm.pack_weights(model)
    o, d, z = _rays(R, S, cuda, seed=R + S)
    before = (fm.launches, fm.sigma_launches)
    got = fm.fused_mlp_cuda(packed, o, d, z)
    pts = (o[:, None, :] + d[:, None, :] * z[..., None]).reshape(-1, 3)
    sigma = fm.fused_sigma_cuda(packed, pts)
    torch.cuda.synchronize()
    assert (fm.launches, fm.sigma_launches) == (before[0] + 1, before[1] + 1)
    assert bool(torch.isfinite(got).all()) and bool(torch.isfinite(sigma).all())
    torch.testing.assert_close(got, fm.fused_mlp_plain(packed, o, d, z), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(sigma, fm.fused_sigma_plain(packed, pts), atol=2e-2, rtol=2e-2)
    zeros = torch.zeros_like(pts)
    assert torch.equal(sigma, fm.fused_mlp_cuda(packed, pts, zeros, zeros[:, :1])[3, :, 0])


def test_forward_and_sigma_keep_their_bits(field_digests):
    """The backward reuses fused_field.cuh; the forward's and the sigma
    kernel's outputs stay bit for bit what they were."""
    assert {k: field_digests[k] for k in FIELD_DIGESTS} == FIELD_DIGESTS


def test_backward_keeps_its_bias_grad_bits(field_digests):
    """The bias grads come from the tile kernel and the reductions alone:
    they stay bit for bit what they were when the dW leg changed."""
    assert field_digests["bwd_dB"] == BWD_DB_DIGEST


# SHA-256 of the backward's f32 dW on that seeded lego case ("bwd_dW"), and
# per width of scripts/torch_field_digest.py's BWD_WIDTHS (`--bwd`: 8
# layers at L 10/4, 1999 x 64 rays, a ragged last tile) of dW, dB, the
# stash's act and feat rows, its dy and dy_dir rows and the whole stash, as
# the tile kernel gave them while it stored the stash from its fragments
# (the script on that tree, and through `--bwd --tree` on it; NVIDIA H100
# 80GB HBM3). The TMA stores send the same bytes and the products keep
# their K order, so every one stays.
BWD_DW_DIGEST = "42700af8f84565b8dd36d7683446de25e292cd1d714fc9f7af007cd4a4ef5643"
BWD_DIGESTS = {
    "w128": {"dW": "90796abb95c5e465751d6df2c849e2fe7cf16eb672f438bf9759c8c4f5827bfd",
             "dB": "fcc5ac029fded36b24a9aa2b14f407767b9ab842990d454acd54744f172812ee",
             "act": "877efb11bc239d3d71939b5fa7c763e3d4a63f683d2d548a7e3695677557cf9d",
             "dy": "22a24a61ff3ce59a6157c4c7815a6f9fdfce892d79542416cc7e8dd279a68506",
             "stash": "6945dac558cdb68b45e52a5715381d14730348c6ba07377c624a76ae8701b523"},
    "w256": {"dW": "26aec0eda93a732522dbbf2f2ac2fd123e0ffeeca4e359baf345845388e2d45c",
             "dB": "164133396381b797f46b43862bb40a08e0057489c1036a821ac8c146e921c677",
             "act": "e5b2ad0c60191770eb180716410687f902a7341a73c39bb460df3a1db5183c1a",
             "dy": "90f906c853cdd49eab2407a1d69fbaba3a921e76d592996904fa03b0cd1a04e2",
             "stash": "6615d96340783fba36a3921da8aa66c54286a73729cdbd1faff208f1e51e92f1"},
    "w384": {"dW": "508fe6663e4fe9518306f928e4d0d86fe76b6cc5274424cd0496ce9de6a9a853",
             "dB": "b30b84a3008ea9714f7ccac12095a1e7b186a0c309edc323dc79dd3e3c4c9748",
             "act": "3649e34511d13d9f308f8b7ed1a599a8caa8fa15c59d1f094f1b6639b9a5e846",
             "dy": "4bbf48507074c80f00b995f27b88c91f3bb253fce6a8eb6afbf371ad454c9ead",
             "stash": "7c7b30abc2e6d2527e7e460797efa38a01a81e51f27df85f0f86978629a015dc"}}


def test_backward_keeps_its_weight_grad_bits(field_digests):
    """dW on the lego case stays bit for bit what it was before the tile
    kernel's stash went out by TMA stores."""
    assert field_digests["bwd_dW"] == BWD_DW_DIGEST


def test_backward_keeps_its_stash_bits(cuda):
    """At 128, 256 and 384 wide, dW, dB and every stash region the tile
    kernel writes (the TMA stores' act, feat, dy and dy_dir rows among
    them) stay bit for bit what they were."""
    assert _digest_script().bwd_digests(cuda) == BWD_DIGESTS


# SHA-256 of the layer route's forward (4, 512, 64) and sigma (65,536,)
# outputs, the backward's f32 dW and the dir layer's bf16 cotangent dy_dir
# on scripts/torch_field_digest.py's seeded 8x1024 field at L 16/4
# (`--layers`), as the product kernel of one 128 x 256 tile a CTA and the
# warp-per-point heads kernel gave them (the script's output on the card,
# NVIDIA H100 80GB HBM3; dy_dir through `--tree` on the tree before the
# heads kernel's redesign): the product kernel's redesign keeps each output
# element's K order and epilogue, the heads kernel's each element's
# arithmetic, so the route keeps those bits. The f32 dB, whose sums the
# one bias-grad reduction a slab takes in another order (row groups
# across blocks, then the groups in order), as that reduction gives it.
LAYER_DIGESTS = {
    "fwd": "5a841151a7b33035f3e3f57781824c0c852b1fabeceb6542b8177d5046bc4280",
    "sigma": "8562954caa85199bd33c584b0f863c88b6ff52f4a0d994050a1c7d7aeaa0a7e6",
    "bwd_dB": "6e88af5513eb5570a20904a366de45b4544db9ef0cb0227babeb96b7823daeeb",
    "bwd_dW": "9f051d06c3855c9fc4f6e4c84f74e4d6a1bb85829fd6fbf5abd75771eb524a7a",
    "bwd_dy_dir": "017c61831bd4d7cde02d8f64950dc10cfac0ea001b8c4d003c2fcf741ccd676c"}


def test_layer_route_keeps_its_bits(cuda):
    """The layer route's forward, sigma, dW and dy_dir stay bit for bit
    what they were before its product and backward heads kernels'
    redesigns; dB is the bias-grad reduction's."""
    assert _digest_script().layer_digests(cuda) == LAYER_DIGESTS


# ---- the layer route (csrc/field_layers.cu): every model supports_fused
# admits that field_route does not send to the fused kernels. The chip
# smoke's shapes scaled down: 8 layers at 1024 wide with mip-NeRF's 16
# position bands, past 1024 (1152, 2048), 16 layers, 32 bands; a deep
# narrow field without the raw inputs; and 8 layers at 512 and 1024 wide
# (L 10/4), which the fused plans hold and the route sends here.
# Tolerances as above; where plain against plain already misses the grad
# bar by rounding noise, the float64 truth decides (_hold_layer_grads).
LAYER_ARCHS = [
    dict(LEGO, hidden_size=1024, num_encoding_fn_xyz=16),
    dict(LEGO, hidden_size=1152),
    dict(LEGO, hidden_size=2048),
    dict(LEGO, num_layers=16),
    dict(LEGO, num_encoding_fn_xyz=32),
    dict(num_layers=16, hidden_size=128, skip_step=3, num_encoding_fn_xyz=25,
         num_encoding_fn_dir=25, include_input_xyz=False, include_input_dir=False),
    dict(LEGO, hidden_size=512),
    dict(LEGO, hidden_size=1024),
]
LAYER_IDS = ["w1024-L16", "w1152", "w2048", "deep16", "bands32", "narrow", "w512", "w1024"]


def _layer_model(kw, device, seed=0):
    torch.manual_seed(seed)
    model = FlexibleNeRFModel(**kw, compute_dtype=torch.bfloat16, device=device)
    packed = fm.pack_weights(model)
    assert fm.supports_fused(model) and fm.field_route(packed.spec) == "layers"
    return packed


def _hold_layer_grads(packed, args, got, want):
    """The layer route's grads against plain's: worst relative error under
    GRAD_BAR, or, where the two miss it, against a float64 truth no worse
    than twice the plain version (as _hold_grads' deepest packs)."""
    worst = _worst_rel(packed, got, want)
    if worst < GRAD_BAR:
        return
    truth = _truth_grads(packed, *args)
    err_kernel, err_plain = _worst_rel(packed, got, truth), _worst_rel(packed, want, truth)
    assert err_kernel < max(2.0 * err_plain, GRAD_BAR), (
        f"worst grad rel err {worst} vs plain; vs float64 {err_kernel} (plain {err_plain})")


# (m, k1, k2, n, nn): a trunk product, a skip ([x | PE]), dir's narrow N
# with its PE part, ragged rows, the dX chain's untransposed weights; then
# what only the persistent kernel can get wrong: more tiles than CTAs
# (42,240 rows: 2,640 128 x 256 tiles, 20 a CTA on 132 SMs; 42,241: a
# ragged last wave), fewer tiles than SMs (one row), n a multiple of 64
# but not of 256 (tiles 192 or 64 wide, 1088 on 192 with 64 empty
# columns), with and without k2, and the mask and column sums (nn)
PRODUCTS = [(256, 256, 0, 256, False), (300, 256, 80, 256, False), (129, 1152, 32, 576, False),
            (1, 64, 0, 64, False), (4097, 208, 0, 1024, False), (300, 256, 0, 512, True),
            (129, 576, 0, 1152, True), (1000, 128, 0, 2048, True),
            (42240, 2048, 0, 2048, False), (42241, 2048, 0, 2048, True), (1, 64, 0, 64, True),
            (300, 256, 0, 320, False), (300, 256, 48, 320, False), (513, 512, 0, 576, False),
            (513, 512, 64, 576, False), (257, 1024, 0, 1088, False),
            (257, 1024, 32, 1088, False), (300, 320, 0, 576, True), (1000, 576, 0, 1088, True)]


def _product_case(m, k1, k2, n, nn, device):
    """A product's operands and epilogue, seeded by its shape."""
    g = torch.Generator(device).manual_seed(m + n)
    a1 = torch.randn((m, k1), generator=g, device=device).to(torch.bfloat16)
    a2 = None if k2 == 0 else torch.randn((m, k2), generator=g, device=device).to(torch.bfloat16)
    k = k1 + k2
    w = (torch.randn((k, n + 64) if nn else (n, k), generator=g, device=device) / k ** 0.5
         ).to(torch.bfloat16)
    bias = None if nn else torch.randn(n, generator=g, device=device)
    mask = (torch.randn((m, n), generator=g, device=device).to(torch.bfloat16) if nn else None)
    return (a1, a2, w, n), dict(nn=nn, bias=bias, relu=not nn, mask=mask)


@pytest.mark.parametrize("m,k1,k2,n,nn", PRODUCTS)
def test_layer_product_matches_plain(cuda, m, k1, k2, n, nn):
    """The product kernel alone against its plain version: bf16 outputs
    within 1e-2 of each other's magnitude (the sums' order differs, so a
    bf16 rounding may fall the other way), column sums within 1e-4 of the
    sum of magnitudes; with bias and ReLU, and with the backward's mask."""
    (a1, a2, w, n), kw = _product_case(m, k1, k2, n, nn, cuda)
    got, got_cs = fl.layers_product_cuda(a1, a2, w, n, **kw)
    torch.cuda.synchronize()
    want, want_cs = fl.layers_product_plain(a1, a2, w, n, **kw)
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= 1e-2 * want.float().abs() + 1e-2 * float(want.float().abs().max())).all())
    mag = fl.layers_product_plain(a1.abs(), None if a2 is None else a2.abs(), w.abs(), n,
                                  nn=nn)[1]
    assert bool(((got_cs - want_cs).abs() <= 1e-4 * mag + 1e-2).all())


@pytest.mark.parametrize("m,k1,k2,n,nn", [PRODUCTS[i] for i in (2, 4, 9, 14, 18)])
def test_layer_product_is_deterministic(cuda, m, k1, k2, n, nn):
    """Two calls of the persistent product kernel give the same bits, out
    and column sums (no float atomics; each tile's sums in a fixed order
    whichever CTA computes it)."""
    args, kw = _product_case(m, k1, k2, n, nn, cuda)
    first = fl.layers_product_cuda(*args, **kw)
    again = fl.layers_product_cuda(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])


def test_layer_product_plan_is_the_c_plan(cuda):
    """product_plan (the Python mirror the CPU tests check) is the plan
    the C launches with on this card, at every tile width and at the
    route's widths; a route call launches the product kernel once per
    product route_products lists."""
    limit = torch.cuda.get_device_properties(cuda).shared_memory_per_block_optin
    for n in (64, 128, 192, 256, 320, 576, 640, 1024, 1088, 1152, 2048, 4096):
        assert fl.layers_product_plan_c(n) == fl.product_plan(n, smem_limit=limit), n
    packed = _layer_model(LAYER_ARCHS[1], cuda)
    o, d, z = _rays(64, 4, cuda)
    cot = torch.zeros((4, 64, 4), device=cuda)
    for kind, call in (("fwd", lambda: fl.layers_mlp_cuda(packed, o, d, z)),
                       ("sigma", lambda: fl.layers_sigma_cuda(packed, o)),
                       ("bwd", lambda: fl.layers_bwd_cuda(packed, o, d, z, cot))):
        before = fl.kernel_launches["product"]
        call()
        assert fl.kernel_launches["product"] - before == len(fl.route_products(packed.spec, kind))
    torch.cuda.synchronize()


@pytest.mark.parametrize("kw", LAYER_ARCHS, ids=LAYER_IDS)
@pytest.mark.parametrize("R,S", [(256, 16), (37, 5)])
def test_layer_route_matches_plain(cuda, kw, R, S):
    """Forward, sigma and backward on the layer route against the plain
    versions; sigma bit for bit the forward's channel 3; two backward
    calls bit for bit equal; one route call each, counted, and no launch
    of the fused kernels."""
    packed = _layer_model(kw, cuda)
    o, d, z = _rays(R, S, cuda)
    before = (fm.launches, fm.sigma_launches, fm.bwd_launches)
    counts = (fl.launches, fl.sigma_launches, fl.bwd_launches)
    got = fm.fused_mlp_rays(packed, o, d, z)
    pts = (o[:, None, :] + d[:, None, :] * z[..., None]).reshape(-1, 3)
    sigma = fm.fused_sigma_points(packed, pts)
    zeros = torch.zeros_like(pts)
    full = fl.layers_mlp_cuda(packed, pts, zeros, zeros[:, :1])
    cot = torch.from_numpy(np.random.default_rng(1).standard_normal((4, R, S))
                           .astype(np.float32)).to(cuda)
    grads = fm.fused_mlp_bwd(packed, o, d, z, cot)
    again = fl.layers_bwd_cuda(packed, o, d, z, cot)
    torch.cuda.synchronize()
    assert (fm.launches, fm.sigma_launches, fm.bwd_launches) == before
    assert (fl.launches, fl.sigma_launches, fl.bwd_launches) == (
        counts[0] + 2, counts[1] + 1, counts[2] + 2)
    torch.testing.assert_close(got, fm.fused_mlp_plain(packed, o, d, z), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(sigma, fm.fused_sigma_plain(packed, pts), atol=2e-2, rtol=2e-2)
    assert torch.equal(sigma, full[3, :, 0])
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    _hold_layer_grads(packed, (o, d, z, cot), grads,
                      fm.fused_mlp_bwd_plain(packed, o, d, z, cot))


@pytest.mark.parametrize("kw", [LAYER_ARCHS[1], LAYER_ARCHS[3]], ids=["w1152", "deep16"])
def test_layer_route_in_slabs(cuda, kw, monkeypatch):
    """A workspace bound that holds 384 points at a time: 4097 points go
    through in 11 slabs, the last one 257 short; each slab's grads added
    to the running ones. Against plain as above."""
    packed = _layer_model(kw, cuda, seed=2)
    o, d, z = _rays(4097, 1, cuda, seed=2)
    cot = torch.from_numpy(np.random.default_rng(3).standard_normal((4, 4097, 1))
                           .astype(np.float32)).to(cuda)
    for kind in ("fwd", "sigma", "bwd"):
        assert fl.slab_points(packed.spec, kind, 4097,
                              fl.workspace_bytes(packed.spec, kind, 384)) == 384
    launched = fl.kernel_launches["pe"]
    calls = {"fwd": lambda: fl.layers_mlp_cuda(packed, o, d, z),
             "sigma": lambda: fl.layers_sigma_cuda(packed, o),
             "bwd": lambda: fl.layers_bwd_cuda(packed, o, d, z, cot)}
    out = {}
    for kind, call in calls.items():
        monkeypatch.setattr(fl, "LAYER_WORKSPACE_BOUND",
                            fl.workspace_bytes(packed.spec, kind, 384))
        out[kind] = call()
    torch.cuda.synchronize()
    assert fl.kernel_launches["pe"] - launched == 3 * 11  # a PE launch a slab
    for kind in calls:  # every kernel's launches, as call_launches predicts them
        monkeypatch.setattr(fl, "LAYER_WORKSPACE_BOUND",
                            fl.workspace_bytes(packed.spec, kind, 384))
        before = dict(fl.kernel_launches)
        calls[kind]()
        want = fl.call_launches(packed.spec, kind, 4097)
        assert {k: fl.kernel_launches[k] - before[k] for k in fl.KERNELS} == want, kind
        assert want["pe"] == 11 and want["bias"] == want["heads_bwd"] == (
            11 if kind == "bwd" else 0)
    got, sigma, grads = out["fwd"], out["sigma"], out["bwd"]
    torch.testing.assert_close(got, fm.fused_mlp_plain(packed, o, d, z), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(sigma, fm.fused_sigma_plain(packed, o), atol=2e-2, rtol=2e-2)
    _hold_layer_grads(packed, (o, d, z, cot), grads,
                      fm.fused_mlp_bwd_plain(packed, o, d, z, cot))


def _fused_stash_pe(kw, R, S, device, seed):
    """(packed, rays, the PE the fused backward's tile kernel builds for its
    first product and stashes: [PE(xyz) | PE(dir)] rows of the workspace)."""
    packed, args = _grad_case(kw, R, S, device, seed=seed)
    workspace = torch.zeros(fm.bwd_workspace_bytes(packed, R * S), dtype=torch.uint8,
                            device=device)
    _bwd_into(packed, args, workspace)
    cols = packed.spec.pxp + packed.spec.pdp
    stash = workspace[:R * S * cols * 2].view(torch.bfloat16).view(R * S, cols)
    return packed, args, stash


# (bands, rays, samples): the lego's 10/4 at 7 samples a ray (blocks of
# 128 points over 19 rays), mip-NeRF's 16/4 (sin and cos arguments past
# the fast path's range) at 192 samples (a block inside one ray) and at one
# (a ray a point), and 32/4 at 64 samples, past the fused kernels' 24
# bands: its first 24 bands are a 24-band field's, which the fused kernels
# build.
PE_CASES = [(10, 1000, 7), (16, 40, 192), (16, 5000, 1), (32, 100, 64)]


@pytest.mark.parametrize("L_x,R,S", PE_CASES, ids=["L10-S7", "L16-S192", "L16-S1", "L32-S64"])
def test_layer_pe_is_the_fused_pe(cuda, L_x, R, S):
    """On a model both routes could take (lego, L_x/4 bands), the layer
    route's PE kernel gives bit for bit the PE the fused backward's tile
    kernel builds for its first product (and stashes: the first pxp + pdp
    columns of each of the workspace's first rows); at points, the same
    PE(xyz) as of the rays. Past 24 bands the fused kernels take none: the
    32-band PE's raw columns, first 24 bands of sin and cos, padding and
    PE(dir) are the 24-band fused PE's, bit for bit, its last 8 bands
    finite sines and cosines."""
    kw = dict(LEGO, num_encoding_fn_xyz=L_x)
    packed, args, stash = _fused_stash_pe(dict(kw, num_encoding_fn_xyz=min(L_x, 24)), R, S, cuda,
                                          L_x)
    fused_spec = packed.spec
    if L_x > 24:
        torch.manual_seed(L_x)
        packed = fm.pack_weights(FlexibleNeRFModel(**kw, compute_dtype=torch.bfloat16,
                                                   device=cuda))
    spec = packed.spec
    pe_x, pe_d = fl.layers_pe_cuda(packed, *args[:3])
    torch.cuda.synchronize()
    assert torch.equal(pe_d, stash[:, fused_spec.pxp:])
    want_x = stash[:, :fused_spec.pxp]
    if L_x > 24:  # columns of the first 24 bands: raw 3, sin (c, l) at 3 + c L + l, cos after
        L, F = L_x, 24
        cols = [0, 1, 2] + [3 + k * 3 * L + c * L + band for k in (0, 1) for c in range(3)
                            for band in range(F)]
        want_cols = [0, 1, 2] + [3 + k * 3 * F + c * F + band for k in (0, 1) for c in range(3)
                                 for band in range(F)]
        assert torch.equal(pe_x[:, cols], want_x[:, want_cols])
        rest = [c for c in range(3, 3 + 6 * L) if c not in cols]
        assert bool(torch.isfinite(pe_x[:, rest].float()).all())
        assert float(pe_x[:, rest].float().abs().max()) <= 1.0
        assert not pe_x[:, 3 + 6 * L:].float().any() and pe_x.shape[1] == spec.pxp
    else:
        assert torch.equal(pe_x, want_x)
        want_x, want_d = fl.layers_pe_plain(packed, *args[:3])
        torch.testing.assert_close(pe_x.float(), want_x.float(), atol=1e-2, rtol=1e-2)
        torch.testing.assert_close(pe_d.float(), want_d.float(), atol=1e-2, rtol=1e-2)
    # at points (the sigma kernel's input), PE(xyz) of the rays' points
    pts = (args[0][:, None, :] + args[1][:, None, :] * args[2][..., None]).reshape(-1, 3)
    zeros = torch.zeros((R * S, 3), device=cuda)
    at_points = fl.layers_pe_cuda(packed, pts)[0]
    assert torch.equal(at_points, fl.layers_pe_cuda(packed, pts, zeros, zeros[:, :1])[0])


# The route's dW leg alone (layer_dw_kernel and its range reduction):
# each LAYER_ARCHS field's launches (layer1, a skip's [x | PE], feat, dir
# with the heads' jobs) over a slab of points not a multiple of 64;
# its plan's ranges, and forced ones: one range (the unit adds to the
# running grads itself), more units than the SMs take at once.
DW_POINTS = 4097


def _dw_jobs(packed, g, m, device, seed):
    """Seeded bf16 operands of weight matrix g's dW launch over m points
    (route_dw_jobs), and the group's flat running grads."""
    spec = packed.spec
    H = spec.hidden
    n, k = spec.gemm_shapes()[g]
    gen = torch.Generator(device).manual_seed(seed)

    def randn(cols):
        return torch.randn((m, cols), generator=gen, device=device).to(torch.bfloat16)

    dy = randn(n)
    if g == 0:
        x, pe, heads = randn(spec.pxp), None, None
    else:
        x = randn(H)
        pe = randn(k - H) if k > H else None
        heads = (randn(16), randn(H), randn(16), randn(H // 2)) if g == spec.num_layers + 1 \
            else None
    jobs, _, cols = fl.route_dw_jobs(packed, g, dy, x, pe, heads)
    out = torch.randn(cols, generator=gen, device=device)
    return jobs, out


def _hold_dw(jobs, out, got, ranges):
    """got against the plain version at the same ranges and against an f32
    torch.mm of the bf16 operands, within 1e-4 of the sum of the products'
    magnitudes (each sums exact bf16 products in f32 in another order)."""
    want = fl.layers_dw_plain(jobs, out, ranges=ranges)
    mag = fl.layers_dw_plain([j._replace(dy=j.dy.abs(), x=j.x.abs()) for j in jobs],
                             out.abs(), ranges=1)
    mm = out.clone()
    for j in jobs:
        block = j.dy.float().t() @ j.x.float()
        view = mm.as_strided(block.shape, (j.ldw, 1), j.w_off + j.col_off)
        view += block
    for ref in (want, mm):
        assert bool(((got - ref).abs() <= 1e-4 * mag + 1e-6).all()), \
            float(((got - ref).abs() / (mag + 1e-6)).max())


@pytest.mark.parametrize("kw", LAYER_ARCHS, ids=LAYER_IDS)
def test_layer_dw_matches_plain(cuda, kw):
    """layer_dw_kernel against its plain version and torch.mm at the ranges
    of its plan, for every weight matrix kind of the field; two launches
    bitwise equal, and bit for bit the fused backward's dw_kernel on the
    same ranges (the last wave's column pieces sum each element as a whole
    unit does); the launch's ranges, units, kernel launches and pieces are
    the Python mirror's (dw_plan)."""
    packed = _layer_model(kw, cuda)
    spec = packed.spec
    L = spec.num_layers
    skips = [g for g in range(1, L + 1) if spec.gemm_shapes()[g][1] > spec.hidden]
    sms = fl.card_sms(cuda)
    for g in [0, *skips[:1], L, L + 1]:
        jobs, out = _dw_jobs(packed, g, DW_POINTS, cuda, seed=g)
        got = fl.layers_dw_cuda(jobs, out)
        again = fl.layers_dw_cuda(jobs, out)
        fused = fl.layers_dw_cuda(jobs, out, variant="fused")
        info = fl.layers_dw_launcher(jobs, out.clone())()
        torch.cuda.synchronize()
        assert torch.equal(got, again) and torch.equal(got, fused), g
        shapes = [(j.dy.shape[1], j.x.shape[1]) for j in jobs]
        ranges = fl._dw_ranges_of(jobs)
        plan = fl.dw_plan(shapes, DW_POINTS, ranges, sms)
        assert info == (plan.ranges, plan.units, plan.launches, plan.pieces), g
        _hold_dw(jobs, out, got, ranges)


# (hidden, points, forced ranges) of the trunk matrix: one range over a
# ragged slab (adding to the grads in place); 2048 wide at 9 ranges (1152
# units: 8 whole waves and 96 units at 256 columns); 1024 wide over 5,000
# points at 24 ranges (20 ranges of 256 points: 640 units, 4 waves and 112
# at 256 columns) and over 20,000 at 5 (160: a wave and 28 units in
# 64-column pieces); 128 wide at 3 ranges (3 units of 128 columns, in two
# 64-column pieces each); one point; ranges past the slabs (as many as the
# 64-point slabs take).
DW_EDGES = [(1024, 1000, 1), (2048, 20000, 9), (1024, 5000, 24), (1024, 20000, 5),
            (128, 777, 3), (512, 1, 1), (256, 300, 7)]


@pytest.mark.parametrize("H,m,ranges", DW_EDGES)
def test_layer_dw_edges(cuda, H, m, ranges):
    """The trunk matrix's and the dir group's (heads) dW at forced ranges,
    against plain and torch.mm, and bit for bit the fused backward's
    dw_kernel and the kernel without column pieces on the same ranges."""
    torch.manual_seed(0)
    packed = fm.pack_weights(FlexibleNeRFModel(**dict(LEGO, num_layers=2, hidden_size=H),
                                               compute_dtype=torch.bfloat16, device=cuda))
    for g in (1, 3):
        jobs, out = _dw_jobs(packed, g, m, cuda, seed=H + m + g)
        got = fl.layers_dw_cuda(jobs, out, ranges=ranges)
        fused = fl.layers_dw_cuda(jobs, out, ranges=ranges, variant="fused")
        plain = fl.layers_dw_cuda(jobs, out, ranges=ranges, variant="plain")
        torch.cuda.synchronize()
        _hold_dw(jobs, out, got, ranges)
        assert torch.equal(got, fused) and torch.equal(got, plain), g

@pytest.mark.parametrize("kw", LAYER_ARCHS, ids=LAYER_IDS)
def test_layer_workspace_is_the_c_layout(cuda, kw):
    """workspace_bytes (which plans the slabs) equals the C layout's bytes
    for each kind at a few slabs."""
    packed = _layer_model(kw, cuda)
    for kind in ("fwd", "sigma", "bwd"):
        for slab in (128, 384, 65536):
            assert fl.workspace_bytes(packed.spec, kind, slab) == \
                fl.layers_workspace_c(packed, kind, slab), (kind, slab)


def test_layer_route_writes_every_row_it_reads(cuda):
    """A workspace full of NaN, two slabs, the second ragged: every region
    the route reads (activations, cotangents, partials) is written first."""
    packed = _layer_model(LAYER_ARCHS[1], cuda, seed=6)
    o, d, z = _rays(300, 1, cuda, seed=6)
    cot = torch.from_numpy(np.random.default_rng(7).standard_normal((4, 300, 1))
                           .astype(np.float32)).to(cuda)
    lib = build.load_library()
    out = torch.empty((4, 300, 1), device=cuda)
    dW = torch.zeros(packed.weights.shape, device=cuda)
    dB = torch.zeros(packed.biases.shape, device=cuda)
    counts = (ctypes.c_int * len(fl.KERNELS))()
    for kind in ("fwd", "bwd"):
        nbytes = fl.workspace_bytes(packed.spec, kind, 256)
        workspace = torch.full((nbytes // 4,), float("nan"), device=cuda).view(torch.uint8)
        rc = lib.nm_field_layers(
            fl.KINDS[kind], o.data_ptr(), d.data_ptr(), z.data_ptr(), 300, 1, cot.data_ptr(),
            packed.weights.data_ptr(), packed.biases.data_ptr(), packed.desc.ctypes.data,
            packed.desc.size, packed.freqs.ctypes.data, packed.freqs.size,
            workspace.data_ptr(), nbytes, 256, out.data_ptr(), 1, dW.data_ptr(), dB.data_ptr(),
            ctypes.addressof(counts), torch.cuda.current_stream().cuda_stream)
        build.check(lib, rc, f"field_layers {kind}")
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(dW).all())
    assert bool(torch.isfinite(dB).all())
    torch.testing.assert_close(out, fm.fused_mlp_plain(packed, o, d, z), atol=2e-2, rtol=2e-2)
    _hold_layer_grads(packed, (o, d, z, cot), (dW, dB),
                      fm.fused_mlp_bwd_plain(packed, o, d, z, cot))


def test_training_function_takes_the_layer_route(cuda):
    """fused_flexible_apply_rays on a 1152-wide model: the forward and
    backward of the training Function launch the layer route's kernels,
    never the fused ones, and its grads reach the parameters."""
    torch.manual_seed(0)
    model = FlexibleNeRFModel(**LAYER_ARCHS[1], compute_dtype=torch.bfloat16, device=cuda)
    o, d, z = _rays(64, 8, cuda)
    before = (fm.launches, fm.bwd_launches, fl.launches, fl.bwd_launches)
    fm.fused_flexible_apply_rays(model, o, d, z).square().sum().backward()
    torch.cuda.synchronize()
    assert (fm.launches, fm.bwd_launches, fl.launches, fl.bwd_launches) == (
        before[0], before[1], before[2] + 1, before[3] + 1)
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in model.parameters())


def test_layer_route_points_entry_and_empty_input(cuda):
    """fused_flexible_apply (points, channels-last (N, 4) output) on a
    1152-wide model takes the layer route and matches the plain version;
    no points launch nothing."""
    torch.manual_seed(0)
    model = FlexibleNeRFModel(**LAYER_ARCHS[1], compute_dtype=torch.bfloat16, device=cuda)
    g = torch.Generator(cuda).manual_seed(9)
    pts = torch.rand((37, 5, 3), generator=g, device=cuda) * 2 - 1
    dirs = torch.nn.functional.normalize(torch.randn((37, 3), generator=g, device=cuda), dim=-1)
    before = fl.launches
    got = fm.fused_flexible_apply(model, pts, dirs)
    torch.cuda.synchronize()
    assert fl.launches == before + 1 and got.shape == (37, 5, 4)
    packed = fm.pack_weights(model)
    flat = pts.reshape(-1, 3)
    zeros = torch.zeros((flat.shape[0], 1), device=cuda)
    want = fm.fused_mlp_plain(packed, flat, dirs[:, None, :].expand(37, 5, 3).reshape(-1, 3),
                              zeros, channels_first=False)
    torch.testing.assert_close(got.reshape(-1, 4), want.reshape(-1, 4), atol=2e-2, rtol=2e-2)
    empty = torch.zeros((0, 3), device=cuda)
    assert fl.layers_mlp_cuda(packed, empty, empty, torch.zeros((0, 4), device=cuda)).shape == \
        (4, 0, 4)
    assert fl.layers_sigma_cuda(packed, empty).shape == (0,)
    assert fl.launches == before + 1


# The backward's heads kernel alone (the route launches it once a slab):
# (H, points) at ragged counts (not multiples of 64 or 128), H/2 of 64 (a
# lane's one chunk, most lanes idle), 256 and 512 (512 and 1024 wide),
# 576 (1152 wide: not a multiple of 256, 8 lanes with a third chunk),
# 1024 (2048 wide: a slab's 41,857 points) and 2048 (4096 wide: two
# windows, the dots in a pass of their own).
HEAD_CASES = [(128, 65), (512, 41857), (1024, 20001), (1152, 777), (2048, 41857), (4096, 300)]


@pytest.mark.parametrize("H,m", HEAD_CASES)
def test_layer_heads_bwd_matches_plain(cuda, H, m):
    """dy_rgb, dy_a, dy_dir and the partials against the plain version
    within 1e-2 of each other's magnitude plus 1e-2 of the largest (the
    product kernel's bar: the rgb dots sum in another order, so a bf16
    rounding of a cotangent may fall the other way); two launches bitwise
    equal."""
    torch.manual_seed(0)
    packed = fm.pack_weights(FlexibleNeRFModel(
        num_layers=2, hidden_size=H, skip_step=4, num_encoding_fn_xyz=4, num_encoding_fn_dir=2,
        compute_dtype=torch.bfloat16, device=cuda))
    g = torch.Generator(cuda).manual_seed(H + m)
    h = torch.randn((m, H // 2), generator=g, device=cuda).clamp_min(0.0).to(torch.bfloat16)
    grad = torch.randn((4, m), generator=g, device=cuda)
    got = fl.layers_heads_bwd_cuda(packed, h, grad)
    again = fl.layers_heads_bwd_cuda(packed, h, grad)
    torch.cuda.synchronize()
    want = fl.layers_heads_bwd_plain(packed, h, grad)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        diff = (a.float() - b.float()).abs()
        assert bool((diff <= 1e-2 * b.float().abs() + 1e-2 * float(b.float().abs().max())).all())
    assert all(torch.equal(a, b) for a, b in zip(got, again))


# The bias-grad reduction alone: an 8x2048 slab's segments (9 products'
# column sums per 128 of 41,856 points, the heads' per 64), ragged rows
# (1, 65, 129, 3000: groups of 64 and a short last one), 576 columns
# (1152 wide's H/2: a short column chunk), and 40 segments (two launches).
BIAS_CASES = [[(327, 2048)] * 9 + [(654, 1024), (654, 4)],
              [(1, 512), (65, 576), (129, 4), (3000, 1152)], [(70, 256)] * 40]


@pytest.mark.parametrize("segs", BIAS_CASES, ids=["w2048-slab", "ragged", "two-launches"])
def test_layer_bias_matches_plain(cuda, segs):
    """Each bias vector's partials summed into its running grads, against
    the plain version within 1e-5 of the sums of magnitudes (another order
    of f32 sums); two launches bitwise equal (the order is fixed,
    whichever block ends last). The route reuses the counters slab after
    slab (test_layer_route_in_slabs)."""
    g = torch.Generator(cuda).manual_seed(len(segs))
    parts = [torch.randn(shape, generator=g, device=cuda) for shape in segs]
    outs = [torch.randn(shape[1], generator=g, device=cuda) for shape in segs]
    got = fl.layers_bias_cuda(parts, outs)
    again = fl.layers_bias_cuda(parts, outs)
    torch.cuda.synchronize()
    want = fl.layers_bias_plain(parts, outs)
    for a, b, o, p in zip(got, want, outs, parts):
        assert bool(((a - b).abs() <= 1e-5 * (o.abs() + p.abs().sum(0)) + 1e-6).all())
    assert all(torch.equal(a, b) for a, b in zip(got, again))

