"""Ray/AABB slab test and first-K chord compaction of the BuFF sampler:
the CUDA kernel, its plain PyTorch version and the dispatch between them.

Replaces the Pallas TPU kernel `_chords_kernel`
(nerfmeshes_tpu/ops/pallas/chords.py:98, launched by `compact_chords`,
:244-327). The kernel is `nerfmeshes_tpu_torch/csrc/chords.cu`, CUDA C++
for sm_90a bound through ctypes (ops/kernels/build.py); its note says
what bounds it and how it is built.

The contract is JAX's `compact_chords`: voxels (V, 2, 3) f32, active (V,)
bool, origins (R, 3) or (3,), dirs (R, 3), near / far scalars or (R,).
Returns, in the sampler's (R, K) orientation, lo_k and hi_k (f32: entry
and exit t), ids_k (the voxel index) and n_hit (R,) int32. The first K
valid chords of each ray are kept in voxel-index order; empty slots hold
BIG / BIG / 0; n_hit also counts the chords dropped past K. ids_k is
int32 here: JAX carries ids as f32 only so that its one-hot compaction
rides the MXU.

Dispatch: CPU tensors take `compact_chords_plain`, CUDA tensors
`compact_chords_cuda`, which launches the kernel or raises. `launches`
counts kernel launches and nothing else.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nerfmeshes_tpu_torch.ops.kernels import build

# Kernel launches since the last reset (callers may set it to 0).
launches = 0

# The sampler's empty-slot sentinel, 2 * the inactive row's hi (1e8 + 1);
# 2e8 in f32.
BIG = 2.0 * (1e8 + 1.0)


class Chords(NamedTuple):
    lo_k: torch.Tensor  # (R, K) f32
    hi_k: torch.Tensor  # (R, K) f32
    ids_k: torch.Tensor  # (R, K) int32
    n_hit: torch.Tensor  # (R,) int32


def _inputs(voxels, active, origins, dirs, near, far, K: int):
    """Check shapes, types and devices; (R, V, origins (R, 3) view)."""
    if K < 1:
        raise ValueError(f"K must be >= 1, got {K}")
    if dirs.dim() != 2 or dirs.shape[1] != 3:
        raise ValueError(f"dirs must be (R, 3), got {tuple(dirs.shape)}")
    R = dirs.shape[0]
    if voxels.dim() != 3 or tuple(voxels.shape[1:]) != (2, 3):
        raise ValueError(f"voxels must be (V, 2, 3), got {tuple(voxels.shape)}")
    V = voxels.shape[0]
    if tuple(active.shape) != (V,) or active.dtype != torch.bool:
        raise ValueError(f"active must be ({V},) bool, got {tuple(active.shape)} {active.dtype}")
    if tuple(origins.shape) not in ((3,), (1, 3), (R, 3)):
        raise ValueError(f"origins must be (3,) or ({R}, 3), got {tuple(origins.shape)}")
    for name, t in (("voxels", voxels), ("origins", origins), ("dirs", dirs)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
    tensors = [("voxels", voxels), ("active", active), ("origins", origins)]
    for name, b in (("near", near), ("far", far)):
        if isinstance(b, torch.Tensor):
            if b.dim() > 0 and tuple(b.shape) != (R,):
                raise ValueError(f"{name} must be a scalar or ({R},), got {tuple(b.shape)}")
            if b.dim() > 0 or b.device.type != "cpu":  # a 0-dim CPU tensor is a scalar
                tensors.append((name, b))
    for name, t in tensors:
        if t.device != dirs.device:
            raise ValueError(f"{name} on {t.device}, dirs on {dirs.device}")
    return R, V, origins.reshape(-1, 3).expand(R, 3)


def _bound(x, R: int) -> torch.Tensor | float:
    """A bound as a python float, a 0-dim tensor or an (R, 1) column."""
    if isinstance(x, torch.Tensor):
        return x.float()[:, None] if x.dim() > 0 else x.float()
    return float(x)


def slab_test(voxels: torch.Tensor, active: torch.Tensor, origins: torch.Tensor,
              inv_d: torch.Tensor, neg: torch.Tensor, near, far):
    """(mask, tmin, tmax), each (R, V): every ray against every voxel, in the
    exact op order of the JAX sampler's _slab_test
    (nerfmeshes_tpu/buff/tree.py:429-454): (lo - o) * inv per axis, entry
    and exit picked by the sign of inv, the x-y pair, then z, then the
    chord within [near, far] and the voxel active. near / far: floats,
    0-dim tensors or (R, 1) columns. Axis by axis, so that no (R, V, 3)
    tensor is made."""
    tvmin, tvmax = [], []
    for a in range(3):
        o, inv, sign = origins[:, a, None], inv_d[:, a, None], neg[:, a, None]
        t_lo = (voxels[None, :, 0, a] - o) * inv
        t_hi = (voxels[None, :, 1, a] - o) * inv
        tvmin.append(torch.where(sign, t_hi, t_lo))
        tvmax.append(torch.where(sign, t_lo, t_hi))
    mask = (tvmin[0] <= tvmax[1]) & (tvmin[1] <= tvmax[0])
    tmin = torch.maximum(tvmin[0], tvmin[1])
    tmax = torch.minimum(tvmax[0], tvmax[1])
    mask &= (tmin <= tvmax[2]) & (tvmin[2] <= tmax)
    tmin = torch.maximum(tmin, tvmin[2])
    tmax = torch.minimum(tmax, tvmax[2])
    mask &= (tmin >= near) & (tmax <= far) & active[None, :]
    return mask, tmin, tmax


def compact_chords_plain(voxels, active, origins, dirs, near, far, *, K: int) -> Chords:
    """Plain PyTorch version of the kernel, on any device: the slab test,
    then each valid chord's rank (an inclusive cumsum over V, minus one)
    and a scatter into slots 0..K-1 of its row, with slot K as the bin for
    invalid tests and ranks past K (cut off at the end). Same bits as the
    kernel: the same arithmetic per test, and each kept value moves
    unchanged."""
    R, V, origins = _inputs(voxels, active, origins, dirs, near, far, K)
    device = dirs.device
    inv_d = 1.0 / dirs
    mask, tmin, tmax = slab_test(voxels, active, origins, inv_d, inv_d < 0.0,
                                 _bound(near, R), _bound(far, R))
    slot = torch.where(mask, torch.cumsum(mask, dim=1) - 1, K).clamp_(max=K)
    lo = torch.full((R, K + 1), BIG, dtype=torch.float32, device=device)
    hi = torch.full((R, K + 1), BIG, dtype=torch.float32, device=device)
    ids = torch.zeros((R, K + 1), dtype=torch.int32, device=device)
    lo.scatter_(1, slot, tmin)
    hi.scatter_(1, slot, tmax)
    ids.scatter_(1, slot, torch.arange(V, dtype=torch.int32, device=device).expand(R, V))
    n_hit = mask.sum(dim=1, dtype=torch.int32)
    return Chords(lo[:, :K].contiguous(), hi[:, :K].contiguous(), ids[:, :K].contiguous(),
                  n_hit)


def _kernel_bound(x) -> tuple[int, int, float]:
    """(pointer, stride, value) of a bound for the C entry point: a device
    tensor is read per ray (stride 1) or once (stride 0); a float or a
    0-dim CPU tensor is passed by value."""
    if isinstance(x, torch.Tensor) and (x.dim() > 0 or x.device.type != "cpu"):
        if x.dtype != torch.float32:
            raise ValueError(f"near/far tensors must be float32, got {x.dtype}")
        if x.dim() > 0 and not x.is_contiguous():
            raise ValueError("near/far must be contiguous")
        return x.data_ptr(), int(x.dim() > 0), 0.0
    return 0, 0, float(x)


def compact_chords_cuda(voxels, active, origins, dirs, near, far, *, K: int) -> Chords:
    """Launch the kernel (csrc/chords.cu) on tensors of one CUDA device.
    Inputs must be contiguous; origins may be one (3,) origin for all rays."""
    global launches
    R, V, _ = _inputs(voxels, active, origins, dirs, near, far, K)
    device = dirs.device
    if device.type != "cuda":
        raise ValueError(f"compact_chords_cuda needs CUDA tensors, got {device}")
    for name, t in (("voxels", voxels), ("active", active), ("origins", origins),
                    ("dirs", dirs)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = Chords(torch.empty((R, K), dtype=torch.float32, device=device),
                 torch.empty((R, K), dtype=torch.float32, device=device),
                 torch.empty((R, K), dtype=torch.int32, device=device),
                 torch.empty((R,), dtype=torch.int32, device=device))
    if R == 0:
        return out
    near_p, near_s, near_v = _kernel_bound(near)
    far_p, far_s, far_v = _kernel_bound(far)
    lib = build.load_library()
    with torch.cuda.device(device):
        rc = lib.nm_compact_chords(
            voxels.data_ptr(), active.data_ptr(), V,
            origins.data_ptr(), 3 if origins.numel() > 3 else 0,
            dirs.data_ptr(), R, near_p, near_s, near_v, far_p, far_s, far_v, K,
            out.lo_k.data_ptr(), out.hi_k.data_ptr(), out.ids_k.data_ptr(),
            out.n_hit.data_ptr(), torch.cuda.current_stream(device).cuda_stream,
        )
    build.check(lib, rc, "compact_chords launch")
    launches += 1
    return out


def compact_chords(voxels, active, origins, dirs, near, far, *, K: int) -> Chords:
    """Slab test + first-K-by-voxel-index chord compaction: CPU tensors take
    the plain version, CUDA tensors the kernel."""
    kind = dirs.device.type
    if kind == "cpu":
        return compact_chords_plain(voxels, active, origins, dirs, near, far, K=K)
    if kind == "cuda":
        return compact_chords_cuda(voxels, active, origins, dirs, near, far, K=K)
    raise ValueError(f"no chord compaction for {kind} tensors")
