"""Mesh extraction: sigma grid -> iso-surface -> appearance (counterpart of
nerfmeshes_tpu/mesh/extract.py, the reference's mesh_nerf pipeline,
src/mesh_nerf.py:27-201).

The res^3 grid is evaluated on the system's device tile by tile (262,144
points per sigma-kernel launch at the default tile), with nothing read
back between tiles. On the sparse path (res % 8 == 0) the device then
reduces the grid to iso statistics and per-8^3-block min/max, and only
the blocks whose dilated range straddles the iso level come to the host.
The native C++ library marches them; the appearance pass renders along
the inverse vertex normals through the system's query_rgb (the forward
kernel).

With a sharded DataGroup (parallel/mesh.py), as with JAX's `mesh=`,
rank r evaluates points [i*tile + r*local, i*tile + (r+1)*local) of every
tile (local = tile / world) and the grid is gathered in flat-index order
by one all_reduce; rank 0 alone reduces it to blocks, marches and writes,
and broadcasts the geometry for the appearance pass, which renders through
the group's query_rgb. LAST_TIMINGS keeps the JAX package's keys (rank
0's); device phases end in torch.cuda.synchronize() on a CUDA device.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from nerfmeshes_tpu_torch.mesh.export import export_obj, export_ply_binary
from nerfmeshes_tpu_torch.mesh.native import fill_blocks_native, marching_cubes
from nerfmeshes_tpu_torch.parallel.mesh import DataGroup, all_sum_, broadcast_

# Phase times (s) and statistics of the last extraction, by the JAX
# package's names: grid_eval_device_s, grid_transfer_s (+ its split),
# marching_cubes_s, appearance_s, write_s, sparse_blocks_fetched / _total,
# iso_requested / _effective, density_min / _max / _std.
LAST_TIMINGS: dict = {}


@dataclass
class MeshArgs:
    """Knobs of the reference CLI (src/mesh_nerf.py:204-266)."""

    iso_level: float = 32.0
    limit: float = 1.2
    res: int = 128
    super_sampling: int = 0
    batch_size: int = 1024
    no_view_dependence: bool = False
    view_disparity: float = 1e-2
    view_disparity_max_bound: float = 4.0
    use_cached_mesh: bool = False
    override_cache_mesh: bool = False
    cache_name: str = "mesh_cache.npz"
    save_dir: str = "."
    mesh_name: str = "mesh.obj"
    # The reference's adaptive clamp iso -> [min+std, max-std]
    # (src/mesh_nerf.py:56-65); False uses the requested iso as it is.
    clamp_iso: bool = True
    # Restrict extraction to the acceleration structure's support when the
    # system has one (mesh_mask_aabbs, a BuFF system's); no effect otherwise.
    tree_mask: bool = True


def _sync(device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def grid_points(idx: torch.Tensor, nums, limit: float) -> torch.Tensor:
    """(m, 3) f32 points of the flat int64 grid indices `idx` of the
    nx*ny*nz grid over [-limit, limit]^3: index i is (x, y, z) with x
    slowest, spacing 2*limit/(n-1) per axis (nerfmeshes_tpu/mesh/
    extract.py:97-109, the same f32 arithmetic)."""
    _, ny, nz = nums
    sx, sy, sz = (2.0 * limit / max(k - 1, 1) for k in nums)
    x = idx // (ny * nz)
    rem = idx % (ny * nz)
    return torch.stack([-limit + x.float() * sx,
                        -limit + (rem // nz).float() * sy,
                        -limit + (rem % nz).float() * sz], dim=-1)


def _grid_tiles(fn: Callable, limit: float, nums, tile: int, device, dtype: torch.dtype,
                channels: int = 1, group: Optional[DataGroup] = None) -> torch.Tensor:
    """fn(points (m, 3)) at every grid point, `tile` points per call, into
    one flat (n[, channels]) `dtype` tensor on `device`. Enqueues only:
    nothing is read back.

    With a sharded `group`, JAX's split (nerfmeshes_tpu/mesh/extract.py:
    83-103): the tile rounds up to a multiple of the world size, rank r
    evaluates its `tile / world` points of every tile (the last tile runs
    past the grid, as JAX's does) into a zero-filled grid, and one
    all_reduce sums the ranks' grids into the whole one."""
    n = int(np.prod(nums))
    if group is not None and group.sharded:
        world = group.world
        tile = -(-tile // world) * world
        local = tile // world
        n_tiles = -(-n // tile)
        out = torch.zeros((n_tiles * tile, channels) if channels > 1 else (n_tiles * tile,),
                          dtype=dtype, device=device)
        for i in range(n_tiles):
            start = i * tile + group.rank * local
            idx = torch.arange(start, start + local, dtype=torch.int64, device=device)
            out[start:start + local] = fn(grid_points(idx, nums, limit))
        return all_sum_(out, group)[:n]
    out = torch.empty((n, channels) if channels > 1 else (n,), dtype=dtype, device=device)
    for start in range(0, n, tile):
        idx = torch.arange(start, min(start + tile, n), dtype=torch.int64, device=device)
        out[start:start + idx.shape[0]] = fn(grid_points(idx, nums, limit))
    return out


def _grid_eval(sample_points_fn, limit: float, nums, *, channels: int, tile: int,
               density_fn=None, device=None, group: Optional[DataGroup] = None
               ) -> np.ndarray:
    """The field over the dense grid, evaluated on `device`, returned as
    f16-rounded f32 (the JAX package sends the grid to the host as f16)."""
    if channels == 1 and density_fn is not None:
        fn = density_fn
    elif channels == 1:
        fn = lambda pts: sample_points_fn(pts, pts)[..., 3]  # noqa: E731
    else:
        fn = lambda pts: sample_points_fn(pts, pts)  # noqa: E731
    t0 = time.perf_counter()
    with torch.inference_mode():
        dev = _grid_tiles(fn, limit, nums, tile, device, torch.float16, channels, group)
    _sync(device)
    LAST_TIMINGS["grid_eval_device_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = dev.cpu().numpy()
    LAST_TIMINGS["grid_transfer_s"] = time.perf_counter() - t0
    shape = (*nums, channels) if channels > 1 else tuple(nums)
    return out.reshape(shape).astype(np.float32)


def extract_density(sample_points_fn, limit: float, nums, *, tile: int = 262144,
                    density_fn=None, device=None, group: Optional[DataGroup] = None
                    ) -> np.ndarray:
    """Density-only grid (nx, ny, nz). `density_fn` ((N, 3) points -> (N,)
    sigma), when given, replaces the full field query (the sigma kernel).
    With a sharded `group` every rank evaluates its share and returns the
    whole grid."""
    if isinstance(nums, int):
        nums = (nums,) * 3
    return _grid_eval(sample_points_fn, limit, tuple(nums), channels=1, tile=tile,
                      density_fn=density_fn, device=device, group=group)


def extract_radiance(sample_points_fn, limit: float, nums, *, tile: int = 65536,
                     device=None, group: Optional[DataGroup] = None) -> np.ndarray:
    """Full radiance grid -> (nx, ny, nz, 4) (the reference's
    extract_radiance, src/mesh_nerf.py:27-53; geometry uses extract_density)."""
    if isinstance(nums, int):
        nums = (nums,) * 3
    if len(nums) != 3:
        raise ValueError(f"nums must give 3 axes, got {nums}")
    return _grid_eval(sample_points_fn, limit, tuple(nums), channels=4, tile=tile,
                      device=device, group=group)


@dataclass
class SparseDensityGrid:
    """Block-sparse density grid: exact values in the fetched
    surface-adjacent 8^3 blocks, one fill value per block elsewhere.
    `to_dense()` builds the full res^3 f32 array."""

    res: int
    block_fill: np.ndarray  # (B, B, B) f32 per-block fill values
    block_ids: np.ndarray  # (K,) int32 flat ids of fetched blocks
    block_values: np.ndarray  # (K, 512) f32 fetched 8^3 blocks

    @property
    def shape(self):
        return (self.res, self.res, self.res)

    def to_dense(self) -> np.ndarray:
        return fill_blocks_native(self.res, self.block_fill, self.block_ids, self.block_values)


def _support_masks(mask_aabbs: np.ndarray, limit: float, res: int, cells_per_block: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """(support, holes): two (B, B, B) bool masks from the support AABBs.

    `support`: blocks overlapping any AABB, where training chords sampled
    the field. `holes`: regions enclosed by support (scipy hole filling),
    a solid object's pruned interior, which callers fill SOLID; the rest of
    non-support reads EMPTY. AABBs that miss the grid are skipped, not
    clipped onto its faces. No dilation of `support`
    (nerfmeshes_tpu/mesh/extract.py:215-268 gives the reasons)."""
    B = res // cells_per_block
    scale = 2.0 * limit / max(res - 1, 1)
    support = np.zeros((B, B, B), bool)
    lo = np.asarray(mask_aabbs[:, 0], np.float64)
    hi = np.asarray(mask_aabbs[:, 1], np.float64)
    overlaps = (hi >= -limit).all(axis=1) & (lo <= limit).all(axis=1)
    lo, hi = lo[overlaps], hi[overlaps]
    # Grid index range each AABB covers (cell i sits at -limit + i*scale),
    # then the block range containing those cells.
    i_lo = np.clip(np.floor((lo + limit) / scale), 0, res - 1).astype(np.int64)
    i_hi = np.clip(np.ceil((hi + limit) / scale), 0, res - 1).astype(np.int64)
    k_lo = i_lo // cells_per_block
    k_hi = i_hi // cells_per_block
    for (x0, y0, z0), (x1, y1, z1) in zip(k_lo, k_hi):
        support[x0:x1 + 1, y0:y1 + 1, z0:z1 + 1] = True
    holes = np.zeros_like(support)
    if support.any() and not support.all():
        from scipy import ndimage

        holes = ndimage.binary_fill_holes(support) & ~support
    return support, holes


def _warn_empty_support(keep: np.ndarray) -> None:
    if not keep.any():
        print("mesh: support mask does not overlap the grid — extraction will be empty "
              "(check --limit vs the tree's extent).", flush=True)


def _block_stats(flat: torch.Tensor, res: int, keep: Optional[np.ndarray]):
    """On the grid's device, from the flat f32 grid: (stats (3,) f32 = [min,
    max, std] over the kept cells, blocks3 (3, B, B, B) f32 = [own-block
    min, 3^3-dilated min, 3^3-dilated max] of the f16 grid, the f16 grid).
    As nerfmeshes_tpu/mesh/extract.py:342-397: statistics from the f32
    values, blocks from the f16 copy (f16 rounding is monotonic, so an f16
    block min is the f16 of the f32 min), +-inf beyond the grid's faces."""
    B = res // 8
    sigma = flat.reshape(res, res, res).half()
    if keep is None:
        cnt = float(flat.numel())

        def kept(t, _fill):
            return t
    else:
        keepc = torch.from_numpy(keep).to(flat.device)[:, None, :, None, :, None]
        keepc = keepc.expand(B, 8, B, 8, B, 8).reshape(-1)
        cnt = keepc.sum().clamp_min(1).float()

        def kept(t, fill):
            return torch.where(keepc, t, fill)
    big = float(np.finfo(np.float32).max)
    mean = kept(flat, 0.0).sum() / cnt
    var = (kept(flat * flat, 0.0).sum() / cnt - mean * mean).clamp_min(0.0)
    stats = torch.stack([kept(flat, big).amin(), kept(flat, -big).amax(), var.sqrt()])

    def dilate_max(x):  # 3^3 neighbourhood; max_pool3d pads with -inf
        return F.max_pool3d(x[None, None], 3, stride=1, padding=1)[0, 0]

    blocks = flat.view(B, 8, B, 8, B, 8)
    bmin_own = blocks.amin(dim=(1, 3, 5)).half().float()
    bmax_own = blocks.amax(dim=(1, 3, 5)).half().float()
    blocks3 = torch.stack([bmin_own, -dilate_max(-bmin_own), dilate_max(bmax_own)])
    return stats, blocks3, sigma


def _sparse_density_extract(density_fn, limit: float, res: int, iso_level: float, *,
                            tile: int = 262144, clamp_iso: bool = True, mask_aabbs=None,
                            device=None, group: Optional[DataGroup] = None
                            ) -> Tuple[SparseDensityGrid, float]:
    """Density grid via sparse block transfer -> (SparseDensityGrid, iso).

    The res^3 grid never crosses to the host: the device computes the iso
    statistics and per-8^3-block min/max dilated over the 3^3 block
    neighbourhood, and the host fetches only the blocks whose dilated range
    straddles the (clamped) iso level. Every iso-crossing cell lies in
    fetched blocks, so the surface is exact, and an unfetched block is
    one-sided, so its min fill adds no crossing. The JAX package pads the
    fetch list to a multiple of 4096 to keep XLA's shapes fixed; eager
    PyTorch gathers exactly the fetched blocks. With a sharded `group`
    the grid is evaluated over the group (_grid_tiles) and the ranks
    other than 0 return (None, None) after it."""
    if res % 8:
        raise ValueError(f"the sparse path needs res % 8 == 0, got {res}")
    B = res // 8
    keep = holes = None
    if mask_aabbs is not None and len(mask_aabbs):
        keep, holes = _support_masks(mask_aabbs, limit, res, 8)
        _warn_empty_support(keep)

    t0 = time.perf_counter()
    with torch.inference_mode():
        flat = _grid_tiles(density_fn, limit, (res,) * 3, tile, device, torch.float32,
                           group=group)
        if group is not None and not group.is_main:
            return None, None
        stats_dev, blocks3_dev, sigma = _block_stats(flat, res, keep)
        del flat
    _sync(device)
    LAST_TIMINGS["grid_eval_device_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    mn, mx, std = (float(v) for v in stats_dev.cpu().numpy())  # the first host read
    if clamp_iso:
        iso = float(min(max(iso_level, mn + std), mx - std))
    else:
        iso = float(iso_level)
    LAST_TIMINGS.update(iso_requested=float(iso_level), iso_effective=iso,
                        density_min=mn, density_max=mx, density_std=std)
    if iso > float(iso_level) + 1e-6:
        print(f"mesh: adaptive clamp raised iso {iso_level:g} -> {iso:.3f} (density min "
              f"{mn:.2f} max {mx:.2f} std {std:.2f}); thin geometry may erode — consider "
              "an explicit --iso-level.", flush=True)
    t_stats = time.perf_counter()
    bmin_own, bminh, bmaxh = blocks3_dev.cpu().numpy()
    t_blocks3 = time.perf_counter()
    fetch = (bminh <= iso) & (bmaxh >= iso)  # (B, B, B) dilated straddle
    if keep is not None:
        LAST_TIMINGS["tree_masked_blocks"] = int((fetch & ~keep).sum())
        fetch &= keep
        # Out-of-support blocks are never fetched: enclosed holes read
        # SOLID, outside-connected ones EMPTY (see _support_masks).
        empty_fill = min(mn, iso) - 1.0
        solid_fill = max(mx, iso) + 1.0
        bmin_own = np.where(keep, bmin_own, np.where(holes, solid_fill, empty_fill))
    idx = np.flatnonzero(fetch)

    with torch.inference_mode():
        ids = torch.from_numpy(idx).to(sigma.device)
        # (B, 8, B, 8, B, 8)[bx, :, by, :, bz, :] -> (K, 8, 8, 8): each
        # block's cells x-major, as the native library reads them.
        gathered = sigma.view(B, 8, B, 8, B, 8)[ids // (B * B), :, (ids // B) % B, :, ids % B, :]
        gathered = gathered.reshape(-1, 512)
    _sync(device)
    t_gather = time.perf_counter()
    packed = gathered.cpu().numpy()
    t_packed = time.perf_counter()
    LAST_TIMINGS["grid_transfer_s"] = t_packed - t0
    LAST_TIMINGS["transfer_blocks3_fetch_s"] = t_blocks3 - t_stats
    LAST_TIMINGS["transfer_gather_compile_run_s"] = t_gather - t_blocks3
    LAST_TIMINGS["transfer_packed_fetch_s"] = t_packed - t_gather
    LAST_TIMINGS["transfer_packed_mb"] = packed.nbytes / 1e6
    LAST_TIMINGS["sparse_blocks_fetched"] = int(idx.size)
    LAST_TIMINGS["sparse_blocks_total"] = int(B ** 3)

    grid = SparseDensityGrid(res=res, block_fill=bmin_own.astype(np.float32),
                             block_ids=idx.astype(np.int32),
                             block_values=packed.astype(np.float32))
    return grid, iso


def extract_iso_level(density: np.ndarray, iso_level: float) -> float:
    """Adaptive clamp of the iso level into [min+std, max-std]
    (reference: src/mesh_nerf.py:56-65)."""
    min_a, max_a, std_a = density.min(), density.max(), density.std()
    iso = float(min(max(iso_level, min_a + std_a), max_a - std_a))
    LAST_TIMINGS.update(iso_requested=float(iso_level), iso_effective=iso,
                        density_min=float(min_a), density_max=float(max_a),
                        density_std=float(std_a))
    return iso


def _mask_dense_density(density: np.ndarray, args: MeshArgs, mask_aabbs
                        ) -> Tuple[np.ndarray, float]:
    """The dense path's support mask at 1-cell granularity, with the sparse
    path's semantics: clamp statistics over support cells only, enclosed
    holes solid, the rest empty. Returns (masked density, iso)."""
    keep = holes = None
    if mask_aabbs is not None and len(mask_aabbs):
        keep, holes = _support_masks(mask_aabbs, args.limit, args.res, 1)
        _warn_empty_support(keep)
    stats_src = density[keep] if (keep is not None and keep.any()) else density
    if args.clamp_iso:
        iso_value = extract_iso_level(stats_src, args.iso_level)
    else:
        iso_value = float(args.iso_level)
        LAST_TIMINGS.update(iso_requested=iso_value, iso_effective=iso_value,
                            density_min=float(stats_src.min()),
                            density_max=float(stats_src.max()),
                            density_std=float(stats_src.std()))
    if keep is not None:
        LAST_TIMINGS["tree_masked_blocks"] = int(((density > iso_value) & ~keep).sum())
        empty_fill = min(float(stats_src.min()), iso_value) - 1.0
        solid_fill = max(float(stats_src.max()), iso_value) + 1.0
        density = np.where(keep, density, np.where(holes, solid_fill, empty_fill))
    return density, iso_value


def _world(vertices: np.ndarray, args: MeshArgs) -> np.ndarray:
    """Grid-index vertices -> world coordinates, by the reference's formula
    limit * (v / (res/2) - 1) (nerfmeshes_tpu/mesh/extract.py:588), which is
    not the grid's own spacing 2*limit/(res-1); kept as it is."""
    return (args.limit * (vertices / (args.res / 2.0) - 1.0)).astype(np.float32)


def extract_geometry(sample_points_fn, args: MeshArgs, *, density_fn=None, mask_aabbs=None,
                     device=None, group: Optional[DataGroup] = None):
    """(vertices in world coordinates, triangles, normals, density grid)
    (reference: src/mesh_nerf.py:68-92).

    With a `density_fn` and res % 8 == 0 (res >= 32) the grid transfers
    sparsely and the density returned is a SparseDensityGrid, not an
    ndarray (`.to_dense()` builds one). With a sharded `group` the grid is
    evaluated over the group and the ranks other than 0 return four Nones
    (export_marching_cubes broadcasts rank 0's geometry)."""
    if not args.tree_mask:
        mask_aabbs = None
    off_main = group is not None and not group.is_main
    if density_fn is not None and args.res % 8 == 0 and args.res >= 32:
        density, iso_value = _sparse_density_extract(
            density_fn, args.limit, args.res, args.iso_level, clamp_iso=args.clamp_iso,
            mask_aabbs=mask_aabbs, device=device, group=group)
    else:
        density = extract_density(sample_points_fn, args.limit, args.res,
                                  density_fn=density_fn, device=device, group=group)
        if not off_main:
            density, iso_value = _mask_dense_density(density, args, mask_aabbs)
    if off_main:
        return None, None, None, None
    t0 = time.perf_counter()
    vertices, triangles, normals = marching_cubes(density, iso_value)
    LAST_TIMINGS["marching_cubes_s"] = time.perf_counter() - t0
    return _world(vertices, args), triangles, normals, density


def extract_geometry_with_super_sampling(sample_points_fn, args: MeshArgs, *, density_fn=None,
                                         mask_aabbs=None, device=None,
                                         group: Optional[DataGroup] = None):
    """Axis-wise super-sampled extraction: the grid is evaluated at a
    higher resolution along each axis in turn, each averaged back to the
    base resolution, and the three averaged (the reference stubs this path,
    src/mesh_nerf.py:95-128). The support mask applies at the base
    resolution. A sharded `group` as in extract_geometry."""
    s = args.super_sampling
    if s < 1:
        raise ValueError(f"super_sampling must be >= 1, got {s}")
    if not args.tree_mask:
        mask_aabbs = None
    base = args.res
    dense = base + (base - 1) * s
    acc = np.zeros((base, base, base), np.float32)
    for axis in range(3):
        nums = [base, base, base]
        nums[axis] = dense
        density = extract_density(sample_points_fn, args.limit, tuple(nums),
                                  density_fn=density_fn, device=device, group=group)
        if group is not None and not group.is_main:
            continue
        # Sample i of the base axis averages fine samples i*(s+1) +- s.
        fine = np.moveaxis(density, axis, 0)
        groups = fine[: (base - 1) * (s + 1) + 1]
        idx = np.arange(base) * (s + 1)
        out = groups[idx]
        for off in range(1, s + 1):
            lo = np.clip(idx - off, 0, dense - 1)
            hi = np.clip(idx + off, 0, dense - 1)
            out = out + 0.5 * (groups[lo] + groups[hi])
        out = out / (1 + s)
        acc += np.moveaxis(out, 0, axis)
    if group is not None and not group.is_main:
        return None, None, None, None
    density = acc / 3.0
    density, iso_value = _mask_dense_density(density, args, mask_aabbs)
    vertices, triangles, normals = marching_cubes(density, iso_value)
    return _world(vertices, args), triangles, normals, density


def export_marching_cubes(system, args: MeshArgs
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Geometry (with caching) + appearance + mesh file (reference:
    src/mesh_nerf.py:131-201). `system` gives density_points(points) (or
    None), sample_points(points, dirs), query_rgb(origins, dirs, near, far,
    chunk, as_uint8) and a `device` (a port NeRFSystem does). A `.ply`
    mesh_name writes binary PLY; anything else the reference's ASCII OBJ.

    A system with a sharded `group` evaluates the grid and renders the
    appearance over its group; rank 0 marches, writes the cache and the
    mesh, and broadcasts the geometry. Every rank returns the same
    (vertices, triangles, diffuse, normals)."""
    group = getattr(system, "group", None)
    if group is not None and not group.sharded:
        group = None
    main = group is None or group.is_main
    os.makedirs(args.save_dir, exist_ok=True)
    cache_path = Path(args.save_dir) / args.cache_name
    geometry_fn = (extract_geometry_with_super_sampling if args.super_sampling >= 1
                   else extract_geometry)

    if args.use_cached_mesh and cache_path.exists() and not args.override_cache_mesh:
        data = np.load(cache_path)
        vertices, triangles, normals = data["vertices"], data["triangles"], data["normals"]
    else:
        mask_aabbs = system.mesh_mask_aabbs() if hasattr(system, "mesh_mask_aabbs") else None
        vertices, triangles, normals, _ = geometry_fn(
            system.sample_points, args, density_fn=getattr(system, "density_points", None),
            mask_aabbs=mask_aabbs, device=getattr(system, "device", None), group=group)
        if main and (args.use_cached_mesh or args.override_cache_mesh):
            np.savez(cache_path, vertices=vertices, triangles=triangles, normals=normals)
    if group is not None:
        vertices, triangles, normals = _broadcast_mesh(group, vertices, triangles, normals)

    # Appearance: cast along inverse surface normals (src/mesh_nerf.py:161-195).
    t0 = time.perf_counter()
    targets, directions = vertices, -normals
    if len(targets) == 0:
        diffuse = np.zeros((0, 3), np.float32)
    elif args.no_view_dependence:
        diffuse = _query_diffuse_direct(system, targets, directions, args.batch_size)
    else:
        origins = targets - args.view_disparity * directions
        # batch_size is the reference's GPU-memory knob (--batch-size 1024);
        # it is taken as a lower bound on the chunk, which is clamped to
        # the ray count so that small meshes render no padding.
        chunk = max(args.batch_size, min(65536, -(-len(targets) // 256) * 256))
        # Colors come back quantized to uint8 (as the mesh writers would).
        diffuse = system.query_rgb(origins, directions, 0.0, args.view_disparity_max_bound,
                                   chunk=chunk, as_uint8=True).astype(np.float32) / 255.0
    LAST_TIMINGS["appearance_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    mesh_path = Path(args.save_dir) / args.mesh_name
    if main and mesh_path.suffix.lower() == ".ply":
        export_ply_binary(vertices, triangles, colors=diffuse, normals=normals,
                          filename=str(mesh_path))
    elif main:
        export_obj(vertices, triangles, diffuse, normals, str(mesh_path))
    LAST_TIMINGS["write_s"] = time.perf_counter() - t0
    if group is not None:
        group.barrier()
    return vertices, triangles, diffuse, normals


def _broadcast_mesh(group: DataGroup, vertices, triangles, normals):
    """Rank 0's (vertices, triangles, normals) on every rank: the counts,
    then the f32 vertices and normals side by side, then the int32
    triangles, each one broadcast on the group's device."""
    if group.is_main:
        counts = [len(vertices), len(triangles)]
        vn = np.concatenate([vertices, normals], 1).astype(np.float32)
        tri = np.asarray(triangles, np.int32)
    else:
        counts = [0, 0]
    nv, nt = broadcast_(torch.tensor(counts, device=group.device), group).tolist()
    if not group.is_main:
        vn = np.zeros((nv, 6), np.float32)
        tri = np.zeros((nt, 3), np.int32)
    if nv:
        vn = broadcast_(torch.from_numpy(vn).to(group.device), group).cpu().numpy()
    if nt:
        tri = broadcast_(torch.from_numpy(tri).to(group.device), group).cpu().numpy()
    if group.is_main:
        return vertices, triangles, normals
    return vn[:, :3].copy(), tri, vn[:, 3:].copy()


def _query_diffuse_direct(system, targets, directions, batch_size: int) -> np.ndarray:
    """Direct field query at the vertices (the no_view_dependence path):
    every chunk is enqueued, and the rgb comes to the host once."""
    n = targets.shape[0]
    chunk = max(int(batch_size), min(65536, -(-n // 256) * 256))
    with torch.inference_mode():
        rgb = torch.cat([system.sample_points(targets[s:s + chunk], directions[s:s + chunk])[:, :3]
                         for s in range(0, n, chunk)])
    return rgb.float().cpu().numpy()
