"""ctypes loader for the native mesh library, `native/marching.cpp` (the
JAX package's host C++, reused unchanged): marching tetrahedra on a dense
or a block-sparse grid, the dense fill of a block-sparse grid, and a
buffered OBJ writer.

The library is built with g++ at first use into `build/native/` (listed
in .gitignore) by utils/gxx.py, under a name keyed on a hash of the
source, the flags and the host (~4 s to build). A failed build raises:
unlike the JAX package's loader (nerfmeshes_tpu/mesh/native.py:118-130)
nothing falls back to numpy.
`marching_tetrahedra_numpy` stays as a plain function with the library's
decomposition, which tests hold the library to.
"""

from __future__ import annotations

import ctypes
import functools
import os
from pathlib import Path
from typing import Tuple

import numpy as np

from nerfmeshes_tpu_torch.utils import gxx

_REPO_ROOT = Path(__file__).resolve().parents[2]
BUILD_DIR = _REPO_ROOT / "build" / "native"


def source_path() -> Path:
    """native/marching.cpp of this checkout, or $NERFMESHES_NATIVE_SRC (an
    install without the repo tree points it at the sdist's copy)."""
    return Path(os.environ.get("NERFMESHES_NATIVE_SRC", _REPO_ROOT / "native" / "marching.cpp"))


def library_path() -> Path:
    return gxx.library_path(source_path(), BUILD_DIR, "marching")


def build_library() -> Path:
    """Compile the source unless a build of it exists; returns its path."""
    return gxx.build_library(source_path(), library_path())


_F = ctypes.POINTER(ctypes.c_float)
_I32 = ctypes.POINTER(ctypes.c_int32)
_I64 = ctypes.c_int64
_OUT = [ctypes.POINTER(_F), ctypes.POINTER(_I64), ctypes.POINTER(_I32),
        ctypes.POINTER(_I64), ctypes.POINTER(_F)]
SIGNATURES = {
    "mt_extract": (_I64, [_F, _I64, _I64, _I64, ctypes.c_float, *_OUT]),
    "mt_extract_sparse": (_I64, [_I64, _I64, _F, _I32, _I64, _F, ctypes.c_float, *_OUT]),
    "mt_fill_blocks": (None, [_F, _I64, _I64, _F, _I32, _I64, _F]),
    "obj_write": (_I64, [ctypes.c_char_p, _F, _I64, _F, _F, _I64, _I32, _I64]),
    "mt_free": (None, [ctypes.c_void_p]),
}


@functools.cache
def get_lib() -> ctypes.CDLL:
    """The built library with every entry point's signature set."""
    lib = ctypes.CDLL(str(build_library()))
    for name, (restype, argtypes) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def _f32(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32)


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.int32)


def _take_mesh(lib, call) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Run an extractor with the five out-pointers, copy its buffers into
    numpy and free them."""
    verts_p, tris_p, normals_p = _F(), _I32(), _F()
    nverts, ntris = _I64(), _I64()
    rc = call(ctypes.byref(verts_p), ctypes.byref(nverts), ctypes.byref(tris_p),
              ctypes.byref(ntris), ctypes.byref(normals_p))
    if rc != 0:
        raise ValueError(f"marching failed (code {rc}): a grid needs >= 2 cells per axis")
    try:
        nv, nt = nverts.value, ntris.value
        verts = np.ctypeslib.as_array(verts_p, shape=(nv * 3,)).reshape(nv, 3).copy()
        tris = np.ctypeslib.as_array(tris_p, shape=(nt * 3,)).reshape(nt, 3).copy()
        normals = np.ctypeslib.as_array(normals_p, shape=(nv * 3,)).reshape(nv, 3).copy()
    finally:
        for p in (verts_p, tris_p, normals_p):
            lib.mt_free(p)
    return verts, tris, normals


def marching_tetrahedra_native(density: np.ndarray, iso: float
                               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(verts, tris, normals) in grid-index coordinates, from a dense grid."""
    lib = get_lib()
    grid = _f32(density)
    nx, ny, nz = grid.shape
    return _take_mesh(lib, lambda *out: lib.mt_extract(
        grid.ctypes.data_as(_F), nx, ny, nz, ctypes.c_float(float(iso)), *out))


def marching_sparse_native(res: int, fill: np.ndarray, ids: np.ndarray, packed: np.ndarray,
                           iso: float) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(verts, tris, normals) from the block-sparse grid (per-block fill,
    fetched block ids and their 8^3 values) without a dense grid."""
    lib = get_lib()
    fill, ids, packed = _f32(fill), _i32(ids), _f32(packed)
    return _take_mesh(lib, lambda *out: lib.mt_extract_sparse(
        res, res // 8, fill.ctypes.data_as(_F), ids.ctypes.data_as(_I32), ids.size,
        packed.ctypes.data_as(_F), ctypes.c_float(float(iso)), *out))


def fill_blocks_native(res: int, fill: np.ndarray, ids: np.ndarray,
                       packed: np.ndarray) -> np.ndarray:
    """Dense (res, res, res) f32 grid from per-block fills + fetched blocks."""
    lib = get_lib()
    dense = np.empty((res, res, res), np.float32)
    fill, ids, packed = _f32(fill), _i32(ids), _f32(packed)
    lib.mt_fill_blocks(dense.ctypes.data_as(_F), res, res // 8, fill.ctypes.data_as(_F),
                       ids.ctypes.data_as(_I32), ids.size, packed.ctypes.data_as(_F))
    return dense


def obj_write_native(filename: str, vertices: np.ndarray, diffuse, normals: np.ndarray,
                     triangles: np.ndarray) -> bool:
    """Buffered OBJ writer, the layout of export.py:export_obj, with the
    shortest decimal that round-trips each float32. Returns False, writing
    nothing, for layouts the C side does not stride (rows other than 3
    wide, colors for only some vertices): export_obj formats those in
    Python."""
    verts, tris, norms = _f32(vertices), _i32(triangles), _f32(normals)
    for arr in (verts, tris, norms):
        if arr.ndim != 2 or (len(arr) and arr.shape[1] != 3):
            return False
    if diffuse is not None and len(diffuse) == len(verts) and len(verts):
        diff = _f32(diffuse)
        if diff.ndim != 2 or diff.shape[1] != 3:
            return False
        diff_p = diff.ctypes.data_as(_F)
    elif diffuse is None or len(diffuse) == 0:
        diff_p = _F()
    else:
        return False
    rc = get_lib().obj_write(str(filename).encode(), verts.ctypes.data_as(_F), len(verts),
                             diff_p, norms.ctypes.data_as(_F), len(norms),
                             tris.ctypes.data_as(_I32), len(tris))
    if rc != 0:
        raise OSError(f"obj_write could not write {filename} (code {rc})")
    return True


def marching_tetrahedra_numpy(density: np.ndarray, iso: float
                              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized numpy marching tetrahedra with the library's 6-tet
    decomposition, without vertex dedup (verts repeated per triangle)."""
    d = np.asarray(density, np.float32)
    nx, ny, nz = d.shape
    corner_off = np.array(
        [[0, 0, 0], [0, 0, 1], [0, 1, 0], [0, 1, 1],
         [1, 0, 0], [1, 0, 1], [1, 1, 0], [1, 1, 1]]
    )
    tets = np.array(
        [[0, 5, 1, 7], [0, 1, 3, 7], [0, 3, 2, 7],
         [0, 2, 6, 7], [0, 6, 4, 7], [0, 4, 5, 7]]
    )

    base = np.stack(
        np.meshgrid(np.arange(nx - 1), np.arange(ny - 1), np.arange(nz - 1), indexing="ij"),
        -1,
    ).reshape(-1, 3)  # (C, 3)
    corners = base[:, None, :] + corner_off[None, :, :]  # (C, 8, 3)
    vals = d[corners[..., 0], corners[..., 1], corners[..., 2]]  # (C, 8)

    def interp(pa, va, pb, vb):
        denom = vb - va
        tt = np.where(np.abs(denom) < 1e-12, 0.5, (iso - va) / np.where(denom == 0, 1, denom))
        tt = np.clip(tt, 0, 1)[..., None]
        return pa + tt * (pb - pa)

    verts_out = []
    for t in tets:
        tc = corners[:, t, :].astype(np.float32)  # (C, 4, 3)
        tv = vals[:, t]  # (C, 4)
        inside = tv > iso
        n_in = inside.sum(-1)
        for target in (1, 3):
            sel = n_in == target
            if not sel.any():
                continue
            # The lone corner: inside for n_in == 1, outside for n_in == 3.
            lone = np.argmax(inside[sel] == (target == 1), -1)
            rows = np.arange(sel.sum())
            oth = np.array([[j for j in range(4) if j != l] for l in lone])
            pl = tc[sel][rows, lone]
            vl = tv[sel][rows, lone]
            tri = [interp(pl, vl, tc[sel][rows, oth[:, k]], tv[sel][rows, oth[:, k]])
                   for k in range(3)]
            verts_out.append(np.stack(tri, 1))
        sel = n_in == 2
        if sel.any():
            order = np.argsort(~inside[sel], -1, kind="stable")
            a0, a1, b0, b1 = order[:, 0], order[:, 1], order[:, 2], order[:, 3]
            rows = np.arange(sel.sum())
            sc, sv = tc[sel], tv[sel]
            v00 = interp(sc[rows, a0], sv[rows, a0], sc[rows, b0], sv[rows, b0])
            v01 = interp(sc[rows, a0], sv[rows, a0], sc[rows, b1], sv[rows, b1])
            v10 = interp(sc[rows, a1], sv[rows, a1], sc[rows, b0], sv[rows, b0])
            v11 = interp(sc[rows, a1], sv[rows, a1], sc[rows, b1], sv[rows, b1])
            verts_out.append(np.stack([v00, v10, v01], 1))
            verts_out.append(np.stack([v01, v10, v11], 1))

    if not verts_out:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32),
                np.zeros((0, 3), np.float32))
    verts = np.concatenate(verts_out, 0).reshape(-1, 3)  # (T * 3, 3)
    tris = np.arange(verts.shape[0], dtype=np.int32).reshape(-1, 3)

    # Normals from the central-difference gradient at the nearest grid point.
    gx, gy, gz = np.gradient(d)
    vi = np.clip(np.round(verts).astype(int), 0, [nx - 1, ny - 1, nz - 1])
    g = np.stack([gx[vi[:, 0], vi[:, 1], vi[:, 2]],
                  gy[vi[:, 0], vi[:, 1], vi[:, 2]],
                  gz[vi[:, 0], vi[:, 1], vi[:, 2]]], -1)
    norm = np.linalg.norm(g, axis=-1, keepdims=True)
    normals = -g / np.where(norm < 1e-12, 1.0, norm)
    return verts.astype(np.float32), tris, normals.astype(np.float32)


def marching_cubes(density, iso: float) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The iso-surface as (verts, tris, normals) in grid-index coordinates,
    from a dense (nx, ny, nz) array or a SparseDensityGrid (mesh/extract.py),
    which marches straight from its fetched blocks."""
    if hasattr(density, "block_ids"):  # SparseDensityGrid
        return marching_sparse_native(density.res, density.block_fill, density.block_ids,
                                      density.block_values, iso)
    return marching_tetrahedra_native(density, iso)
