"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every `nerfmeshes_tpu_torch/csrc/*.cu` (the fused MLP forward and
backward, the sigma-only field, the field's layer route, the chord
compaction) is compiled on
first use, one nvcc
per source, all started together, and the objects are linked into one
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds, not minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC
         -Xptxas -v -c -o build/torch_kernels/<name>....o csrc/<name>.cu   (each)
    nvcc -shared -o build/torch_kernels/lib....so build/torch_kernels/*....o

The library name carries a hash of the sources and flags, so an edited
source rebuilds and an unchanged one loads the cached build. No fast-math
flag: the positional encoding feeds sinf/cosf arguments of thousands of
radians.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, per kernel
)

# C signatures of the library's entry points: name -> (restype, argtypes).
# Every pointer and the stream are c_void_p, or ctypes would cut them to
# 32 bits.
_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
SIGNATURES = {
    "nm_compact_chords": (
        _I,
        [_P, _P, _I, _P, _I, _P, _I, _P, _I, _F, _P, _I, _F, _I, _P, _P, _P, _P, _P],
    ),
    "nm_fused_mlp_fwd": (
        _I,
        [_P, _P, _P, _LL, _I, _P, _P, _P, _I, _P, _I, _P, _I, _P],
    ),
    "nm_fused_mlp_bwd_workspace": (
        _I,
        [_P, _I, _P, _I, _LL, ctypes.POINTER(_LL)],
    ),
    "nm_fused_mlp_bwd": (
        _I,
        [_P, _P, _P, _LL, _I, _P, _P, _P, _P, _I, _P, _I, _P, _LL, _P, _P, _P],
    ),
    "nm_dw_product": (
        _I,
        [_P, _I, _I, _P, _I, _I, _LL, _P, _LL, _P, _P],
    ),
    "nm_fused_sigma": (
        _I,
        [_P, _LL, _P, _P, _P, _I, _P, _I, _P, _P],
    ),
    "nm_field_layers_workspace": (
        _I,
        [_I, _P, _I, _P, _I, _LL, ctypes.POINTER(_LL)],
    ),
    "nm_field_layers": (
        _I,
        [_I, _P, _P, _P, _LL, _I, _P, _P, _P, _P, _I, _P, _I, _P, _LL, _LL, _P, _I, _P, _P, _P,
         _P],
    ),
    "nm_field_layers_pe": (
        _I,
        [_P, _P, _P, _LL, _I, _P, _I, _P, _I, _P, _P, _P, _P],
    ),
    "nm_field_layers_product": (
        _I,
        [_P, _I, _P, _I, _LL, _P, _LL, _I, _I, _P, _I, _P, _P, _P, _P],
    ),
    "nm_field_layers_product_plan": (_I, [_I, _P]),
    "nm_field_layers_heads_bwd": (_I, [_P, _P, _LL, _I, _P, _P, _P, _P, _P, _P, _P]),
    "nm_field_layers_bias": (_I, [_I, _P, _P, _P, _P, _P, _P, _LL, _P]),
    "nm_field_layers_dw": (_I, [_I, _P, _P, _P, _LL, _I, _P, _LL, _I, _I, _P, _P, _LL, _P, _P]),
    "nm_cuda_error_string": (ctypes.c_char_p, [_I]),
}


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and PATH); "
            "the CUDA kernels of nerfmeshes_tpu_torch are built on the GPU host."
        )
    return found


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libnerfmeshes_kernels_{digest.hexdigest()[:16]}.so"


def build_library() -> tuple[Path, str]:
    """Compile csrc/ unless a build of these exact sources exists: one nvcc
    per .cu, run in parallel, then one link. Returns (library path,
    nvcc's output: '' when the build was cached)."""
    out = library_path()
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    start = time.monotonic()
    jobs = []
    for src in (p for p in _sources() if p.suffix == ".cu"):
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    log = []
    failed = []
    for cmd, _, proc in jobs:
        text, _ = proc.communicate()
        log.append(text)
        log.append(f"nvcc {Path(cmd[-1]).name}: finished by {time.monotonic() - start:.1f} s "
                   "into the build\n")
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{text}")
    objs = [obj for _, obj, _ in jobs]
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return out, "".join(log)


@functools.cache
def load_library() -> ctypes.CDLL:
    """The built kernel library with every entry point's signature set."""
    path, _ = build_library()
    lib = ctypes.CDLL(str(path))
    for name, (restype, argtypes) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def ptxas_usage(log: str) -> dict[str, dict[str, int]]:
    """What `-Xptxas -v` reports per kernel in an nvcc log: {mangled
    entry name: {"registers", "stack", "spill_stores", "spill_loads" (bytes
    a thread), "c7519" (notes that ptxas serialised the kernel's wgmma)}}."""
    usage: dict[str, dict[str, int]] = {}
    name = None
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            name = (line.split("'")[1] if "'" in line else line.split()[-1]).strip()
            usage.setdefault(name, dict(registers=0, stack=0, spill_stores=0, spill_loads=0,
                                        c7519=0))
        elif "C7519" in line:
            key = line.rsplit("function", 1)[-1].strip(" '")
            usage.setdefault(key, dict(registers=0, stack=0, spill_stores=0, spill_loads=0,
                                       c7519=0))["c7519"] += 1
        elif name is not None and "bytes stack frame" in line:
            words = line.replace(",", " ").split()
            usage[name]["stack"] = int(words[words.index("stack") - 2])
            usage[name]["spill_stores"] = int(words[words.index("stores") - 3])
            usage[name]["spill_loads"] = int(words[words.index("loads") - 3])
        elif name is not None and "Used" in line and "registers" in line:
            words = line.replace(",", " ").split()
            usage[name]["registers"] = int(words[words.index("registers") - 1])
    return usage


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if code != 0:
        msg = lib.nm_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")
