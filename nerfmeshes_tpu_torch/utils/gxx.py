"""g++ builds of the port's host C++: the native mesh library
(mesh/native.py), the JPEG decoder and encoder (data/jpeg.py) and the GIF
encoder (data/gif.py).

Each library is built at first use under a name keyed on a hash of its
source, the flags and the host, so an edited source rebuilds and every
later process on the host loads the cached build. A failed build raises;
nothing falls back.
"""

from __future__ import annotations

import hashlib
import os
import platform
import subprocess
from pathlib import Path

GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")


def library_path(src: Path, build_dir: Path, stem: str, extra: tuple = ()) -> Path:
    """build_dir / lib{stem}_{hash}.so for the source `src` built with
    GXX_FLAGS and `extra` flags."""
    digest = hashlib.sha256(" ".join(GXX_FLAGS + tuple(extra)).encode())
    # -march=native builds for this host's CPU: another host must not load it.
    digest.update(f"{platform.node()} {platform.machine()}".encode())
    digest.update(Path(src).read_bytes())
    return Path(build_dir) / f"lib{stem}_{digest.hexdigest()[:16]}.so"


def build_library(src: Path, out: Path, extra: tuple = ()) -> Path:
    """Compile `src` (GXX_FLAGS and `extra` flags) into `out` unless it
    exists; returns `out`."""
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, *extra, str(src), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out
