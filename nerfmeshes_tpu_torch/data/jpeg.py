"""Baseline JPEG decoding for the port: `csrc/jpeg_decode.cpp`, host C++
bound with ctypes.

The GPU host has no imageio, PIL or cv2, and a Huffman decoder in Python
loops takes seconds a frame, so the decoder is C++ built with g++ at first
use into `build/jpeg/` (listed in .gitignore) by utils/gxx.py, as the
mesh library is built. A failed build raises; nothing falls back.

It decodes sequential DCT JPEG (SOF0, SOF1), 8-bit, 1 or 3 components,
sampling factors 1 or 2 on each axis, restart intervals, any size, to what
`imageio.v2.imread` gives through PIL and libjpeg's default settings: the
same (H, W, 3) or (H, W) uint8 pixels, bit for bit (the source's header
names each libjpeg step it follows). The EXIF orientation is not applied,
as imageio does not apply it. Progressive, lossless, arithmetic-coded,
12-bit and 4-component (CMYK) files raise NotImplementedError naming the
file; a corrupt one raises ValueError.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np

from nerfmeshes_tpu_torch.utils import gxx

_PACKAGE = Path(__file__).resolve().parents[1]
BUILD_DIR = _PACKAGE.parent / "build" / "jpeg"
_UNSUPPORTED = 1  # the C entry points return 0 (decoded), 1 (unsupported), 2 (corrupt)
JPEG_SUFFIXES = (".jpg", ".jpeg")


def source_path() -> Path:
    return _PACKAGE / "csrc" / "jpeg_decode.cpp"


def library_path() -> Path:
    return gxx.library_path(source_path(), BUILD_DIR, "jpeg_decode")


def build_library() -> Path:
    """Compile the source unless a build of it exists; returns its path."""
    return gxx.build_library(source_path(), library_path())


@functools.cache
def get_lib() -> ctypes.CDLL:
    """The built library with both entry points' signatures set."""
    lib = ctypes.CDLL(str(build_library()))
    u8 = ctypes.POINTER(ctypes.c_uint8)
    lib.nm_jpeg_info.restype = ctypes.c_int
    lib.nm_jpeg_info.argtypes = [u8, ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
                                 ctypes.c_char_p, ctypes.c_int64]
    lib.nm_jpeg_decode.restype = ctypes.c_int
    lib.nm_jpeg_decode.argtypes = [u8, ctypes.c_int64, u8, ctypes.c_int64, ctypes.c_char_p,
                                   ctypes.c_int64]
    return lib


def _check(code: int, err, name: str) -> None:
    if code == 0:
        return
    msg = err.value.decode("utf-8", "replace")
    if code == _UNSUPPORTED:
        raise NotImplementedError(
            f"{name}: {msg} is not decoded by the port, which reads baseline JPEG only "
            "(queued in ROADMAP.md)")
    raise ValueError(f"{name}: corrupt JPEG: {msg}")


def decode_jpeg(data: bytes, name: str = "bytes") -> np.ndarray:
    """JPEG bytes -> (H, W, 3) uint8 RGB, or (H, W) uint8 for a grey
    image. `name` (a path, or "bytes") heads any error's message."""
    lib = get_lib()
    buf = np.frombuffer(bytes(data), np.uint8)
    src = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    err = ctypes.create_string_buffer(256)
    hwc = (ctypes.c_int32 * 3)()
    _check(lib.nm_jpeg_info(src, buf.size, hwc, err, len(err)), err, name)
    H, W, C = hwc
    out = np.empty((H, W, C) if C == 3 else (H, W), np.uint8)
    _check(lib.nm_jpeg_decode(src, buf.size, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                              out.size, err, len(err)), err, name)
    return out


def read_jpeg(path) -> np.ndarray:
    """decode_jpeg of the file at `path`, errors naming the file."""
    return decode_jpeg(Path(path).read_bytes(), str(path))
