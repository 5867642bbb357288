"""JPEG for the port: the decoder `csrc/jpeg_decode.cpp` and the encoder
`csrc/jpeg_encode.cpp`, host C++ bound with ctypes.

The GPU host has no imageio, PIL or cv2, and a Huffman coder in Python
loops takes seconds a frame, so both are C++ built with g++ at first use
into `build/jpeg/` (listed in .gitignore) by utils/gxx.py, as the mesh
library is built. A failed build raises; nothing falls back.

The decoder reads sequential (SOF0, SOF1) and progressive (SOF2) DCT JPEG,
8-bit, 1 or 3 components, sampling factors 1, 2 or 4 on each axis,
restart intervals, any size, to what `imageio.v2.imread` gives through PIL
and libjpeg's default settings: the same (H, W, 3) or (H, W) uint8 pixels,
bit for bit (the source's header names each libjpeg step it follows). The
EXIF orientation is not applied, as imageio does not apply it. Lossless,
arithmetic-coded, 12-bit and 4-component (CMYK) files raise
NotImplementedError naming the file; a corrupt one raises ValueError.

The encoder writes baseline JPEG as libjpeg-turbo's defaults write it
(PIL's `Image.save(format="JPEG")`, which imageio's JPEG writer calls):
quality 75, 4:2:0, the standard Huffman tables, a JFIF 1.01 header.
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
    """Compile the decoder unless a build of it exists; returns its path."""
    return gxx.build_library(source_path(), library_path())


def encoder_source_path() -> Path:
    return _PACKAGE / "csrc" / "jpeg_encode.cpp"


def build_encoder() -> Path:
    """Compile the encoder unless a build of it exists; returns its path."""
    src = encoder_source_path()
    return gxx.build_library(src, gxx.library_path(src, BUILD_DIR, "jpeg_encode"))


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
            f"{name}: {msg} is not decoded by the port, which reads 8-bit Huffman-coded "
            "sequential and progressive JPEG of 1 or 3 components (ROADMAP.md lists the gaps)")
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


@functools.cache
def get_encoder_lib() -> ctypes.CDLL:
    """The built encoder with its entry point's signature set."""
    lib = ctypes.CDLL(str(build_encoder()))
    u8 = ctypes.POINTER(ctypes.c_uint8)
    lib.nm_jpeg_encode.restype = ctypes.c_int64
    lib.nm_jpeg_encode.argtypes = [u8, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, u8,
                                   ctypes.c_int64]
    return lib


def encode_jpeg(img: np.ndarray) -> bytes:
    """(H, W, 3) RGB or (H, W) grey uint8 -> the bytes of the baseline JPEG
    file that PIL's default save writes (quality 75, 4:2:0 for colour)."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"encode_jpeg takes (H, W) or (H, W, 3) uint8, got {img.dtype} "
                         f"{img.shape}")
    H, W = img.shape[:2]
    C = 1 if img.ndim == 2 else 3
    if not (1 <= H <= 65535 and 1 <= W <= 65535):
        raise ValueError(f"JPEG sides are 1..65535 pixels, got {H}x{W}")
    lib = get_encoder_lib()
    u8 = ctypes.POINTER(ctypes.c_uint8)
    src = img.ctypes.data_as(u8)
    # Photos take ~1/20 of their samples' bytes; noise takes more, and then
    # the encoder is called again with the room it reports.
    out = np.empty(img.size // 8 + 4096, np.uint8)
    size = lib.nm_jpeg_encode(src, H, W, C, out.ctypes.data_as(u8), out.size)
    if size > out.size:
        out = np.empty(size, np.uint8)
        size = lib.nm_jpeg_encode(src, H, W, C, out.ctypes.data_as(u8), out.size)
    return out[:size].tobytes()


def write_jpeg(path, img: np.ndarray) -> None:
    """Write encode_jpeg(img) to `path`."""
    Path(path).write_bytes(encode_jpeg(img))
