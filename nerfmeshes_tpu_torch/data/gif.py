"""Animated GIF writing for the port: `csrc/gif_encode.cpp`, host C++ bound
with ctypes (the GPU host has no imageio or Pillow, and LZW in Python
loops would cost more than the render it follows).

Built with g++ at first use into `build/gif/` (listed in .gitignore) by
utils/gxx.py, with -pthread: frames are coded on every core. A failed
build raises; nothing falls back.

`write_gif(path, frames, duration_ms=42, loop=0)` writes what
`imageio.mimwrite(path, frames, duration=42, loop=0)` writes through
Pillow, block for block but not byte for byte: the frame count and size,
a delay of duration_ms // 10 hundredths of a second on each frame (4 for
42 ms: imageio reads 40 ms back), a NETSCAPE2.0 loop count, and a palette
of at most 256 colours per frame by a median cut without dithering (the
source's header says how).
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np

from nerfmeshes_tpu_torch.utils import gxx

_PACKAGE = Path(__file__).resolve().parents[1]
BUILD_DIR = _PACKAGE.parent / "build" / "gif"
_FLAGS = ("-pthread",)


def source_path() -> Path:
    return _PACKAGE / "csrc" / "gif_encode.cpp"


def build_library() -> Path:
    """Compile the encoder unless a build of it exists; returns its path."""
    src = source_path()
    return gxx.build_library(src, gxx.library_path(src, BUILD_DIR, "gif_encode", _FLAGS), _FLAGS)


@functools.cache
def get_lib() -> ctypes.CDLL:
    """The built encoder with its entry point's signature set."""
    lib = ctypes.CDLL(str(build_library()))
    u8 = ctypes.POINTER(ctypes.c_uint8)
    lib.nm_gif_encode.restype = ctypes.c_int64
    lib.nm_gif_encode.argtypes = [u8, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                                  ctypes.c_int32, ctypes.c_int32, u8, ctypes.c_int64]
    return lib


def encode_gif(frames, duration_ms: float = 42, loop: int = 0) -> bytes:
    """(N, H, W, 3) uint8 frames (an array or a sequence of equal-sized
    frames) -> the bytes of an animated GIF showing each for duration_ms
    (kept to the hundredth of a second below, as Pillow keeps it), looping
    `loop` times (0: forever)."""
    frames = np.ascontiguousarray(frames if isinstance(frames, np.ndarray) else np.stack(frames))
    if frames.dtype != np.uint8 or frames.ndim != 4 or frames.shape[-1] != 3 or not len(frames):
        raise ValueError(f"encode_gif takes (N, H, W, 3) uint8 frames, got {frames.dtype} "
                         f"{frames.shape}")
    N, H, W, _ = frames.shape
    if not (1 <= H <= 65535 and 1 <= W <= 65535):
        raise ValueError(f"GIF sides are 1..65535 pixels, got {H}x{W}")
    delay, loop = int(duration_ms / 10), int(loop)
    if not (0 <= delay <= 65535 and 0 <= loop <= 65535):
        raise ValueError(f"delay {delay} cs and loop {loop} must fit GIF's 16-bit fields")
    lib = get_lib()
    u8 = ctypes.POINTER(ctypes.c_uint8)
    src = frames.ctypes.data_as(u8)
    # Renders take under half a byte a sample; noise takes more, and then
    # the encoder is called again with the room it reports.
    out = np.empty(frames.size // 2 + 1024 * (N + 1), np.uint8)
    size = lib.nm_gif_encode(src, N, H, W, delay, loop, out.ctypes.data_as(u8), out.size)
    if size > out.size:
        out = np.empty(size, np.uint8)
        size = lib.nm_gif_encode(src, N, H, W, delay, loop, out.ctypes.data_as(u8), out.size)
    return out[:size].tobytes()


def write_gif(path, frames, duration_ms: float = 42, loop: int = 0) -> None:
    """Write encode_gif(frames, duration_ms, loop) to `path`."""
    Path(path).write_bytes(encode_gif(frames, duration_ms, loop))


def gif_summary(data: bytes) -> dict:
    """Walk a GIF's blocks without decoding its pixels: {"width",
    "height", "frames": [(left, top, width, height)], "delays" (hundredths
    of a second, one per Graphic Control Extension), "loop" (the
    NETSCAPE2.0 count, or None), "trailer" (whether the file ends with
    one)}. Raises ValueError on a malformed block."""
    if data[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError("not a GIF file")
    width, height, packed = int.from_bytes(data[6:8], "little"), \
        int.from_bytes(data[8:10], "little"), data[10]
    pos = 13 + (3 << ((packed & 7) + 1) if packed & 0x80 else 0)
    out = {"width": width, "height": height, "frames": [], "delays": [], "loop": None,
           "trailer": False}

    def sub_blocks(p: int) -> tuple[bytes, int]:
        chunks = []
        while True:
            if p >= len(data):
                raise ValueError("GIF ends inside a block")
            n = data[p]
            if n == 0:
                return b"".join(chunks), p + 1
            chunks.append(data[p + 1:p + 1 + n])
            p += 1 + n

    while pos < len(data):
        kind = data[pos]
        if kind == 0x3B:
            out["trailer"] = pos == len(data) - 1
            break
        if kind == 0x21:  # an extension: its label, then sub-blocks
            label = data[pos + 1]
            body, pos = sub_blocks(pos + 2)
            if label == 0xF9:
                out["delays"].append(int.from_bytes(body[1:3], "little"))
            elif label == 0xFF and body[:11] == b"NETSCAPE2.0" and body[11] == 1:
                out["loop"] = int.from_bytes(body[12:14], "little")
        elif kind == 0x2C:  # an image: descriptor, local table, LZW data
            left, top, w, h = (int.from_bytes(data[pos + 1 + 2 * i:pos + 3 + 2 * i], "little")
                               for i in range(4))
            local = data[pos + 9]
            pos += 10 + (3 << ((local & 7) + 1) if local & 0x80 else 0)
            out["frames"].append((left, top, w, h))
            _, pos = sub_blocks(pos + 1)  # after the LZW minimum code size
        else:
            raise ValueError(f"unknown GIF block 0x{kind:02x} at byte {pos}")
    return out
