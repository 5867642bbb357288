"""Write the progressive and 4:1:1 JPEG fixtures of the port's decoder
tests and chip_smoke.py's jpeg_phase into tests/data/jpeg/, with
digests.json: for each file the SHA-256 of the pixels imageio.v2.imread
gives (PIL and its libjpeg-turbo), their shape, the frame type and the
sampling factors.

Needs PIL, cv2 and imageio (the JAX host's packages):

    python scripts/torch_jpeg_fixtures.py [--out tests/data/jpeg]
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
from pathlib import Path

import cv2
import imageio.v2 as imageio
import numpy as np
from PIL import Image, ImageFile

ImageFile.MAXBLOCK = 1 << 24  # progressive saves of noisy images outgrow PIL's guess


def scene(H: int, W: int, noise: float = 4.0, seed: int = 0) -> np.ndarray:
    """A smooth colour field with a little noise: photo-like, small files."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    img = np.stack([128 + 100 * np.sin(xx / 37.0 + yy / 53.0), 128 + 90 * np.cos(yy / 41.0),
                    128 + 80 * np.sin((xx + yy) / 61.0)], -1)
    img += np.random.default_rng(seed).normal(0, noise, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def pil(img: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def cv(img: np.ndarray, *params) -> bytes:
    ok, buf = cv2.imencode(".jpg", img[..., ::-1] if img.ndim == 3 else img, list(params))
    assert ok
    return buf.tobytes()


def frame_info(data: bytes) -> tuple[str, str]:
    """('SOF0' / 'SOF2', 'HxV,HxV,...') from the frame header."""
    p = 2
    while p < len(data):
        m, length = data[p + 1], (data[p + 2] << 8) | data[p + 3]
        if m in (0xC0, 0xC1, 0xC2):
            n = data[p + 9]
            comps = [data[p + 11 + 3 * i] for i in range(n)]
            return f"SOF{m - 0xC0}", ",".join(f"{c >> 4}x{c & 15}" for c in comps)
        p += 2 + length
    raise ValueError("no SOF")


def fixtures() -> dict[str, bytes]:
    small = scene(40, 56)
    odd = scene(37, 53, seed=1)
    return {
        "prog_420_pil.jpg": pil(small, progressive=True, quality=80),
        "prog_444_pil.jpg": pil(odd, progressive=True, quality=90, subsampling=0),
        "prog_420_rst_pil.jpg": pil(odd, progressive=True, quality=75, restart_marker_blocks=3),
        "prog_grey_pil.jpg": pil(np.ascontiguousarray(odd[..., 1]), progressive=True),
        "prog_rst_cv2.jpg": cv(odd, cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                               cv2.IMWRITE_JPEG_RST_INTERVAL, 2),
        "s411_cv2.jpg": cv(odd, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                           cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411),
        "s411_prog_cv2.jpg": cv(small, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
                                cv2.IMWRITE_JPEG_PROGRESSIVE, 1),
        "prog_1296x968_pil.jpg": pil(scene(968, 1296, noise=1.5, seed=2), progressive=True,
                                     quality=75),
    }


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=str(Path(__file__).resolve().parents[1] / "tests" /
                                              "data" / "jpeg"))
    out = Path(parser.parse_args(argv).out)
    out.mkdir(parents=True, exist_ok=True)
    digests = {}
    for name, data in fixtures().items():
        (out / name).write_bytes(data)
        pixels = np.ascontiguousarray(imageio.imread(io.BytesIO(data)))
        sof, sampling = frame_info(data)
        digests[name] = {"sha256": hashlib.sha256(pixels.tobytes()).hexdigest(),
                         "shape": list(pixels.shape), "frame": sof, "sampling": sampling}
        print(f"{name}: {len(data)} B, {sof} {sampling}, {pixels.shape}")
    (out / "digests.json").write_text(json.dumps(digests, indent=1, sort_keys=True) + "\n")


if __name__ == "__main__":
    main()
