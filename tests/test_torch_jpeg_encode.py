"""The port's baseline JPEG encoder (nerfmeshes_tpu_torch/data/jpeg.py:
encode_jpeg, csrc/jpeg_encode.cpp built with g++) against PIL's default
save on this host (libjpeg-turbo), on the CPU.

Tolerance: none. Every case's file equals PIL's `Image.save(format=
"JPEG")` byte for byte, the bytes imageio's JPEG writer gives (and so the
JAX ScanNet exporter's files): random and smooth images, colour (4:2:0)
and grey, sizes 1x1, 17x9, 16x16, 33x47 (dummy blocks at the right and
bottom MCU edges), 1297x969 and 968x1296, and noise that outgrows the
first output buffer. The port's decoder reads each file back as imageio
does.
The encode time of a 1296x968 frame is printed: a time of this host's CPU,
not of any card.
"""

import io
import time

import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image

from nerfmeshes_tpu_torch.data import jpeg as t_jpeg


def _pil(img: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def _image(kind: str, H: int, W: int, seed: int = 0) -> np.ndarray:
    if kind == "random":
        return np.random.default_rng(seed).integers(0, 256, (H, W, 3), dtype=np.uint8)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    img = np.stack([128 + 100 * np.sin(xx / 17.0 + yy / 29.0), 128 + 90 * np.cos(yy / 11.0),
                    (xx * 3 + yy * 5) % 256], -1)
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("kind", ["random", "smooth"])
@pytest.mark.parametrize("size", [(1, 1), (17, 9), (16, 16), (33, 47), (1297, 969),
                                  (968, 1296)])
@pytest.mark.parametrize("grey", [False, True])
def test_default_save_bytes_equal_pil(kind, size, grey):
    img = _image(kind, *size)
    if grey:
        img = np.ascontiguousarray(img[..., 1])
    got = t_jpeg.encode_jpeg(img)
    assert got == _pil(img)
    want = imageio.imread(io.BytesIO(got))
    np.testing.assert_array_equal(t_jpeg.decode_jpeg(got), want)


def test_noise_outgrows_the_first_buffer():
    """The encoder reports the room it needs, and is called again."""
    img = _image("random", 256, 256, seed=3)
    assert t_jpeg.encode_jpeg(img) == _pil(img)
    assert len(_pil(img)) > img.size // 8 + 4096


def test_write_jpeg_and_views(tmp_path):
    img = _image("smooth", 20, 30)[::-1, ::2]  # a strided view
    t_jpeg.write_jpeg(tmp_path / "a.jpg", img)
    assert (tmp_path / "a.jpg").read_bytes() == _pil(np.ascontiguousarray(img))


@pytest.mark.parametrize("bad", [np.zeros((4, 4, 4), np.uint8), np.zeros((4, 4), np.float32),
                                 np.zeros((0, 4, 3), np.uint8), np.zeros(5, np.uint8)])
def test_what_it_does_not_encode_raises(bad):
    with pytest.raises(ValueError, match="encode_jpeg takes|sides"):
        t_jpeg.encode_jpeg(bad)


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "jpeg_encode.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(t_jpeg, "encoder_source_path", lambda: bad)
    monkeypatch.setattr(t_jpeg, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        t_jpeg.build_encoder()


def test_encode_time_of_a_scannet_sized_frame(capsys):
    img = _image("smooth", 968, 1296)
    data = t_jpeg.encode_jpeg(img)
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        t_jpeg.encode_jpeg(img)
        runs.append(time.perf_counter() - t0)
    ms = 1e3 * float(np.median(runs))
    with capsys.disabled():
        print(f"\njpeg encode 1296x968 4:2:0 q75 ({len(data)} B): {ms:.3f} ms median of 5 "
              "(this host's CPU)")
