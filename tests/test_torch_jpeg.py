"""The port's baseline JPEG decoder (nerfmeshes_tpu_torch/data/jpeg.py,
csrc/jpeg_decode.cpp built with g++) against imageio.v2.imread (PIL and
its libjpeg-turbo) on this host, on the CPU.

Tolerance: none. Every case equals imageio's pixels bit for bit, shape and
dtype included: (H, W, 3) uint8 for colour, (H, W) for grey.

- Fixtures encoded here at test time: random and smooth images at
  qualities 50, 75, 90 and 100, subsampled 4:4:4, 4:2:2 and 4:2:0 (PIL)
  and 4:4:0 (cv2: PIL cannot write it), and grey; restart intervals (in
  blocks and in rows, PIL and cv2); sizes 1x1, 17x9 and 1297x969, and
  chroma widths of 1-2 samples (where libjpeg replicates, not
  interpolates); an EXIF block with orientation 6 (not applied, as
  imageio does not apply it); RGB stored without a colour transform (an
  Adobe marker with transform 0); non-interleaved scans.
- Decoded from bytes and from a path, as imageio reads both.
- Progressive files (SOF2: spectral selection, successive approximation,
  EOB runs) written by PIL (4:2:0, 4:2:2, 4:4:4, grey, restart intervals
  in blocks and in rows) and by cv2 (with and without restarts), and
  4:1:1 (cv2's IMWRITE_JPEG_SAMPLING_FACTOR_411, baseline and progressive:
  libjpeg replicates the 4x1 chroma, no triangle filter), at sizes 1x1 to
  1297x969; the committed fixtures of tests/data/jpeg/ (made
  by scripts/torch_jpeg_fixtures.py) against imageio and the SHA-256 of
  imageio's pixels in their digests.json, which chip_smoke.py holds the
  card host's build to.
- Lossless, arithmetic-coded, 12-bit and CMYK files raise
  NotImplementedError naming the file and ROADMAP.md; a truncated or
  foreign file raises ValueError; damaged files decode or raise; a source
  g++ cannot build raises.
- The decode time of a 1296x968 4:2:0 frame is printed: a time of this
  host's CPU, not of any card.
"""

import hashlib
import io
import json
import time
from pathlib import Path

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image, ImageFile

from nerfmeshes_tpu_torch.data import jpeg as t_jpeg

FIXTURES = Path(__file__).resolve().parent / "data" / "jpeg"

SUBSAMPLING = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2}


def _pil(img: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def _cv2(img: np.ndarray, *params) -> bytes:
    ok, buf = cv2.imencode(".jpg", img, list(params))
    assert ok
    return buf.tobytes()


def _image(kind: str, H: int, W: int, seed: int = 0) -> np.ndarray:
    if kind == "random":
        return np.random.default_rng(seed).integers(0, 256, (H, W, 3), dtype=np.uint8)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    img = np.stack([128 + 100 * np.sin(xx / 17.0 + yy / 29.0), 128 + 90 * np.cos(yy / 11.0),
                    (xx * 3 + yy * 5) % 256], -1)
    return np.clip(img, 0, 255).astype(np.uint8)


def _assert_as_imageio(data: bytes):
    want = imageio.imread(io.BytesIO(data))
    got = t_jpeg.decode_jpeg(data)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize("kind", ["random", "smooth"])
@pytest.mark.parametrize("quality", [50, 75, 90, 100])
@pytest.mark.parametrize("subsampling", list(SUBSAMPLING))
def test_colour_matches_imageio(kind, quality, subsampling):
    for H, W in [(17, 9), (40, 56)]:
        data = _pil(_image(kind, H, W), quality=quality, subsampling=SUBSAMPLING[subsampling])
        assert _assert_as_imageio(data).shape == (H, W, 3)


@pytest.mark.parametrize("kind", ["random", "smooth"])
@pytest.mark.parametrize("quality", [50, 75, 90, 100])
def test_grey_matches_imageio(kind, quality):
    for H, W in [(1, 1), (17, 9), (40, 56)]:
        data = _pil(_image(kind, H, W)[..., 0], quality=quality)
        assert _assert_as_imageio(data).shape == (H, W)


@pytest.mark.parametrize("kind", ["random", "smooth"])
@pytest.mark.parametrize("quality", [50, 90])
def test_440_from_cv2_matches_imageio(kind, quality):
    for H, W in [(1, 1), (17, 9), (37, 53)]:
        data = _cv2(_image(kind, H, W), cv2.IMWRITE_JPEG_QUALITY, quality,
                    cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440)
        assert _assert_as_imageio(data).shape == (H, W, 3)


@pytest.mark.parametrize("subsampling", list(SUBSAMPLING))
@pytest.mark.parametrize("size", [(1, 1), (2, 3), (3, 5), (9, 17), (1297, 969)])
def test_odd_sizes_match_imageio(subsampling, size):
    """Sizes off the MCU grid; at widths up to 4 the 2x chroma is 1-2
    samples wide and libjpeg replicates it instead of interpolating."""
    W, H = size
    data = _pil(_image("smooth", H, W), quality=90, subsampling=SUBSAMPLING[subsampling])
    assert _assert_as_imageio(data).shape == (H, W, 3)


@pytest.mark.parametrize("restart", [dict(restart_marker_blocks=1),
                                     dict(restart_marker_blocks=3),
                                     dict(restart_marker_rows=1)])
@pytest.mark.parametrize("subsampling", ["4:4:4", "4:2:0"])
def test_restart_intervals_match_imageio(restart, subsampling):
    data = _pil(_image("random", 37, 53), quality=80, subsampling=SUBSAMPLING[subsampling],
                **restart)
    assert b"\xff\xdd" in data and b"\xff\xd1" in data
    _assert_as_imageio(data)


def test_restart_intervals_from_cv2_match_imageio():
    data = _cv2(_image("random", 37, 53), cv2.IMWRITE_JPEG_RST_INTERVAL, 2)
    assert b"\xff\xdd" in data
    _assert_as_imageio(data)


def test_exif_is_skipped_and_not_applied():
    exif = Image.Exif()
    exif[0x0112] = 6  # orientation: rotate 90 degrees clockwise to display
    data = _pil(_image("random", 24, 40), quality=85, exif=exif.tobytes())
    assert b"Exif" in data
    assert _assert_as_imageio(data).shape == (24, 40, 3)


def test_rgb_without_colour_transform_matches_imageio():
    """PIL's keep_rgb stores RGB samples with an Adobe marker of
    transform 0: no YCbCr conversion on decode."""
    data = _pil(_image("random", 19, 23), quality=90, keep_rgb=True, subsampling=0)
    assert b"Adobe" in data
    _assert_as_imageio(data)


def test_non_interleaved_scans_match_imageio():
    """A sequential file with one scan per component: three grey baseline
    files joined into one 3-component frame (_join_planes)."""
    planes = [_image("smooth", 21, 30)[..., k] for k in range(3)]
    grey = [_pil(p, quality=90) for p in planes]
    data = _join_planes(grey)
    want = np.stack([imageio.imread(io.BytesIO(g)) for g in grey], -1)
    got = t_jpeg.decode_jpeg(data)
    np.testing.assert_array_equal(got, want)  # RGB ids, no colour transform
    _assert_as_imageio(data)


def _segments(data: bytes):
    """(marker, payload) of each header segment up to SOS, then the scan's
    entropy-coded bytes (up to EOI) as marker 0xDA's second item."""
    pos, out = 2, []
    while True:
        marker = data[pos + 1]
        length = int.from_bytes(data[pos + 2:pos + 4], "big")
        body = data[pos + 4:pos + 2 + length]
        pos += 2 + length
        if marker == 0xDA:
            return out, body, data[pos:data.rindex(b"\xff\xd9")]
        out.append((marker, body))


def _join_planes(grey: list) -> bytes:
    """Three grey baseline files -> one 3-component file with ids R, G, B
    (so libjpeg applies no colour transform) and one scan per component,
    each plane keeping its own tables (renumbered 0, 1, 2)."""
    frames, dqt, dht, scans = [], b"", b"", b""
    for k, g in enumerate(grey):
        segs, sos, entropy = _segments(g)
        for marker, body in segs:
            if marker == 0xDB:
                dqt += bytes([k]) + body[1:65]
            elif marker == 0xC4:
                p = 0
                while p < len(body):
                    n = 17 + sum(body[p + 1:p + 17])
                    dht += bytes([(body[p] & 0xF0) | k]) + body[p + 1:p + n]
                    p += n
            elif marker == 0xC0:
                frames.append(body)
        sos_k = bytes([1, ord("RGB"[k]), (k << 4) | k]) + sos[-3:]
        scans += b"\xff\xda" + (len(sos_k) + 2).to_bytes(2, "big") + sos_k + entropy
    f0 = frames[0]
    sof = f0[:5] + bytes([3]) + b"".join(bytes([ord("RGB"[k]), 0x11, k]) for k in range(3))

    def seg(marker: int, body: bytes) -> bytes:
        return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") + body

    return (b"\xff\xd8" + seg(0xDB, dqt) + seg(0xC4, dht) + seg(0xC0, sof) + scans
            + b"\xff\xd9")


@pytest.fixture
def big_pil_buffer(monkeypatch):
    """PIL sizes its progressive encoder's buffer by the pixel count, which
    noise at a high quality outgrows."""
    monkeypatch.setattr(ImageFile, "MAXBLOCK", 1 << 24)


def _cv2_rgb(img: np.ndarray, *params) -> bytes:
    return _cv2(np.ascontiguousarray(img[..., ::-1]), *params)


PROGRESSIVE = {
    "pil-420": lambda img: _pil(img, progressive=True, quality=80),
    "pil-422": lambda img: _pil(img, progressive=True, quality=70, subsampling=1),
    "pil-444": lambda img: _pil(img, progressive=True, quality=90, subsampling=0),
    "pil-grey": lambda img: _pil(np.ascontiguousarray(img[..., 0]), progressive=True),
    "pil-restart-blocks": lambda img: _pil(img, progressive=True, restart_marker_blocks=3),
    "pil-restart-rows": lambda img: _pil(img, progressive=True, restart_marker_rows=1),
    "cv2": lambda img: _cv2_rgb(img, cv2.IMWRITE_JPEG_PROGRESSIVE, 1),
    "cv2-restart": lambda img: _cv2_rgb(img, cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                                        cv2.IMWRITE_JPEG_RST_INTERVAL, 2),
}


@pytest.mark.parametrize("writer", list(PROGRESSIVE))
@pytest.mark.parametrize("kind", ["random", "smooth"])
def test_progressive_matches_imageio(big_pil_buffer, writer, kind):
    for H, W in [(1, 1), (17, 9), (40, 56), (1297, 969)]:
        data = PROGRESSIVE[writer](_image(kind, H, W))
        assert data[data.index(b"\xff\xc2"):][:2] == b"\xff\xc2"  # SOF2
        _assert_as_imageio(data)


@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("kind", ["random", "smooth"])
def test_411_from_cv2_matches_imageio(progressive, kind):
    """Y 4x1, chroma 1x1: libjpeg-turbo replicates each chroma sample 4
    times (int_upsample); its triangle filter covers 2:1 only."""
    for H, W in [(1, 1), (9, 17), (37, 53), (968, 1296)]:
        data = _cv2_rgb(_image(kind, H, W), cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                        cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411, cv2.IMWRITE_JPEG_PROGRESSIVE,
                        int(progressive))
        sof = data.index(b"\xff\xc2" if progressive else b"\xff\xc0")
        assert data[sof + 11] == 0x41 and data[sof + 14] == data[sof + 17] == 0x11
        _assert_as_imageio(data)


def test_committed_fixtures_match_imageio_and_their_digests():
    digests = json.loads((FIXTURES / "digests.json").read_text())
    assert len(digests) == 8 and sum(d["frame"] == "SOF2" for d in digests.values()) == 7
    assert {d["sampling"].split(",")[0] for d in digests.values()} == {"1x1", "2x2", "4x1"}
    for name, want in digests.items():
        data = (FIXTURES / name).read_bytes()
        got = _assert_as_imageio(data)
        assert list(got.shape) == want["shape"]
        assert hashlib.sha256(got.tobytes()).hexdigest() == want["sha256"]


def test_path_and_read_images_match_imageio(tmp_path):
    from nerfmeshes_tpu_torch.data.blender import read_images

    img = _image("smooth", 33, 47)
    paths = []
    for suffix in (".jpg", ".JPEG"):
        path = tmp_path / f"frame{suffix}"
        path.write_bytes(_pil(img, quality=75))
        paths.append(path)
    imageio.imwrite(tmp_path / "frame.png", img)
    got = read_images([paths[0], tmp_path / "frame.png", paths[1]])
    for path, g in zip(paths, (got[0], got[2])):
        want = imageio.imread(path)
        np.testing.assert_array_equal(t_jpeg.read_jpeg(path), want)
        np.testing.assert_array_equal(g, want)
    np.testing.assert_array_equal(got[1], img)


def _patched(data: bytes, old: bytes, new: bytes) -> bytes:
    assert old in data
    return data.replace(old, new, 1)


def _unsupported_cases():
    img = _image("random", 16, 16)
    base = _pil(img, quality=75)
    sof = base.index(b"\xff\xc0")
    twelve = base[:sof + 4] + bytes([12]) + base[sof + 5:]
    buf = io.BytesIO()
    Image.fromarray(np.dstack([img, img[..., :1]]), "CMYK").save(buf, format="JPEG")
    return {
        "lossless": (_patched(base, b"\xff\xc0", b"\xff\xc3"), "lossless"),
        "arithmetic": (_patched(base, b"\xff\xc0", b"\xff\xc9"), "arithmetic"),
        "12-bit": (twelve, "12-bit"),
        "cmyk": (buf.getvalue(), "4-component"),
    }


@pytest.mark.parametrize("case", ["lossless", "arithmetic", "12-bit", "cmyk"])
def test_unsupported_files_raise(case, tmp_path):
    data, what = _unsupported_cases()[case]
    path = tmp_path / "photo.jpg"
    path.write_bytes(data)
    with pytest.raises(NotImplementedError, match=rf"photo\.jpg: .*{what}.*ROADMAP"):
        t_jpeg.read_jpeg(path)
    with pytest.raises(NotImplementedError, match=rf"^bytes: .*{what}"):
        t_jpeg.decode_jpeg(data)


def test_corrupt_files_raise():
    data = _pil(_image("random", 16, 16), quality=75)
    with pytest.raises(ValueError, match="no SOI"):
        t_jpeg.decode_jpeg(b"\x89PNG\r\n\x1a\n" + data)
    with pytest.raises(ValueError, match="corrupt JPEG"):
        t_jpeg.decode_jpeg(data[:data.index(b"\xff\xda")])


@pytest.mark.parametrize("subsampling", list(SUBSAMPLING))
def test_damaged_files_decode_or_raise(subsampling):
    """Outside input: 500 copies with a few bytes overwritten or the tail
    cut each decode to some image or raise ValueError / NotImplementedError;
    none takes the process down."""
    rng = np.random.default_rng(5)
    base = _pil(_image("random", 37, 53), quality=80, subsampling=SUBSAMPLING[subsampling],
                restart_marker_blocks=2)
    outcomes = set()
    for i in range(500):
        data = bytearray(base)
        for _ in range(int(rng.integers(1, 6))):
            data[int(rng.integers(0, len(data)))] = int(rng.integers(0, 256))
        if i % 7 == 0:
            data = data[:int(rng.integers(2, len(data)))]
        try:
            t_jpeg.decode_jpeg(bytes(data))
            outcomes.add("decoded")
        except (ValueError, NotImplementedError):
            outcomes.add("raised")
    assert outcomes == {"decoded", "raised"}


@pytest.mark.parametrize("writer", ["pil-420", "pil-restart-blocks", "cv2"])
def test_damaged_progressive_files_decode_or_raise(writer):
    """As above, through the progressive scans' EOB runs and refinements."""
    rng = np.random.default_rng(6)
    base = PROGRESSIVE[writer](_image("random", 37, 53))
    outcomes = set()
    for i in range(500):
        data = bytearray(base)
        for _ in range(int(rng.integers(1, 6))):
            data[int(rng.integers(0, len(data)))] = int(rng.integers(0, 256))
        if i % 7 == 0:
            data = data[:int(rng.integers(2, len(data)))]
        try:
            t_jpeg.decode_jpeg(bytes(data))
            outcomes.add("decoded")
        except (ValueError, NotImplementedError):
            outcomes.add("raised")
    assert outcomes == {"decoded", "raised"}


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "jpeg_decode.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(t_jpeg, "source_path", lambda: bad)
    monkeypatch.setattr(t_jpeg, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        t_jpeg.build_library()
    assert not list((tmp_path / "build").iterdir())


def test_decode_time_of_a_scannet_sized_frame(capsys):
    data = _pil(_image("smooth", 968, 1296), quality=90, subsampling=2)
    _assert_as_imageio(data)
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        t_jpeg.decode_jpeg(data)
        runs.append(time.perf_counter() - t0)
    ms = 1e3 * float(np.median(runs))
    with capsys.disabled():
        print(f"\njpeg decode 1296x968 4:2:0 ({len(data)} B): {ms:.3f} ms median of 5, "
              f"{len(data) / ms / 1e3:.3f} MB/s (this host's CPU)")
