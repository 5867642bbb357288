"""The port's animated GIF writer (nerfmeshes_tpu_torch/data/gif.py,
csrc/gif_encode.cpp built with g++) against imageio's GIF writer (Pillow)
on this host, on the CPU.

- imageio reads the port's file back with the frame count, size, duration
  (40 ms for 42) and loop (0) of imageio's own file of the same frames,
  written as JAX's eval writes it (mimwrite(..., duration=42, loop=0)).
- Quality: the PSNR of imageio's decode of the port's file against the
  source frames is at most 0.5 dB below that of imageio's own file, on
  smooth moving frames, on noise, and on renders of the procedural scene.
  Frames of at most 256 colours come back exactly.
- gif_summary walks both files' blocks to the same counts, delays and loop.
- Bad frames raise; a source g++ cannot build raises.
"""

import io

import imageio.v2 as imageio
import numpy as np
import pytest
import torch

from nerfmeshes_tpu_torch.data import gif as t_gif

torch.set_num_threads(1)


def _psnr(a, b) -> float:
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return float(10 * np.log10(255.0 ** 2 / max(mse, 1e-12)))


def _smooth(n, H, W):
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    frames = []
    for t in np.linspace(0, 3, n):
        img = np.stack([128 + 100 * np.sin(xx / 17.0 + yy / 29.0 + t),
                        128 + 90 * np.cos(yy / 11.0 - t), (xx * 3 + yy * 5 + 20 * t) % 256], -1)
        frames.append(np.clip(img, 0, 255).astype(np.uint8))
    return np.stack(frames)


def _rendered(n):
    from nerfmeshes_tpu_torch.data.synthetic import make_synthetic_dataset

    bundle = make_synthetic_dataset(num_images=n, image_size=48, scene="hard", num_samples=64,
                                    device=torch.device("cpu"))
    return (np.clip(bundle.ray_targets, 0, 1) * 255).astype(np.uint8)


FRAMES = {
    "smooth": lambda: _smooth(6, 60, 80),
    "noise": lambda: np.random.default_rng(0).integers(0, 256, (3, 37, 41, 3), dtype=np.uint8),
    "rendered": lambda: _rendered(4),
}


def _imageio_gif(frames) -> bytes:
    buf = io.BytesIO()
    imageio.mimwrite(buf, list(frames), format="gif", duration=42, loop=0)
    return buf.getvalue()


def _read(data: bytes):
    from PIL import Image

    frames = np.stack([f[..., :3] for f in imageio.mimread(io.BytesIO(data))])
    im = Image.open(io.BytesIO(data))
    durations = []
    for i in range(im.n_frames):
        im.seek(i)
        durations.append(im.info.get("duration"))
    return frames, durations, im.info.get("loop")


@pytest.mark.parametrize("kind", list(FRAMES))
def test_imageio_reads_what_it_writes_and_as_well(kind, tmp_path, capsys):
    frames = FRAMES[kind]()
    t_gif.write_gif(tmp_path / "a.gif", frames)
    got, got_dur, got_loop = _read((tmp_path / "a.gif").read_bytes())
    want, want_dur, want_loop = _read(_imageio_gif(frames))
    assert got.shape == want.shape == frames.shape
    assert got_dur == want_dur == [40] * len(frames)
    assert got_loop == want_loop == 0
    ours, theirs = _psnr(got, frames), _psnr(want, frames)
    with capsys.disabled():
        print(f"\ngif {kind} {frames.shape}: PSNR port {ours:.3f} dB, imageio {theirs:.3f} dB")
    assert ours >= theirs - 0.5


def test_few_colours_come_back_exactly():
    rng = np.random.default_rng(2)
    frames = (rng.integers(0, 5, (3, 30, 20, 3)) * 60).astype(np.uint8)
    got, _, _ = _read(t_gif.encode_gif(frames))
    np.testing.assert_array_equal(got, frames)
    one = np.full((2, 1, 1, 3), 7, np.uint8)
    np.testing.assert_array_equal(_read(t_gif.encode_gif(one))[0], one)


def test_block_walk_matches_imageio_file():
    frames = _smooth(5, 24, 40)
    got = t_gif.gif_summary(t_gif.encode_gif(list(frames)))
    want = t_gif.gif_summary(_imageio_gif(frames))
    assert (got["width"], got["height"]) == (want["width"], want["height"]) == (40, 24)
    assert got["delays"] == [4] * 5 and want["delays"] == [4] * 5
    assert got["loop"] == want["loop"] == 0
    assert got["frames"] == [(0, 0, 40, 24)] * 5 and len(want["frames"]) == 5
    assert got["trailer"] and want["trailer"]
    slow = t_gif.gif_summary(t_gif.encode_gif(frames, duration_ms=100, loop=3))
    assert slow["loop"] == 3 and slow["delays"] == [10] * 5
    with pytest.raises(ValueError, match="not a GIF"):
        t_gif.gif_summary(b"\x89PNG")


def test_many_frames_and_a_large_one():
    frames = np.random.default_rng(1).integers(0, 256, (2, 300, 500, 3), dtype=np.uint8)
    got, _, _ = _read(t_gif.encode_gif(frames))
    assert got.shape == frames.shape and _psnr(got, frames) > 20


@pytest.mark.parametrize("bad", [np.zeros((2, 4, 4, 4), np.uint8), np.zeros((4, 4, 3), np.uint8),
                                 np.zeros((1, 4, 4, 3), np.float32),
                                 np.zeros((0, 4, 4, 3), np.uint8)])
def test_bad_frames_raise(bad):
    with pytest.raises(ValueError, match="encode_gif takes"):
        t_gif.encode_gif(bad)


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "gif_encode.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(t_gif, "source_path", lambda: bad)
    monkeypatch.setattr(t_gif, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        t_gif.build_library()
