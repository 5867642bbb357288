"""The port's periodic loggers (nerfmeshes_tpu_torch/utils/loggers.py)
against the JAX package's (nerfmeshes_tpu/utils/loggers.py) on the same
seeded arrays: the point clouds and their colour codes, comp_depth,
voxel_mesh and DepthLossLogger (integer parts exactly, floats within
1e-6); the memm curve image within 1 px of the sorted values, column by
column; the loggers' cadence and masks."""

import numpy as np
import pytest

from nerfmeshes_tpu.utils import loggers as j_loggers
from nerfmeshes_tpu_torch.utils import loggers
from nerfmeshes_tpu_torch.utils.tb_events import EventWriter, event_files, read_events

R = 257


def _rays(seed):
    rng = np.random.default_rng(seed)
    o = rng.standard_normal((R, 3)).astype(np.float32)
    d = rng.standard_normal((R, 3)).astype(np.float32)
    target = rng.uniform(2.0, 6.0, R).astype(np.float32)
    target[rng.random(R) < 0.3] = 0.0
    pred = (target + rng.normal(0.0, 0.3, R)).astype(np.float32)
    return rng, o, d, pred, target


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("with_target", [True, False])
def test_depth_point_clouds_match_jax(seed, with_target):
    _, o, d, pred, target = _rays(seed)
    tgt = target if with_target else None
    got = loggers.depth_point_clouds(o, d, pred, tgt)
    want = j_loggers.depth_point_clouds(o, d, pred, tgt)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[1], want[1])  # the colour codes, exactly
    if with_target:
        assert got[0].shape[0] == 2 * R  # target + predicted points
        codes = {tuple(c) for c in got[1]}
        assert codes <= {(0, 0, 255), (0, 255, 0), (0, 0, 0), (255, 0, 0)}


def test_create_point_cloud_with_one_origin_and_a_mask():
    _, _, d, pred, target = _rays(3)
    mask = target > 0
    got = loggers.create_point_cloud(np.ones(3), d, pred, loggers.POINT_OUT_TRUE, mask)
    want = j_loggers.create_point_cloud(np.ones(3), d, pred, j_loggers.POINT_OUT_TRUE, mask)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
    assert got[0].shape == (mask.sum(), 3)


@pytest.mark.parametrize("empty", [0.0, 2.5])
def test_comp_depth_matches_jax(empty):
    _, _, _, pred, target = _rays(4)
    np.testing.assert_allclose(loggers.comp_depth(pred, target, empty),
                               j_loggers.comp_depth(pred, target, empty), rtol=1e-6)
    all_empty = np.zeros(8, np.float32)
    assert loggers.comp_depth(all_empty + 1, all_empty) == j_loggers.comp_depth(
        all_empty + 1, all_empty)


def test_voxel_mesh_matches_jax():
    rng = np.random.default_rng(5)
    lo = rng.uniform(-1, 1, (33, 3)).astype(np.float32)
    voxels = np.stack([lo, lo + rng.uniform(0.1, 0.4, (33, 3)).astype(np.float32)], 1)
    got, want = loggers.voxel_mesh(voxels), j_loggers.voxel_mesh(voxels)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-6)
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("empty", [0.0, 3.0])
def test_depth_loss_logger_matches_jax(empty):
    rng, _, _, pred, target = _rays(6)
    rgb_out = rng.uniform(size=(R, 3))
    rgb_tgt = rng.uniform(size=(R, 3))
    got = loggers.DepthLossLogger("train", empty).tick({"a": 1.0}, rgb_out, rgb_tgt, pred,
                                                       target)
    want = j_loggers.DepthLossLogger("train", empty).tick({"a": 1.0}, rgb_out, rgb_tgt, pred,
                                                          target)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    assert loggers.DepthLossLogger().tick({"x": 2.0}, rgb_out, rgb_tgt, None, None) == {"x": 2.0}


def _blue_rows(img, col):
    return np.nonzero((img[:, col] == loggers.CURVE_COLOR).all(-1))[0]


@pytest.mark.parametrize("n, seed", [(4096, 0), (300, 1), (7, 2), (1, 3)])
def test_memm_curve_stands_within_a_pixel_of_the_sorted_values(n, seed):
    """Find the frame in the image, then check every column inside it: the
    curve's pixels reach within 1 px of the row the sorted value at that
    column maps to (the largest value on the top row, the smallest on the
    bottom)."""
    rng = np.random.default_rng(seed)
    memm = rng.gamma(0.5, 1.0, n).astype(np.float32)
    values = np.sort(memm)[::-1]
    img = loggers.curve_image(values)
    assert img.shape == (480, 640, 3) and img.dtype == np.uint8
    black = (img == 0).all(-1)
    frame_cols = np.nonzero(black.sum(0) > 200)[0]
    frame_rows = np.nonzero(black.sum(1) > 200)[0]
    x0, x1 = frame_cols.min(), frame_cols.max()
    y0, y1 = frame_rows.min(), frame_rows.max()
    lo, hi = float(values.min()), float(values.max())
    for col in range(x0 + 1, x1):
        rows = _blue_rows(img, col)
        assert rows.size, col
        v = np.interp((col - x0) / (x1 - x0) * (n - 1), np.arange(n), values)
        want = y1 - (v - lo) / (hi - lo) * (y1 - y0) if hi > lo else (y0 + y1) / 2
        want = min(max(want, y0 + 1), y1 - 1)
        assert rows.min() - 1 <= want <= rows.max() + 1, (col, want, rows)
    # Only white, black and the curve's colour.
    colours = {tuple(c) for c in img.reshape(-1, 3)}
    assert colours <= {(255, 255, 255), (0, 0, 0), tuple(loggers.CURVE_COLOR)}


def test_tree_loggers_write_the_active_voxels(tmp_path):
    rng = np.random.default_rng(7)
    lo = rng.uniform(-1, 1, (50, 3)).astype(np.float32)
    voxels = np.stack([lo, lo + 0.1], 1)
    active = rng.random(50) < 0.5
    writer = EventWriter(tmp_path)
    loggers.TreeLogger().tick(writer, 10, voxels, active)
    loggers.TreeWeightsLogger().tick(writer, 10, rng.random(50).astype(np.float32), active)
    loggers.TreeLogger().tick(None, 11, voxels, active)  # no writer: nothing
    writer.close()
    events = read_events(event_files(tmp_path)[0])[1:]
    assert [e["step"] for e in events] == [10, 10]
    verts = events[0]["summary"][0]["tensor"]
    assert verts["shape"] == [1, 8 * int(active.sum()), 3]
    np.testing.assert_array_equal(verts["float_val"].reshape(-1, 3),
                                  loggers.voxel_mesh(voxels[active])[0])
    image = events[1]["summary"][0]
    assert image["tag"] == "Tree Memm" and image["image"]["height"] == 480


def test_depth_projection_logger_fires_once_per_step_bucket(tmp_path):
    _, o, d, pred, target = _rays(8)
    writer = EventWriter(tmp_path)
    logger = loggers.DepthProjectionLogger(step_size=100)
    for step in (50, 100, 150, 199, 200, 250, 400):
        logger.tick(writer, step, o, d, pred, target)
    writer.close()
    events = read_events(event_files(tmp_path)[0])[1:]
    # The first tick always fires (the last step starts at -1), as in JAX's.
    assert [e["step"] for e in events] == [50, 100, 200, 400]
    colors = events[0]["summary"][1]["tensor"]["float_val"].reshape(-1, 3)
    assert colors.shape[0] == 2 * R
    assert (colors[:R] == [0, 0, 255]).all()  # the target cloud first, in blue
