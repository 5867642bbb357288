"""The control: the reference put in the program's place and computed in
fp8, the nearest precision below the configurations' bfloat16, fails a
number of each cell (calibrate.py reads it on the card at each cell's own
size; here at a tiny size)."""

import calibrate
import numpy as np
import pytest
from harness import kind_render, kind_train, reference, scene, spec


def failed(cell, numbers: dict) -> list:
    return [k for k, limit in cell.limits.items() if not numbers[k] <= limit]


@pytest.mark.parametrize("name", ["lego.train", "llff.train"])
def test_the_control_fails_a_training_cell(tiny, name):
    cell = tiny(name)
    seed = 2**31 + 101
    cfg = spec.program_cfg(cell, seed)
    data = scene.train_data(cell.config["scene"], seed, "cpu")
    weights = scene.initial_weights(cfg["models"], seed, "cpu")
    draws = calibrate.control_draws(cfg, data, seed, "cpu")
    low = reference.train_steps(weights, cfg, data, draws, precision="fp8")
    got = kind_train.readings(cfg, weights, data, draws, low.losses, low.first_maps,
                              low.first_grads, low.params)
    assert failed(cell, got)


@pytest.mark.parametrize("name", ["lego.render", "llff.render"])
def test_the_control_fails_a_render_cell(tiny, name):
    cell = tiny(name)
    seed = 2**31 + 102
    cfg = spec.program_cfg(cell, seed)
    sc = cell.config["scene"]
    near, far = (float(v) for v in sc["bounds"])
    views = scene.view_rays(sc, scene.view_poses(sc, seed, "cpu"), bool(cfg["dataset"]["use_ndc"]))
    weights = scene.initial_weights(cfg["models"], seed, "cpu")
    ids = np.repeat(np.arange(len(views)), 64)
    pix = np.tile(np.arange(64) * 3, len(views))
    low = kind_render.reference_rgb(cfg, weights, views, ids, pix, near, far, precision="fp8")
    ref = kind_render.reference_rgb(cfg, weights, views, ids, pix, near, far)
    assert failed(cell, kind_render.gaps(low, ref))
