"""Tests of the benchmark's harness, on the CPU at tiny sizes (the card's
runs are benchmark/run.py's). Cells are shrunk here, never in their files."""

import sys
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parent
for path in (str(BENCH_DIR.parent), str(BENCH_DIR)):
    if path not in sys.path:
        sys.path.insert(0, path)


def tiny_cell(name: str, compute_dtype: str = "bfloat16"):
    """Cell `name` of BENCHMARK.json at a size the CPU runs in seconds: its
    fields 8 x 128 (the fused kernels' plain versions take 128 and up),
    8 + 8 samples, 12 x 16 views, 64 rays a step, chunks of 64."""
    from harness import spec

    cell = spec.load_cell(name)
    cfg = cell.config["cfg"]
    cfg["experiment"]["compute_dtype"] = compute_dtype
    for field in ("coarse", "fine"):
        cfg["models"][field]["hidden_size"] = 128
    for mode in ("train", "validation"):
        cfg["nerf"][mode]["num_coarse"] = 8
        cfg["nerf"][mode]["num_fine"] = 8
    scene = cell.config["scene"]
    scene.update(height=12, width=16, train_views=3, test_views=4)
    if "focal" in scene:
        scene["focal"] = 14.0
    if cell.kind == "train":
        cell.traffic["cfg"]["nerf"]["train"]["num_random_rays"] = 64
        cell.traffic["cfg"]["experiment"]["steps_per_call"] = 4
    else:
        cell.traffic["chunk"] = 64
        cell.traffic["check_rays"] = 256
    return cell


@pytest.fixture
def tiny():
    return tiny_cell
