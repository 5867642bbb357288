"""BENCHMARK.json holds to the benchmark's contract, every cell finds its
files by name, and a new cell is new files and entries only."""

import hashlib
import json
import re
import shutil

import pytest
from harness import spec

from conftest import BENCH_DIR

ROOT = BENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def one_line(text, most=200):
    return isinstance(text, str) and 1 <= len(text) <= most and not set(text) & set("\t\n\r")


def test_benchmark_json_keeps_to_the_contract():
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    bench = spec.load_benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"] and 1 <= bench["run_seconds"] <= 51
    assert 1 <= len(bench["command"]) <= 32 and all(one_line(w) for w in bench["command"])
    metrics = bench["end_to_end"] + bench["per_layer"]
    names = [e["name"] for e in bench["configs"] + bench["workloads"] + metrics]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in metrics)
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in bench["end_to_end"])
    assert all(0.01 <= m["bound"] <= 0.25 for m in bench["end_to_end"])
    metric_keys = {"name", "unit", "better", "source"}
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == metric_keys | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == metric_keys | {"layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert one_line(m["layer"])
    cells = {w["name"] for w in bench["workloads"]}
    for m in metrics:
        assert set(m.get("workloads", cells)) <= cells
    assert 1 <= len(bench["configs"]) <= 24 and 1 <= len(bench["workloads"]) <= 24
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
        assert one_line(c["source"]) and one_line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in bench["workloads"])
    assert len({c["file"] for c in bench["configs"]}) == len(bench["configs"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and one_line(w["why"]) and NAME.match(w["traffic"])
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("name", [w["name"] for w in spec.load_benchmark()["workloads"]])
def test_every_cell_finds_its_files(name):
    cell = spec.load_cell(name)
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"} and len(cell.end_to_end) >= 2
    assert cell.per_layer and cell.limits
    reported = {m["name"] for m in cell.end_to_end}
    for entry in cell.per_layer:
        assert entry["moves"] in reported
        assert callable(spec.load_reader(entry["name"]).read)
    assert (BENCH_DIR / f"harness/kind_{cell.kind}.py").is_file()


def digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_cell_is_new_files_and_entries(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = digest(root / "benchmark")
    bench_dir = root / "benchmark"

    config = json.loads((bench_dir / "configs/nerf-llff-8x128.json").read_text())
    config["name"] = "nerf-llff-8x256"
    for field in ("coarse", "fine"):
        config["cfg"]["models"][field]["hidden_size"] = 256
    (bench_dir / "configs/nerf-llff-8x256.json").write_text(json.dumps(config))
    (bench_dir / "traffic/train-8192.json").write_text(json.dumps(
        {"kind": "train", "cfg": {"nerf": {"train": {"num_random_rays": 8192}}}}))
    (bench_dir / "limits/llff256.train.json").write_text(json.dumps({"coarse_median_gap": 0.002}))
    (bench_dir / "metrics/sort_ms.train.py").write_text(
        "from harness.readers import device_seconds, per_unit_ms\n"
        "KERNELS = ('radixSortKVInPlace',)\n"
        "def read(ctx):\n"
        "    return per_unit_ms(ctx, device_seconds(ctx, KERNELS))\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "nerf-llff-8x256", "source": "a paper",
                             "file": "benchmark/configs/nerf-llff-8x256.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "llff256.train", "config": "nerf-llff-8x256",
                               "traffic": "train-8192", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_rays_per_s":
            m["workloads"].append("llff256.train")
    bench["per_layer"].append({"name": "sort_ms.train", "unit": "ms", "better": "lower",
                               "source": "device_trace", "layer": "torch ops",
                               "moves": "train_rays_per_s", "workloads": ["llff256.train"]})
    # Without a `workloads` key a metric is every cell's that reports what it moves.
    bench["per_layer"].append({"name": "sort_share.train", "unit": "%", "better": "lower",
                               "source": "device_trace", "layer": "torch ops",
                               "moves": "train_rays_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.load_cell("llff256.train", root=root, bench_dir=bench_dir)
    assert cell.config["cfg"]["models"]["fine"]["hidden_size"] == 256
    assert spec.program_cfg(cell, 3)["nerf"]["train"]["num_random_rays"] == 8192
    assert [m["name"] for m in cell.per_layer] == ["sort_ms.train", "sort_share.train"]
    for name in ("lego.train", "llff.train"):
        got = spec.load_cell(name, root=root, bench_dir=bench_dir).per_layer
        assert "sort_share.train" in [m["name"] for m in got]
    got = spec.load_cell("lego.render", root=root, bench_dir=bench_dir).per_layer
    assert "sort_share.train" not in [m["name"] for m in got]
    assert callable(spec.load_reader("sort_ms.train", bench_dir=bench_dir).read)
    after = digest(bench_dir)
    assert all(after[p] == h for p, h in before.items())
