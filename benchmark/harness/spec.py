"""Cells by name. BENCHMARK.json's workloads pair a configuration
(configs/<file>) with a traffic mix (traffic/<traffic>.json); each cell
has its limits (limits/<cell>.json), and each per-layer metric a reader
(metrics/<metric>.py). A new cell, configuration or metric is new files
and entries: nothing here names one."""

from __future__ import annotations

import copy
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration's file
    traffic: dict  # the traffic mix's file
    limits: dict  # compared number -> limit
    end_to_end: list  # BENCHMARK.json's entries that this cell reports
    per_layer: list

    @property
    def kind(self) -> str:
        return self.traffic["kind"]


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _by_name(entries: list, name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise ValueError(f"no {what} named {name!r} in BENCHMARK.json "
                     f"(there are: {', '.join(e['name'] for e in entries)})")


def load_cell(name: str, root: Path = ROOT, bench_dir: Path = BENCH_DIR) -> Cell:
    bench = load_benchmark(root)
    work = _by_name(bench["workloads"], name, "workload")
    conf = _by_name(bench["configs"], work["config"], "configuration")
    end_to_end = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in end_to_end}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return Cell(
        name=name,
        chips=int(work["chips"]),
        config=json.loads((root / conf["file"]).read_text()),
        traffic=json.loads((bench_dir / "traffic" / f"{work['traffic']}.json").read_text()),
        limits=json.loads((bench_dir / "limits" / f"{name}.json").read_text()),
        end_to_end=end_to_end,
        per_layer=per_layer,
    )


def merged(base: dict, over: dict) -> dict:
    """`base` with `over`'s leaves written over it, nested dicts merged."""
    out = copy.deepcopy(base)
    for key, value in over.items():
        if isinstance(value, dict) and isinstance(out.get(key), dict):
            out[key] = merged(out[key], value)
        else:
            out[key] = copy.deepcopy(value)
    return out


def program_cfg(cell: Cell, seed: int) -> dict:
    """The config the program runs, as nested dicts: the configuration's,
    under the traffic mix's settings (batch, steps a call), seeded by the
    run, with validation, checkpoints and the early-stopping check off."""
    cfg = merged(cell.config["cfg"], cell.traffic.get("cfg", {}))
    return merged(cfg, {"experiment": {"randomseed": int(seed), "validate_every": 0,
                                       "use_early_stopping": False}})


def load_reader(metric: str, bench_dir: Path = BENCH_DIR):
    """The module metrics/<metric>.py (its `read(ctx)` returns the metric,
    or None where the trace holds nothing for it)."""
    path = bench_dir / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{metric.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
