#!/usr/bin/env python3
"""Count the launches of the chord kernel that torch.profiler's trace
holds, on one CUDA card.

    python3 scripts/torch_trace_probe.py TREE [--trials 4] [--padded-first]

TREE is the root of a checkout of this repository; its chords.cu is built
alone as scripts/torch_chords_ab.py builds it. Each trial traces 7 calls
at 2048 x 4096 x 64 (chip_smoke.py's train read) in a profiler session of
its own, after 2 untraced calls, in one of two ways: "bare", the calls
then a synchronisation (as chip_smoke.py traced the chord kernel up to
its parent commit), or "padded", with the host asleep for 10 ms before
the calls and after the synchronisation. Per trial it prints the kernel
events of every name the trace holds, the CUDA launch events the host
side recorded, and, where both are there, the kernel events' start
against their launches' (matched by correlation id) and against the
span of the calls (a record_function around them), in microseconds.
Trials run "bare" first unless --padded-first.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile, record_function

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

import chip_smoke  # noqa: E402
import torch_chords_ab  # noqa: E402

RUNS = 7


def trace(fn, padded: bool) -> list:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        if padded:
            time.sleep(0.01)
        with record_function("probe_calls"):
            for _ in range(RUNS):
                fn()
            torch.cuda.synchronize()
        if padded:
            time.sleep(0.01)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        return json.loads(path.read_text())["traceEvents"]


def summary(events: list) -> str:
    kernels = [e for e in events if e.get("cat") == "kernel"]
    launches = [e for e in events if e.get("cat") == "cuda_runtime" and "Launch" in e["name"]]
    span = [e for e in events if e.get("name") == "probe_calls" and e.get("ph") == "X"]
    names = Counter(("chords_kernel" if "chords_kernel" in e["name"] else e["name"][:40])
                    for e in kernels)
    text = f"kernels {dict(names)}; launch events {len(launches)}"
    by_corr = {e["args"].get("correlation"): e for e in launches if "args" in e}
    lags = [k["ts"] - by_corr[k["args"]["correlation"]]["ts"] for k in kernels
            if k.get("args", {}).get("correlation") in by_corr]
    if lags:
        text += f"; kernel start - launch {min(lags):.1f} .. {max(lags):.1f} us"
    if span and kernels:
        s0, s1 = span[0]["ts"], span[0]["ts"] + span[0]["dur"]
        starts = [k["ts"] for k in kernels]
        text += (f"; kernels start {min(starts) - s0:.1f} .. {max(starts) - s0:.1f} us into "
                 f"the calls' span of {s1 - s0:.1f} us")
    return text


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("tree", type=Path, help="checkout root whose chords.cu is traced")
    parser.add_argument("--trials", type=int, default=4, help="trials of each way")
    parser.add_argument("--padded-first", action="store_true", help="run the padded trials first")
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_trace_probe.py needs a CUDA device")
    root = opts.tree.resolve()
    run = torch_chords_ab.launcher(torch_chords_ab.compile_tree(root))
    cases = chip_smoke.chord_timed_cases(chip_smoke._chord_inputs(torch.device("cuda")))
    args = cases["train"]
    ways = [False, True] if not opts.padded_first else [True, False]
    for padded in ways:
        for trial in range(opts.trials):
            events = trace(lambda: run(*args), padded)
            print(f"{root.name} {'padded' if padded else 'bare'} trial {trial}: {summary(events)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
