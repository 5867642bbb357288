#!/usr/bin/env python3
"""Count the kernel records torch.profiler's traces keep in a process
while other processes come and go on the same CUDA card.

    python3 scripts/torch_trace_after_child.py [--children 3]

The process traces 7 calls of the chord kernel (1024 BuFF rays of
chip_smoke.py's initial tree, K = 64) after 2 untraced ones, then, per
child, starts a child process that runs 50 f32 matrix products
on the card and exits, and traces again with the host asleep 10 ms and
0.5 s at each end of the trace. Per trace it prints the kernel records,
the kernel launches the host recorded, the launches with no kernel record
(matched by correlation id), each kept kernel's start less its launch's
in microseconds, and the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from nerfmeshes_tpu_torch.ops.kernels import build  # noqa: E402
from nerfmeshes_tpu_torch.ops.kernels import chords as ch  # noqa: E402

CHILD = ("import torch; a = torch.randn(2048, 2048, device='cuda'); "
         "[a @ a for _ in range(50)]; torch.cuda.synchronize()")


def trace(fn, label: str, pad: float) -> None:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(pad)
        for _ in range(7):
            fn()
        torch.cuda.synchronize()
        time.sleep(pad)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    kernels = {e["args"].get("correlation"): e for e in events if e.get("cat") == "kernel"}
    launches = [e for e in events
                if e.get("cat") == "cuda_runtime" and "Launch" in e.get("name", "")]
    kept = [(kernels[c]["ts"] - e["ts"]) for e in launches
            if (c := e["args"].get("correlation")) in kernels]
    print(f"{label}, sleep {pad} s: {len(kernels)} kernel records, {len(launches)} launches, "
          f"{len(launches) - len(kept)} launches without a kernel record; kernel start - launch "
          "(us): " + ", ".join(f"{t:.0f}" for t in kept), flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--children", type=int, default=3)
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_trace_after_child.py needs a CUDA device")
    print(chip_smoke._run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"]).splitlines()[0])
    build.build_library()
    build.load_library()
    inputs = chip_smoke._chord_inputs(torch.device("cuda"))
    initial = inputs["initial"]
    o, d = inputs["o"][:1024].contiguous(), inputs["d"][:1024].contiguous()

    def chords():
        return ch.compact_chords_cuda(initial.voxels, initial.active, o, d, 2.0, 6.0, K=64)

    trace(chords, "before any child", 0.01)
    for i in range(opts.children):
        subprocess.run([sys.executable, "-c", CHILD], check=True)
        for pad in (0.01, 0.5):
            trace(chords, f"after child {i + 1}", pad)
    return 0


if __name__ == "__main__":
    sys.exit(main())
