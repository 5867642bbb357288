"""Run one cell of BENCHMARK.json on this machine's CUDA card(s).

    python3 benchmark/run.py --workload lego.train --seed 7 --seconds 40 --trace 0

Prints the result as the last line of standard output (one JSON object:
correct, attempted, failed, metrics, device, with --trace 1 breakdown,
and last the checks, each number compared with its limit) and the checks
as the last lines of standard error. Exits non-zero, printing no result,
without enough CUDA cards, when the program cannot be imported, or when
a module of JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    # The program's kernel library builds into <checkout>/build/; nothing
    # of the run lives outside the checkout, HOME, XDG_CACHE_HOME and TMPDIR.
    os.chdir(ROOT)
    for path in (str(ROOT), str(BENCH_DIR)):
        if path not in sys.path:
            sys.path.insert(0, path)
    from harness import runner, spec

    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA card(s); this machine has {found}",
              file=sys.stderr)
        return 2
    from harness.flops import power_limit

    card = power_limit()
    result, lines = runner.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                    device="cuda:0", cell=cell)
    banned = runner.banned_modules()
    if banned:
        print(f"modules of JAX or the JAX package were loaded: {', '.join(banned)}",
              file=sys.stderr)
        return 3
    result["device"]["power_limit"] = card
    print(json.dumps(result), flush=True)
    print(f"card: {card}", file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
