#!/usr/bin/env python3
"""Library-call times of PERF.md section 6 that the smoke does not take at
these shapes, on the CUDA card, by chip_smoke.py's own phases:

- row 2, the fused backward at 2048 x 64 points, H 256 (lego's coarse
  call): kernel, plain and the library call (the nn.Module's forward and
  autograd backward under bf16 autocast), bwd_kernel_phase timed at the
  coarse shape;
- row 3, sigma at 262,144 points, H 128 (configs/hard-llff.yml's field):
  kernel, plain and the library call (the nn.Module under bf16 autocast),
  sigma_kernel_phase;
- row 2c, the fused backward's dW leg (dw_kernel + reduce_rows_kernel) at
  2048 x 128 points, H 128 (hard-llff.yml's fine call), with the other
  legs, torch.profiler device time by kernel name (fused_legs), beside
  torch.mm per product.

Each is taken READS times (each read itself a median of 7 calls, or the
profiler's mean over 7) and the median of the reads is printed beside the
card's name and power limit. Run it alone in its process (torch.profiler
loses kernel records in a process that outlived another's use of the
card):

    python3 scripts/torch_library_rows.py [--out build/library_rows.json]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
READS = 5


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path)
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_library_rows.py needs a CUDA card")
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from nerfmeshes_tpu_torch.ops.kernels import build

    card = smoke._run(["nvidia-smi", "--query-gpu=name,power.limit",
                       "--format=csv,noheader"]).splitlines()[0]
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_library()
    build.load_library()
    device = torch.device("cuda")

    # The traces first, in this fresh process.
    legs = [smoke.fused_legs(smoke.llff_cfg(), card, device) for _ in range(READS)]
    coarse = [smoke.bwd_kernel_phase(smoke._lego_bf16_cfg(), card, device, time_fine=False)
              for _ in range(READS)]
    sigma = [smoke.sigma_kernel_phase(smoke.llff_cfg(), card, device) for _ in range(READS)]

    def medians(rows, keys):
        return {k: statistics.median(r[k] for r in rows) for k in keys}

    result = {
        "card": card,
        "reads": READS,
        "bwd_2048x64_H256": dict(medians(coarse, ("ms", "plain_ms", "library_ms")),
                                 bound_ms=coarse[0]["bound_ms"], shape=coarse[0]["shape"],
                                 reads_ms=[r["ms"] for r in coarse],
                                 reads_library_ms=[r["library_ms"] for r in coarse]),
        "sigma_262144_H128": dict(medians(sigma, ("ms", "plain_ms", "library_ms")),
                                  bound_ms=sigma[0]["bound_ms"],
                                  reads_ms=[r["ms"] for r in sigma],
                                  reads_library_ms=[r["library_ms"] for r in sigma]),
        "bwd_legs_2048x128_H128": {
            leg: dict(ms=statistics.median(r[leg]["ms"] for r in legs),
                      reads_ms=[r[leg]["ms"] for r in legs],
                      bound_ms=legs[0][leg]["bound_ms"], bound_by=legs[0][leg]["bound_by"],
                      library_ms=(None if legs[0][leg]["library_ms"] is None else
                                  statistics.median(r[leg]["library_ms"] for r in legs)))
            for leg in legs[0]},
    }
    line = json.dumps(result)
    print(line)
    if opts.out:
        opts.out.parent.mkdir(parents=True, exist_ok=True)
        opts.out.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
