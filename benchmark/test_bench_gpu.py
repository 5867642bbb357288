"""One short run of each cell kind on a CUDA card: the result line and
the checks on standard error as the benchmark's contract has them."""

import json
import subprocess
import sys

import pytest

from conftest import BENCH_DIR


@pytest.mark.gpu
@pytest.mark.parametrize("name,trace", [("llff.render", 1), ("llff.train", 0)])
def test_a_short_run_on_the_card(name, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", name, "--seed",
                          str(2**31 + 77), "--seconds", "4", "--trace", str(trace)],
                         cwd=BENCH_DIR.parent, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "checks"
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
        assert "fwd_roofline.render" in result["metrics"]
