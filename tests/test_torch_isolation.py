"""The port stands apart from JAX, and has no CPU fallback for the card.

- Importing every module of nerfmeshes_tpu_torch loads no jax (nor flax,
  optax, orbax) in a fresh interpreter.
- chip_smoke.py on a host without a CUDA card exits non-zero and prints
  no "ok" line.
"""

import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import nerfmeshes_tpu_torch

REPO = Path(__file__).resolve().parents[1]

torch.set_num_threads(1)


def test_every_port_module_imports_without_jax():
    modules = sorted(
        m.name for m in pkgutil.walk_packages(nerfmeshes_tpu_torch.__path__,
                                              "nerfmeshes_tpu_torch.")
    )
    assert "nerfmeshes_tpu_torch.ops.kernels.fused_mlp" in modules
    assert {"nerfmeshes_tpu_torch.mesh.extract", "nerfmeshes_tpu_torch.mesh.native"} <= set(modules)
    code = (
        "import importlib, sys\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in ('jax', 'flax', 'optax', 'orbax') if m in sys.modules)\n"
        "assert not bad, bad\n"
        "print('imported', len(sys.modules))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "imported" in proc.stdout


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card; chip_smoke.py would run")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "CUDA" in proc.stderr
