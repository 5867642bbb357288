"""No run loads JAX, flax or the JAX package, compared by whole top-level
name; the reference loads nothing of the program."""

import subprocess
import sys

from harness.runner import banned_modules

from conftest import BENCH_DIR


def test_banned_names_compare_the_whole_top_level_name():
    loaded = ["nerfmeshes_tpu_torch", "nerfmeshes_tpu_torch.ops.math", "jaxtyping", "flaxen",
              "jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "nerfmeshes_tpu",
              "nerfmeshes_tpu.ops.pallas"]
    assert banned_modules(loaded) == ["flax.linen", "jax", "jax.numpy", "jaxlib.xla_client",
                                      "nerfmeshes_tpu", "nerfmeshes_tpu.ops.pallas"]


def _run(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH_DIR.parent, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_a_run_loads_nothing_of_jax():
    code = (
        "import sys; sys.path[:0] = ['.', 'benchmark']\n"
        "from conftest import tiny_cell\n"
        "from harness import runner\n"
        "for name in ('lego.train', 'llff.render'):\n"
        "    runner.run_cell(name, 2**31 + 5, 0.2, False, device='cpu', cell=tiny_cell(name))\n"
        "assert 'nerfmeshes_tpu_torch' in sys.modules\n"
        "print(runner.banned_modules())\n")
    assert _run(code) == "[]"


def test_the_reference_loads_nothing_of_the_program():
    code = (
        "import sys; sys.path[:0] = ['.', 'benchmark']\n"
        "from harness import reference, scene, flops, devtrace, readers, spec, window\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}"
        " & {'nerfmeshes_tpu_torch', 'nerfmeshes_tpu', 'jax', 'jaxlib', 'flax'}))\n")
    assert _run(code) == "[]"
