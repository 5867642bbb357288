"""The port stands apart from JAX, and has no CPU fallback for the card.

- Importing every module of nerfmeshes_tpu_torch, the CLIs included, loads
  no jax (nor flax, optax, orbax), no PyYAML, no tensorboard, no
  matplotlib, none of PIL, cv2 and imageio (the GPU host has none of them:
  the image codecs are the port's own) and nothing of the JAX package in a
  fresh interpreter. (torch itself imports tqdm where it is installed.)
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
    assert {"nerfmeshes_tpu_torch.buff.tree", "nerfmeshes_tpu_torch.buff.system",
            "nerfmeshes_tpu_torch.ops.kernels.chords", "nerfmeshes_tpu_torch.train.factory",
            "nerfmeshes_tpu_torch.device"} <= set(modules)
    assert {"nerfmeshes_tpu_torch.config.cfgnode", "nerfmeshes_tpu_torch.config.yaml_lite",
            "nerfmeshes_tpu_torch.config.schema", "nerfmeshes_tpu_torch.config.paths",
            "nerfmeshes_tpu_torch.train.checkpoint", "nerfmeshes_tpu_torch.utils.logging",
            "nerfmeshes_tpu_torch.data.helpers", "nerfmeshes_tpu_torch.data.bundle",
            "nerfmeshes_tpu_torch.data.datasets", "nerfmeshes_tpu_torch.data.synthetic",
            "nerfmeshes_tpu_torch.cli.train_nerf", "nerfmeshes_tpu_torch.cli.eval_nerf",
            "nerfmeshes_tpu_torch.cli.mesh_nerf"} <= set(modules)
    assert {"nerfmeshes_tpu_torch.data.loaders", "nerfmeshes_tpu_torch.data.loaders.llff",
            "nerfmeshes_tpu_torch.data.loaders.colmap", "nerfmeshes_tpu_torch.data.colmap_dataset",
            "nerfmeshes_tpu_torch.cli.colmap_convert", "nerfmeshes_tpu_torch.cli.surface_ray",
            "nerfmeshes_tpu_torch.mesh.surface_ray"} <= set(modules)
    assert {"nerfmeshes_tpu_torch.data.jpeg", "nerfmeshes_tpu_torch.data.loaders.scannet",
            "nerfmeshes_tpu_torch.data.scannet_dataset"} <= set(modules)
    assert {"nerfmeshes_tpu_torch.models.layers", "nerfmeshes_tpu_torch.models.nerf_models",
            "nerfmeshes_tpu_torch.models.transplant", "nerfmeshes_tpu_torch.train.optim",
            "nerfmeshes_tpu_torch.train.render", "nerfmeshes_tpu_torch.buff.tree"} <= set(modules)
    assert {"nerfmeshes_tpu_torch.utils.tb_events", "nerfmeshes_tpu_torch.utils.loggers",
            "nerfmeshes_tpu_torch.cli.import_checkpoint",
            "nerfmeshes_tpu_torch.ops.depth_sampling"} <= set(modules)
    assert {"nerfmeshes_tpu_torch.utils.images", "nerfmeshes_tpu_torch.data.gif",
            "nerfmeshes_tpu_torch.utils.gxx"} <= set(modules)
    code = (
        "import importlib, sys\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in ('jax', 'flax', 'optax', 'orbax', 'yaml', 'nerfmeshes_tpu',\n"
        "                         'tensorboard', 'matplotlib', 'PIL', 'cv2', 'imageio')\n"
        "             if m in sys.modules)\n"
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
