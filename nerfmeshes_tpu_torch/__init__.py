"""nerfmeshes_tpu_torch — the PyTorch + CUDA port of nerfmeshes_tpu.

The JAX package (`nerfmeshes_tpu`) is the reference: every module here
mirrors the module of the same path there and is held against it by the
`tests/test_torch_*.py` suite. Each Pallas kernel of the JAX package
becomes a kernel written by hand for Hopper under `csrc/`, built with
nvcc on first use (`ops/kernels/build.py`).

This package imports torch and numpy, and nothing of the JAX package (nor
PyYAML): `config/` carries the JAX schema's defaults and reads the YAML
configs and run directories itself.
"""

__version__ = "0.1.0"
