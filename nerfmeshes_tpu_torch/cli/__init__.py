"""Command-line entry points: train_nerf, eval_nerf and mesh_nerf
(counterparts of nerfmeshes_tpu/cli/). Each runs on the CUDA card unless
given `--device cpu`."""
