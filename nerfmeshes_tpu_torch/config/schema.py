"""The default experiment config and YAML loading (counterpart of
nerfmeshes_tpu/config/schema.py).

The same keys and values as the JAX schema, which
tests/test_torch_config.py holds it to; `load_config` merges an
experiment YAML onto them through the port's own CfgNode and YAML reader,
so neither PyYAML nor the JAX package is needed (the GPU host has
neither).
"""

from __future__ import annotations

from nerfmeshes_tpu_torch.config.cfgnode import CfgNode


def _mlp_defaults() -> dict:
    return {
        "num_layers": 8,
        "skip_step": 4,
        "encoding": "positional",
        "num_layers_view": -1,
        "hidden_size": 256,
        "include_input_xyz": True,
        "log_sampling_xyz": True,
        "num_encoding_fn_xyz": 10,
        "include_input_dir": True,
        "num_encoding_fn_dir": 4,
        "log_sampling_dir": True,
        "use_viewdirs": True,
        "luminance_function": "min1",
    }


def _nerf_mode_defaults(train: bool) -> dict:
    d = {
        "chunksize": 2048,
        "perturb": False,
        "num_coarse": 64,
        "num_fine": 128,
        "radiance_field_noise_std": 0.2 if train else 0.0,
        "lindisp": False,
    }
    if train:
        d["num_random_rays"] = 2048
        d["sample_all_images"] = False
    else:
        d["num_samples"] = 1
        d["fixed_views"] = False
    return d


def get_default_cfg() -> CfgNode:
    """The JAX package's default config, key for key."""
    return CfgNode({
        "experiment": {
            "id": "experiment",
            "model": "NeRFModel",
            "description": "",
            "logdir": "../logs",
            "randomseed": 42,
            "train_iters": 250000,
            "validate_every": 5000,
            "print_every": 100,
            "meshdir": "../data/meshes",
            "use_early_stopping": False,
            "early_stopping_step": 25,
            "chamfer_loss": False,
            "chamfer_sampling_size": 2400,
            "compute_dtype": "bfloat16",
            "steps_per_call": 10,
            "use_fused_kernel": True,
        },
        "logging": {
            "use_acronyms": True,
            "use_projection": True,
            "projection_step_size": 5000,
        },
        "tree": {
            "subdivision_outer_count": 12,
            "subdivision_inner_count": 2,
            "max_depth": 4,
            "eps": 0.0001,
            "use_random_sampling": False,
            "max_voxel_count": 1536,
            "step_size_integration_offset": 6000,
            "step_size_tree": 6000,
            "max_chords_per_ray": 0,
            "max_chord_cap": 256,
        },
        "dataset": {
            "type": "blender",
            "basedir": "../data/nerf_synthetic/lego",
            "reduced_resolution": 1,
            "testskip": 1,
            "use_ndc": False,
            "near": 2.0,
            "far": 6.0,
            "empty": 0.0,
            "num_workers": 6,
            "llff_downsample_factor": 8,
            "llff_hold_step": 8,
            "white_background": False,
            "spherify": True,
            "scene": "blobs",
            "synthetic": {
                "num_images": 8,
                "image_size": 32,
                "gt_samples": 256,
                "keep_on_device": False,
                "with_depth": False,
            },
            "caching": {
                "use_caching": False,
                "override_caching": False,
                "cache_dir": "../cache/cache",
                "num_variations": 4,
                "sample_all": True,
            },
        },
        "models": {
            "coarse_type": "FlexibleNeRFModel",
            "coarse": _mlp_defaults(),
            "fine_type": "FlexibleNeRFModel",
            "use_fine": True,
            "fine": _mlp_defaults(),
        },
        "optimizer": {
            "type": "Adam",
            "lr": 5.0e-3,
            "accumulate_steps": 1,
        },
        "scheduler": {
            "type": "DefaultScheduler",
            "options": {
                "gamma": 0.1,
                "step_size": 450000,
            },
        },
        "nerf": {
            "use_viewdirs": True,
            "encode_position_fn": "positional_encoding",
            "encode_direction_fn": "positional_encoding",
            "train": _nerf_mode_defaults(train=True),
            "validation": _nerf_mode_defaults(train=False),
        },
    })


def load_config(path: str, overrides: list | None = None) -> CfgNode:
    """Load an experiment YAML on top of the default schema."""
    cfg = get_default_cfg()
    cfg.merge_from_file(path)
    if overrides:
        cfg.merge_from_list(overrides)
    return cfg
