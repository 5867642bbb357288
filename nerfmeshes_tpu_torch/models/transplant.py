"""Carry JAX-package weights into the port.

The flax FlexibleNeRFModel names its dense layers `TorchLinear_{i}` in
call order, with kernels laid out (in, out); the port names them as the
reference does and lays weights out (out, in). The name order is
nerfmeshes_tpu/cli/import_checkpoint.py:_torch_linear_order.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from nerfmeshes_tpu_torch.models.nerf_models import build_model


def linear_names(num_layers: int, use_viewdirs: bool) -> list[str]:
    """Reference FlexibleNeRFModel submodule names in call order."""
    names = ["layer1"] + [f"layers_xyz.{i}" for i in range(num_layers - 1)]
    if use_viewdirs:
        names += ["fc_feat", "fc_alpha", "layers_dir.0", "fc_rgb"]
    else:
        names += ["fc_out"]
    return names


def state_dict_from_flax(params_np: Mapping, model_cfg: Mapping) -> dict:
    """flax `{"params": {"TorchLinear_i": {"kernel", "bias"}}}` (numpy
    arrays) -> the state dict of the port FlexibleNeRFModel that
    `model_cfg` (a `cfg.models.coarse`/`fine` node) builds.

    Every shape is checked against that model; a mismatch, a missing layer
    or an extra one raises ValueError."""
    model = build_model("FlexibleNeRFModel", model_cfg, device=torch.device("meta"))
    p = params_np["params"] if "params" in params_np else params_np
    names = linear_names(model.num_layers, model.use_viewdirs)
    expected = {f"TorchLinear_{i}" for i in range(len(names))}
    if set(p) != expected:
        raise ValueError(
            f"flax param tree {sorted(p)} does not match the FlexibleNeRFModel "
            f"layout {sorted(expected)}"
        )
    target = model.state_dict()
    sd = {}
    for i, name in enumerate(names):
        leaf = p[f"TorchLinear_{i}"]
        weight = np.asarray(leaf["kernel"], dtype=np.float32).T
        bias = np.asarray(leaf["bias"], dtype=np.float32)
        for key, value in ((f"{name}.weight", weight), (f"{name}.bias", bias)):
            want = tuple(target[key].shape)
            if value.shape != want:
                raise ValueError(
                    f"{key}: flax TorchLinear_{i} gives shape {value.shape}, the "
                    f"model expects {want} (hidden_size/num_layers/encoding dims)"
                )
            sd[key] = torch.tensor(value)  # a copy: flax leaves may be read-only
    return sd
