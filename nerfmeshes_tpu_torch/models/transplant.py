"""Carry JAX-package weights into the port.

flax names a module's submodules `{ClassName}_{i}`, counting each class
in the order the module creates them, and lays a dense kernel out (in,
out). The port's models register their submodules in that same order,
under the flax classes' names, and lay weights out (out, in) as torch
does. So the flax path of every port parameter follows from the module
tree alone: each child's name is its class's name and its rank among the
siblings of that class (ModuleLists flattened), a `weight` is flax's
transposed `kernel`, and any other leaf keeps its name. For the
FlexibleNeRFModel this is nerfmeshes_tpu/cli/import_checkpoint.py's
`TorchLinear_{i}` order.

FastRotPos's B is no flax parameter: JAX derives it from
jax.random.PRNGKey(0) at every call. The port keeps it as a buffer, and
`state_dict_from_flax` takes JAX's B as an explicit input.
"""

from __future__ import annotations

from collections import Counter
from typing import Iterator, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn

from nerfmeshes_tpu_torch.models.layers import FastRotPos
from nerfmeshes_tpu_torch.models.nerf_models import build_model


def _children(module: nn.Module, prefix: str) -> Iterator[tuple[str, nn.Module]]:
    """(state-dict prefix, child) in registration order, ModuleLists and
    Sequentials flattened."""
    for name, child in module.named_children():
        if isinstance(child, (nn.ModuleList, nn.Sequential)):
            yield from _children(child, f"{prefix}{name}.")
        else:
            yield f"{prefix}{name}.", child


def flax_paths(module: nn.Module, prefix: str = "") -> dict:
    """{flax path (tuple of names): (state-dict key, transposed)} of every
    parameter of `module`, and of FastRotPos's B buffer (flax path ending
    in "b", under the FastRotPos_{i} that holds no flax parameter)."""
    out = {}
    for name, _ in module.named_parameters(recurse=False):
        leaf = "kernel" if name == "weight" else name
        out[(leaf,)] = (prefix + name, name == "weight")
    if isinstance(module, FastRotPos):
        out[("b",)] = (prefix + "b", False)
    seen = Counter()
    for child_prefix, child in _children(module, prefix):
        cls = type(child).__name__
        flax_name = f"{cls}_{seen[cls]}"
        seen[cls] += 1
        for path, target in flax_paths(child, child_prefix).items():
            out[(flax_name, *path)] = target
    return out


def _flatten(tree: Mapping, path: tuple = ()) -> dict:
    out = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            out.update(_flatten(value, (*path, key)))
        else:
            out[(*path, key)] = value
    return out


def state_dict_from_flax(params_np: Mapping, model_cfg: Mapping,
                         type_name: str = "FlexibleNeRFModel", *,
                         fastrot_b: Optional[np.ndarray] = None) -> dict:
    """flax params (`{"params": {...}}` or the inner tree, numpy arrays)
    -> the state dict of the port model that `type_name` and `model_cfg`
    (a `cfg.models.coarse`/`fine` node) build. A model with a FastRotPos
    needs `fastrot_b`, JAX's B for it ((3, num_encoding_fn_xyz) f32).

    Every shape is checked against that model; a mismatch, a missing leaf
    or an extra one raises ValueError."""
    model = build_model(type_name, model_cfg, device=torch.device("meta"))
    return module_state_from_flax(model, params_np, fastrot_b=fastrot_b, what=type_name)


def module_state_from_flax(module: nn.Module, params_np: Mapping, *,
                           fastrot_b: Optional[np.ndarray] = None,
                           what: Optional[str] = None) -> dict:
    """The state dict of `module` (any port model or layer; a meta-device
    one will do) from its flax counterpart's params, as
    state_dict_from_flax."""
    what = what or type(module).__name__
    p = params_np["params"] if "params" in params_np else params_np
    paths = flax_paths(module)
    params = dict(module.named_parameters())
    leaves = _flatten(p)
    if any(key not in params for key, _ in paths.values()):
        if fastrot_b is None:
            raise ValueError(f"{what} holds FastRotPos's B, which flax does not store: "
                             "pass JAX's B as fastrot_b")
        for path, (key, _) in paths.items():
            if key not in params:
                leaves[path] = fastrot_b
    if set(leaves) != set(paths):
        missing = sorted("/".join(k) for k in set(paths) - set(leaves))
        extra = sorted("/".join(k) for k in set(leaves) - set(paths))
        raise ValueError(f"flax param tree does not match the {what} layout: "
                         f"missing {missing}, extra {extra}")
    target = module.state_dict()
    sd = {}
    for path, (key, transposed) in paths.items():
        value = np.asarray(leaves[path], dtype=np.float32)
        if transposed:
            value = value.T
        want = tuple(target[key].shape)
        if value.shape != want:
            raise ValueError(
                f"{key}: flax {'/'.join(path)} gives shape {value.shape}, the model expects "
                f"{want} (hidden_size/num_layers/encoding dims)")
        sd[key] = torch.tensor(value)  # a copy: flax leaves may be read-only
    return sd
