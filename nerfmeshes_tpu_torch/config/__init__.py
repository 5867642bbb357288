"""Configs: the default schema, the CfgNode tree, YAML files and run
directories (counterpart of nerfmeshes_tpu/config/)."""

from nerfmeshes_tpu_torch.config.cfgnode import CfgNode, flatten_dict, nest_dict
from nerfmeshes_tpu_torch.config.schema import get_default_cfg, load_config

__all__ = ["CfgNode", "flatten_dict", "nest_dict", "get_default_cfg", "load_config"]
