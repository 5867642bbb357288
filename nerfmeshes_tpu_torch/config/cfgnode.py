"""Attribute-access config tree with YAML IO, merging and freezing
(counterpart of nerfmeshes_tpu/config/cfgnode.py).

The same nested dict with attribute access, freeze/defrost, load/dump,
merge_from_file / merge_from_other_cfg / merge_from_list, the
deprecated/renamed key registry and the type coercion on merge, with the
same errors. YAML goes through config/yaml_lite.py (the GPU host has no
PyYAML), which resolves every scalar as yaml.safe_load does.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List

from nerfmeshes_tpu_torch.config import yaml_lite

# Leaf types a config value may take.
_LEAF_TYPES = (bool, int, float, str, list, tuple, type(None))

_IMMUTABLE = "__cfg_frozen__"
_DEPRECATED = "__cfg_deprecated_keys__"
_RENAMED = "__cfg_renamed_keys__"
_NEW_ALLOWED = "__cfg_new_allowed__"


class CfgNode(dict):
    """A nested configuration node: a dict whose items are also attributes.

    >>> cfg = CfgNode({"a": {"b": 1}})
    >>> cfg.a.b
    1
    """

    def __init__(self, init_dict: Dict | None = None, new_allowed: bool = False):
        init_dict = {} if init_dict is None else init_dict
        super().__init__(self._convert(init_dict))
        self.__dict__[_IMMUTABLE] = False
        self.__dict__[_DEPRECATED] = set()
        self.__dict__[_RENAMED] = {}
        self.__dict__[_NEW_ALLOWED] = new_allowed

    @classmethod
    def _convert(cls, d: Dict) -> Dict:
        out = {}
        for k, v in d.items():
            if isinstance(v, dict) and not isinstance(v, CfgNode):
                out[k] = cls(v)
            else:
                cls._check_leaf(k, v)
                out[k] = v
        return out

    @staticmethod
    def _check_leaf(key, value):
        if isinstance(value, (CfgNode, *_LEAF_TYPES)):
            return
        raise TypeError(f"Config key {key!r} has unsupported value type {type(value)}")

    # -- attribute access --------------------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        if name in self:
            return self[name]
        raise AttributeError(f"No config key {name!r}")

    def __setattr__(self, name: str, value: Any) -> None:
        if self.is_frozen():
            raise AttributeError(f"Config is frozen; cannot set {name!r}")
        self._check_leaf(name, value)
        self[name] = value

    def __setitem__(self, key, value):
        if self.is_frozen():
            raise AttributeError(f"Config is frozen; cannot set {key!r}")
        super().__setitem__(key, value)

    # -- immutability ---------------------------------------------------------------------
    def freeze(self) -> "CfgNode":
        self._set_frozen(True)
        return self

    def defrost(self) -> "CfgNode":
        self._set_frozen(False)
        return self

    def is_frozen(self) -> bool:
        return self.__dict__[_IMMUTABLE]

    def _set_frozen(self, frozen: bool) -> None:
        self.__dict__[_IMMUTABLE] = frozen
        for v in self.values():
            if isinstance(v, CfgNode):
                v._set_frozen(frozen)

    # -- cloning / serialization -------------------------------------------------------------
    def clone(self) -> "CfgNode":
        return copy.deepcopy(self)

    def __deepcopy__(self, memo) -> "CfgNode":
        # Rebuilt unfrozen, then frozen again: a plain deepcopy would restore
        # the frozen flag before re-inserting the items.
        new = type(self)(copy.deepcopy(self.to_dict(), memo))
        if self.is_frozen():
            new.freeze()
        return new

    def to_dict(self) -> Dict:
        return {k: (v.to_dict() if isinstance(v, CfgNode) else v) for k, v in self.items()}

    def dump(self) -> str:
        return yaml_lite.dump(self.to_dict())

    def save(self, path: str) -> None:
        with open(path, "w") as fh:
            fh.write(self.dump())

    @classmethod
    def load_yaml(cls, path_or_stream) -> "CfgNode":
        if hasattr(path_or_stream, "read"):
            data = yaml_lite.loads(path_or_stream.read())
        else:
            data = yaml_lite.load(path_or_stream)
        return cls(data or {})

    # -- deprecated / renamed key registry -----------------------------------------------------
    def register_deprecated_key(self, key: str) -> None:
        self.__dict__[_DEPRECATED].add(key)

    def register_renamed_key(self, old: str, new: str, message: str = "") -> None:
        self.__dict__[_RENAMED][old] = (new, message)

    def key_is_deprecated(self, key: str) -> bool:
        return key in self.__dict__[_DEPRECATED]

    def key_is_renamed(self, key: str) -> bool:
        return key in self.__dict__[_RENAMED]

    def raise_key_rename_error(self, key: str):
        new, message = self.__dict__[_RENAMED][key]
        raise KeyError(
            f"Config key {key!r} was renamed to {new!r}"
            + (f"; note: {message}" if message else "")
        )

    # -- merging ---------------------------------------------------------------------------------
    def merge_from_file(self, path: str) -> None:
        self.merge_from_other_cfg(CfgNode.load_yaml(path))

    def merge_from_other_cfg(self, other: "CfgNode") -> None:
        self._merge(other, self, [])

    def merge_from_list(self, opts: List) -> None:
        if len(opts) % 2 != 0:
            raise ValueError("Override list must be key/value pairs")
        for full_key, value in zip(opts[0::2], opts[1::2]):
            if self.key_is_deprecated(full_key):
                continue
            if self.key_is_renamed(full_key):
                self.raise_key_rename_error(full_key)
            node = self
            *parents, leaf = full_key.split(".")
            for p in parents:
                if p not in node:
                    raise KeyError(f"Unknown config key {full_key!r}")
                node = node[p]
            if leaf not in node:
                raise KeyError(f"Unknown config key {full_key!r}")
            node[leaf] = _coerce(_parse_literal(value), node[leaf], full_key)

    def _merge(self, src: "CfgNode", dst: "CfgNode", path: List[str]) -> None:
        for key, src_val in src.items():
            full_key = ".".join(path + [key])
            if key not in dst:
                if self.key_is_deprecated(full_key):
                    continue
                if self.key_is_renamed(full_key):
                    self.raise_key_rename_error(full_key)
                if self.__dict__[_NEW_ALLOWED] or dst.__dict__.get(_NEW_ALLOWED):
                    dst[key] = copy.deepcopy(src_val)
                    continue
                raise KeyError(f"Unknown config key {full_key!r}")
            dst_val = dst[key]
            if isinstance(dst_val, CfgNode) and isinstance(src_val, CfgNode):
                self._merge(src_val, dst_val, path + [key])
            else:
                dst[key] = _coerce(copy.deepcopy(src_val), dst_val, full_key)

    def __repr__(self) -> str:
        return f"CfgNode({super().__repr__()})"

    def __str__(self) -> str:
        def _fmt(node, indent):
            lines = []
            for k, v in sorted(node.items()):
                if isinstance(v, CfgNode):
                    lines.append(" " * indent + f"{k}:")
                    lines.append(_fmt(v, indent + 2))
                else:
                    lines.append(" " * indent + f"{k}: {v}")
            return "\n".join(lines)

        return _fmt(self, 0)


def _parse_literal(value: Any) -> Any:
    """Parse a CLI override string into a python literal where possible."""
    if not isinstance(value, str):
        return value
    try:
        parsed = yaml_lite.load_value(value)
    except (ValueError, IndexError):
        return value
    if isinstance(parsed, str):
        # YAML 1.1 leaves exponent notation without a decimal point ('1e-3')
        # a string; the CLI help documents that form for --override.
        try:
            return int(parsed)
        except ValueError:
            pass
        try:
            return float(parsed)
        except ValueError:
            pass
    return parsed


def _coerce(new: Any, old: Any, key: str) -> Any:
    """Coerce `new` to the type of `old` for compatible scalar types."""
    if old is None or new is None or type(new) is type(old):
        return new
    # int -> float promotion, float -> int demotion when exact, tuple<->list.
    if isinstance(old, float) and isinstance(new, int):
        return float(new)
    if isinstance(old, int) and isinstance(new, float) and new.is_integer():
        return int(new)
    if isinstance(old, tuple) and isinstance(new, list):
        return tuple(new)
    if isinstance(old, list) and isinstance(new, tuple):
        return list(new)
    if isinstance(old, bool) and isinstance(new, str):
        if new.lower() in ("true", "1"):
            return True
        if new.lower() in ("false", "0"):
            return False
    if isinstance(old, (CfgNode, dict)) or isinstance(new, (CfgNode, dict)):
        raise ValueError(f"Cannot merge non-dict into dict at key {key!r}")
    raise ValueError(
        f"Type mismatch for key {key!r}: cannot replace {type(old).__name__} "
        f"with {type(new).__name__}"
    )


def flatten_dict(d: Dict, sep: str = ".", _prefix: str = "") -> Dict:
    """Nested dict -> flat {'a.b.c': v} dict (hparams.yaml persistence format)."""
    out = {}
    for k, v in d.items():
        key = f"{_prefix}{sep}{k}" if _prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_dict(v, sep=sep, _prefix=key))
        else:
            out[key] = v
    return out


def nest_dict(d: Dict, sep: str = ".") -> Dict:
    """Flat {'a.b.c': v} dict -> nested dict (inverse of flatten_dict)."""
    out: Dict = {}
    for k, v in d.items():
        node = out
        *parents, leaf = str(k).split(sep)
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out
