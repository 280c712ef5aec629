# Copied from pointcloudpdf_tpu/utils/config.py; keep in step.  Two departures:
# ``Config`` pickles (``__reduce__``), as ``launch`` hands it to spawned ranks,
# and a config's ``from pointcloudpdf_tpu.X import ...`` reads the port's
# ``pointcloudpdf_tpu_torch.X`` (the ScanNet200 configs import their class
# names so; the JAX package's ``datasets`` imports jax).
"""Python-file configuration system.

Configs are executable Python files whose top-level variables become the
config dict. A ``_base_`` entry (str or list of str, paths relative to the
config file) is loaded first and recursively overridden; a dict override may
carry ``_delete_=True`` to replace rather than merge the base dict. CLI
overrides use dotted keys (``optimizer.lr=0.1``).

Fresh implementation of the reference contract
(reference: pointcept/utils/config.py:70,179-332,600).
"""

from __future__ import annotations

import argparse
import ast
import copy
import os
import types
from typing import Any, Dict, List, Optional

DELETE_KEY = "_delete_"
BASE_KEY = "_base_"
# a config's imports of the JAX package read the port's module of that name
JAX_PACKAGE, PORT_PACKAGE = "pointcloudpdf_tpu", "pointcloudpdf_tpu_torch"


class ConfigDict(dict):
    """A dict with attribute access; missing attributes raise AttributeError."""

    def __getattr__(self, name: str) -> Any:
        try:
            value = self[name]
        except KeyError:
            raise AttributeError(f"ConfigDict has no attribute '{name}'")
        return value

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError:
            raise AttributeError(name)

    def __deepcopy__(self, memo):
        other = ConfigDict()
        memo[id(self)] = other
        for k, v in self.items():
            other[copy.deepcopy(k, memo)] = copy.deepcopy(v, memo)
        return other


def _to_config_dict(obj: Any) -> Any:
    if isinstance(obj, dict):
        return ConfigDict({k: _to_config_dict(v) for k, v in obj.items()})
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_config_dict(v) for v in obj)
    return obj


def _exec_pyfile(filename: str) -> Dict[str, Any]:
    filename = os.path.abspath(os.path.expanduser(filename))
    if not os.path.isfile(filename):
        raise FileNotFoundError(f"config file not found: {filename}")
    with open(filename, "r") as f:
        source = f.read()
    tree = ast.parse(source)  # raise a clean SyntaxError before exec
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module and (
                node.module.split(".")[0] == JAX_PACKAGE):
            node.module = PORT_PACKAGE + node.module[len(JAX_PACKAGE):]
    module = types.ModuleType("_cfg_module")
    module.__file__ = filename
    exec(compile(tree, filename, "exec"), module.__dict__)
    return {
        k: v
        for k, v in module.__dict__.items()
        if not k.startswith("__") and not isinstance(v, types.ModuleType)
    }


def merge_dict(base: Dict, override: Dict) -> Dict:
    """Recursively merge ``override`` into ``base`` (returns a new dict)."""
    merged = copy.deepcopy(base)
    for key, value in override.items():
        if isinstance(value, dict):
            value = dict(value)
            delete = value.pop(DELETE_KEY, False)
            if not delete and key in merged and isinstance(merged[key], dict):
                merged[key] = merge_dict(merged[key], value)
            else:
                merged[key] = copy.deepcopy(value)
        else:
            merged[key] = copy.deepcopy(value)
    return merged


def _load_cfg_file(filename: str) -> Dict[str, Any]:
    cfg = _exec_pyfile(filename)
    bases = cfg.pop(BASE_KEY, [])
    if isinstance(bases, str):
        bases = [bases]
    merged: Dict[str, Any] = {}
    cfg_dir = os.path.dirname(os.path.abspath(os.path.expanduser(filename)))
    for base in bases:
        base_cfg = _load_cfg_file(os.path.join(cfg_dir, base))
        merged = merge_dict(merged, base_cfg)
    return merge_dict(merged, cfg)


class Config:
    """Resolved configuration with attribute access and pretty dump."""

    def __init__(self, cfg_dict: Optional[Dict] = None, filename: Optional[str] = None):
        object.__setattr__(self, "_cfg_dict", _to_config_dict(cfg_dict or {}))
        object.__setattr__(self, "_filename", filename)

    @staticmethod
    def fromfile(filename: str) -> "Config":
        return Config(_load_cfg_file(filename), filename=filename)

    @property
    def filename(self) -> Optional[str]:
        return self._filename

    def __reduce__(self):
        return Config, (self.to_dict(), self._filename)

    # -- mapping / attribute protocol -------------------------------------
    def __getattr__(self, name: str) -> Any:
        return getattr(self._cfg_dict, name)

    def __setattr__(self, name: str, value: Any) -> None:
        self._cfg_dict[name] = _to_config_dict(value)

    def __getitem__(self, key: str) -> Any:
        return self._cfg_dict[key]

    def __setitem__(self, key: str, value: Any) -> None:
        self._cfg_dict[key] = _to_config_dict(value)

    def __contains__(self, key: str) -> bool:
        return key in self._cfg_dict

    def __iter__(self):
        return iter(self._cfg_dict)

    def get(self, key: str, default: Any = None) -> Any:
        return self._cfg_dict.get(key, default)

    def setdefault(self, key: str, default: Any = None) -> Any:
        return self._cfg_dict.setdefault(key, _to_config_dict(default))

    def keys(self):
        return self._cfg_dict.keys()

    def items(self):
        return self._cfg_dict.items()

    def to_dict(self) -> Dict[str, Any]:
        def _plain(obj):
            if isinstance(obj, dict):
                return {k: _plain(v) for k, v in obj.items()}
            if isinstance(obj, (list, tuple)):
                return type(obj)(_plain(v) for v in obj)
            return obj

        return _plain(self._cfg_dict)

    def merge_from_dict(self, options: Dict[str, Any]) -> None:
        """Merge dotted-key overrides, e.g. ``{"optimizer.lr": 0.1}``."""
        nested: Dict[str, Any] = {}
        for full_key, value in options.items():
            node = nested
            parts = full_key.split(".")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = value
        merged = merge_dict(self.to_dict(), nested)
        object.__setattr__(self, "_cfg_dict", _to_config_dict(merged))

    # -- dump ---------------------------------------------------------------
    @property
    def pretty_text(self) -> str:
        import pprint

        return pprint.pformat(self.to_dict(), width=100, sort_dicts=False)

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            f.write("config = " + self.pretty_text + "\n")

    def __repr__(self) -> str:
        return f"Config(file={self._filename})\n{self.pretty_text}"


def _parse_value(value: str) -> Any:
    """Parse a CLI value string into python (int/float/bool/None/list/str)."""
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        pass
    lowered = value.lower()
    if lowered in ("true", "false"):
        return lowered == "true"
    if lowered in ("none", "null"):
        return None
    if "," in value:
        return [_parse_value(v) for v in value.split(",") if v != ""]
    return value


class DictAction(argparse.Action):
    """argparse action parsing ``k=v`` pairs with dotted keys into a dict.

    Mirrors the CLI override contract of the reference
    (pointcept/utils/config.py:600).
    """

    def __call__(self, parser, namespace, values, option_string=None):
        options = getattr(namespace, self.dest, None) or {}
        for kv in values:
            key, sep, value = kv.partition("=")
            if not sep:
                raise argparse.ArgumentError(self, f"expected key=value, got '{kv}'")
            options[key] = _parse_value(value)
        setattr(namespace, self.dest, options)
