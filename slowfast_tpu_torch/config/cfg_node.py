"""Lightweight yacs-style configuration node.

A from-scratch, dependency-free replacement for the fvcore/yacs ``CfgNode``
used by the reference framework (reference: slowfast/config/defaults.py:15,
slowfast/utils/parser.py:67-94). Supports:

  * attribute- and item-style access (``cfg.TRAIN.BATCH_SIZE``),
  * ``merge_from_file(yaml_path)`` with strict key checking,
  * ``merge_from_list(["KEY.SUBKEY", value, ...])`` for CLI ``--opts``,
  * ``clone()``, ``dump()`` (yaml text), ``freeze()/defrost()``,
  * new-key registration only on unfrozen nodes via normal assignment.

Values are plain Python scalars / lists / tuples, so a config is always
picklable and yaml-serializable.
"""

from __future__ import annotations

import copy
from typing import Any, List

import yaml


_VALID_SCALARS = (int, float, bool, str, type(None))


def _check_value(full_key: str, value: Any) -> Any:
    """Validate that a config value is a yaml-representable plain type."""
    if isinstance(value, dict):
        return CfgNode(value)
    if isinstance(value, _VALID_SCALARS):
        return value
    if isinstance(value, (list, tuple)):
        return type(value)(_check_value(full_key, v) for v in value)
    raise TypeError(
        f"Invalid config value type {type(value)} for key {full_key!r}; "
        "only scalars, lists, tuples, and nested dicts are allowed."
    )


def _coerce(full_key: str, old: Any, new: Any) -> Any:
    """Coerce an override value to be type-compatible with the default."""
    if isinstance(new, str) and not isinstance(old, str):
        # yaml leaves python literals like "None", "(3, 7, 7)" as strings.
        import ast

        try:
            new = ast.literal_eval(new)
        except (ValueError, SyntaxError):
            pass
    if old is None or new is None:
        return new
    if isinstance(old, bool) != isinstance(new, bool):
        # bool is a subclass of int; keep them distinct.
        if isinstance(old, bool) and isinstance(new, int):
            return bool(new)
        raise ValueError(f"Type mismatch for {full_key}: {old!r} vs {new!r}")
    if type(old) is type(new):
        return new
    if isinstance(old, (tuple, list)) and isinstance(new, (tuple, list)):
        return type(old)(new)
    if isinstance(old, float) and isinstance(new, int):
        return float(new)
    if isinstance(old, float) and isinstance(new, str):
        # yaml 1.1 parses "1e-4" (no dot) as a string; accept numeric strings.
        try:
            return float(new)
        except ValueError:
            pass
    if isinstance(old, (list, tuple)) and isinstance(new, str):
        # Reference configs write python tuples like "(3, 7, 7)" in yaml.
        import ast

        try:
            parsed = ast.literal_eval(new)
        except (ValueError, SyntaxError):
            parsed = None
        if isinstance(parsed, (list, tuple)):
            return type(old)(parsed)
    if isinstance(old, int) and isinstance(new, float) and new.is_integer():
        return int(new)
    raise ValueError(
        f"Type mismatch for {full_key}: default {type(old).__name__} "
        f"({old!r}) vs override {type(new).__name__} ({new!r})"
    )


class CfgNode(dict):
    """A dict with attribute access, freezing, and strict yaml merging."""

    _FROZEN_KEY = "__frozen__"
    _NEW_ALLOWED_KEY = "__new_allowed__"

    def __init__(self, init_dict: dict | None = None, new_allowed: bool = False):
        super().__init__()
        object.__setattr__(self, self._FROZEN_KEY, False)
        object.__setattr__(self, self._NEW_ALLOWED_KEY, new_allowed)
        if init_dict:
            for k, v in init_dict.items():
                super().__setitem__(k, _check_value(str(k), v))

    # -- attribute access ---------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(
                f"Config has no key {name!r}. Available: {sorted(self.keys())[:20]}"
            ) from None

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __setitem__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, self._FROZEN_KEY):
            raise AttributeError(f"Cannot set {name!r} on a frozen config.")
        super().__setitem__(name, _check_value(name, value))

    def __delattr__(self, name: str) -> None:
        del self[name]

    # -- freezing -----------------------------------------------------------
    def freeze(self) -> "CfgNode":
        object.__setattr__(self, self._FROZEN_KEY, True)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.freeze()
        return self

    def defrost(self) -> "CfgNode":
        object.__setattr__(self, self._FROZEN_KEY, False)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.defrost()
        return self

    def is_frozen(self) -> bool:
        return object.__getattribute__(self, self._FROZEN_KEY)

    # -- cloning / dumping ----------------------------------------------------
    def clone(self) -> "CfgNode":
        return copy.deepcopy(self)

    def __deepcopy__(self, memo) -> "CfgNode":
        node = CfgNode()
        memo[id(self)] = node
        for k, v in self.items():
            dict.__setitem__(node, k, copy.deepcopy(v, memo))
        return node

    def to_dict(self) -> dict:
        def convert(v):
            if isinstance(v, CfgNode):
                return {k: convert(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return [convert(x) for x in v]
            return v

        return {k: convert(v) for k, v in self.items()}

    def dump(self) -> str:
        return yaml.safe_dump(self.to_dict(), default_flow_style=None, sort_keys=True)

    # -- merging --------------------------------------------------------------
    def merge_from_other_cfg(self, other: "CfgNode", prefix: str = "") -> None:
        for key, value in other.items():
            full_key = f"{prefix}.{key}" if prefix else str(key)
            if key not in self:
                if object.__getattribute__(self, self._NEW_ALLOWED_KEY):
                    self[key] = value
                    continue
                raise KeyError(f"Non-existent config key: {full_key}")
            old = self[key]
            if isinstance(old, CfgNode):
                if not isinstance(value, (dict, CfgNode)):
                    raise ValueError(
                        f"Cannot overwrite config node {full_key} with a scalar."
                    )
                old.merge_from_other_cfg(CfgNode(dict(value)), prefix=full_key)
            else:
                super().__setitem__(key, _coerce(full_key, old, _check_value(full_key, value)))

    def merge_from_file(self, cfg_filename: str) -> None:
        with open(cfg_filename, "r") as f:
            text = f.read()
        try:
            loaded = yaml.safe_load(text)
        except yaml.YAMLError:
            # Some upstream configs have a stray one-space indent on a line
            # inside a two-space block; normalize odd indents and retry.
            fixed = "\n".join(
                " " + ln if (len(ln) - len(ln.lstrip(" "))) % 2 == 1 else ln
                for ln in text.splitlines()
            )
            loaded = yaml.safe_load(fixed)
        if loaded is None:
            return
        self.merge_from_other_cfg(CfgNode(loaded))

    def merge_from_list(self, cfg_list: List[Any]) -> None:
        if len(cfg_list) % 2 != 0:
            raise ValueError(f"Override list must have even length: {cfg_list}")
        for full_key, raw in zip(cfg_list[0::2], cfg_list[1::2]):
            keys = full_key.split(".")
            node = self
            for sub in keys[:-1]:
                if sub not in node:
                    raise KeyError(f"Non-existent config key: {full_key}")
                node = node[sub]
                if not isinstance(node, CfgNode):
                    raise KeyError(f"{full_key}: {sub} is not a config node")
            leaf = keys[-1]
            if leaf not in node:
                raise KeyError(f"Non-existent config key: {full_key}")
            value = raw
            if isinstance(raw, str):
                try:
                    value = yaml.safe_load(raw)
                except yaml.YAMLError:
                    value = raw
                if isinstance(value, str):
                    # yacs-style fallback for python literals like "(0.9, 0.95)".
                    import ast

                    try:
                        value = ast.literal_eval(value)
                    except (ValueError, SyntaxError):
                        pass
            dict.__setitem__(
                node, leaf, _coerce(full_key, node[leaf], _check_value(full_key, value))
            )

    # -- misc -----------------------------------------------------------------
    def __repr__(self) -> str:
        return f"CfgNode({dict.__repr__(self)})"

    def __reduce__(self):
        return (CfgNode, (self.to_dict(),))
