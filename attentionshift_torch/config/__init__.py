"""Config system: python-file configs with ``_base_`` includes.

The port's own copy of the loader of ``attentionshift_tpu/config`` (the
port imports nothing from the JAX package): it reads the same
``configs/*.py`` files. Mirrors mmcv ``Config.fromfile`` with ``_base_``
inheritance and ``--cfg-options`` dotted-path overrides, minus the
global registries — components are constructed explicitly from the
resulting dict tree.
"""

from __future__ import annotations

import ast
import copy
import os
import runpy
from typing import Any

__all__ = ["Config"]


def _deep_merge(base: dict, override: dict) -> dict:
    """Override wins; dicts merge recursively; `_delete_` resets a node."""
    out = copy.deepcopy(base)
    for k, v in override.items():
        if isinstance(v, dict) and v.get("_delete_"):
            v = {kk: vv for kk, vv in v.items() if kk != "_delete_"}
            out[k] = copy.deepcopy(v)
        elif isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _parse_value(text: str) -> Any:
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text


class Config(dict):
    """dict with attribute access and the loader/merge machinery."""

    def __getattr__(self, name):
        try:
            v = self[name]
        except KeyError as e:
            raise AttributeError(name) from e
        return Config(v) if isinstance(v, dict) and not isinstance(v, Config) else v

    def __setattr__(self, name, value):
        self[name] = value

    @classmethod
    def fromfile(cls, path: str) -> "Config":
        path = os.path.abspath(path)
        ns = runpy.run_path(path)
        cfg: dict = {}
        for base in ns.get("_base_", []) or []:
            base_path = os.path.join(os.path.dirname(path), base)
            cfg = _deep_merge(cfg, dict(cls.fromfile(base_path)))
        own = {
            k: v for k, v in ns.items()
            if not k.startswith("_") and not callable(v) and not isinstance(v, type(os))
        }
        return cls(_deep_merge(cfg, own))

    def merge_from_options(self, options: dict[str, Any] | list[str]) -> "Config":
        """Apply ``a.b.c=value`` overrides (mmcv --cfg-options)."""
        if isinstance(options, list):
            parsed = {}
            for item in options:
                k, _, v = item.partition("=")
                parsed[k] = _parse_value(v)
            options = parsed
        out = Config(copy.deepcopy(dict(self)))
        for dotted, value in options.items():
            node = out
            keys = dotted.split(".")
            for k in keys[:-1]:
                nxt = node.get(k)
                if not isinstance(nxt, dict):
                    nxt = {}
                    node[k] = nxt
                node = nxt
            node[keys[-1]] = value
        return out

    def to_dict(self) -> dict:
        def conv(v):
            if isinstance(v, dict):
                return {k: conv(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return type(v)(conv(x) for x in v)
            return v

        return conv(dict(self))
