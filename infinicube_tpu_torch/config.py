"""YAML config system with recursive includes, interpolation and CLI
overrides; the port's own copy of ``infinicube_tpu/config.py`` (the port
imports nothing of the JAX package):

- ``include_configs:`` keys merge recursively, listed files first, current
  file winning (depth-first include resolution);
- ``${key.path}`` interpolation against the merged tree;
- every leaf becomes a typed ``--key.path value`` CLI flag, plus
  ``--exec k=v`` ad-hoc overrides evaluated as Python literals.

Plain PyYAML and a small dot-dict. PyYAML is imported by ``load_config``
only, so a machine without it can still build a ``Config`` from ``"none"``
plus overrides."""

from __future__ import annotations

import argparse
import ast
import copy
import re
from pathlib import Path
from typing import Any


class Config(dict):
    """dict with attribute access and dotted-path get/set."""

    def __getattr__(self, k):
        try:
            v = self[k]
        except KeyError as e:
            raise AttributeError(k) from e
        return v

    def __setattr__(self, k, v):
        self[k] = v

    @staticmethod
    def wrap(obj):
        if isinstance(obj, dict):
            return Config({k: Config.wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [Config.wrap(v) for v in obj]
        return obj

    def get_path(self, path: str, default=None):
        node: Any = self
        for part in path.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def set_path(self, path: str, value):
        parts = path.split(".")
        node = self
        for p in parts[:-1]:
            if p not in node or not isinstance(node[p], dict):
                node[p] = Config()
            node = node[p]
        node[parts[-1]] = value

    def to_dict(self) -> dict:
        def unwrap(o):
            if isinstance(o, dict):
                return {k: unwrap(v) for k, v in o.items()}
            if isinstance(o, list):
                return [unwrap(v) for v in o]
            return o
        return unwrap(self)


def _deep_merge(base: dict, override: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


_INTERP = re.compile(r"\$\{([^}]+)\}")


def _interpolate(tree: dict):
    def resolve(node):
        if isinstance(node, dict):
            return {k: resolve(v) for k, v in node.items()}
        if isinstance(node, list):
            return [resolve(v) for v in node]
        if isinstance(node, str):
            m = _INTERP.fullmatch(node)
            root = Config.wrap(tree)
            if m:  # whole-value interpolation keeps the referenced type
                val = root.get_path(m.group(1))
                return resolve(val) if isinstance(val, str) else val
            return _INTERP.sub(
                lambda mm: str(root.get_path(mm.group(1))), node)
        return node
    return resolve(tree)


def load_config(path: str | Path, overrides: list[str] | None = None) -> Config:
    """Load a YAML config, resolving include_configs + interpolation, then
    apply ``k.e.y=value`` override strings."""
    try:
        import yaml
    except ImportError as e:
        raise RuntimeError(
            f"reading {path} needs PyYAML, which is not installed; pass "
            "'none' as the config and give every setting as an override "
            "(--exec k.e.y=value)") from e
    path = Path(path)

    def load_tree(p: Path) -> dict:
        raw = yaml.safe_load(p.read_text()) or {}
        includes = raw.pop("include_configs", [])
        if isinstance(includes, str):
            includes = [includes]
        merged: dict = {}
        for inc in includes:
            ip = (p.parent / inc) if not Path(inc).is_absolute() else Path(inc)
            merged = _deep_merge(merged, load_tree(ip))
        return _deep_merge(merged, raw)

    tree = load_tree(path)
    tree = _interpolate(tree)
    cfg = Config.wrap(tree)
    for ov in overrides or []:
        k, _, v = ov.partition("=")
        cfg.set_path(k.strip(), parse_literal(v.strip()))
    return cfg


def parse_literal(s: str):
    try:
        return ast.literal_eval(s)
    except (ValueError, SyntaxError):
        low = s.lower()
        if low in ("true", "false"):
            return low == "true"
        if low in ("null", "none"):
            return None
        return s


def _flatten(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flatten(v, key)
        else:
            yield key, v


class ConfigArgumentParser(argparse.ArgumentParser):
    """Positional config path; every YAML leaf can be set as
    ``--dotted.path value``; ``--exec k=v`` for arbitrary overrides."""

    def __init__(self, base_config: str | None = None, **kw):
        super().__init__(**kw)
        self.add_argument("config", type=str, nargs="?", default=base_config,
                          help="YAML config path (or 'none')")
        self.add_argument("--exec", type=str, nargs="*", default=[],
                          help="extra overrides k.e.y=value")

    def parse_config(self, argv: list[str] | None = None) -> Config:
        known, unknown = self.parse_known_args(argv)
        cfg = Config() if known.config in (None, "none") else \
            load_config(known.config)
        # turn --a.b.c v pairs into overrides
        i = 0
        overrides: list[str] = list(known.exec)
        while i < len(unknown):
            tok = unknown[i]
            if tok.startswith("--"):
                if "=" in tok:
                    overrides.append(tok[2:])
                    i += 1
                else:
                    overrides.append(f"{tok[2:]}={unknown[i + 1]}")
                    i += 2
            else:
                i += 1
        for ov in overrides:
            k, _, v = ov.partition("=")
            cfg.set_path(k.strip(), parse_literal(v.strip()))
        # keep program args accessible
        for k, v in vars(known).items():
            if k not in ("config", "exec"):
                cfg.set_path(k, v)
        return cfg
