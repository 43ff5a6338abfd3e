"""YAML configuration with recursive ``inherit_from`` (copy of
``load_config`` from ``endosurf_tpu/config.py``; the JAX package cannot be
imported where the port runs), and ``save_config``.

A config file may name a parent via ``inherit_from``; parents load first and
children deep-merge on top. Parents resolve relative to the working directory
first, then to the child file's directory. ``load_config`` also accepts an
already-built dict, which it deep-copies. PyYAML is imported only when a file
is read.
"""

from __future__ import annotations

import copy
import json
import os.path as osp
from typing import Any, Dict, Optional, Union


def deep_merge(base: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    """Recursively merge ``override`` into ``base`` (in place) and return it."""
    for key, value in override.items():
        if isinstance(value, dict):
            node = base.setdefault(key, {})
            if not isinstance(node, dict):
                base[key] = copy.deepcopy(value)
            else:
                deep_merge(node, value)
        else:
            base[key] = value
    return base


def _resolve_parent(path: str, child_dir: str) -> str:
    candidates = [path, osp.join(child_dir, path)]
    for cand in candidates:
        if osp.exists(cand):
            return cand
    raise FileNotFoundError(
        f"inherit_from target {path!r} not found (tried {candidates})")


def load_config(path: Union[str, Dict[str, Any]],
                _seen: Optional[set] = None) -> Dict[str, Any]:
    """Load a YAML config (or copy a dict), resolving ``inherit_from``."""
    if isinstance(path, dict):
        return copy.deepcopy(path)
    import yaml

    _seen = set() if _seen is None else _seen
    real = osp.realpath(path)
    if real in _seen:
        raise ValueError(f"circular inherit_from chain at {path}")
    _seen.add(real)

    with open(path, "r") as f:
        cfg_child = yaml.safe_load(f) or {}

    parent = cfg_child.pop("inherit_from", None)
    if parent is not None:
        parent_path = _resolve_parent(parent, osp.dirname(real))
        cfg = load_config(parent_path, _seen)
    else:
        cfg = {}
    deep_merge(cfg, cfg_child)
    return cfg


def save_config(cfg: Dict[str, Any], path: str) -> None:
    """Write ``cfg`` as JSON text, which YAML loaders read as YAML: the file
    loads back with :func:`load_config`, and writing it needs no PyYAML."""
    with open(path, "w") as f:
        json.dump(cfg, f, indent=2, default=str)
        f.write("\n")
