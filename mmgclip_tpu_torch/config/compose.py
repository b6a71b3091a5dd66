"""Hydra-compatible YAML config composition (port of mmgclip_tpu/config/compose.py).

The reference drives every entry point through Hydra config groups
(reference: train.py:9, configs/train_binary_class_clf.yaml:1-22).  This module
re-implements the subset of Hydra semantics the framework needs — `defaults:`
group composition, `${a.b.c}` interpolation, `${now:...}` / `${hydra:run.dir}`
resolvers, CLI overrides, and the `.hydra/config.yaml` run-dir snapshot that
evaluate/generate entry points recompose (reference: evaluate_clip.py:36-45) —
without the Hydra dependency, on top of frozen-by-convention attribute dicts.
"""

from __future__ import annotations

import copy
import os
import time
from typing import Any, Dict, Iterable, List, Optional

from .yaml_lite import load as _yaml_load_text


def _yaml_load(stream):
    """YAML text or a file object -> data (YAML 1.2 floats, see yaml_lite)."""
    return _yaml_load_text(stream if isinstance(stream, str) else stream.read())


__all__ = [
    "Config",
    "compose",
    "load_config",
    "resolve",
    "recompose",
]


class Config(dict):
    """A nested dict with attribute access (`cfg.dataset.config.seed`).

    Mirrors the reference's ``AttrDict(cfg)`` usage (reference: train.py:14) but
    keeps dict semantics so YAML round-trips are trivial.
    """

    def __init__(self, data: Optional[Dict[str, Any]] = None):
        super().__init__()
        for key, value in (data or {}).items():
            self[key] = value

    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, Config):
            return value
        if isinstance(value, dict):
            return Config(value)
        if isinstance(value, list):
            return [Config._wrap(v) for v in value]
        return value

    def __setitem__(self, key: str, value: Any) -> None:
        super().__setitem__(key, Config._wrap(value))

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as exc:  # pragma: no cover - attribute protocol
            raise AttributeError(key) from exc

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __delattr__(self, key: str) -> None:
        try:
            del self[key]
        except KeyError as exc:  # pragma: no cover
            raise AttributeError(key) from exc

    def get_path(self, dotted: str, default: Any = None) -> Any:
        node: Any = self
        for part in dotted.split("."):
            if isinstance(node, dict) and part in node:
                node = node[part]
            else:
                return default
        return node

    def set_path(self, dotted: str, value: Any) -> None:
        parts = dotted.split(".")
        node: Config = self
        for part in parts[:-1]:
            if part not in node or not isinstance(node[part], dict):
                node[part] = Config()
            node = node[part]
        node[parts[-1]] = value

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for key, value in self.items():
            if isinstance(value, Config):
                out[key] = value.to_dict()
            elif isinstance(value, list):
                out[key] = [v.to_dict() if isinstance(v, Config) else v for v in value]
            else:
                out[key] = value
        return out

    def copy(self) -> "Config":  # type: ignore[override]
        return Config(copy.deepcopy(self.to_dict()))


def _merge(dst: Config, src: Dict[str, Any]) -> Config:
    for key, value in src.items():
        if key in dst and isinstance(dst[key], dict) and isinstance(value, dict):
            _merge(dst[key], value)
        else:
            dst[key] = value
    return dst


def _load_yaml(path: str) -> Dict[str, Any]:
    with open(path, "r") as fh:
        data = _yaml_load(fh)
    return data or {}


def _iter_defaults(defaults: Iterable[Any]):
    """Yield (group, name) pairs from a Hydra `defaults:` list.

    Accepts the reference's style — a list of single-key mappings whose value
    is either a string or a one-element list (configs/train_binary_class_clf.yaml:2-22).
    """
    for entry in defaults:
        if entry == "_self_":
            yield ("_self_", None)
            continue
        if isinstance(entry, str):
            yield (None, entry)
            continue
        if isinstance(entry, dict):
            for group, name in entry.items():
                if isinstance(name, list):
                    for item in name:
                        yield (group, item)
                else:
                    yield (group, name)


def _strip_yaml_suffix(name: str) -> str:
    return name[:-5] if name.endswith(".yaml") else name


def compose(
    config_dir: str,
    config_name: str,
    overrides: Optional[List[str]] = None,
    run_dir: Optional[str] = None,
) -> Config:
    """Compose a config from a top-level file and its `defaults:` groups."""
    top_path = os.path.join(config_dir, _strip_yaml_suffix(config_name) + ".yaml")
    top = _load_yaml(top_path)
    defaults = top.pop("defaults", [])

    cfg = Config()
    for group, name in _iter_defaults(defaults):
        if group == "_self_":
            _merge(cfg, copy.deepcopy(top))
            continue
        if group is None:
            # bare-string defaults entry: merge configs/<name>.yaml at the top
            _merge(cfg, _load_yaml(os.path.join(config_dir, _strip_yaml_suffix(str(name)) + ".yaml")))
            continue
        name = _strip_yaml_suffix(str(name))
        group_path = os.path.join(config_dir, group.replace(".", "/"), name + ".yaml")
        group_cfg = _load_yaml(group_path)
        # nest under the group key path: "dataset/percentage" -> cfg.dataset.percentage
        node = cfg
        parts = group.split("/")
        for part in parts[:-1]:
            if part not in node:
                node[part] = Config()
            node = node[part]
        leaf = parts[-1]
        if leaf not in node or not isinstance(node.get(leaf), dict):
            node[leaf] = Config()
        _merge(node[leaf], group_cfg)
    if "_self_" not in [g for g, _ in _iter_defaults(defaults)]:
        _merge(cfg, copy.deepcopy(top))

    for override in overrides or []:
        key, _, raw = override.partition("=")
        key = key.strip()
        group_path = os.path.join(config_dir, key.replace(".", "/"))
        candidate = os.path.join(group_path, _strip_yaml_suffix(raw.strip()) + ".yaml")
        if os.path.isdir(group_path) and os.path.isfile(candidate):
            # merge INTO the existing node rather than replace it wholesale:
            # a group override (dataset=multi-label) must not wipe sibling
            # nested-group content composed from the defaults list
            # (dataset.percentage, networks.dropout)
            dotted = key.replace("/", ".")
            existing = cfg.get_path(dotted)
            new_cfg = Config(_load_yaml(candidate))
            if isinstance(existing, dict):
                _merge(existing, new_cfg)
            else:
                cfg.set_path(dotted, new_cfg)
        else:
            cfg.set_path(key, _yaml_load(raw))

    return resolve(cfg, run_dir=run_dir)


def resolve(cfg: Config, run_dir: Optional[str] = None) -> Config:
    """Resolve `${...}` interpolations in-place (OmegaConf.resolve analogue)."""
    stamp = time.localtime()
    if run_dir is None:
        run_tpl = cfg.get_path("hydra.run.dir", "outputs/${now:%Y-%m-%d}/${now:%H-%M-%S}")
        run_dir = _interp_string(str(run_tpl), cfg, stamp, run_dir="")

    def walk(node: Any) -> Any:
        if isinstance(node, dict):
            for key in list(node.keys()):
                node[key] = walk(node[key])
            return node
        if isinstance(node, list):
            return [walk(v) for v in node]
        if isinstance(node, str) and "${" in node:
            return _interp_string(node, cfg, stamp, run_dir)
        return node

    walk(cfg)
    cfg["hydra"] = Config({"run": {"dir": run_dir}})
    return cfg


def _interp_string(text: str, cfg: Config, stamp, run_dir: str) -> Any:
    """Expand all ${...} references inside one string value."""
    out = text
    for _ in range(8):  # bounded nested-interpolation passes
        start = out.find("${")
        if start < 0:
            break
        depth, idx = 0, start
        while idx < len(out):
            if out[idx] == "{":
                depth += 1
            elif out[idx] == "}":
                depth -= 1
                if depth == 0:
                    break
            idx += 1
        expr = out[start + 2 : idx]
        if expr.startswith("now:"):
            value: Any = time.strftime(expr[4:], stamp)
        elif expr.startswith("hydra:run.dir"):
            value = run_dir
        else:
            value = cfg.get_path(expr)
            if value is None:
                value = ""
        if start == 0 and idx == len(out) - 1 and not isinstance(value, str):
            return value  # full-string interpolation keeps the native type
        out = out[:start] + str(value) + out[idx + 1 :]
    return out


def load_config(config_dir: str, config_name: str, overrides: Optional[List[str]] = None) -> Config:
    """Alias for :func:`compose` matching entry-point wording."""
    return compose(config_dir, config_name, overrides)


def recompose(experiment_path: str) -> Config:
    """Reload a past run's snapshot config (reference: evaluate_clip.py:36-45)."""
    path = os.path.join(experiment_path, ".hydra", "config.yaml")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"No config snapshot at {path}")
    return Config(_load_yaml(path))
