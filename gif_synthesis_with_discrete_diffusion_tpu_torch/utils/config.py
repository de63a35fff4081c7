"""Composable YAML config system.

The port's own copy of ``gif_synthesis_with_discrete_diffusion_tpu/utils/
config.py``: the same composition over the JAX package's config tree, read
where it lies (:func:`default_config_root`), with the port's own YAML reader
(:mod:`.yaml_lite`) in place of PyYAML, which the port does not need.
``compose`` gives what the JAX package's gives, its quirks included (a
``${...}`` nested inside an ``env:`` default is substituted once and the
outer one left as text; ``gen_lr: 1e-4`` is a string, as YAML 1.1 reads it):

* config *groups* are directories under a config root (``model/``,
  ``datamodule/``, ``trainer/``, ...);
* each YAML file may carry a ``defaults`` list composing other groups,
  including nested-group injection ``/model/foo@key`` (reference
  configs/model/discrete_diffusion.yaml:47-50);
* CLI overrides: ``group=name`` swaps a group, ``a.b.c=value`` sets a leaf,
  ``+a.b=value`` adds a new leaf, ``~a.b`` deletes one;
* ``${a.b.c}`` interpolation against the composed root and ``${env:VAR}``
  environment lookup (reference configs/paths/default.yaml:4);
* ``instantiate``: builds objects from ``_target_`` dotted paths (reference
  uses hydra.utils.instantiate, src/tasks/train_task.py:33-47).
"""
from __future__ import annotations

import copy
import dataclasses
import importlib
import os
import re
from pathlib import Path
from typing import Any, Callable, Mapping, Sequence

from . import yaml_lite

__all__ = [
    "ConfigError",
    "compose",
    "compose_from_root",
    "default_config_root",
    "instantiate",
    "resolve_interpolations",
    "to_yaml",
    "merge",
]


class ConfigError(Exception):
    pass


def default_config_root() -> Path:
    """The JAX package's config tree, read in place (not imported)."""
    return (Path(__file__).resolve().parents[2]
            / "gif_synthesis_with_discrete_diffusion_tpu" / "configs")


# ---------------------------------------------------------------------------
# loading + merging
# ---------------------------------------------------------------------------

def _load_yaml(path: Path) -> dict:
    if not path.exists():
        raise ConfigError(f"config file not found: {path}")
    data = yaml_lite.safe_load(path.read_text())
    if data is None:
        data = {}
    if not isinstance(data, dict):
        raise ConfigError(f"top-level YAML must be a mapping: {path}")
    return data


def merge(base: dict, overlay: Mapping) -> dict:
    """Recursively merge ``overlay`` into ``base`` (overlay wins)."""
    out = dict(base)
    for k, v in overlay.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, Mapping):
            out[k] = merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _resolve_group_file(root: Path, group: str, name: str) -> Path:
    name = name if name.endswith(".yaml") else name + ".yaml"
    return root / group / name if group else root / name


def _compose_file(root: Path, group: str, name: str,
                  group_overrides: dict[str, str]) -> dict:
    """Compose one config file, honoring its ``defaults`` list.

    Placement semantics: a defaults entry ``group: name`` nests the composed
    sub-config under the group's last path component; ``group@key: name``
    nests it under ``key`` (dotted keys allowed); a sub-config containing
    ``_global_: true`` is merged at the top level instead (the analogue of
    Hydra's ``@package _global_``).
    """
    path = _resolve_group_file(root, group, name)
    raw = _load_yaml(path)
    defaults = raw.pop("defaults", None)
    raw.pop("_global_", None)
    if defaults is None:
        return raw

    composed: dict = {}
    self_done = False
    for entry in defaults:
        if entry == "_self_":
            composed = merge(composed, raw)
            self_done = True
            continue
        if isinstance(entry, str):
            entry = _parse_default_str(entry)
        if not isinstance(entry, Mapping) or len(entry) != 1:
            raise ConfigError(f"bad defaults entry {entry!r} in {path}")
        (key, val), = entry.items()
        target_key = None
        if "@" in key:
            key, target_key = key.split("@", 1)
        optional = key.startswith("optional ")
        if optional:
            key = key[len("optional "):]
        g = key.lstrip("/")
        # CLI group override wins; `group: null` means no default selected.
        chosen = group_overrides.pop(g) if g in group_overrides else val
        if chosen is None:
            continue
        sub_group = g if key.startswith("/") or not group else f"{group}/{g}"
        if optional and not _resolve_group_file(root, sub_group, str(chosen)).exists():
            continue
        sub_raw = _load_yaml(_resolve_group_file(root, sub_group, str(chosen)))
        is_global = bool(sub_raw.get("_global_", False))
        sub = _compose_file(root, sub_group, str(chosen), group_overrides)
        if target_key is not None:
            node: dict = sub
            for part in reversed(target_key.split(".")):
                node = {part: node}
            composed = merge(composed, node)
        elif is_global:
            composed = merge(composed, sub)
        else:
            composed = merge(composed, {g.split("/")[-1]: sub})
    if not self_done:
        composed = merge(composed, raw)
    return composed


def _parse_default_str(entry: str) -> dict:
    """Parse string defaults entries like ``/model/foo@bar`` or ``group/name``."""
    if "@" in entry:
        lhs, key = entry.split("@", 1)
        group, _, name = lhs.rpartition("/")
        return {f"{group}@{key}" if group else f"{lhs}@{key}": name or None}
    group, _, name = entry.rpartition("/")
    if not group:
        raise ConfigError(f"string defaults entry needs a group: {entry!r}")
    return {group: name}


# ---------------------------------------------------------------------------
# overrides
# ---------------------------------------------------------------------------

def _parse_value(text: str) -> Any:
    try:
        return yaml_lite.safe_load(text)
    except yaml_lite.YamlError:
        return text


def _set_path(cfg: dict, dotted: str, value: Any, *, allow_new: bool) -> None:
    parts = dotted.split(".")
    node = cfg
    for p in parts[:-1]:
        if p not in node or not isinstance(node[p], dict):
            if not allow_new and p not in node:
                raise ConfigError(f"override path not found: {dotted!r} (at {p!r})")
            node[p] = {} if not isinstance(node.get(p), dict) else node[p]
        node = node[p]
    if not allow_new and parts[-1] not in node:
        raise ConfigError(
            f"override key not found: {dotted!r}; prefix with '+' to add")
    node[parts[-1]] = value


def _delete_path(cfg: dict, dotted: str) -> None:
    parts = dotted.split(".")
    node = cfg
    for p in parts[:-1]:
        node = node.get(p, {})
        if not isinstance(node, dict):
            return
    node.pop(parts[-1], None)


def compose_from_root(root: Path | str, config_name: str,
                      overrides: Sequence[str] = ()) -> dict:
    """Compose ``config_name`` from the tree at ``root`` with CLI overrides."""
    root = Path(root)
    group_overrides: dict[str, str] = {}
    value_overrides: list[tuple[str, str]] = []
    for ov in overrides:
        if ov.startswith("~"):
            value_overrides.append(("~", ov[1:]))
            continue
        if "=" not in ov:
            raise ConfigError(f"override must be key=value: {ov!r}")
        key, val = ov.split("=", 1)
        if key.startswith("+"):
            value_overrides.append(("+", ov[1:]))
        elif "." not in key and (root / key).is_dir():
            group_overrides[key] = val
        else:
            value_overrides.append(("=", ov))

    cfg = _compose_file(root, "", config_name, dict(group_overrides))
    for mode, ov in value_overrides:
        if mode == "~":
            _delete_path(cfg, ov)
            continue
        key, val = ov.split("=", 1)
        _set_path(cfg, key, _parse_value(val), allow_new=(mode == "+"))
    return resolve_interpolations(cfg)


def compose(config_name: str, overrides: Sequence[str] = ()) -> dict:
    """Compose from the package's built-in config tree."""
    return compose_from_root(default_config_root(), config_name, overrides)


# ---------------------------------------------------------------------------
# interpolation
# ---------------------------------------------------------------------------

_INTERP = re.compile(r"\$\{([^${}]+)\}")


def _lookup(root: Mapping, dotted: str) -> Any:
    node: Any = root
    for p in dotted.split("."):
        if not isinstance(node, Mapping) or p not in node:
            raise ConfigError(f"interpolation target not found: {dotted!r}")
        node = node[p]
    return node


def _resolve_str(root: Mapping, text: str, depth: int = 0) -> Any:
    if depth > 10:
        raise ConfigError(f"interpolation loop at {text!r}")
    m = _INTERP.fullmatch(text.strip())
    if m:  # whole-string interpolation keeps the native type
        return _resolve_node(root, _interp_value(root, m.group(1)), depth + 1)

    def repl(mm: re.Match) -> str:
        v = _resolve_node(root, _interp_value(root, mm.group(1)), depth + 1)
        return str(v)

    return _INTERP.sub(repl, text)


def _interp_value(root: Mapping, expr: str) -> Any:
    expr = expr.strip()
    if expr.startswith("env:") or expr.startswith("oc.env:"):
        name = expr.split(":", 1)[1]
        if "," in name:
            name, default = name.split(",", 1)
            return os.environ.get(name.strip(), default.strip())
        if name not in os.environ:
            raise ConfigError(f"environment variable not set: {name}")
        return os.environ[name]
    return _lookup(root, expr)


def _resolve_node(root: Mapping, node: Any, depth: int = 0) -> Any:
    if isinstance(node, str):
        return _resolve_str(root, node, depth)
    if isinstance(node, Mapping):
        return {k: _resolve_node(root, v, depth) for k, v in node.items()}
    if isinstance(node, list):
        return [_resolve_node(root, v, depth) for v in node]
    return node


def resolve_interpolations(cfg: dict) -> dict:
    return _resolve_node(cfg, cfg)


# ---------------------------------------------------------------------------
# instantiation
# ---------------------------------------------------------------------------

def _import_target(dotted: str) -> Callable:
    module, _, attr = dotted.rpartition(".")
    if not module:
        raise ConfigError(f"bad _target_: {dotted!r}")
    return getattr(importlib.import_module(module), attr)


def instantiate(node: Any, *, _recursive_: bool = True, **kwargs: Any) -> Any:
    """Build the object described by a ``_target_`` mapping."""
    if not isinstance(node, Mapping) or "_target_" not in node:
        raise ConfigError(f"instantiate needs a mapping with _target_: {node!r}")
    node = dict(node)
    target = _import_target(node.pop("_target_"))
    recursive = node.pop("_recursive_", _recursive_)
    args = {}
    for k, v in node.items():
        if recursive and isinstance(v, Mapping) and "_target_" in v:
            v = instantiate(v)
        args[k] = v
    args.update(kwargs)
    return target(**args)


def to_yaml(cfg: Mapping) -> str:
    """Block YAML of a composed config that :func:`.yaml_lite.safe_load`
    (and PyYAML) read back to the same dict."""
    return yaml_lite.dump(dict(cfg))


def asdict(obj: Any) -> dict:
    if dataclasses.is_dataclass(obj):
        return dataclasses.asdict(obj)
    return dict(obj)
