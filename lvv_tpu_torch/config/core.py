"""Typed configuration: frozen dataclasses, dotted overrides, JSON files
with recursive `_base_` inheritance, and round-trip serialisation
(counterpart of lvv_tpu/config/core.py).

A config file written by either package's `save` is read by the other's
`load`. Only JSON is read: a `.yaml` / `.yml` file raises.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import typing
from typing import Any, Mapping, Sequence, Type, TypeVar

T = TypeVar("T")

_BASE_KEY = "_base_"


def config(cls: Type[T]) -> Type[T]:
    """Decorator: a frozen config dataclass."""
    return dataclasses.dataclass(frozen=True)(cls)


def to_dict(cfg: Any) -> Any:
    """Recursively convert a config dataclass tree to plain dicts/lists."""
    if dataclasses.is_dataclass(cfg) and not isinstance(cfg, type):
        return {f.name: to_dict(getattr(cfg, f.name))
                for f in dataclasses.fields(cfg)}
    if isinstance(cfg, (list, tuple)):
        return [to_dict(v) for v in cfg]
    if isinstance(cfg, Mapping):
        return {k: to_dict(v) for k, v in cfg.items()}
    return cfg


def from_dict(cls: Type[T], data: Mapping[str, Any]) -> T:
    """Build a config dataclass tree from nested dicts. Keys starting with
    "_" (comments) are skipped; any other unknown key raises KeyError."""
    if not dataclasses.is_dataclass(cls):
        return data  # leaf passthrough
    field_map = {f.name: f for f in dataclasses.fields(cls)}
    kwargs: dict[str, Any] = {}
    for k, v in data.items():
        if k.startswith("_"):
            continue
        if k not in field_map:
            raise KeyError(f"unknown config key {k!r} for {cls.__name__}; "
                           f"valid keys: {sorted(field_map)}")
        f = field_map[k]
        ftype = (f.type if isinstance(f.type, type)
                 else typing.get_type_hints(cls).get(f.name, object))
        if dataclasses.is_dataclass(ftype) and isinstance(v, Mapping):
            kwargs[k] = from_dict(ftype, v)
        elif isinstance(v, list):
            kwargs[k] = tuple(v) if "uple" in str(f.type) else v
        else:
            kwargs[k] = v
    return cls(**kwargs)


def replace(cfg: T, **updates: Any) -> T:
    return dataclasses.replace(cfg, **updates)


def override(cfg: T, path: str, value: Any) -> T:
    """A copy of `cfg` with the dotted `path` replaced by `value`."""
    head, _, rest = path.partition(".")
    if not rest:
        return dataclasses.replace(cfg, **{head: value})
    return dataclasses.replace(
        cfg, **{head: override(getattr(cfg, head), rest, value)})


def apply_overrides(cfg: T, pairs: Sequence[str]) -> T:
    """Apply ``key.path=value`` strings (values parsed as JSON, else str)."""
    for pair in pairs:
        path, _, raw = pair.partition("=")
        try:
            value = json.loads(raw)
        except json.JSONDecodeError:
            value = raw
        cfg = override(cfg, path.strip(), value)
    return cfg


def load_file(path: str | pathlib.Path) -> dict:
    """Load a JSON config dict, merging it over its `_base_` file (a path
    relative to it, itself loaded the same way): the child's keys win."""
    path = pathlib.Path(path)
    if path.suffix in (".yaml", ".yml"):
        raise ValueError(f"{path}: the port reads JSON config files only")
    data = json.loads(path.read_text())
    base_ref = data.pop(_BASE_KEY, None)
    if base_ref is not None:
        data = deep_merge(load_file((path.parent / base_ref).resolve()), data)
    return data


def deep_merge(base: dict, child: dict) -> dict:
    out = dict(base)
    for k, v in child.items():
        if k in out and isinstance(out[k], Mapping) and isinstance(v, Mapping):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def load(cls: Type[T], path: str | pathlib.Path,
         overrides: Sequence[str] = ()) -> T:
    return apply_overrides(from_dict(cls, load_file(path)), overrides)


def save(cfg: Any, path: str | pathlib.Path) -> None:
    pathlib.Path(path).write_text(json.dumps(to_dict(cfg), indent=2))
