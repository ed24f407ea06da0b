"""Config loading: YAML/JSON with strict schema validation.

Reference: config/config.h:497-505 (LoadConfig + JSON-schema validation).
Unknown keys, wrong types, and out-of-range values are reported with their
dotted path, like the reference's embedded JSON-schema validator.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Type, TypeVar, get_args, get_origin, List

from .schema import Config
from ..utils.errors import ConfigError, ErrorCode

T = TypeVar("T")


def _coerce(value: Any, typ: Any, path: str) -> Any:
    origin = get_origin(typ)
    if origin is list:
        if not isinstance(value, list):
            raise ConfigError(f"{path}: expected list, got {type(value).__name__}")
        (item_t,) = get_args(typ)
        return [_coerce(v, item_t, f"{path}[{i}]") for i, v in enumerate(value)]
    if dataclasses.is_dataclass(typ):
        if not isinstance(value, dict):
            raise ConfigError(f"{path}: expected mapping, got {type(value).__name__}")
        return _from_dict_resolved(typ, value, path)
    if typ is bool:
        if isinstance(value, bool):
            return value
        raise ConfigError(f"{path}: expected bool, got {type(value).__name__}")
    if typ is int:
        if isinstance(value, bool) or not isinstance(value, int):
            raise ConfigError(f"{path}: expected int, got {type(value).__name__}")
        return value
    if typ is float:
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise ConfigError(f"{path}: expected number, got {type(value).__name__}")
        return float(value)
    if typ is str:
        if not isinstance(value, str):
            raise ConfigError(f"{path}: expected string, got {type(value).__name__}")
        return value
    # typing.Any / Optional passthrough
    return value


def load_config_from_dict(data: Dict[str, Any]) -> Config:
    if not isinstance(data, dict):
        raise ConfigError("configuration root must be a mapping")
    # Resolve string annotations (from __future__ import annotations)
    cfg = _from_dict_resolved(Config, data, "")
    cfg.validate()
    return cfg


def _from_dict_resolved(cls: Type[T], data: Dict[str, Any], path: str) -> T:
    import typing
    hints = typing.get_type_hints(cls)
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, value in data.items():
        if key not in fields:
            where = f"{path}.{key}" if path else key
            raise ConfigError(f"unknown configuration key: {where}")
        sub_path = f"{path}.{key}" if path else key
        typ = hints[key]
        origin = get_origin(typ)
        if dataclasses.is_dataclass(typ):
            if not isinstance(value, dict):
                raise ConfigError(
                    f"{sub_path}: expected mapping, got {type(value).__name__}")
            kwargs[key] = _from_dict_resolved(typ, value, sub_path)
        elif origin is list and dataclasses.is_dataclass(get_args(typ)[0]):
            if not isinstance(value, list):
                raise ConfigError(
                    f"{sub_path}: expected list, got {type(value).__name__}")
            item_t = get_args(typ)[0]
            kwargs[key] = [
                _from_dict_resolved(item_t, v, f"{sub_path}[{i}]")
                if isinstance(v, dict) else _raise_item(sub_path, i, v)
                for i, v in enumerate(value)]
        else:
            kwargs[key] = _coerce(value, typ, sub_path)
    return cls(**kwargs)


def _raise_item(path: str, i: int, v: Any) -> Any:
    raise ConfigError(f"{path}[{i}]: expected mapping, got {type(v).__name__}")


def load_config(path: str) -> Config:
    """Load and validate a YAML or JSON config file."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            raw = f.read()
    except OSError as e:
        raise ConfigError(f"cannot read config file {path}: {e}",
                          ErrorCode.CONFIG_PARSE)
    data: Any
    if path.endswith(".json"):
        try:
            data = json.loads(raw)
        except json.JSONDecodeError as e:
            raise ConfigError(f"invalid JSON in {path}: {e}", ErrorCode.CONFIG_PARSE)
    else:
        try:
            import yaml
            data = yaml.safe_load(raw)
        except Exception as e:
            raise ConfigError(f"invalid YAML in {path}: {e}", ErrorCode.CONFIG_PARSE)
    if data is None:
        data = {}
    return load_config_from_dict(data)


def config_to_dict(cfg: Config) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)
