"""Typed config-model helpers.

Port of ``deepspeed_tpu/runtime/config_utils.py`` (a plain copy: the JAX
module has no jax import). Each config block is a dataclass hydrated from
a (possibly partial) dict, with unknown-key detection. "auto" values are
scrubbed to the field defaults at ingestion (config.py ``_scrub_auto``).
"""

import dataclasses
from dataclasses import fields
from typing import Any, Dict, Optional, Type, TypeVar

T = TypeVar("T")

AUTO = "auto"


class ConfigError(ValueError):
    pass


def hydrate(cls: Type[T], data: Optional[Dict[str, Any]], path: str = "") -> T:
    """Build dataclass `cls` from dict `data`, recursing into nested dataclasses.

    Unknown keys raise ConfigError (the reference's strict pydantic models).
    """
    data = dict(data or {})
    kwargs = {}
    field_map = {f.name: f for f in fields(cls)}  # type: ignore[arg-type]
    for key, value in data.items():
        if key not in field_map:
            raise ConfigError(f"Unknown config key '{path}{key}' for {cls.__name__}")
        f = field_map[key]
        ftype = f.type
        if dataclasses.is_dataclass(ftype) and isinstance(value, dict):
            kwargs[key] = hydrate(ftype, value, path=f"{path}{key}.")
        elif isinstance(f.default, _SubConfig) and isinstance(value, dict):
            kwargs[key] = hydrate(f.default.cls, value, path=f"{path}{key}.")
        else:
            kwargs[key] = value
    obj = cls(**kwargs)  # type: ignore[call-arg]
    # replace _SubConfig placeholders for omitted nested blocks
    for f in fields(cls):  # type: ignore[arg-type]
        val = getattr(obj, f.name)
        if isinstance(val, _SubConfig):
            setattr(obj, f.name, hydrate(val.cls, {}, path=f"{path}{f.name}."))
    return obj


class _SubConfig:
    """Default marker for a nested config block (instantiated empty if absent)."""

    def __init__(self, cls):
        self.cls = cls


def subconfig(cls):
    return dataclasses.field(default_factory=lambda: hydrate(cls, {}))


def as_dict(obj) -> Dict[str, Any]:
    if dataclasses.is_dataclass(obj):
        return {f.name: as_dict(getattr(obj, f.name)) for f in fields(obj)}
    if isinstance(obj, (list, tuple)):
        return type(obj)(as_dict(x) for x in obj)
    return obj
