"""Typed config trees: frozen dataclasses with `from_dict`/`to_dict`."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Type, TypeVar

T = TypeVar("T")


def from_dict(cls: Type[T], d: Dict[str, Any]) -> T:
    """Build a (possibly nested) dataclass from a plain dict, ignoring
    unknown keys and recursing into dataclass-typed fields."""
    if not dataclasses.is_dataclass(cls):
        return d  # type: ignore[return-value]
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in d.items():
        if k not in fields:
            continue
        ftype = fields[k].type
        if isinstance(ftype, str):
            ftype = None  # postponed annotations; accept as-is
        if ftype is not None and dataclasses.is_dataclass(ftype) and isinstance(v, dict):
            v = from_dict(ftype, v)
        kwargs[k] = v
    return cls(**kwargs)


def to_dict(obj) -> Dict[str, Any]:
    return dataclasses.asdict(obj)
