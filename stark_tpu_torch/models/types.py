"""Validated fluent parameter base.

Reference: stark/src/models/types.h:8-53 — the STARK_PARAM
macro system generates validated fluent `set_`/`get_` builder methods on every
Params struct. Here a mixin provides the same surface generically for the
dataclass-based params.
"""
from __future__ import annotations


class FluentParams:
    """Adds `set_<field>(value) -> self` and `get_<field>()` builders."""

    def __getattr__(self, name):
        if name.startswith("set_"):
            field = name[4:]
            if field in getattr(self, "__dataclass_fields__", {}):
                def setter(value):
                    setattr(self, field, value)
                    return self
                return setter
        if name.startswith("get_"):
            field = name[4:]
            if field in getattr(self, "__dataclass_fields__", {}):
                return lambda: getattr(self, field)
        raise AttributeError(f"{type(self).__name__} has no attribute {name}")
