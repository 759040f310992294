"""Dataclass config base (counterpart of ``deepspeed_tpu/config/config_utils.py``).

The JAX package's config sections are pydantic models; the port keeps their
field names and defaults as plain ``dataclasses`` so it needs nothing beyond
the standard library. ``from_dict`` builds a section from a JSON-style dict
and raises on a key the section does not define, so a typo or a setting the
port does not carry is never silently ignored. The ``"auto"`` sentinel keeps
its meaning: the field's default applies.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Type, TypeVar

AUTO_VALUE = "auto"

T = TypeVar("T", bound="DeepSpeedConfigModel")


@dataclasses.dataclass
class DeepSpeedConfigModel:
    """Base for the port's config sections (subclasses are dataclasses)."""

    @classmethod
    def from_dict(cls: Type[T], data: Mapping[str, Any]) -> T:
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(data) - names)
        if unknown:
            raise ValueError(
                f"{cls.__name__}: unknown config key(s) {unknown}; "
                f"known keys are {sorted(names)}")
        return cls(**{k: v for k, v in data.items() if v != AUTO_VALUE})
