"""Transformation filters: lowercase, uppercase, map.

Behavior parity with reference src/data/filters/_transformation.py:1-113.
"""

from __future__ import annotations

from lmms_owc_tpu_torch.filters._api import Filter, register_filter

__all__ = ["LowercaseFilter", "UppercaseFilter", "MapFilter"]


@register_filter("lowercase")
class LowercaseFilter(Filter):
    """Lowercase every response."""

    def apply(self, responses: list, docs: list | None = None) -> list:
        return [[resp.lower() for resp in inst] for inst in responses]


@register_filter("uppercase")
class UppercaseFilter(Filter):
    """Uppercase every response."""

    def apply(self, responses: list, docs: list | None = None) -> list:
        return [[resp.upper() for resp in inst] for inst in responses]


@register_filter("map")
class MapFilter(Filter):
    """Map responses through a dict with a default for misses."""

    def __init__(self, mapping_dict: dict | None = None, default_value=None) -> None:
        self.mapping_dict = mapping_dict or {}
        self.default_value = default_value

    def apply(self, responses: list, docs: list | None = None) -> list:
        return [
            [self.mapping_dict.get(resp, self.default_value) for resp in inst]
            for inst in responses
        ]
