"""Filter base classes and registry (parity: reference src/data/filters/_base.py, _api.py)."""

from __future__ import annotations

from typing import Callable, Iterable

from lmms_owc_tpu_torch.schema import FilterInfo
from lmms_owc_tpu_torch.utils import get_logger

log = get_logger(__name__)

__all__ = [
    "FILTERS",
    "Filter",
    "FilterEnsemble",
    "get_filter",
    "get_filters_ensemble",
    "register_filter",
]

FILTERS: dict[str, FilterInfo] = {}


class Filter:
    """Transforms the responses of all instances of a task.

    ``apply`` receives a list (one element per instance) of response lists (one
    element per repeat) and returns the same nested structure.
    """

    def __init__(self, *args, **kwargs) -> None:
        pass

    def apply(self, responses: list, docs: list | None = None) -> Iterable:
        return responses


class FilterEnsemble:
    """Chain of filters writing ``instance.filtered_resps[name]``."""

    def __init__(self, name: str, filters: list[Filter]) -> None:
        self.name = name
        self.filters = filters

    def apply(self, instances: list, docs: list | None = None) -> None:
        responses = [inst.resps for inst in instances]
        for f in self.filters:
            responses = f.apply(responses, docs)
        for inst, response in zip(instances, list(responses)):
            inst.filtered_resps[self.name] = response


def register_filter(name: str) -> Callable:
    def decorate(cls):
        if name in FILTERS:
            raise ValueError(f"filter {name!r} already registered")
        FILTERS[name] = FilterInfo(name=name, filter_cls=cls, description=(cls.__doc__ or "").split("\n")[0])
        return cls

    return decorate


def get_filter(name: str) -> type:
    if name not in FILTERS:
        raise KeyError(f"unknown filter {name!r}; available: {sorted(FILTERS)}")
    return FILTERS[name].filter_cls


def get_filters_ensemble(name: str, components: list[tuple]) -> FilterEnsemble:
    """Build a named ensemble from ``[(filter_name_or_class, kwargs), ...]``.

    Task YAMLs may pass a custom filter class via ``!function`` instead of a
    registered name (e.g. the example tasks' CustomMultiChoiceRegexFilter).
    """
    filters = []
    for fname, kwargs in components:
        cls = fname if callable(fname) else get_filter(fname)
        filters.append(cls(**(kwargs or {})))
    return FilterEnsemble(name=name, filters=filters)
