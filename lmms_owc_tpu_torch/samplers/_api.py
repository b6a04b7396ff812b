"""Sampler base class and registry (parity: reference src/data/samplers/_base.py, _api.py)."""

from __future__ import annotations

from collections.abc import Callable

from lmms_owc_tpu_torch.schema import SamplerInfo

__all__ = [
    "SAMPLERS",
    "Sampler",
    "get_sampler",
    "get_sampler_builder",
    "get_sampler_info",
    "get_samplers_info",
    "register_sampler",
]

SAMPLERS: dict[str, SamplerInfo] = {}


class Sampler:
    """Base sampler for few-shot context docs."""

    def __init__(self, *args, **kwargs) -> None:
        pass

    def sample(self, n_samples: int) -> list:
        raise NotImplementedError


def register_sampler(name: str | None = None) -> Callable:
    def decorate(cls):
        sampler_name = name or cls.__name__.lower()
        SAMPLERS[sampler_name] = SamplerInfo(name=sampler_name, sampler_cls=cls)
        return cls

    return decorate


def get_sampler_info(sampler_id: str) -> SamplerInfo:
    if sampler_id not in SAMPLERS:
        raise KeyError(f"unknown sampler {sampler_id!r}; available: {sorted(SAMPLERS)}")
    return SAMPLERS[sampler_id]


def get_sampler_builder(sampler_id: str) -> Callable:
    return get_sampler_info(sampler_id).sampler_cls


def get_sampler(sampler_id: str, **sampler_kwargs) -> Sampler:
    return get_sampler_builder(sampler_id)(**sampler_kwargs)


def get_samplers_info() -> list[SamplerInfo]:
    return list(SAMPLERS.values())
