"""Few-shot context samplers (parity surface: reference src/data/samplers/)."""

from lmms_owc_tpu_torch.samplers._api import (
    SAMPLERS,
    Sampler,
    get_sampler,
    get_sampler_builder,
    get_sampler_info,
    get_samplers_info,
    register_sampler,
)
from lmms_owc_tpu_torch.samplers._context import ContextSampler, FirstNSampler

__all__ = [
    "SAMPLERS",
    "ContextSampler",
    "FirstNSampler",
    "Sampler",
    "get_sampler",
    "get_sampler_builder",
    "get_sampler_info",
    "get_samplers_info",
    "register_sampler",
]
