"""Registry records of the port (counterpart of :mod:`lmms_owc_tpu.schema`).

The records of the port's registries (models, metrics, aggregations, filters,
samplers), with the JAX package's fields and defaults, as dataclasses.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

__all__ = ["AggregationInfo", "FilterInfo", "MetricInfo", "ModelInfo", "SamplerInfo"]


@dataclasses.dataclass
class ModelInfo:
    """Registry record for a model adapter."""

    name: str
    model_cls: Any = dataclasses.field(repr=False)
    description: str = ""


@dataclasses.dataclass
class MetricInfo:
    """Registry record for an instance metric.

    Attributes:
        builder_fn: the per-instance metric callable.
        group_fn_name: name of the registered aggregation used to reduce samples.
        higher_is_better: direction for leaderboard arrows/comparisons.
        output_types: which task output types this metric applies to.
        can_bootstrap: whether bootstrap stderr is meaningful for this metric.
    """

    name: str
    builder_fn: Callable | None = dataclasses.field(default=None, repr=False)
    group_fn_name: str = "mean"
    higher_is_better: bool = True
    output_types: list[str] = dataclasses.field(default_factory=lambda: ["generate_until"])
    can_bootstrap: bool = False

    @property
    def group_fn(self) -> Callable:
        from lmms_owc_tpu_torch.metrics._api import get_aggregation_info

        return get_aggregation_info(self.group_fn_name).builder_fn


@dataclasses.dataclass
class AggregationInfo:
    """Registry record for a group aggregation function."""

    name: str
    builder_fn: Callable = dataclasses.field(repr=False)
    can_bootstrap: bool = False


@dataclasses.dataclass
class FilterInfo:
    name: str
    filter_cls: Any = dataclasses.field(repr=False)
    description: str = ""


@dataclasses.dataclass
class SamplerInfo:
    name: str
    sampler_cls: Any = dataclasses.field(repr=False)
