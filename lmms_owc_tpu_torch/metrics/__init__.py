"""Metrics: instance metrics, group aggregations, registries, bootstrap stderr."""

from lmms_owc_tpu_torch.metrics._api import (
    AGGREGATIONS,
    DEFAULT_METRICS_PER_OUTPUT_TYPE,
    METRICS,
    bootstrap_stderr,
    get_aggregation,
    get_aggregation_builder,
    get_aggregation_info,
    get_aggregations_info,
    get_metric,
    get_metric_builder,
    get_metric_info,
    get_metric_stderr_builder,
    get_metrics_info,
    mean_stderr,
    register_aggregation,
    register_metric,
    sample_stddev,
)
from lmms_owc_tpu_torch.metrics import _group, _instance  # noqa: F401  (populate registries)

__all__ = [
    "AGGREGATIONS",
    "DEFAULT_METRICS_PER_OUTPUT_TYPE",
    "METRICS",
    "bootstrap_stderr",
    "get_aggregation",
    "get_aggregation_builder",
    "get_aggregation_info",
    "get_aggregations_info",
    "get_metric",
    "get_metric_builder",
    "get_metric_info",
    "get_metric_stderr_builder",
    "get_metrics_info",
    "mean_stderr",
    "register_aggregation",
    "register_metric",
    "sample_stddev",
]
