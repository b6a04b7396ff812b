"""Metric / aggregation registries and bootstrap-stderr machinery.

Contract parity with reference src/data/metrics/_api.py:
  - ``METRICS`` / ``AGGREGATIONS`` registries of schema info records.
  - ``DEFAULT_METRICS_PER_OUTPUT_TYPE`` (reference :31-36).
  - bootstrap stderr with per-chunk seeded ``random.Random(i)`` resampling
    (reference :165-232) so stderr values reproduce exactly across machines.
"""

from __future__ import annotations

import math
import random
from collections.abc import Callable

from lmms_owc_tpu_torch.schema import AggregationInfo, MetricInfo
from lmms_owc_tpu_torch.utils import get_logger

log = get_logger(__name__)

__all__ = [
    "AGGREGATIONS",
    "DEFAULT_METRICS_PER_OUTPUT_TYPE",
    "METRICS",
    "get_aggregation",
    "get_aggregation_builder",
    "get_aggregation_info",
    "get_aggregations_info",
    "get_metric",
    "get_metric_builder",
    "get_metric_info",
    "get_metrics_info",
    "get_metric_stderr_builder",
    "register_aggregation",
    "register_metric",
    "mean_stderr",
    "sample_stddev",
]

AGGREGATIONS: dict[str, AggregationInfo] = {}
METRICS: dict[str, MetricInfo] = {}

DEFAULT_METRICS_PER_OUTPUT_TYPE = {
    "loglikelihood": ["perplexity", "acc"],
    "multiple_choice": ["acc", "acc_norm"],
    "generate_until": ["exact_match"],
    "generate_until_multi_round": ["exact_match"],
}


def register_aggregation(name: str | None = None, can_bootstrap: bool = False) -> Callable:
    def decorate(fn: Callable) -> Callable:
        agg_name = name or fn.__name__
        if agg_name in AGGREGATIONS:
            raise ValueError(f"aggregation {agg_name!r} already registered")
        AGGREGATIONS[agg_name] = AggregationInfo(
            name=agg_name, builder_fn=fn, can_bootstrap=can_bootstrap
        )
        return fn

    return decorate


def register_metric(
    name: str | None = None,
    group_fn_name: str = "mean",
    higher_is_better: bool = True,
    output_types: list[str] | None = None,
    can_bootstrap: bool = False,
) -> Callable:
    def decorate(fn: Callable) -> Callable:
        metric_name = name or fn.__name__
        if metric_name in METRICS:
            raise ValueError(f"metric {metric_name!r} already registered")
        METRICS[metric_name] = MetricInfo(
            name=metric_name,
            builder_fn=fn,
            group_fn_name=group_fn_name,
            higher_is_better=higher_is_better,
            output_types=output_types or ["generate_until"],
            can_bootstrap=can_bootstrap,
        )
        return fn

    return decorate


def get_metric_info(metric_id: str) -> MetricInfo:
    if metric_id not in METRICS:
        raise KeyError(f"unknown metric {metric_id!r}; available: {sorted(METRICS)}")
    return METRICS[metric_id]


def get_metrics_info() -> dict[str, MetricInfo]:
    return dict(METRICS)


def get_metric_builder(metric_id: str) -> Callable:
    return get_metric_info(metric_id).builder_fn


def get_metric(metric_id: str, **metric_kwargs):
    return get_metric_builder(metric_id)(**metric_kwargs)


def get_aggregation_info(aggregation_id: str) -> AggregationInfo:
    if aggregation_id not in AGGREGATIONS:
        raise KeyError(f"unknown aggregation {aggregation_id!r}; available: {sorted(AGGREGATIONS)}")
    return AGGREGATIONS[aggregation_id]


def get_aggregations_info() -> dict[str, AggregationInfo]:
    return dict(AGGREGATIONS)


def get_aggregation_builder(aggregation_id: str) -> Callable:
    return get_aggregation_info(aggregation_id).builder_fn


def get_aggregation(aggregation_id: str, **aggregation_kwargs):
    return get_aggregation_builder(aggregation_id)(**aggregation_kwargs)


# --------------------------------------------------------------------------------------
# Standard-error machinery
# --------------------------------------------------------------------------------------


def sample_stddev(arr: list) -> float:
    mu = sum(arr) / len(arr)
    return math.sqrt(sum((x - mu) ** 2 for x in arr) / (len(arr) - 1))


def mean_stderr(arr: list) -> float:
    return sample_stddev(arr) / math.sqrt(len(arr))


class _BootstrapChunk:
    """One seeded chunk of bootstrap resampling (chunk ``i`` seeds ``random.Random(i)``)."""

    def __init__(self, fn: Callable, n: int) -> None:
        self.fn = fn
        self.n = n

    def __call__(self, args: tuple) -> list:
        i, xs = args
        rnd = random.Random()
        rnd.seed(i)
        return [self.fn(rnd.choices(xs, k=len(xs))) for _ in range(self.n)]


def bootstrap_stderr(fn: Callable, xs: list, iters: int) -> float:
    """Bootstrapped stderr with deterministic per-chunk seeds.

    Identical resampling stream to the reference (chunked, chunk i seeded with i),
    computed sequentially or via a process pool depending on CPU availability.
    """
    import multiprocessing as mp

    chunk_size = min(1000, iters)
    chunk_args = [(i, xs) for i in range(iters // chunk_size)]
    chunk_fn = _BootstrapChunk(fn, chunk_size)
    res: list = []
    n_cpu = mp.cpu_count()
    if n_cpu > 1 and len(chunk_args) > 1:
        with mp.Pool(n_cpu) as pool:
            for chunk in pool.imap(chunk_fn, chunk_args):
                res.extend(chunk)
    else:
        for args in chunk_args:
            res.extend(chunk_fn(args))
    return sample_stddev(res)


def acc_all_stderr(items: list) -> float:
    """Grouped-question stderr for the acc_all metric."""
    question_scoring: dict[tuple, list] = {}
    preds = [p for p, _ in items]
    docs = [d for _, d in items]
    for doc, pred in zip(docs, preds):
        key = (doc["idx"]["paragraph"], doc["idx"]["question"])
        gold_label = doc["label"] == 1
        question_scoring.setdefault(key, []).append(gold_label == pred)
    return mean_stderr([int(all(x)) for x in question_scoring.values()])


def get_metric_stderr_builder(metric: Callable, bootstrap_iters: int) -> Callable | None:
    """Map an aggregation callable to its stderr estimator.

    ``mean`` gets the analytic stderr; ``acc_all`` its grouped variant; aggregations
    registered with ``can_bootstrap`` get seeded bootstrap; the rest get None.
    """
    from lmms_owc_tpu_torch.metrics._group import mean
    from lmms_owc_tpu_torch.metrics._instance import acc_all

    if bootstrap_iters <= 0:
        return None

    can_bootstrap_fns = [info.builder_fn for info in AGGREGATIONS.values() if info.can_bootstrap]
    can_bootstrap_fns += [info.builder_fn for info in METRICS.values() if info.can_bootstrap]

    if metric in can_bootstrap_fns:
        return lambda x: bootstrap_stderr(metric, x, iters=bootstrap_iters)

    return {mean: mean_stderr, acc_all: acc_all_stderr}.get(metric)
