"""Task / group configuration dataclasses — the YAML schema.

Contract parity with reference src/data/tasks/_config.py:14-248: field names, defaults,
and __post_init__ normalization (group->tag migration, generation_kwargs defaults).
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field, fields
from inspect import getsource
from typing import Any, Callable

from lmms_owc_tpu_torch.utils import get_logger

log = get_logger(__name__)

__all__ = ["AggregationConfig", "GroupConfig", "TaskConfig"]


class _DictLike(dict):
    """Mixin giving dataclasses dict-style getitem/setitem over attributes."""

    def __getitem__(self, item: str) -> Any:
        return getattr(self, item)

    def __setitem__(self, item: str, value: Any) -> None:
        setattr(self, item, value)


def _serialize_function(value: Callable | str, keep_callable: bool = False) -> Callable | str:
    if keep_callable:
        return value
    try:
        return getsource(value)
    except (TypeError, OSError):
        return str(value)


@dataclass
class AggregationConfig(_DictLike):
    """Group-level aggregate-metric entry (only "mean" is supported)."""

    metric: str | None = None
    aggregation: str | None = "mean"
    weight_by_size: bool | None = False
    filter_list: str | list | None = "none"

    def __post_init__(self) -> None:
        if self.aggregation != "mean" and not callable(self.aggregation):
            raise ValueError(
                "'mean' is the only predefined aggregation across groups' subtasks;"
                f" got {self.aggregation!r}"
            )
        if isinstance(self.filter_list, str):
            self.filter_list = [self.filter_list]


@dataclass
class GroupConfig(_DictLike):
    """Group configuration: named collection of subtasks with optional aggregate metrics."""

    group: str | None = None
    group_alias: str | None = None
    task: str | list | None = None
    aggregate_metric_list: list | AggregationConfig | dict | None = None
    metadata: dict | None = None

    def __post_init__(self) -> None:
        if self.aggregate_metric_list is not None:
            if isinstance(self.aggregate_metric_list, dict):
                self.aggregate_metric_list = list(self.aggregate_metric_list)
            self.aggregate_metric_list = [
                AggregationConfig(**item) if isinstance(item, dict) else item
                for item in self.aggregate_metric_list
            ]

    def to_dict(self, keep_callable: bool = False) -> dict:
        cfg = asdict(self)
        for key, value in list(cfg.items()):
            if callable(value):
                cfg[key] = _serialize_function(value, keep_callable=keep_callable)
        return cfg


@dataclass
class TaskConfig(_DictLike):
    """Task configuration — every key a task YAML may define."""

    task: str | None = None
    task_alias: str | None = None
    tag: str | None = None
    group: str | None = None
    group_alias: str | list | None = None

    # Dataset options
    dataset_path: str | None = None
    dataset_name: str | None = None
    dataset_kwargs: dict | None = None
    training_split: str | None = None
    validation_split: str | None = None
    test_split: str | None = None
    fewshot_split: str | None = None
    full_docs: bool = False

    # Formatting and prompting options
    process_results_use_image: bool = False
    process_docs: Callable | None = None
    doc_to_visual: Callable | str | None = None
    doc_to_text: Callable | str | None = None
    doc_to_target: Callable | str | None = None
    doc_to_choice: Callable | str | dict | list | None = None
    process_results: Callable | str | None = None
    use_prompt: str | None = None
    description: str = ""
    target_delimiter: str = " "
    fewshot_delimiter: str = "\n\n"
    fewshot_config: dict | None = None

    # Runtime options
    num_fewshot: int | None = None

    # Scoring options
    metric_list: list | None = None
    output_type: str = "generate_until"
    generation_kwargs: dict | None = None
    repeats: int = 1
    filter_list: str | list | None = None
    should_decontaminate: bool = False
    doc_to_decontamination_query: str | None = None

    metadata: str | list | dict | None = None

    model_specific_kwargs: dict | None = None
    model_specific_generation_kwargs: dict | None = None
    model_specific_target_kwargs: dict | None = None

    def __post_init__(self) -> None:
        if self.group is not None:
            log.warning(
                "Task %s uses the deprecated `group` key inside a task config;"
                " treating it as `tag`. Use a separate group config for aggregation.",
                self.task,
            )
            if self.tag is None:
                self.tag = self.group
            else:
                raise ValueError("got both `group` and `tag` in a TaskConfig; use only `tag`")

        if self.generation_kwargs is not None:
            if "generate_until" not in self.output_type:
                raise ValueError(
                    f"task {self.task} has generation_kwargs but output_type is not generate_until"
                )
            if "temperature" in self.generation_kwargs:
                self.generation_kwargs["temperature"] = float(self.generation_kwargs["temperature"])
            if "until" not in self.generation_kwargs:
                self.generation_kwargs["until"] = [self.fewshot_delimiter]
        elif "generate_until" in self.output_type:
            # Greedy generation by default.
            self.generation_kwargs = {
                "until": None if self.fewshot_delimiter is None else [self.fewshot_delimiter],
                "do_sample": False,
            }

    def to_dict(self) -> dict:
        """Dump as a printable dict: drops None fields, stringifies callables."""
        cfg = asdict(self)
        for key, value in list(cfg.items()):
            if value is None:
                cfg.pop(key)
            elif callable(value):
                cfg[key] = str(value)
        return cfg


TASK_CONFIG_KEYS = [f.name for f in fields(TaskConfig)]
GROUP_ONLY_KEYS = [f.name for f in fields(GroupConfig)]
