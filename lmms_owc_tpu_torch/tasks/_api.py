"""Results consolidation and task-dict helpers.

Contract parity with reference src/data/tasks/_api.py: per-task consolidation
(:185-229), recursive group aggregation with size-weighted mean + pooled stderr
(:60-182), subtask-dict extraction and competing-group detection (:232-325), task-dict
loading (:328-395), and indented print-table preparation (:419-507).
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from lmms_owc_tpu_torch.tasks._base import Task, TaskOutput
from lmms_owc_tpu_torch.tasks._manager import ConfigurableGroup, TaskManager

__all__ = [
    "get_consolidated_group_results",
    "get_consolidated_results",
    "get_subtasks_as_dict",
    "get_tasks_as_dict",
    "get_tasks_as_list",
    "prepare_print_tasks",
]


def _aggregate_subtask_metrics(metrics: list, sizes: list, weight_by_size: bool = True) -> float:
    if not weight_by_size:
        sizes = [1] * len(sizes)
    if len(metrics) != len(sizes):
        raise ValueError("metrics and sizes must be the same length")
    return sum(m * s for m, s in zip(metrics, sizes)) / sum(sizes)


def _pooled_sample_stderr(std_errs: list[float], sizes: list[int]) -> float:
    """Pooled-variance stderr across subtasks (assumes mean aggregation)."""
    if len(std_errs) != len(sizes):
        raise ValueError("stderrs and sizes must be the same length")
    pooled_sample_var = sum(
        (size - 1) * stderr**2 * size for size, stderr in zip(sizes, std_errs)
    ) / (sum(sizes) - len(sizes))
    return float(np.sqrt(pooled_sample_var / sum(sizes)))


def get_consolidated_group_results(
    results: dict,
    versions: dict,
    task_dict: dict,
    task_root: str | None = None,
    show_group_table: bool = False,
    task_aggregation_list: dict | None = None,
) -> tuple[dict, dict, bool, dict | None]:
    """Recursively compute group-level aggregate metrics into ``results``."""
    if task_root is None:
        task_root = {}
    if task_aggregation_list is None:
        task_aggregation_list = {}

    for group_or_task, info in task_dict.items():
        if isinstance(group_or_task, ConfigurableGroup):
            group_config = group_or_task.config
            group_or_task = group_or_task.group_name
        else:
            group_config = None

        if isinstance(info, Task):
            if task_root:
                task_aggregation_list.setdefault(task_root, []).append(info.task_name)
            continue

        results, versions, show_group_table, _task_aggregation_list = (
            get_consolidated_group_results(
                results, versions, info, group_or_task, show_group_table, task_aggregation_list
            )
        )
        if task_root:
            task_aggregation_list.setdefault(task_root, []).extend(
                task_aggregation_list.get(group_or_task, [])
            )

        if (group_config is None) or (group_config["aggregate_metric_list"] is None):
            results[group_or_task][" "] = " "
            continue

        agg_metric_list = group_config["aggregate_metric_list"]
        show_group_table = show_group_table | bool(agg_metric_list)
        task_list = _task_aggregation_list[group_or_task]

        metric_list = list(
            {
                key
                for task in task_list
                for key in results[task]
                if "_stderr" not in key and key not in ["task", "alias", "samples"]
            }
        )
        for metric in metric_list:
            stderr = "_stderr,".join(metric.split(","))
            metrics = [results[task][metric] for task in task_list if metric in results[task]]
            stderrs = [results[task][stderr] for task in task_list if stderr in results[task]]
            sizes = [results[task]["samples"] for task in task_list if metric in results[task]]

            for metric_config in agg_metric_list:
                for _ in metric_config["filter_list"]:
                    if metric_config["metric"] not in metric:
                        continue
                    if metric_config["aggregation"] == "mean":
                        aggregate_fn = _aggregate_subtask_metrics
                    elif callable(metric_config["aggregation"]):
                        aggregate_fn = metric_config["aggregation"]
                    else:
                        raise ValueError(
                            "only 'mean' is supported for group aggregation;"
                            f" got {metric_config['aggregation']!r} for group {group_or_task!r}"
                        )
                    results[group_or_task][metric] = aggregate_fn(
                        metrics, sizes, metric_config["weight_by_size"]
                    )
                    if "N/A" in stderrs:
                        results[group_or_task][stderr] = "N/A"
                    else:
                        results[group_or_task][stderr] = _pooled_sample_stderr(stderrs, sizes)

            results[group_or_task]["samples"] = sum(sizes)
            group_metadata = group_config.get("metadata", None)
            if group_metadata is not None:
                versions[group_or_task] = group_metadata.get("version", None)

    return results, versions, show_group_table, task_aggregation_list


def get_consolidated_results(
    eval_tasks: list[TaskOutput],
) -> tuple[dict, dict, dict, dict, dict, dict]:
    """Consolidate TaskOutputs into results/samples/configs/versions/n-shot/hib dicts."""
    results: dict = defaultdict(dict)
    samples: dict = defaultdict(list)
    num_fewshot: dict = defaultdict(int)
    configs: dict = defaultdict(dict)
    versions: dict = defaultdict(dict)
    higher_is_better: dict = defaultdict(dict)

    for task_output in eval_tasks:
        task_config = task_output.task_config
        if "task_alias" in task_config:
            results[task_output.task_name]["alias"] = task_config["task_alias"]
        else:
            results[task_output.task_name]["alias"] = task_output.task_name

        if group_alias := task_output.group_alias:
            if group_alias not in results and (group_name := task_output.group_name):
                results[group_name]["alias"] = group_alias

        num_fewshot[task_output.task_name] = task_output.n_shot
        configs[task_output.task_name] = task_output.task_config
        versions[task_output.task_name] = task_output.version
        samples[task_output.task_name] = task_output.logged_samples
        higher_is_better[task_output.task_name] = task_output.task.higher_is_better()

        for (metric, filter_key), _ in task_output.sample_metrics.items():
            metric_key = f"{metric},{filter_key}"
            results[task_output.task_name][metric_key] = task_output.agg_metrics[metric_key]
            results[task_output.task_name]["samples"] = task_output.sample_len
            results[task_output.task_name][f"{metric}_stderr,{filter_key}"] = (
                task_output.agg_metrics[f"{metric}_stderr,{filter_key}"]
            )

    return results, samples, configs, versions, num_fewshot, higher_is_better


def get_subtasks_as_dict(task_dict: dict, task_root: str | None = None, depth: int = 0) -> dict:
    """Map each group name to its (direct) subtask names."""
    subtasks_dict: dict = {}
    for group_obj, task_obj in task_dict.items():
        group_name = group_obj.group_name if isinstance(group_obj, ConfigurableGroup) else group_obj
        if isinstance(task_obj, dict):
            _subtasks = get_subtasks_as_dict(task_obj, task_root=group_name, depth=depth + 1)
            if task_root:
                subtasks_dict.setdefault((task_root, depth), []).extend(
                    task for (task, d) in _subtasks if (d - 1) == depth
                )
            subtasks_dict = {**subtasks_dict, **_subtasks}
        else:
            if isinstance(task_obj, ConfigurableGroup):
                name = task_obj.group_name
            elif isinstance(task_obj, Task):
                name = task_obj.task_name
            else:
                name = group_name
            if task_root is None:
                subtasks_dict.setdefault((name, depth), [])
            else:
                subtasks_dict.setdefault((task_root, depth), []).append(name)

    if depth == 0:
        subtasks_dict = {group_name: task_list for (group_name, _), task_list in subtasks_dict.items()}
    return subtasks_dict


def _get_task_name_from_object(task_object) -> str:
    if hasattr(task_object, "config"):
        return task_object._config["task"]
    return (
        task_object.EVAL_HARNESS_NAME
        if hasattr(task_object, "EVAL_HARNESS_NAME")
        else type(task_object).__name__
    )


def _check_duplicates(task_dict: dict) -> None:
    subtask_names: list = []
    for value in task_dict.values():
        subtask_names.extend(value)
    duplicates = {name for name in subtask_names if subtask_names.count(name) > 1}
    competing = [g for g in task_dict if set(task_dict[g]) & duplicates]
    if duplicates:
        raise ValueError(
            f"found tasks belonging to more than one called group: {sorted(duplicates)};"
            f" offending groups: {competing}. Evaluate overlapping groups in separate runs."
        )


def get_tasks_as_dict(
    task_name_list: str | list,
    task_manager: TaskManager | None = None,
) -> dict:
    """Load a (possibly mixed str/dict/Task) task list into a nested task dict."""
    if isinstance(task_name_list, str):
        task_name_list = [task_name_list]
    elif isinstance(task_name_list, list):
        if not all(isinstance(t, (str, dict, Task)) for t in task_name_list):
            raise TypeError("expected list items of type str, dict, or Task")
    else:
        raise TypeError(f"expected str or list, got {type(task_name_list)}")

    string_names = [t for t in task_name_list if isinstance(t, str)]
    other_items = [t for t in task_name_list if not isinstance(t, str)]

    from_strings: dict = {}
    if string_names:
        if task_manager is None:
            task_manager = TaskManager()
        from_strings = task_manager.load_task_or_group(string_names)
    if task_manager is None:
        raise ValueError("task_manager cannot be None")

    from_configs: dict = {}
    from_objects: dict = {}
    for item in other_items:
        if isinstance(item, dict):
            from_configs = {**from_configs, **task_manager.load_config(config=item)}
        elif isinstance(item, Task):
            from_objects[_get_task_name_from_object(item)] = item

    if set(from_strings) & set(from_objects):
        raise ValueError("task names from string and object are overlapping")

    final = {**from_strings, **from_configs, **from_objects}
    _check_duplicates(get_subtasks_as_dict(final))
    return final


def get_tasks_as_list(task_dict: dict) -> list[TaskOutput]:
    """Flatten a nested task dict into TaskOutput objects."""
    outputs: list[TaskOutput] = []
    for task_name, task_obj in task_dict.items():
        if isinstance(task_obj, dict):
            outputs.extend(get_tasks_as_list(task_obj))
        else:
            outputs.append(TaskOutput.from_task_dict(task_name, task_obj))
    return outputs


def prepare_print_tasks(
    task_dict: dict, results: dict, task_depth: int = 0, group_depth: int = 0
) -> tuple[dict, dict]:
    """Build indented task/group aggregation tables for printing."""

    def _sort(d: dict) -> dict:
        return dict(
            sorted(
                d.items(),
                key=lambda item: item[0].group_name
                if isinstance(item[0], ConfigurableGroup)
                else item[0],
            )
        )

    task_agg: dict = defaultdict(dict)
    group_agg: dict = defaultdict(dict)
    task_dict = _sort(task_dict)
    for key, obj in task_dict.items():
        tab_string = " " * task_depth + "- " if task_depth > 0 else ""
        if isinstance(key, ConfigurableGroup):
            name = key.group_name
            from_group = True
            obj = _sort(obj)
        else:
            name = obj.task_name if isinstance(obj, Task) else key
            from_group = False

        task_agg[name] = results[name].copy()
        if from_group:
            alias = key.group_alias if key.group_alias is not None else key.group
        else:
            alias = task_agg[name].get("alias", name)
        task_agg[name]["alias"] = tab_string + alias
        task_agg[name].pop("samples", None)

        if from_group and (" " not in results[name]):
            group_tab = " " * group_depth + "- " if group_depth > 0 else ""
            group_agg[name] = results[name].copy()
            group_agg[name]["alias"] = group_tab + alias
            group_agg[name].pop("samples", None)

        if isinstance(obj, dict):
            _task_agg, _group_agg = prepare_print_tasks(obj, results, task_depth + 1, group_depth + 1)
            task_agg = {**task_agg, **_task_agg}
            group_agg = {**group_agg, **_group_agg}

    return task_agg, group_agg
