"""Task system: YAML-driven tasks, groups, tags, and result consolidation."""

from lmms_owc_tpu_torch.tasks._api import (
    get_consolidated_group_results,
    get_consolidated_results,
    get_subtasks_as_dict,
    get_tasks_as_dict,
    get_tasks_as_list,
    prepare_print_tasks,
)
from lmms_owc_tpu_torch.tasks._base import Task, TaskInstance, TaskOutput
from lmms_owc_tpu_torch.tasks._config import AggregationConfig, GroupConfig, TaskConfig
from lmms_owc_tpu_torch.tasks._manager import (
    ALL_OUTPUT_TYPES,
    ConfigurableGroup,
    ConfigurableTask,
    TaskManager,
)

__all__ = [
    "ALL_OUTPUT_TYPES",
    "AggregationConfig",
    "ConfigurableGroup",
    "ConfigurableTask",
    "GroupConfig",
    "Task",
    "TaskConfig",
    "TaskInstance",
    "TaskManager",
    "TaskOutput",
    "get_consolidated_group_results",
    "get_consolidated_results",
    "get_subtasks_as_dict",
    "get_tasks_as_dict",
    "get_tasks_as_list",
    "prepare_print_tasks",
]
