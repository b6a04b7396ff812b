"""Task base classes: TaskInstance (one model request), Task ABC, TaskOutput
(the JAX package's ``tasks._base``).

Contract parity with reference src/data/tasks/_base.py: request lifecycle, rank/world
sharded request building with a dill request cache (``doc_to_visual`` is restored after
cache loads since callables don't serialize), and aggregate-metric computation with
bootstrap stderr (bleu/chrf/ter capped at 100 iterations).
"""

from __future__ import annotations

import abc
import inspect
import random
from collections import defaultdict
from collections.abc import Callable, Iterator
from dataclasses import dataclass, field
from itertools import islice
from typing import Any

from lmms_owc_tpu_torch import utils
from lmms_owc_tpu_torch.filters import get_filters_ensemble
from lmms_owc_tpu_torch.metrics import get_metric_builder, get_metric_info, get_metric_stderr_builder
from lmms_owc_tpu_torch.tasks._config import TaskConfig

__all__ = ["Task", "TaskInstance", "TaskOutput"]

log = utils.get_logger(__name__)


@dataclass
class TaskInstance:
    """One request to the model.

    ``arguments`` layout per request type (positions matter; index 2 is always the
    ``doc_to_visual`` callable so it can be dropped/restored around pickling):
      - loglikelihood:          (ctx, doc_to_target, doc_to_visual, doc_id, task, split)
      - multiple_choice:        loglikelihood per choice
      - generate_until:         (ctx, gen_kwargs, doc_to_visual, doc_id, task, split)
      - generate_until_multi_round: (ctx, gen_kwargs, doc_to_visual, doc_to_text, doc_id, task, split)
    """

    request_type: str
    arguments: tuple
    idx: int
    metadata: dict = field(default_factory=dict)
    resps: list = field(default_factory=list)
    filtered_resps: dict = field(default_factory=dict)

    task_name: str | None = None
    doc_id: int | None = None
    repeats: int | None = None
    doc: dict | None = None

    def __post_init__(self) -> None:
        self.task_name = self.metadata.get("task")
        self.doc_id = self.metadata.get("doc_id")
        self.repeats = self.metadata.get("repeats")

    @property
    def args(self) -> tuple:
        return self.arguments if isinstance(self.arguments, tuple) else (self.arguments,)


class Task(abc.ABC):
    """An evaluation task: dataset + prompt construction + scoring."""

    VERSION: Any = None
    DATASET_PATH: str | None = None
    DATASET_NAME: str | None = None
    OUTPUT_TYPE: str | None = None

    def __init__(
        self,
        data_dir: str | None = None,
        cache_dir: str | None = None,
        download_mode=None,
        config: dict | None = None,
    ) -> None:
        self.download(data_dir, cache_dir, download_mode)
        self._training_docs = None
        self._fewshot_docs = None
        self._instances: list[TaskInstance] | None = None
        self._config = TaskConfig(**config) if config else TaskConfig()
        self._filters = [get_filters_ensemble("none", [("take_first", None)])]

    # ------------------------------------------------------------------ dataset

    def download(self, data_dir=None, cache_dir=None, download_mode=None) -> None:
        import datasets

        self.dataset = datasets.load_dataset(
            path=self.DATASET_PATH,
            name=self.DATASET_NAME,
            data_dir=data_dir,
            cache_dir=cache_dir,
            download_mode=download_mode,
        )
        self.dataset_no_image = _strip_image_columns(self.dataset)

    @property
    def config(self) -> TaskConfig:
        return self._config

    @abc.abstractmethod
    def has_training_docs(self) -> bool: ...

    @abc.abstractmethod
    def has_validation_docs(self) -> bool: ...

    @abc.abstractmethod
    def has_test_docs(self) -> bool: ...

    def training_docs(self) -> list:
        return []

    def validation_docs(self) -> list:
        return []

    def test_docs(self) -> list:
        return []

    def validation_docs_no_media(self):
        if self.has_validation_docs():
            return self.dataset_no_image[self.config.validation_split]
        return []

    def test_docs_no_media(self):
        if self.has_test_docs():
            return self.dataset_no_image[self.config.test_split]
        return []

    def fewshot_docs(self):
        if self.has_training_docs():
            return self.training_docs()
        if self.has_validation_docs():
            return self.validation_docs()
        if self.config.num_fewshot is not None:
            log.warning("using test_docs as fewshot_docs; this is not recommended")
        return self.test_docs()

    @property
    def eval_docs(self):
        if self.has_test_docs():
            return self.test_docs()
        if self.has_validation_docs():
            return self.validation_docs()
        raise ValueError(f"task {self.DATASET_PATH} has no validation or test docs")

    @property
    def eval_docs_no_media(self):
        if self.has_test_docs():
            return self.test_docs_no_media()
        if self.has_validation_docs():
            return self.validation_docs_no_media()
        raise ValueError(f"task {self.DATASET_PATH} has no validation or test docs")

    def doc_iterator(
        self, *, rank: int = 0, limit: int | None = None, world_size: int = 1
    ) -> Iterator[tuple[int, Any]]:
        return utils.create_iterator(
            enumerate(self.eval_docs),
            rank=int(rank),
            limit=int(limit) if limit else None,
            world_size=int(world_size),
        )

    # ------------------------------------------------------------------ prompts

    @property
    def instances(self) -> list[TaskInstance] | None:
        return self._instances

    def fewshot_examples(self, k: int, rnd: random.Random) -> list:
        if self._training_docs is None:
            self._training_docs = list(self.training_docs())
        return rnd.sample(self._training_docs, k)

    @abc.abstractmethod
    def doc_to_text(self, doc: dict) -> str: ...

    @abc.abstractmethod
    def doc_to_target(self, doc: dict) -> int | str | list: ...

    @abc.abstractmethod
    def doc_to_visual(self, doc: dict) -> Any: ...

    @abc.abstractmethod
    def construct_requests(self, doc_id: int, ctx: str, **kwargs) -> list[TaskInstance] | TaskInstance: ...

    @abc.abstractmethod
    def process_results(self, doc: dict, results, **kwargs) -> dict: ...

    @abc.abstractmethod
    def aggregation(self) -> dict: ...

    @abc.abstractmethod
    def higher_is_better(self) -> dict: ...

    def build_all_requests(
        self,
        *,
        limit: int | None = None,
        rank: int = 0,
        world_size: int = 1,
        cache_requests: bool = False,
        rewrite_requests_cache: bool = False,
        system_instruction: str | None = None,
        apply_chat_template: bool = False,
        fewshot_as_multiturn: bool = False,
        chat_template: Callable | None = None,
        tokenizer_name: str = "",
    ) -> None:
        """Build this rank's TaskInstances into ``self._instances``.

        Documents are sharded over data-parallel workers with ``create_iterator``;
        built instance groups may be cached (dill) keyed by task/shots/rank/world-size/
        chat-template/system-prompt-hash/tokenizer.
        """
        if self.has_test_docs():
            split = self.config.test_split
        elif self.has_validation_docs():
            split = self.config.validation_split
        else:
            raise ValueError("no test or validation docs found")

        og_limit = limit

        cache_key = (
            f"requests-{self._config.task}-{self.config.num_fewshot}shot"
            f"-rank{rank}-world_size{world_size}"
        )
        cache_key += "-chat_template" if apply_chat_template else ""
        cache_key += "-fewshot_as_multiturn" if fewshot_as_multiturn else ""
        if system_instruction is not None:
            cache_key += f"-system_prompt_hash{utils.hash_string(system_instruction)}"
        cache_key += f"-tokenizer{tokenizer_name}"

        cached_instances = utils.load_from_cache(file_name=cache_key) if cache_requests else None
        if cache_requests and cached_instances and not rewrite_requests_cache:
            cached_instances = cached_instances[:limit]
            self._instances = [inst for group in cached_instances for inst in group]
            self._restore_unserializable_arguments()
            return

        log.info("Building contexts for %s on rank %d...", self.config.task, rank)

        # When writing the cache, build all documents so any later limit can be sliced.
        build_limit = None if (cache_requests and not cached_instances) else limit

        doc_id_docs = utils.create_iterator(
            enumerate(self.eval_docs_no_media),
            rank=rank,
            limit=int(build_limit) if build_limit else None,
            world_size=world_size,
        )
        num_docs = sum(1 for _ in islice(range(len(self.eval_docs)), rank, build_limit, world_size))

        instance_groups: list[list[TaskInstance]] = []
        for doc_id, doc in utils.get_progress_bar(iterable=doc_id_docs, total=num_docs):
            fewshot_ctx = self.fewshot_context(
                doc,
                0 if self.config.num_fewshot is None else self.config.num_fewshot,
                system_instruction,
                apply_chat_template,
                fewshot_as_multiturn,
                chat_template,
            )
            metadata = {
                "task": self.config["task"],
                "doc_id": doc_id,
                "repeats": self.config.repeats,
                "split": split,
            }
            if self.config.metadata and isinstance(self.config.metadata, dict):
                metadata.update(self.config.metadata)

            inst = self.construct_requests(doc_id=doc_id, ctx=fewshot_ctx, metadata=metadata)
            instance_groups.append(inst if isinstance(inst, list) else [inst])

        sliced = instance_groups[:og_limit]
        self._instances = [inst for group in sliced for inst in group]
        if not self._instances:
            # With rank-sharded docs a rank can legitimately draw zero documents
            # (world_size > doc count); the evaluator's union-sync and rank-0
            # gather handle the empty rank. Single-process empty means a broken
            # task config — keep the reference's hard error there
            # (reference src/data/tasks/_base.py:417).
            if world_size <= 1:
                raise ValueError("task.build_all_requests() did not find any docs!")
            log.warning(
                "task %s: rank %d/%d drew no documents (doc count < world size)",
                self.config.task, rank, world_size,
            )

        if cache_requests and (not cached_instances or rewrite_requests_cache):
            utils.save_to_cache(file_name=cache_key, obj=instance_groups)

        self._restore_unserializable_arguments()

    def _restore_unserializable_arguments(self) -> None:
        """Re-attach ``doc_to_visual`` (arguments[2]) lost through pickling."""
        for instance in self._instances or []:
            args = instance.arguments
            if len(args) > 2 and args[2] is None:
                instance.arguments = (args[0], args[1], self.doc_to_visual, *args[3:])

    def fewshot_context(
        self,
        doc_id: int,
        num_fewshot: int,
        split: str,
        rnd: random.Random | None = None,
        description: str | None = None,
    ) -> str:
        """Simple non-configurable few-shot context (description + examples + prompt)."""
        if rnd is None:
            raise ValueError("a random.Random generator must be provided to rnd")
        description = description or ""
        doc = self.dataset_no_image[split][doc_id]
        if num_fewshot == 0:
            labeled_examples = ""
        else:
            if self.has_training_docs():
                fewshot_examples = self.fewshot_examples(k=num_fewshot, rnd=rnd)
            else:
                if self._fewshot_docs is None:
                    self._fewshot_docs = list(
                        self.validation_docs() if self.has_validation_docs() else self.test_docs()
                    )
                fewshot_examples = rnd.sample(self._fewshot_docs, num_fewshot + 1)
                fewshot_examples = [x for x in fewshot_examples if x != doc][:num_fewshot]
            labeled_examples = (
                "\n\n".join(self.doc_to_text(d) + self.doc_to_target(d) for d in fewshot_examples)
                + "\n\n"
            )
        return description + labeled_examples + self.doc_to_text(doc)

    # ------------------------------------------------------------------ scoring

    def apply_filters(self) -> list | None:
        if hasattr(self, "_filters"):
            for f in self._filters:
                f.apply(self._instances, None)
            return None
        log.warning("no filter defined, passing through instances")
        return self._instances

    def dump_config(self) -> dict:
        return self.config.to_dict()

    def set_config(self, key: str, value: Any, update: bool = False) -> None:
        if key is None:
            raise ValueError("key must be provided")
        if update:
            current = getattr(self._config, key, {})
            if not isinstance(current, dict):
                raise TypeError(f"expected dict for key {key!r}, got {type(current).__name__}")
            current.update(value)
        else:
            setattr(self._config, key, value)

    def override_metric(self, metric_name: str) -> None:
        """Replace all metrics with one (used by --predict_only -> bypass)."""
        from lmms_owc_tpu_torch.tasks._manager import ConfigurableTask

        metric_info = get_metric_info(metric_name)
        self._metric_fn_list = {metric_name: metric_info.builder_fn}
        self._aggregation_list = {metric_name: metric_info.group_fn}
        self._higher_is_better = {metric_name: metric_info.higher_is_better}
        self._metric_fn_kwargs = {metric_name: {}}
        if not isinstance(self, ConfigurableTask):
            self.process_results = lambda x, y: {metric_name: get_metric_builder(metric_name)}
            self.aggregation = lambda: {metric_name: get_metric_info(metric_name).group_fn}
        self._config.metric_list = [{"metric": metric_name}]
        self._config.process_results = None

    def set_fewshot_seed(self, seed: int | None = None) -> None:
        self.fewshot_rnd = random.Random(seed)
        if hasattr(self, "sampler"):
            self.sampler.rnd = self.fewshot_rnd


def _strip_image_columns(dataset_dict):
    """Copy of a DatasetDict with all Image (or Sequence-of-Image) columns removed."""
    from datasets import Image as ImageFeature
    from datasets import Sequence

    stripped = dataset_dict.copy() if hasattr(dataset_dict, "copy") else dict(dataset_dict)
    for split_name in stripped:
        features = stripped[split_name].features
        remove_cols = [
            name
            for name, feat in features.items()
            if isinstance(feat, ImageFeature)
            or (isinstance(feat, Sequence) and isinstance(feat.feature, ImageFeature))
        ]
        for col in remove_cols:
            stripped[split_name] = stripped[split_name].remove_columns(col)
    return stripped


class TaskOutput:
    """Accumulates logged samples and per-(metric,filter) sample values for one task."""

    def __init__(
        self,
        task: Task | None = None,
        task_name: str | None = None,
        task_config: dict | None = None,
        version: str | None = None,
        group_name: str | None = None,
        n_shot: int | None = None,
        task_alias: str | None = None,
        group_alias: str | None = None,
        is_group: bool | None = None,
    ) -> None:
        self.task = task
        self.task_config = task_config
        self.task_name = task_name
        self.group_name = group_name
        self.version = version
        self.n_shot = n_shot
        self.task_alias = task_alias
        self.group_alias = group_alias
        self.is_group = is_group
        self.logged_samples: list = []
        self.sample_len: int | None = None
        self.sample_metrics: dict = defaultdict(list)
        self.agg_metrics: dict = defaultdict(list)
        self.args = None

    @classmethod
    def from_task_dict(cls, task_name: str, task) -> "TaskOutput":
        if isinstance(task, tuple):
            group_name, task = task
        else:
            group_name = None
        if not task:
            return cls(task=task, task_name=task_name, is_group=True, group_name=group_name)

        version = task.VERSION
        task_config = dict(task.dump_config())
        n_shot = task_config.get("num_fewshot")
        if n_shot == 0 or n_shot is None:
            meta = task_config.get("metadata", {})
            n_shot = meta.get("num_fewshot", 0) if isinstance(meta, dict) else 0
        return cls(
            task=task,
            task_name=task_name,
            task_config=task_config,
            group_name=group_name,
            version=version,
            n_shot=n_shot,
            task_alias=task_config.get("alias"),
            group_alias=task_config.get("group_alias"),
        )

    def calculate_aggregate_metric(self, bootstrap_iters: int = 100000) -> None:
        """Reduce sample metrics to aggregate values + stderr per (metric, filter)."""
        if not isinstance(bootstrap_iters, int):
            raise ValueError(
                f"received bootstrap_iters {bootstrap_iters!r}; expected an int (0 disables stderr)"
            )
        for (metric, filter_key), items in self.sample_metrics.items():
            if metric not in self.task.aggregation():
                continue
            agg_fn = self.task.aggregation()[metric]
            metric_key = f"{metric},{filter_key}"
            if "args" in inspect.signature(agg_fn).parameters:
                self.agg_metrics[metric_key] = agg_fn(items, args=self.task.args)
            else:
                self.agg_metrics[metric_key] = agg_fn(items)
            self.sample_len = len(items)

            iters = min(bootstrap_iters, 100) if metric in ["bleu", "chrf", "ter"] else bootstrap_iters
            stderr_fn = get_metric_stderr_builder(metric=agg_fn, bootstrap_iters=iters)
            self.agg_metrics[f"{metric}_stderr,{filter_key}"] = (
                stderr_fn(items) if (stderr_fn and len(items) > 1) else "N/A"
            )

    def __repr__(self) -> str:
        return (
            f"TaskOutput(task_name={self.task_name}, group_name={self.group_name},"
            f" version={self.version}, n_shot={self.n_shot})"
        )
