"""ConfigurableTask (YAML-driven task), ConfigurableGroup, and TaskManager
(the JAX package's ``tasks._manager``); the default task directory is the
port's own ``tasks/configs``.

Contract parity with reference src/data/tasks/_manager.py:
  - ConfigurableTask: model-specific prompt kwargs resolution (:281-313), metric/
    aggregation map construction (:315-383), retried dataset download including
    ``load_from_disk`` + ``custom_download`` hooks (:385-440), polymorphic
    ``doc_to_text/target/visual/choice`` (jinja template | column | callable, :647-802),
    request construction per output type (:804-916), and result processing (:920-1098).
  - TaskManager: walks task directories for ``*.yaml``, indexes into
    {task, python_task, group, tag} (:1591-1688), resolves wildcards and recursive
    group/tag composition with per-group config overrides (:1399-1563).
"""

from __future__ import annotations

import ast
import collections
import copy
import inspect
import os
import random
from collections.abc import Callable
from functools import partial

import numpy as np

from lmms_owc_tpu_torch import utils
from lmms_owc_tpu_torch.filters import get_filters_ensemble
from lmms_owc_tpu_torch.metrics import (
    DEFAULT_METRICS_PER_OUTPUT_TYPE,
    get_aggregation_builder,
    get_metric_builder,
    get_metric_info,
)
from lmms_owc_tpu_torch.samplers import get_sampler_builder
from lmms_owc_tpu_torch.tasks._base import Task, TaskInstance, _strip_image_columns
from lmms_owc_tpu_torch.tasks._config import GROUP_ONLY_KEYS, GroupConfig, TaskConfig

__all__ = ["ALL_OUTPUT_TYPES", "ConfigurableGroup", "ConfigurableTask", "TaskManager"]

log = utils.get_logger(__name__)

ALL_OUTPUT_TYPES = [
    "loglikelihood",
    "multiple_choice",
    "generate_until",
    "generate_until_multi_round",
]


def _config_is_task(config: dict) -> bool:
    return "task" in config and isinstance(config["task"], str)


def _config_is_group(config: dict) -> bool:
    return "task" in config and isinstance(config["task"], list)


def _config_is_python_task(config: dict) -> bool:
    return "class" in config


def _class_has_config_in_constructor(cls: type) -> bool:
    constructor = getattr(cls, "__init__", None)
    return "config" in inspect.signature(constructor).parameters if constructor else False


def _retry(fn: Callable, attempts: int = 5, wait_s: float = 2.0):
    """Small retry helper (replaces tenacity decorators on download/process_results).

    ``LMMS_OWC_RETRY_ATTEMPTS`` overrides the attempt count — set it to 1 for
    fast failure in offline environments (task listing over many datasets).
    """
    import os
    import time

    attempts = max(1, int(os.environ.get("LMMS_OWC_RETRY_ATTEMPTS", attempts)))
    last_err = None
    for attempt in range(attempts):
        try:
            return fn()
        except Exception as err:  # noqa: BLE001
            last_err = err
            if attempt + 1 < attempts:
                log.warning("attempt %d/%d failed: %s; retrying", attempt + 1, attempts, err)
                time.sleep(wait_s)
    raise last_err


class ConfigurableGroup:
    """A named group of subtasks with optional aggregate metric configuration."""

    def __init__(self, config: dict | None = None) -> None:
        self._config = GroupConfig(**config)

    @property
    def group(self) -> str:
        return self._config.group

    @property
    def group_alias(self) -> str:
        return self._config.group_alias

    @property
    def config(self) -> dict:
        return self._config.to_dict()

    @property
    def group_name(self) -> str:
        return self._config.group

    def __repr__(self) -> str:
        return f"ConfigurableGroup(group={self.group}, group_alias={self.group_alias})"


class ConfigurableTask(Task):
    """YAML-driven evaluation task."""

    VERSION = "Yaml"
    OUTPUT_TYPE: str | None = None
    CONFIG: TaskConfig | None = None

    def __init__(
        self,
        data_dir: str | None = None,
        cache_dir: str | None = None,
        download_mode=None,
        config: dict | None = None,
        model_name: str | None = None,
    ) -> None:
        # Deliberately no super().__init__(): config must be prepared before download.
        self._config = self.CONFIG
        if self._config is None:
            self._config = TaskConfig(**config)
        elif config is not None:
            self._config.__dict__.update(config)
        if self._config is None:
            raise ValueError("must pass a config to ConfigurableTask")

        if isinstance(self.config.metadata, dict) and "version" in self.config.metadata:
            self.VERSION = self.config.metadata["version"]

        self.model_name = model_name
        self._prepare_model_specific_config()

        if self.config.output_type is not None:
            if self.config.output_type not in ALL_OUTPUT_TYPES:
                raise ValueError(
                    f"invalid output_type {self.config.output_type!r};"
                    f" must be one of {ALL_OUTPUT_TYPES}"
                )
            self.OUTPUT_TYPE = self.config.output_type
        if self.config.dataset_path is not None:
            self.DATASET_PATH = self.config.dataset_path
        if self.config.dataset_name is not None:
            self.DATASET_NAME = self.config.dataset_name

        self._prepare_metric_and_aggregation()

        _retry(lambda: self.download(self.config.dataset_kwargs))
        self._training_docs = None
        self._fewshot_docs = None
        self._instances = None

        if self.config.filter_list is not None:
            self._filters = []
            for filter_config in self.config.filter_list:
                filter_name = filter_config["name"]
                components = [
                    (fn["function"], {k: v for k, v in fn.items() if k != "function"})
                    for fn in filter_config["filter"]
                ]
                self._filters.append(get_filters_ensemble(filter_name, components))
        else:
            self._filters = [get_filters_ensemble("none", [("take_first", None)])]

        if self.config.fewshot_config is not None:
            sampler_key = self.config.fewshot_config.get("sampler", "default")
            sampler_cls = get_sampler_builder(sampler_key)
            self.sampler = sampler_cls(list(self.fewshot_docs()), self, rnd=random.Random(1234))

        if self.has_test_docs():
            self.task_docs = self.test_docs()
        elif self.has_validation_docs():
            self.task_docs = self.validation_docs()
        else:
            raise ValueError(
                f"task dataset (path={self.DATASET_PATH}, name={self.DATASET_NAME})"
                " must have valid or test docs"
            )

        # Probe one doc to discover multiple-input / multiple-target structure.
        self.features = list(self.task_docs.features.keys())
        self.multiple_input = 0
        self.multiple_target = 0
        test_doc = self.task_docs[0]
        test_text = self.doc_to_text(test_doc)
        test_target = self.doc_to_target(test_doc)
        if self.config.doc_to_choice is not None:
            test_choice = self.doc_to_choice(test_doc)
            if not isinstance(test_choice, list):
                log.error("doc_to_choice must return a list")
            elif isinstance(test_text, int):
                self.multiple_input = len(test_choice)
        else:
            test_choice = None
        if isinstance(test_target, list):
            self.multiple_target = len(test_target)

    # ------------------------------------------------------------- config prep

    def _prepare_model_specific_config(self) -> None:
        """Resolve per-model prompt/generation/target kwargs by model name."""
        self.model_specific_kwargs = self.config.model_specific_kwargs
        if self.model_specific_kwargs is not None:
            if self.model_name in self.model_specific_kwargs:
                self.model_specific_kwargs = self.model_specific_kwargs[self.model_name]
            elif "default" in self.model_specific_kwargs:
                self.model_specific_kwargs.update(self.model_specific_kwargs.get("default", {}))
            elif "dataset" in self.model_specific_kwargs:
                self.model_specific_kwargs.update(self.model_specific_kwargs.get("dataset", {}))

        self.model_specific_target_kwargs = self.config.model_specific_target_kwargs
        if self.model_specific_target_kwargs is not None:
            if self.model_name in self.model_specific_target_kwargs:
                self.model_specific_target_kwargs = self.model_specific_target_kwargs[self.model_name]
            else:
                self.model_specific_target_kwargs = self.model_specific_target_kwargs.get(
                    "default", None
                )

        self.model_specific_generation_kwargs = self.config.model_specific_generation_kwargs
        if self.model_specific_generation_kwargs is not None:
            if self.model_name in self.model_specific_generation_kwargs:
                self.model_specific_generation_kwargs = self.model_specific_generation_kwargs[
                    self.model_name
                ]
            else:
                self.model_specific_generation_kwargs = self.model_specific_generation_kwargs.get(
                    "default", {}
                )
            self.config.generation_kwargs.update(self.model_specific_generation_kwargs)

    def _prepare_metric_and_aggregation(self) -> None:
        """Build metric fn / aggregation / higher_is_better maps from metric_list."""
        self._metric_fn_list: dict = {}
        self._metric_fn_kwargs: dict = {}
        self._aggregation_list: dict = {}
        self._higher_is_better: dict = {}

        if self.config.metric_list is None:
            for metric_name in DEFAULT_METRICS_PER_OUTPUT_TYPE[self.config.output_type]:
                info = get_metric_info(metric_name)
                self._metric_fn_list[metric_name] = info.builder_fn
                self._metric_fn_kwargs[metric_name] = {}
                self._aggregation_list[metric_name] = info.group_fn
                self._higher_is_better[metric_name] = info.higher_is_better
            return

        for metric_config in self.config.metric_list:
            if "metric" not in metric_config:
                raise KeyError("missing required 'metric' key in metric configuration")
            metric_name = metric_config["metric"]
            kwargs = {
                k: metric_config[k]
                for k in metric_config
                if k not in ["metric", "aggregation", "higher_is_better"]
            }

            if self.config.process_results is not None:
                self._metric_fn_list[metric_name] = None
                self._metric_fn_kwargs[metric_name] = {}
            elif callable(metric_name):
                metric_fn = metric_name.__call__
                metric_name = metric_name.__name__
                self._metric_fn_list[metric_name] = metric_fn
                self._metric_fn_kwargs[metric_name] = kwargs
            else:
                self._metric_fn_list[metric_name] = get_metric_builder(metric_name)
                self._metric_fn_kwargs[metric_name] = kwargs

            if "aggregation" in metric_config:
                agg = metric_config["aggregation"]
                self._aggregation_list[metric_name] = (
                    get_aggregation_builder(agg) if isinstance(agg, str) else agg
                )
            else:
                self._aggregation_list[metric_name] = get_metric_info(metric_name).group_fn

            if "higher_is_better" in metric_config:
                self._higher_is_better[metric_name] = metric_config["higher_is_better"]
            else:
                self._higher_is_better[metric_name] = get_metric_info(metric_name).higher_is_better

    # ------------------------------------------------------------------ dataset

    def download(self, dataset_kwargs: dict | None = None) -> None:
        import datasets

        dataset_kwargs = dict(dataset_kwargs or {})
        for consumed in ["force_download", "force_unzip", "local_files_only", "create_link",
                         "max_retries", "num_proc", "token"]:
            dataset_kwargs.pop(consumed, None)

        if dataset_kwargs.pop("load_from_disk", False):
            custom_download = dataset_kwargs.pop("custom_download", None)
            if callable(custom_download):
                custom_download()
            self.dataset = datasets.load_from_disk(self.DATASET_PATH)
        else:
            dataset_kwargs.pop("custom_download", None)
            self.dataset = datasets.load_dataset(
                path=self.DATASET_PATH,
                name=self.DATASET_NAME,
                **dataset_kwargs,
            )

        if self.config.process_docs is not None:
            for split in self.dataset:
                if split in [
                    self.config.training_split,
                    self.config.validation_split,
                    self.config.test_split,
                    self.config.fewshot_split,
                ]:
                    self.dataset[split] = self.config.process_docs(self.dataset[split])

        self.dataset_no_image = _strip_image_columns(self.dataset)

    def has_training_docs(self) -> bool:
        return self.config.training_split is not None

    def has_validation_docs(self) -> bool:
        return self.config.validation_split is not None

    def has_test_docs(self) -> bool:
        return self.config.test_split is not None

    def training_docs(self):
        if self.has_training_docs():
            return self.dataset[self.config.training_split]

    def validation_docs(self):
        if self.has_validation_docs():
            return self.dataset[self.config.validation_split]

    def test_docs(self):
        if self.has_test_docs():
            return self.dataset[self.config.test_split]

    def fewshot_docs(self):
        if self.config.fewshot_split is not None:
            return self.dataset[self.config.fewshot_split]
        if (self.config.num_fewshot is not None) and (self.config.num_fewshot > 0):
            log.warning(
                "task %s: num_fewshot > 0 but fewshot_split is None; using fallback rule",
                self.config.task,
            )
        return super().fewshot_docs()

    # ------------------------------------------------------------------ prompts

    def fewshot_context(
        self,
        doc: dict,
        num_fewshot: int,
        system_instruction: str | None = None,
        apply_chat_template: bool = False,
        fewshot_as_multiturn: bool = False,
        chat_template: Callable | None = None,
    ) -> str | list:
        """Build the full prompt: system/description + few-shot examples + question."""
        if num_fewshot > 0 and not hasattr(self, "sampler"):
            # Tasks without an explicit fewshot_config get the default sampler,
            # seeded by set_fewshot_seed (fewshot_random_seed).
            sampler_cls = get_sampler_builder("default")
            self.sampler = sampler_cls(
                list(self.fewshot_docs()), self,
                rnd=getattr(self, "fewshot_rnd", random.Random(1234)),
            )

        description = self.config.description
        if description:
            description = utils.apply_jinja_template(self.config.description, doc)

        if system_instruction is not None and description:
            system_prompt = f"{system_instruction}{self.sampler.fewshot_delimiter}{description}"
        elif system_instruction is not None:
            system_prompt = system_instruction
        else:
            system_prompt = description or ""

        example = self.doc_to_text(doc)

        if apply_chat_template:
            messages: list[dict] = []
            if system_prompt:
                messages.append({"role": "system", "content": system_prompt})
            if num_fewshot > 0:
                messages.extend(self.sampler.get_chat_context(doc, num_fewshot, fewshot_as_multiturn))
            if self.multiple_input:
                return chat_template(messages)
            if isinstance(example, str):
                self.append_target_question(messages, example, fewshot_as_multiturn)
                return chat_template(messages)
            if isinstance(example, list):
                outputs = []
                for ex in example:
                    chat = copy.deepcopy(messages)
                    self.append_target_question(chat, ex, fewshot_as_multiturn)
                    outputs.append(chat_template(chat))
                return outputs
            if isinstance(example, int):
                text = (
                    self.doc_to_choice(doc)[example]
                    if self.config.doc_to_choice is not None
                    else str(example)
                )
                self.append_target_question(messages, text, fewshot_as_multiturn)
                return chat_template(messages)
            raise ValueError("unknown example type")

        prefix = system_prompt
        if num_fewshot > 0:
            prefix += self.sampler.get_context(doc, num_fewshot)
        if self.multiple_input:
            return prefix
        if isinstance(example, str):
            return prefix + example
        if isinstance(example, list):
            return [prefix + ex for ex in example]
        if isinstance(example, int):
            if self.config.doc_to_choice is not None:
                return prefix + self.doc_to_choice(doc)[example]
            return prefix + str(example)
        raise ValueError("unknown example type")

    @staticmethod
    def append_target_question(
        messages: list[dict], question: str, fewshot_as_multiturn: bool = False
    ) -> None:
        """Append the eval question as the final user turn (or merge into the last one)."""
        if not fewshot_as_multiturn and messages and messages[-1]["role"] == "user":
            messages[-1]["content"] += question
        else:
            messages.append({"role": "user", "content": question})

    def apply_filters(self) -> list | None:
        if hasattr(self, "_filters"):
            for f in self._filters:
                f.apply(self._instances, self.task_docs)
            return None
        log.warning("no filter defined, passing through instances")
        return self._instances

    def should_decontaminate(self) -> bool:
        return self.config.should_decontaminate

    def doc_to_decontamination_query(self, doc: dict) -> str | None:
        if not self.config.should_decontaminate:
            return None
        query = self.config.doc_to_decontamination_query
        if query is None:
            return self.doc_to_text(doc)
        if query in self.features:
            return doc[query]
        if callable(query):
            return query(doc)
        return ast.literal_eval(utils.apply_jinja_template(query, doc))

    def doc_to_text(self, doc: dict) -> str | int | list:
        doc_to_text = self.config.doc_to_text
        if isinstance(doc_to_text, int):
            return doc_to_text
        if isinstance(doc_to_text, str):
            if doc_to_text in self.features:
                return doc[doc_to_text]
            rendered = utils.apply_jinja_template(doc_to_text, doc)
            if rendered.isdigit() and self._config.doc_to_choice is not None:
                return ast.literal_eval(rendered)
            return rendered
        if callable(doc_to_text):
            if self.model_specific_kwargs is not None:
                return doc_to_text(doc, self.model_specific_kwargs)
            return doc_to_text(doc)
        raise TypeError(f"doc_to_text must be str, int, or callable; got {type(doc_to_text)}")

    def doc_to_target(self, doc: dict) -> int | str | list:
        doc_to_target = self.config.doc_to_target
        if isinstance(doc_to_target, int):
            return doc_to_target
        if isinstance(doc_to_target, str):
            if doc_to_target in self.features:
                return doc[doc_to_target]
            rendered = utils.apply_jinja_template(doc_to_target, doc)
            if rendered.isdigit() and self._config.doc_to_choice is not None:
                return ast.literal_eval(rendered)
            if len(rendered) >= 2 and rendered[0] == "[" and rendered[-1] == "]":
                try:
                    return ast.literal_eval(rendered)
                except (SyntaxError, ValueError):
                    return rendered
            return rendered
        if isinstance(doc_to_target, list):
            return doc_to_target
        if callable(doc_to_target):
            if self.model_specific_target_kwargs is not None:
                return doc_to_target(doc, self.model_specific_target_kwargs)
            return doc_to_target(doc)
        raise TypeError(f"doc_to_target must be str, list, or callable; got {type(doc_to_target)}")

    def doc_to_visual(self, doc: dict):
        doc_to_visual = self.config.doc_to_visual
        if isinstance(doc_to_visual, str):
            if doc_to_visual not in self.features:
                raise ValueError(
                    f"doc_to_visual {doc_to_visual!r} not found in features {self.features}"
                )
            return [doc[doc_to_visual]]
        if callable(doc_to_visual):
            takes_kwargs = (
                self.model_specific_kwargs is not None
                and len(inspect.signature(doc_to_visual).parameters) == 2
            )
            return doc_to_visual(doc, self.model_specific_kwargs) if takes_kwargs else doc_to_visual(doc)
        return doc_to_visual

    def doc_to_choice(self, doc: dict) -> list[str]:
        doc_to_choice = self.config.doc_to_choice
        if doc_to_choice is None:
            log.error("doc_to_choice was called but not set in config")
        if isinstance(doc_to_choice, str):
            if doc_to_choice in self.features:
                return doc[doc_to_choice]
            return ast.literal_eval(utils.apply_jinja_template(doc_to_choice, doc))
        if isinstance(doc_to_choice, list):
            return doc_to_choice
        if isinstance(doc_to_choice, dict):
            return list(doc_to_choice.values())
        if callable(doc_to_choice):
            takes_kwargs = (
                self.model_specific_kwargs is not None
                and len(inspect.signature(doc_to_choice).parameters) == 2
            )
            return doc_to_choice(doc, self.model_specific_kwargs) if takes_kwargs else doc_to_choice(doc)
        raise TypeError(f"doc_to_choice must be str, list, dict, or callable; got {type(doc_to_choice)}")

    # ------------------------------------------------------------------ requests

    def construct_requests(self, doc_id: int, ctx, **kwargs) -> list[TaskInstance] | TaskInstance:
        split = kwargs["metadata"].get("split")

        if self.OUTPUT_TYPE == "loglikelihood":
            arguments = (ctx, self.doc_to_target, self.doc_to_visual, doc_id, self.config.task, split)

        elif self.OUTPUT_TYPE == "multiple_choice":
            doc = self.dataset[split][doc_id]
            choices = self.doc_to_choice(doc)
            target_delimiter = self.config.target_delimiter
            if self.multiple_input:
                # Choices are alternative contexts; the target is the continuation.
                cont = self.doc_to_target(doc)
                arguments = [
                    (choice_ctx, f"{target_delimiter}{cont}", self.doc_to_visual, doc_id,
                     self.config.task, split)
                    for choice_ctx in choices
                ]
            else:
                arguments = [
                    (ctx, f"{target_delimiter}{cont}", self.doc_to_visual, doc_id,
                     self.config.task, split)
                    for cont in choices
                ]
            request_list = [
                TaskInstance(request_type="loglikelihood", arguments=arg, idx=i, **kwargs)
                for i, arg in enumerate(arguments)
            ]
            if "acc_mutual_info" in self._metric_fn_list:
                # Unconditional P(choice) requests for mutual-information normalization.
                request_list.extend(
                    TaskInstance(
                        request_type="loglikelihood", arguments=("", f"{choice}"), idx=i, **kwargs
                    )
                    for i, choice in enumerate(choices)
                )
            return request_list

        elif self.OUTPUT_TYPE == "generate_until":
            arguments = (
                ctx,
                copy.deepcopy(self.config.generation_kwargs),
                self.doc_to_visual,
                doc_id,
                self.config.task,
                split,
            )
        elif self.OUTPUT_TYPE == "generate_until_multi_round":
            arguments = (
                ctx,
                copy.deepcopy(self.config.generation_kwargs),
                self.doc_to_visual,
                partial(self.config.doc_to_text, model_specific_kwargs=self.model_specific_kwargs),
                doc_id,
                self.config.task,
                split,
            )
        else:
            raise ValueError(f"invalid output type {self.OUTPUT_TYPE!r}")
        return TaskInstance(request_type=self.OUTPUT_TYPE, arguments=arguments, idx=0, **kwargs)

    # ------------------------------------------------------------------ scoring

    def process_results(self, doc: dict, results, full_docs: dict | None = None, **kwargs) -> dict:
        """Score one document. Retried on transient failure like the reference
        (src/data/tasks/_manager.py:920, tenacity retry for scoring-model flakes)."""
        return _retry(lambda: self._process_results_once(doc, results, full_docs, **kwargs))

    def _process_results_once(self, doc: dict, results, full_docs: dict | None = None, **kwargs) -> dict:
        if self.OUTPUT_TYPE == "generate_until":
            if isinstance(results, list) and isinstance(results[0], list):
                results = [res.strip() for res in results[0]]
            else:
                results = [res.strip() for res in results]

        kwargs = {}
        if full_docs is not None:
            kwargs["full_docs"] = full_docs
        if callable(self.config.process_results):
            return self.config.process_results(doc, results, **kwargs)

        use_metric = list(self._metric_fn_list.keys())

        if self.OUTPUT_TYPE == "loglikelihood":
            ll, is_greedy = results
            return {
                **({"perplexity": ll} if "perplexity" in use_metric else {}),
                **({"acc": int(is_greedy)} if "acc" in use_metric else {}),
            }

        if self.OUTPUT_TYPE == "multiple_choice":
            return self._process_multiple_choice(doc, results, use_metric)

        if "generate_until" in self.OUTPUT_TYPE:
            return self._process_generation(doc, results)

        raise ValueError(f"invalid output type {self.OUTPUT_TYPE!r}")

    def _process_multiple_choice(self, doc: dict, results, use_metric: list) -> dict:
        lls, is_greedy = zip(*results)
        choices = self.doc_to_choice(doc)
        completion_len = np.array([float(len(c)) for c in choices])

        lls_unconditional = None
        if 2 * len(choices) == len(lls) and "acc_mutual_info" in self._metric_fn_list:
            lls_unconditional = lls[1::2]
            if len(lls_unconditional) != len(choices):
                raise ValueError("unconditional loglikelihood / choice count mismatch")
            lls = lls[::2]

        # Loglikelihood responses hold losses, so the best choice is the argmin.
        pred = np.argmin(lls)
        pred_norm = np.argmin(lls / completion_len)

        gold = self.doc_to_text(doc) if self.multiple_input else self.doc_to_target(doc)
        gold_index_error = False
        if isinstance(gold, list):
            gold = [i if i < len(choices) else -100 for i in gold]
            gold_index_error = -100 in gold
        else:
            if isinstance(gold, int):
                gold = gold if gold < len(choices) else -100
            elif isinstance(gold, str):
                gold = choices.index(gold) if gold in choices else -100
            gold_index_error = gold == -100
        if gold_index_error:
            log.warning("label index out of range of available choices; sample:\n%s", doc)

        if self.multiple_target:
            acc = 1.0 if pred in gold else 0.0
            acc_norm = 1.0 if pred_norm in gold else 0.0
            exact_match = int(any(is_greedy[i] if i != -100 else 0 for i in gold))
        else:
            acc = 1.0 if pred == gold else 0.0
            acc_norm = 1.0 if pred_norm == gold else 0.0
            exact_match = int(is_greedy[gold]) if gold != -100 else 0

        result_dict = {
            **({"acc": acc} if "acc" in use_metric else {}),
            **({"f1": (gold, pred)} if "f1" in use_metric else {}),
            **({"mcc": (gold, pred)} if "mcc" in use_metric else {}),
            **({"acc_norm": acc_norm} if "acc_norm" in use_metric else {}),
            **({"exact_match": exact_match} if "exact_match" in use_metric else {}),
        }
        if "acc_mutual_info" in use_metric and lls_unconditional is not None:
            # Bug-for-bug parity with the reference: responses here are LOSSES
            # (pred = argmin above), so argmax of (conditional - unconditional)
            # selects the LOWEST-mutual-information choice. The reference has the
            # identical inversion (it moved from logprobs to losses without
            # flipping this argmax); kept so scores match exactly. The
            # information-theoretically correct selector would be np.argmin here.
            lls_mi = [c - u for c, u in zip(lls, lls_unconditional)]
            result_dict["acc_mutual_info"] = 1.0 if np.argmax(lls_mi) == gold else 0.0
        return result_dict

    def _process_generation(self, doc: dict, results) -> dict:
        gold = self.doc_to_target(doc)
        if self.OUTPUT_TYPE == "generate_until_multi_round":
            result = [res[-1].strip() for res in results]
        else:
            result = [res.strip() for res in results]

        if self.config.doc_to_choice is not None:
            gold = self.doc_to_choice(doc)[gold]
        elif self.multiple_target:
            gold = list(gold)
        elif not self.multiple_target and isinstance(result, tuple):
            result = result[-1]

        result_dict = {}
        for metric in self._metric_fn_list:
            if self.multiple_target and metric != "anls":
                gold_list = gold if isinstance(gold, list) else [gold]
                scores = []
                for gold_option in gold_list:
                    score = self._call_metric(metric, [gold_option], result)
                    scores.append(score)
                result_dict[metric] = 1.0 if any(scores) else 0.0
            else:
                gold_list = gold if isinstance(gold, list) else [gold]
                result_dict[metric] = self._call_metric(metric, gold_list, result)
        return result_dict

    def _metric_protocol(self, metric: str) -> str:
        """Decide a metric fn's calling convention ONCE, from its signature.

        Dispatching via a TypeError fallback at scoring time would mask
        TypeErrors raised INSIDE a metric (e.g. comparing str to None on a
        malformed doc) by silently re-calling it under the wrong protocol.
        """
        cache = self.__dict__.setdefault("_metric_protocol_cache", {})
        proto = cache.get(metric)
        if proto is None:
            fn = self._metric_fn_list[metric]
            try:
                params = inspect.signature(fn).parameters
                accepts_kw = any(
                    p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values()
                )
                proto = (
                    "keyword"
                    if accepts_kw or ("references" in params and "predictions" in params)
                    else "items"
                )
            except (TypeError, ValueError):  # builtins / C callables
                proto = "keyword"
            cache[metric] = proto
        return proto

    def _call_metric(self, metric: str, references: list, predictions) -> float:
        """Call a metric fn under its registered protocol (keyword or item-pair)."""
        if self._metric_protocol(metric) == "keyword":
            score = self._metric_fn_list[metric](
                references=references,
                predictions=predictions,
                **self._metric_fn_kwargs[metric],
            )
        else:
            score = self._metric_fn_list[metric]([references, predictions])
        if isinstance(score, dict):
            score = score[metric]
        return score

    def aggregation(self) -> dict:
        return self._aggregation_list

    def higher_is_better(self) -> dict:
        return self._higher_is_better

    def get_config(self, key: str):
        return getattr(self._config, key, None)

    @property
    def task_name(self):
        return getattr(self.config, "task", None)

    def __repr__(self) -> str:
        return (
            f"ConfigurableTask(task_name={getattr(self.config, 'task', None)},"
            f" output_type={self.OUTPUT_TYPE},"
            f" num_fewshot={getattr(self.config, 'num_fewshot', None)},"
            f" num_samples={len(self.eval_docs)})"
        )


class TaskManager:
    """Indexes task YAMLs and loads tasks/groups/tags into Task objects."""

    def __init__(
        self,
        include_path: str | list | None = None,
        include_defaults: bool = True,
        model_name: str | None = None,
    ) -> None:
        self.include_path = include_path
        self.model_name = model_name
        self._task_index = self.init_tasks(include_path=include_path, include_defaults=include_defaults)
        self._all_tasks = sorted(self._task_index.keys())
        self._all_groups = sorted(t for t in self._all_tasks if self._task_index[t]["type"] == "group")
        self._all_subtasks = sorted(t for t in self._all_tasks if self._task_index[t]["type"] == "task")
        self._all_tags = sorted(t for t in self._all_tasks if self._task_index[t]["type"] == "tag")
        self.task_group_map: dict = collections.defaultdict(list)

    @property
    def all_tasks(self) -> list:
        return self._all_tasks

    @property
    def all_groups(self) -> list:
        return self._all_groups

    @property
    def all_subtasks(self) -> list:
        return self._all_subtasks

    @property
    def all_tags(self) -> list:
        return self._all_tags

    @property
    def task_index(self) -> dict:
        return self._task_index

    def init_tasks(self, include_path: str | list | None = None, include_defaults: bool = True) -> dict:
        all_paths = []
        if include_defaults:
            all_paths.append(os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs"))
        if include_path is not None:
            all_paths.extend([include_path] if isinstance(include_path, str) else include_path)

        task_index: dict = {}
        for task_dir in all_paths:
            tasks = self._get_task_and_group(task_dir)
            task_index = {**tasks, **task_index}
        return task_index

    def list_all_tasks(
        self, list_groups: bool = True, list_tags: bool = True, list_subtasks: bool = True
    ) -> str:
        """Markdown listing of groups / tags / subtasks with config locations."""
        lines = []
        if list_groups:
            lines += ["| Group | Config Location |", "|---|---|"]
            for g in self.all_groups:
                path = self.task_index[g]["yaml_path"]
                lines.append(f"| {g} | {'---' if path == -1 else path} |")
            lines.append("")
        if list_tags:
            lines += ["| Tag |", "|---|"]
            lines += [f"| {t} |" for t in self.all_tags]
            lines.append("")
        if list_subtasks:
            lines += ["| Task | Config Location | Output Type |", "|---|---|---|"]
            for t in self.all_subtasks:
                path = self.task_index[t]["yaml_path"]
                output_type = ""
                if path != -1:
                    config = utils.load_yaml_config(path, mode="simple")
                    output_type = config.get("output_type", "")
                    if not output_type and "include" in config:
                        inc = os.path.join(os.path.dirname(path), config["include"])
                        try:
                            output_type = utils.load_yaml_config(inc, mode="simple").get("output_type", "")
                        except FileNotFoundError:
                            pass
                lines.append(f"| {t} | {'---' if path == -1 else path} | {output_type} |")
            lines.append("")
        return "\n" + "\n".join(lines)

    def match_tasks(self, task_list: list) -> list:
        return utils.pattern_match(task_list, self.all_tasks)

    def _name_is_registered(self, name: str) -> bool:
        return name in self.all_tasks

    def _name_is_task(self, name: str) -> bool:
        return self._name_is_registered(name) and self.task_index[name]["type"] == "task"

    def _name_is_tag(self, name: str) -> bool:
        return self._name_is_registered(name) and self.task_index[name]["type"] == "tag"

    def _name_is_group(self, name: str) -> bool:
        return self._name_is_registered(name) and self.task_index[name]["type"] == "group"

    def _name_is_python_task(self, name: str) -> bool:
        return self._name_is_registered(name) and self.task_index[name]["type"] == "python_task"

    def _get_yaml_path(self, name: str):
        if name not in self.task_index:
            raise ValueError(f"task {name} not found in task index")
        return self.task_index[name]["yaml_path"]

    def _get_config(self, name: str) -> dict:
        yaml_path = self._get_yaml_path(name)
        if yaml_path == -1:
            return {}
        return utils.load_yaml_config(yaml_path, mode="full")

    def _get_task_list(self, name: str):
        if self._name_is_task(name):
            raise ValueError(f"task {name} is not a group")
        return self.task_index[name]["task"]

    def _load_individual_task_or_group(
        self,
        name_or_config: str | dict | None = None,
        parent_name: str | None = None,
        update_config: dict | None = None,
    ) -> dict:
        def _load_task(config: dict, task: str) -> dict:
            if "include" in config:
                config = {
                    **utils.load_yaml_config(
                        yaml_path=None,
                        yaml_config={"include": config.pop("include")},
                        yaml_dir=os.path.dirname(self._get_yaml_path(task))
                        if self._name_is_registered(task)
                        else None,
                        mode="full",
                    ),
                    **config,
                }
            if _config_is_python_task(config):
                if _class_has_config_in_constructor(config["class"]):
                    task_object = config["class"](config=config)
                else:
                    task_object = config["class"]()
                if isinstance(task_object, ConfigurableTask):
                    task_object.config.task = config["task"]
            else:
                task_object = ConfigurableTask(config=config, model_name=self.model_name)
            return {task: task_object}

        def _get_group_and_subtask_from_config(config: dict) -> tuple:
            group = ConfigurableGroup(config=config)
            subtask_list: list = []
            for task in group.config["task"]:
                if isinstance(task, str) and self._name_is_tag(task):
                    subtask_list.extend(self._get_task_list(task))
                else:
                    subtask_list.append(task)
            return group, subtask_list

        def _process_group_config(config: dict, update_cfg: dict | None = None) -> tuple:
            if update_cfg is not None:
                config = {**config, **update_cfg}
            _update = {k: v for k, v in config.items() if k not in GROUP_ONLY_KEYS} or None
            group_config = {k: v for k, v in config.items() if k in GROUP_ONLY_KEYS}
            return group_config, _update

        if isinstance(name_or_config, str):
            if update_config is not None:
                name_or_config = {"task": name_or_config, **update_config}
            elif self._name_is_task(name_or_config) or self._name_is_python_task(name_or_config):
                return _load_task(self._get_config(name_or_config), task=name_or_config)
            else:
                subtask_list = self._get_task_list(name_or_config)
                if subtask_list == -1:
                    group_config = self._get_config(name_or_config)
                    group_config, update_config = _process_group_config(group_config)
                    group_name, subtask_list = _get_group_and_subtask_from_config(group_config)
                elif self._name_is_tag(name_or_config):
                    fn = partial(self._load_individual_task_or_group, update_config=None)
                    return dict(collections.ChainMap(*map(fn, reversed(subtask_list))))
                else:
                    group_name = ConfigurableGroup(
                        config={"group": name_or_config, "task": subtask_list}
                    )

        if isinstance(name_or_config, dict):
            if _config_is_task(name_or_config):
                name = name_or_config.pop("task")
                if update_config is not None:
                    name_or_config = {**name_or_config, **update_config}
                if self._name_is_group(name):
                    group_config = self._get_config(name)
                    group_config, update_config = _process_group_config(group_config, name_or_config)
                    group_name, subtask_list = _get_group_and_subtask_from_config(group_config)
                elif self._name_is_tag(name):
                    subtask_list = self._get_task_list(name)
                    fn = partial(self._load_individual_task_or_group, update_config=name_or_config)
                    return dict(collections.ChainMap(*map(fn, reversed(subtask_list))))
                else:
                    if self._name_is_registered(name):
                        base_config = self._get_config(name)
                        if parent_name is not None:
                            num_dup = len(
                                [x for x in self.task_group_map[parent_name] if x.startswith(name)]
                            )
                            if num_dup > 0:
                                name = f"{name}-{num_dup}"
                            self.task_group_map[parent_name].append(name)
                        task_config = {**base_config, **name_or_config}
                    else:
                        task_config = name_or_config
                    return _load_task(task_config, task=name)
            else:
                group_config, update_config = _process_group_config(name_or_config)
                group_name, subtask_list = _get_group_and_subtask_from_config(group_config)

        fn = partial(
            self._load_individual_task_or_group,
            parent_name=group_name.group_name,
            update_config=update_config,
        )
        return {group_name: dict(collections.ChainMap(*map(fn, reversed(subtask_list))))}

    def load_task_or_group(self, task_list: str | list | None = None) -> dict:
        if isinstance(task_list, str):
            task_list = [task_list]
        return dict(collections.ChainMap(*map(self._load_individual_task_or_group, task_list)))

    def load_config(self, config: dict) -> dict:
        return self._load_individual_task_or_group(config)

    def _get_task_and_group(self, task_dir: str) -> dict:
        """Walk ``task_dir`` for YAMLs and index them as task/python_task/group/tag."""
        ignore_dirs = ["__pycache__", ".ipynb_checkpoints", "assets"]
        index: dict = collections.defaultdict()
        for root, dirs, files in os.walk(task_dir):
            dirs[:] = [d for d in dirs if d not in ignore_dirs]
            for f in files:
                if not f.endswith(".yaml"):
                    continue
                yaml_path = os.path.join(root, f)
                try:
                    config = utils.load_yaml_config(yaml_path, mode="simple")
                except Exception as err:  # noqa: BLE001
                    log.debug("file %s could not be parsed: %s", yaml_path, err)
                    continue
                if not isinstance(config, dict):
                    continue
                if _config_is_python_task(config):
                    index[config["task"]] = {"type": "python_task", "yaml_path": yaml_path}
                elif _config_is_group(config):
                    index[config["group"]] = {"type": "group", "task": -1, "yaml_path": yaml_path}
                elif _config_is_task(config):
                    task = config["task"]
                    index[task] = {"type": "task", "yaml_path": yaml_path}
                    for attr in ["tag", "group"]:
                        if attr not in config:
                            continue
                        attr_list = config[attr]
                        if isinstance(attr_list, str):
                            attr_list = [attr_list]
                        for tag in attr_list:
                            if tag not in index:
                                index[tag] = {"type": "tag", "task": [task], "yaml_path": -1}
                            elif index[tag]["type"] != "tag":
                                log.warning(
                                    "tag %s already registered as a group; skipping", tag
                                )
                                break
                            else:
                                index[tag]["task"].append(task)
                else:
                    log.debug("file %s in %s is not a task or group", f, root)
        return index
