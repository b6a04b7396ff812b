"""Evaluator of the port: ``evaluate`` (request lifecycle) and ``simple_evaluate``
(setup wrapper), the JAX package's ``engine.evaluator`` over ``torch.distributed``.

  - request sharding by rank is the JAX evaluator's (create_iterator over docs),
    where rank is the ``torch.distributed`` rank, or under an adapter's mesh
    the data coordinate: the ranks of one model group serve the same
    requests, the collectives run over each rank's data group, and only the
    ranks at model coordinate 0 gather the samples and write.
  - per-rank request-count padding is kept, so every rank runs the same number
    of batches and meets the same barriers.
  - the rank-0 gather of samples and metrics is ``all_gather_object``, and the
    barriers are ``dist.barrier()``. A single process never touches
    ``torch.distributed``.
  - ``LMMS_OWC_PROFILE_DIR`` traces the model phase with ``torch.profiler``
    (CPU and CUDA activities) and writes a Chrome trace there.
  - seeding covers python/numpy/torch: the third seed is ``torch_random_seed``,
    which the adapter's ``torch.Generator`` takes.
  - ``check_integrity`` runs the port's task tests for the selected tasks in a
    subprocess (:mod:`lmms_owc_tpu_torch.engine._integrity`), before the model loads.
"""

from __future__ import annotations

import math
import os
import random
import time
from argparse import Namespace
from collections import defaultdict
from typing import TYPE_CHECKING

import numpy as np
import torch

from lmms_owc_tpu_torch import utils
from lmms_owc_tpu_torch.models import get_model
from lmms_owc_tpu_torch.tasks import (
    TaskManager,
    get_consolidated_group_results,
    get_consolidated_results,
    get_subtasks_as_dict,
    get_tasks_as_dict,
    get_tasks_as_list,
    prepare_print_tasks,
)

if TYPE_CHECKING:
    from lmms_owc_tpu_torch.engine.tracker import EngineTracker
    from lmms_owc_tpu_torch.models import Model

log = utils.get_logger(__name__)

__all__ = ["evaluate", "simple_evaluate"]


_KNOWN_TYPES = ("loglikelihood", "generate_until", "generate_until_multi_round")


def _multihost_gather_objects(objs: list, rank: int, world_size: int, group=None) -> list:
    """Allgather python objects over ``group`` (None: the default group);
    every rank receives the concatenated list."""
    if world_size <= 1:
        return list(objs)
    gathered: list = [None] * world_size
    torch.distributed.all_gather_object(gathered, list(objs), group=group)
    return [obj for part in gathered for obj in part]


def _sync_processes(world_size: int, group=None) -> None:
    if world_size > 1:
        torch.distributed.barrier(group=group)


def _allgather_ints(values: list[int], world_size: int, group=None) -> np.ndarray:
    """[world_size, len(values)] of every rank's ``values`` (CPU tensors: gloo or nccl)."""
    local = torch.tensor(values, dtype=torch.int64)
    if torch.distributed.get_backend(group) == "nccl":
        local = local.cuda()
    parts = [torch.empty_like(local) for _ in range(world_size)]
    torch.distributed.all_gather(parts, local, group=group)
    return torch.stack(parts).cpu().numpy()


def evaluate(
    model: "Model",
    task_dict: dict,
    limit: int | float | None = None,
    cache_requests: bool = False,
    rewrite_requests_cache: bool = False,
    bootstrap_iters: int | None = 100000,
    write_out: bool = False,
    log_samples: bool = True,
    system_instruction: str | None = None,
    apply_chat_template: bool = False,
    fewshot_as_multiturn: bool = False,
    cli_args: Namespace | None = None,
) -> dict | None:
    """Run the request -> model -> filter -> metric pipeline over a task dict."""
    results: dict = defaultdict(dict)
    versions: dict = defaultdict(dict)
    configs: dict = defaultdict(dict)
    requests: dict = defaultdict(list)
    padding_requests: dict = defaultdict(int)
    task_hierarchy: dict = defaultdict(list)
    task_group_alias: dict = defaultdict(dict)
    num_fewshot: dict = defaultdict(int)

    RANK = model.rank
    WORLD_SIZE = model.world_size
    GROUP = getattr(model, "data_group", None)
    # Per-phase wall-clock (SURVEY 5: the reference records only total time;
    # we break out request build / model inference / scoring for observability).
    phase_timings: dict = {"build_requests": 0.0, "inference": {}, "scoring": 0.0}

    eval_tasks = get_tasks_as_list(task_dict)
    if not log_samples and any(
        "bypass" in getattr(t.task, "_metric_fn_list", {}) for t in eval_tasks
    ):
        raise ValueError("log_samples must be True for 'bypass' metric-only tasks")

    # ------------------------------------------------------------ build requests
    _t_build = time.perf_counter()
    for task_output in eval_tasks:
        task = task_output.task
        task_name = task_output.task_name
        task.args = cli_args

        group_name = None
        task_hierarchy[task_name] = []
        if isinstance(task, tuple):
            group_name, task = task
            task_hierarchy[group_name].append(task_name)
            versions[group_name] = "N/A"
        if task is None:
            continue

        versions[task_name] = task.VERSION
        configs[task_name] = dict(task.dump_config())
        num_fewshot[task_name] = configs[task_name].get("num_fewshot", 0)
        if "task_alias" in configs[task_name]:
            task_group_alias[task_name] = configs[task_name]["task_alias"]
        if (
            "group_alias" in configs[task_name]
            and group_name not in task_group_alias
            and group_name is not None
        ):
            task_group_alias[group_name] = configs[task_name]["group_alias"]

        if limit is not None:
            limit = int(math.ceil(len(task.eval_docs) * limit)) if limit < 1.0 else int(limit)

        task.build_all_requests(
            limit=limit,
            rank=RANK,
            world_size=WORLD_SIZE,
            cache_requests=cache_requests,
            rewrite_requests_cache=rewrite_requests_cache,
            system_instruction=system_instruction,
            apply_chat_template=apply_chat_template,
            fewshot_as_multiturn=fewshot_as_multiturn,
            chat_template=model.apply_chat_template if apply_chat_template else None,
            tokenizer_name=getattr(model, "tokenizer_name", "") if apply_chat_template else "",
        )
        log.debug("task %s: %d requests on rank %d", task_name, len(task.instances), RANK)

        if write_out:
            for inst in task.instances:
                if inst.doc_id < 1:
                    log.info(
                        "Task: %s; document %s; context prompt:\n%s\ntarget:\n%s",
                        task_name,
                        inst.doc_id,
                        inst.args[0],
                        task.doc_to_target(task.eval_docs_no_media[inst.doc_id]),
                    )

        for instance in task.instances:
            requests[instance.request_type].append(instance)

        if WORLD_SIZE > 1:
            # Pad request counts so every rank runs the same number of batches.
            gathered = _allgather_ints([len(task.instances)], WORLD_SIZE, GROUP).reshape(-1)
            req_type = (
                "loglikelihood" if task.OUTPUT_TYPE == "multiple_choice" else task.OUTPUT_TYPE
            )
            padding_requests[req_type] += int(gathered.max() - gathered[RANK])

    if WORLD_SIZE > 1:
        # Union of request types across hosts: a rank that received zero requests
        # of a type present elsewhere (world_size > doc count, small --limit) must
        # still enter that type's run loop, or the per-type _sync_processes barrier
        # counts diverge across ranks and the barrier deadlocks.
        gathered_types = _allgather_ints([int(t in requests) for t in _KNOWN_TYPES], WORLD_SIZE, GROUP)
        for i, t in enumerate(_KNOWN_TYPES):
            if gathered_types[:, i].any():
                requests[t]  # defaultdict: materialize the (possibly empty) list
        # Canonicalize ITERATION ORDER too: insertion order differs across ranks
        # when one rank first saw a type only via the union above, and the
        # per-type _sync_processes barriers must fire in the same sequence
        # everywhere. (A rank whose list is empty still dispatches zero model
        # batches for that type — fine for this DP design, where each rank's
        # model is its own and only metric gathers cross ranks.)
        ordered = {t: requests[t] for t in _KNOWN_TYPES if t in requests}
        requests.clear()
        requests.update(ordered)

    phase_timings["build_requests"] = round(time.perf_counter() - _t_build, 3)

    # ------------------------------------------------------------ run the model
    profile_dir = os.environ.get("LMMS_OWC_PROFILE_DIR")
    profiler = None
    if profile_dir and RANK == 0:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()
        log.info("torch profiler tracing to %s", profile_dir)

    for req_type, reqs in requests.items():
        log.info("Running %d %s requests", len(reqs), req_type)
        t_start = time.perf_counter()

        cloned_reqs: list = []
        for req in reqs:
            cloned_reqs.extend([req] * req.repeats)
        if WORLD_SIZE > 1 and padding_requests[req_type] > 0 and reqs:
            for _ in range(padding_requests[req_type]):
                cloned_reqs.extend([reqs[-1]] * reqs[-1].repeats)

        # Response cache (--use_cache DIR): serve hits from disk, run only misses.
        # The reference ships this as a never-initialized scaffold
        # (src/models/_base.py:23-53); here it is functional. Keys hash every
        # request arg except the non-serializable doc_to_visual callable at
        # index 2 — doc identity (doc_id, task, split) stays in the key.
        # Callables that remain in args (doc_to_target at index 1 for
        # loglikelihood, doc_to_text at index 3 for multi-round) map to their
        # module-qualified names: stringifying the object itself would embed a
        # per-process 0x... address and the on-disk cache could never hit again.
        def _stable_key_part(value):
            if callable(value):
                fn = getattr(value, "func", value)  # unwrap functools.partial
                name = getattr(fn, "__qualname__", type(fn).__qualname__)
                return f"<fn:{getattr(fn, '__module__', '')}.{name}>"
            return value

        def _cache_key(req):
            return tuple(_stable_key_part(v) for v in req.args[:2] + req.args[3:])

        cache = model.cache_hook
        if cache.cache_dir is not None:
            misses = [
                req for req in cloned_reqs if cache.get(req_type, _cache_key(req)) is None
            ]
            if misses:
                miss_resps = getattr(model, req_type)(misses)
                for resp, req in zip(miss_resps, misses):
                    cache.add_partial(req_type, _cache_key(req), resp)
            hits = len(cloned_reqs) - len(misses)
            if hits:
                log.info("%s: %d/%d responses served from cache", req_type, hits, len(cloned_reqs))
            resps = [cache.get(req_type, _cache_key(req)) for req in cloned_reqs]
        else:
            resps = getattr(model, req_type)(cloned_reqs)

        for resp, req in zip(resps, cloned_reqs):
            req.resps.append(resp)

        elapsed = time.perf_counter() - t_start
        phase_timings["inference"][req_type] = round(elapsed, 3)
        if elapsed > 0:
            log.info(
                "%s finished: %d requests in %.2fs (%.2f req/s)",
                req_type,
                len(cloned_reqs),
                elapsed,
                len(cloned_reqs) / elapsed,
            )
        _sync_processes(WORLD_SIZE, GROUP)

    if profiler is not None:
        profiler.stop()
        os.makedirs(profile_dir, exist_ok=True)
        trace = os.path.join(profile_dir, f"trace_{utils.get_datetime_str()}.json")
        profiler.export_chrome_trace(trace)
        log.info("wrote the torch profiler trace to %s", trace)

    # Padded duplicates appended extra resps to the final request; trim them.
    for req_type, reqs in requests.items():
        for req in reqs:
            if len(req.resps) > req.repeats:
                del req.resps[req.repeats :]

    if getattr(model, "model_rank", 0) != 0:
        return None  # the model group's rank 0 holds the same responses and reports them

    # ------------------------------------------------------------ score samples
    _t_score = time.perf_counter()
    for task_output in eval_tasks:
        task = task_output.task
        if not task.instances:
            # This rank drew no documents for the task (world_size > doc count);
            # the rank-0 gather below still collects the other ranks' samples.
            continue
        task.apply_filters()

        instances_by_doc_id: dict = defaultdict(list)
        for instance in task.instances:
            instances_by_doc_id[instance.doc_id].append(instance)
        for instances in instances_by_doc_id.values():
            instances.sort(key=lambda x: x.idx)

        for filter_key in task.instances[0].filtered_resps:
            if not getattr(cli_args, "process_with_media", False):
                doc_iterator = utils.create_iterator(
                    enumerate(task.eval_docs_no_media),
                    rank=RANK,
                    limit=int(limit) if limit else None,
                    world_size=WORLD_SIZE,
                )
            else:
                doc_iterator = task.doc_iterator(rank=RANK, limit=limit, world_size=WORLD_SIZE)

            for doc_id, doc in doc_iterator:
                doc_requests = instances_by_doc_id[doc_id]
                metrics = task.process_results(
                    doc, [req.filtered_resps[filter_key] for req in doc_requests]
                )

                if log_samples:
                    target = task.doc_to_target(doc)
                    saved_doc = {k: v for k, v in doc.items() if "image" not in k}
                    serializable = (str, int, float, bool, list, dict, type(None))
                    filtered_arguments = [
                        value for req in doc_requests for value in req.args
                        if isinstance(value, serializable)
                    ]
                    example = {
                        "doc_id": doc_id,
                        "doc": saved_doc,
                        "target": target,
                        "arguments": filtered_arguments,
                        "resps": [req.resps for req in doc_requests],
                        "filtered_resps": [
                            req.filtered_resps[filter_key] for req in doc_requests
                        ],
                        "doc_hash": utils.hash_string(
                            utils.json_dumps_deterministic(doc_requests[0].doc)
                        ),
                        "prompt_hash": utils.hash_string(str(doc_requests[0].arguments[0])),
                        "target_hash": utils.hash_string(str(target)),
                    }
                    example.update(metrics)
                    task_output.logged_samples.append(example)

                for metric, value in metrics.items():
                    task_output.sample_metrics[(metric, filter_key)].append(value)

    # ------------------------------------------------------------ gather to rank 0
    if WORLD_SIZE > 1:
        for task_output in eval_tasks:
            if log_samples:
                gathered_samples = _multihost_gather_objects(
                    task_output.logged_samples, RANK, WORLD_SIZE, GROUP
                )
                if RANK == 0:
                    task_output.logged_samples = gathered_samples
            # Every rank must issue an identical collective sequence: a rank with
            # zero instances for this task has no local metric keys, so agree on
            # the union of keys first, then gather each in a canonical order.
            all_keys = sorted(
                set(
                    _multihost_gather_objects(
                        sorted(task_output.sample_metrics.keys()), RANK, WORLD_SIZE, GROUP
                    )
                )
            )
            for metric_key in all_keys:
                gathered_metrics = _multihost_gather_objects(
                    task_output.sample_metrics.get(metric_key, []), RANK, WORLD_SIZE, GROUP
                )
                if RANK == 0:
                    task_output.sample_metrics[metric_key] = gathered_metrics
        _sync_processes(WORLD_SIZE, GROUP)

    phase_timings["scoring"] = round(time.perf_counter() - _t_score, 3)

    if RANK != 0:
        _sync_processes(WORLD_SIZE, GROUP)
        return None

    # ------------------------------------------------------------ aggregate
    for task_output in eval_tasks:
        task_output.calculate_aggregate_metric(bootstrap_iters)
    results, samples, configs, versions, num_fewshot, higher_is_better = (
        get_consolidated_results(eval_tasks)
    )

    show_group_table = False
    if bool(results):
        results, versions, show_group_table, *_ = get_consolidated_group_results(
            results, versions, task_dict
        )

    results_agg, group_agg = prepare_print_tasks(task_dict, results)
    subtasks_dict = get_subtasks_as_dict(task_dict)

    # Merge higher_is_better across each group's subtasks.
    _higher_is_better: dict = {}
    for group, task_list in subtasks_dict.items():
        if len(task_list) != 0:
            for task in task_list:
                for metric, hib in higher_is_better[task].items():
                    if metric not in _higher_is_better:
                        _higher_is_better[metric] = hib
                    elif _higher_is_better[metric] is not None and _higher_is_better[metric] != hib:
                        log.warning(
                            "inconsistent higher_is_better for metric %s in group %s;"
                            " defaulting to None",
                            metric,
                            group,
                        )
                        _higher_is_better[metric] = None
            higher_is_better[group] = _higher_is_better

    results_dict = {
        "results": dict(results_agg.items()),
        **({"groups": dict(group_agg.items())} if bool(group_agg) & show_group_table else {}),
        "group_subtasks": dict(reversed(list(subtasks_dict.items()))),
        "configs": dict(sorted(configs.items())),
        "versions": dict(sorted(versions.items())),
        "n-shot": dict(sorted(num_fewshot.items())),
        "higher_is_better": dict(sorted(higher_is_better.items())),
        "n-samples": {
            task_output.task_name: {
                "original": len(task_output.task.eval_docs),
                "effective": min(
                    limit if limit else len(task_output.task.eval_docs),
                    len(task_output.task.eval_docs),
                ),
            }
            for task_output in eval_tasks
        },
    }
    results_dict["timings"] = phase_timings
    if log_samples:
        results_dict["samples"] = dict(samples)

    _sync_processes(WORLD_SIZE, GROUP)
    return results_dict


def simple_evaluate(
    model_name: str,
    model_args: str | None = None,
    tasks: list | None = None,
    num_fewshot: int | None = None,
    batch_size: int | None = None,
    use_cache: str | None = None,
    cache_requests: bool = False,
    rewrite_requests_cache: bool = False,
    delete_requests_cache: bool = False,
    limit: int | float | None = None,
    bootstrap_iters: int = 100000,
    check_integrity: bool = False,
    write_out: bool = False,
    log_samples: bool = True,
    engine_tracker: "EngineTracker | None" = None,
    system_instruction: str | None = None,
    apply_chat_template: bool = False,
    fewshot_as_multiturn: bool = False,
    gen_kwargs: str | None = None,
    task_manager: TaskManager | None = None,
    predict_only: bool = False,
    random_seed: int = 0,
    numpy_random_seed: int = 1234,
    torch_random_seed: int = 1234,
    fewshot_random_seed: int = 1234,
    datetime_str: str | None = None,
    cli_args: Namespace | None = None,
) -> dict | None:
    """Set up tasks + model, run :func:`evaluate`, and attach the run config."""
    if datetime_str is None:
        datetime_str = utils.get_datetime_str()

    if random_seed is not None:
        log.info("Setting random seed to %d", random_seed)
        random.seed(random_seed)
    if numpy_random_seed is not None:
        log.info("Setting numpy seed to %d", numpy_random_seed)
        np.random.seed(numpy_random_seed)
    if torch_random_seed is not None:
        log.info("Setting torch seed to %d", torch_random_seed)
        torch.manual_seed(torch_random_seed)

    if delete_requests_cache:
        log.info("Deleting requests cache...")
        utils.delete_cache()

    if not tasks:
        raise ValueError("no tasks specified, or no tasks found")
    if check_integrity:  # before the model loads: a failing check costs no load
        from lmms_owc_tpu_torch.engine._integrity import run_task_tests

        run_task_tests(task_list=tasks)

    if gen_kwargs:
        gen_kwargs = utils.parse_string_args(gen_kwargs)
        log.warning("generation_kwargs specified through cli; overriding task YAML settings")
        if gen_kwargs == "":
            gen_kwargs = None

    if model_args is None:
        model_args = ""
    if task_manager is None:
        task_manager = TaskManager(model_name=model_name)

    task_dict = get_tasks_as_dict(tasks, task_manager)

    model_kwargs = utils.parse_string_args(model_args)
    if use_cache is not None:
        model_kwargs.setdefault("use_cache", use_cache)
    if batch_size is not None:
        model_kwargs.setdefault("batch_size", batch_size)
    model_kwargs.setdefault("torch_random_seed", torch_random_seed)
    model = get_model(model_name, **model_kwargs)

    def _adjust_config(task_dict: dict) -> dict:
        adjusted: dict = {}
        for task_name, task_obj in task_dict.items():
            if isinstance(task_obj, dict):
                adjusted[task_name] = _adjust_config(task_obj)
                continue
            if isinstance(task_obj, tuple):
                _group, task_obj = task_obj
                if task_obj is None:
                    continue
            model.task_dict[task_name] = task_obj
            if "generate_until" in task_obj.get_config("output_type") and gen_kwargs:
                task_obj.set_config(key="generation_kwargs", value=gen_kwargs, update=True)
            if predict_only:
                log.info("processing %s in output-only mode; metrics not calculated", task_name)
                task_obj.override_metric(metric_name="bypass")
            if num_fewshot is not None:
                if task_obj.get_config("num_fewshot") == 0:
                    log.info("num_fewshot pinned to 0 in %s config; not overriding", task_name)
                else:
                    task_obj.set_config(key="num_fewshot", value=num_fewshot)
            elif task_obj.get_config("num_fewshot") is None:
                task_obj.set_config(key="num_fewshot", value=0)
            task_obj.set_fewshot_seed(seed=fewshot_random_seed)
            adjusted[task_name] = task_obj
        return adjusted

    task_dict = _adjust_config(task_dict)

    if engine_tracker is not None:
        engine_tracker.general_config_tracker.log_experiment_args(
            model_source=model_name,
            model_args=model_args,
            system_instruction=system_instruction,
            chat_template=getattr(model, "chat_template", None) if apply_chat_template else None,
            fewshot_as_multiturn=fewshot_as_multiturn,
        )

    results = evaluate(
        model=model,
        task_dict=task_dict,
        limit=limit,
        cache_requests=cache_requests,
        rewrite_requests_cache=rewrite_requests_cache,
        bootstrap_iters=bootstrap_iters,
        write_out=write_out,
        log_samples=True if predict_only else log_samples,
        system_instruction=system_instruction,
        apply_chat_template=apply_chat_template,
        fewshot_as_multiturn=fewshot_as_multiturn,
        cli_args=cli_args,
    )

    if results is not None:
        results["config"] = {
            "model": model_name,
            "model_args": model_args,
            "batch_size": batch_size,
            "batch_sizes": list(getattr(model, "batch_sizes", {}).values()),
            "use_cache": use_cache,
            "limit": limit,
            "bootstrap_iters": bootstrap_iters,
            "gen_kwargs": gen_kwargs,
            "random_seed": random_seed,
            "numpy_seed": numpy_random_seed,
            "torch_seed": torch_random_seed,
            "fewshot_seed": fewshot_random_seed,
        }
        results["git_hash"] = utils.get_git_commit_hash()
        results["date"] = datetime_str
        return results
    return None
