"""CLI of the port: evaluate model(s) on task(s) with PyTorch on the card.

    python -m lmms_owc_tpu_torch.eval_model --model qwen2-vl-7b \
        --model_args pretrained=DIR,dtype=bfloat16 --tasks toy \
        --include_path tests/fixtures/tasks --log_samples --output_path OUT

The JAX package's ``eval_model.py``: the same flag surface, task-listing
subcommands, multi-run YAML configs, EngineTracker output and markdown result
tables. Models run on the card unless ``--model_args`` holds ``device=cpu``.
Data parallelism is one process per card, started by ``torchrun`` or by hand
with ``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` in the
environment: ``torch.distributed`` is initialised (nccl for a CUDA model,
gloo on the CPU) only when ``WORLD_SIZE`` is above 1. :func:`main` takes an
argument list, so the CLI runs in-process too.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
from functools import partial

import torch
import yaml

from lmms_owc_tpu_torch import utils
from lmms_owc_tpu_torch.engine import EngineTracker, simple_evaluate
from lmms_owc_tpu_torch.models import get_model_info
from lmms_owc_tpu_torch.tasks import TaskManager
from lmms_owc_tpu_torch.utils import make_table

log = utils.get_logger(__name__)


def _int_or_none_list_arg_type(
    min_len: int, max_len: int, defaults: str, value: str, split_char: str = ","
):
    """Parse the --seed argument: a single int or a list of int-or-None values."""

    def parse_value(item: str):
        item = item.strip().lower()
        if item == "none":
            return None
        try:
            return int(item)
        except ValueError as err:
            raise argparse.ArgumentTypeError(f"{item!r} is not an integer or None") from err

    items = [parse_value(v) for v in value.split(split_char)]
    num_items = len(items)
    if num_items == 1:
        items = items * max_len
    elif num_items < min_len or num_items > max_len:
        raise argparse.ArgumentTypeError(
            f"argument requires {max_len} integers or 'None' (separated by {split_char!r})"
        )
    elif num_items != max_len:
        log.warning(
            "argument requires %d integers or None; missing values filled with defaults %s",
            max_len,
            defaults,
        )
        default_items = [parse_value(v) for v in defaults.split(split_char)]
        items.extend(default_items[num_items:])
    return items


def _handle_task_listing(args, task_manager: TaskManager) -> bool:
    """Handle the --tasks list/list_groups/list_tags/list_subtasks/list_with_num commands."""
    if args.tasks is None:
        return False
    if args.tasks == "list":
        print(task_manager.list_all_tasks())
    elif args.tasks == "list_groups":
        print(task_manager.list_all_tasks(list_subtasks=False, list_tags=False))
    elif args.tasks == "list_tags":
        print(task_manager.list_all_tasks(list_groups=False, list_subtasks=False))
    elif args.tasks == "list_subtasks":
        print(task_manager.list_all_tasks(list_groups=False, list_tags=False))
    elif args.tasks == "list_with_num":
        log.info(
            "Loading every task to report sample counts; this downloads all datasets."
        )
        # Fail fast per task when datasets are unreachable (offline hosts).
        os.environ.setdefault("LMMS_OWC_RETRY_ATTEMPTS", "1")
        for task_name in sorted(task_manager.all_subtasks):
            try:
                from lmms_owc_tpu_torch.tasks import get_tasks_as_dict

                task_dict = get_tasks_as_dict([task_name], task_manager)
                for name, task in task_dict.items():
                    if isinstance(task, dict):
                        continue
                    print(f"{name}: {len(task.eval_docs)} samples")
            except Exception as err:  # noqa: BLE001
                log.warning("failed to load %s: %s", task_name, err)
    else:
        return False
    return True


def _run_single_evaluation(args) -> tuple[dict | None, "EngineTracker | None"]:
    """Run one evaluation config."""
    if args.include_path is not None:
        log.info("Including external tasks from %s", args.include_path)
    task_manager = TaskManager(include_path=args.include_path, model_name=args.model)

    if args.limit:
        log.warning("--limit SHOULD ONLY BE USED FOR TESTING. REAL METRICS SHOULD NOT BE COMPUTED USING LIMIT.")

    if _handle_task_listing(args, task_manager):
        sys.exit(0)

    if args.tasks is None:
        log.error("Need to specify tasks to evaluate.")
        sys.exit(2)
    if os.path.isdir(args.tasks):
        import glob

        task_names = []
        for yaml_file in glob.glob(f"{args.tasks}/*.yaml"):
            task_names.append(utils.load_yaml_config(yaml_file))
    else:
        task_list = args.tasks.split(",")
        task_names = task_manager.match_tasks(task_list)
        for task in (t for t in task_list if t not in task_names):
            if os.path.isfile(task):
                task_names.append(utils.load_yaml_config(task))
        missing = ", ".join(t for t in task_list if t not in task_names and "*" not in t)
        if missing:
            log.error(
                "Tasks were not found: %s. Try `python -m lmms_owc_tpu_torch.eval_model --tasks list` for a list of"
                " available tasks",
                missing,
            )
            raise ValueError(f"Tasks not found: {missing}")

    engine_tracker_args = utils.parse_string_args(args.hf_hub_log_args)
    if args.output_path:
        engine_tracker_args["output_path"] = args.output_path
    engine_tracker = EngineTracker(**engine_tracker_args) if engine_tracker_args else EngineTracker(
        output_path=args.output_path
    )

    log.info("Selected tasks: %s", task_names)

    datetime_str = utils.get_datetime_str(timezone=args.timezone)
    results = simple_evaluate(
        model_name=args.model,
        model_args=args.model_args,
        tasks=task_names,
        num_fewshot=args.num_fewshot,
        batch_size=args.batch_size,
        use_cache=args.use_cache,
        cache_requests=args.cache_requests == "true",
        rewrite_requests_cache=args.cache_requests == "refresh",
        delete_requests_cache=args.cache_requests == "delete",
        limit=args.limit,
        check_integrity=args.check_integrity,
        write_out=args.write_out,
        log_samples=args.log_samples,
        engine_tracker=engine_tracker,
        system_instruction=args.system_instruction,
        apply_chat_template=args.apply_chat_template,
        fewshot_as_multiturn=args.fewshot_as_multiturn,
        gen_kwargs=args.gen_kwargs,
        task_manager=task_manager,
        predict_only=args.predict_only,
        random_seed=args.seed[0],
        numpy_random_seed=args.seed[1],
        torch_random_seed=args.seed[2],
        fewshot_random_seed=args.seed[3],
        datetime_str=datetime_str,
        cli_args=args,
    )

    if results is not None:
        if args.log_samples:
            samples = results.pop("samples")
        else:
            samples = None
        dumped = json.dumps(results, indent=4, default=utils.convert_non_serializable)
        if args.show_config:
            print(dumped)

        engine_tracker.save_results_aggregated(
            results=results, samples=samples if args.log_samples else None, datetime_str=datetime_str
        )
        if args.log_samples:
            for task_name in results["configs"]:
                engine_tracker.save_results_samples(
                    task_name=task_name, samples=samples[task_name]
                )
        if engine_tracker.push_results_to_hub or engine_tracker.push_samples_to_hub:
            engine_tracker.recreate_metadata_card()

        return results, samples
    return None, None


def _maybe_init_distributed(model: str, model_args: str) -> None:
    """Initialise ``torch.distributed`` from the environment when ``WORLD_SIZE`` > 1.

    The backend is nccl when the model runs on the card (each rank takes the
    card ``LOCAL_RANK``), gloo when it runs on the CPU (``device=cpu`` in
    ``--model_args``, or an adapter whose default device is the CPU, as the
    fake model's). ``MASTER_ADDR``/``MASTER_PORT`` (as ``torchrun`` sets them)
    give the rendezvous; ``LMMS_OWC_DIST_TIMEOUT`` (seconds) bounds every
    collective's wait (torch's default otherwise).
    """
    world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if world_size <= 1 or torch.distributed.is_initialized():
        return
    # A registered factory function (every real adapter's) defaults to the card.
    default = getattr(get_model_info(model).model_cls, "default_device", "cuda")
    device = str(utils.parse_string_args(model_args).get("device") or default)
    backend = "gloo" if device.startswith("cpu") else "nccl"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0"))))
    timeout = os.environ.get("LMMS_OWC_DIST_TIMEOUT")
    torch.distributed.init_process_group(
        backend=backend, init_method="env://", world_size=world_size,
        rank=int(os.environ["RANK"]),
        **({"timeout": datetime.timedelta(seconds=float(timeout))} if timeout else {}),
    )


def main(args: argparse.Namespace | list[str] | None = None) -> list:
    """Run the CLI on a parsed namespace or an argument list (``sys.argv[1:]``
    when None); returns each run's results dict (None on ranks other than 0)."""
    if not isinstance(args, argparse.Namespace):
        args = build_parser().parse_args(args)
    if isinstance(args.seed, str):
        args.seed = _int_or_none_list_arg_type(3, 4, "0,1234,1234,1234", args.seed)
    os.environ.setdefault("LMMS_OWC_TPU_LOG_LEVEL", args.log_level)
    _maybe_init_distributed(args.model, args.model_args)
    if args.wandb_args:
        from lmms_owc_tpu_torch.loggers import WandbLogger

        wandb_logger = WandbLogger(**utils.parse_string_args(args.wandb_args))
    else:
        wandb_logger = None

    args_list = []
    if args.config:
        if not os.path.exists(args.config):
            raise ValueError(f"Config file does not exist: {args.config}")
        with open(args.config, encoding="utf-8") as f:
            config_args = yaml.safe_load(f)
        if isinstance(config_args, list):
            args_list.extend([argparse.Namespace(**{**vars(args), **c}) for c in config_args])
        else:
            args_list.append(argparse.Namespace(**{**vars(args), **config_args}))
    else:
        args_list.append(args)

    aggregate_results = []
    for run_args in args_list:
        try:
            results, samples = _run_single_evaluation(run_args)
            aggregate_results.append(results)
            if results is not None:
                if wandb_logger is not None:
                    wandb_logger.post_init(results)
                    wandb_logger.log_eval_result()
                    if run_args.wandb_log_samples and samples is not None:
                        wandb_logger.log_eval_samples(samples)
                print(
                    f"{run_args.model} ({run_args.model_args}),"
                    f" gen_kwargs: ({run_args.gen_kwargs}),"
                    f" limit: {run_args.limit},"
                    f" num_fewshot: {run_args.num_fewshot},"
                    f" batch_size: {run_args.batch_size}"
                )
                print(make_table(results))
                if "groups" in results:
                    print(make_table(results, "groups"))
        except SystemExit:
            raise
        except Exception as err:  # noqa: BLE001
            if len(args_list) == 1:
                raise
            log.error("Error during evaluation: %s; continuing with next config", err)
            aggregate_results.append(None)

    if wandb_logger is not None:
        wandb_logger.finish()
    return aggregate_results


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument("--config", default="", help="Path to a YAML file specifying all eval arguments; may define a list of runs")
    parser.add_argument("--model", default="fake", help="Name of the model adapter, e.g. qwen2-vl-7b")
    parser.add_argument("--tasks", default=None, help="Comma-separated task names, or list/list_groups/list_tags/list_subtasks/list_with_num")
    parser.add_argument("--model_args", default="", help="String arguments for the model, e.g. pretrained=...,dtype=bfloat16")
    parser.add_argument("--num_fewshot", type=int, default=None, help="Number of examples in the few-shot context")
    parser.add_argument("--batch_size", "-b", type=int, default=8, help="Requests per model batch")
    parser.add_argument("--output_path", default=None, type=str, metavar="DIR", help="Directory for results/samples output")
    parser.add_argument("--limit", type=float, default=None, help="Limit number of examples per task (<1 = fraction)")
    parser.add_argument("--use_cache", "-c", type=str, default=None, metavar="DIR", help="Directory for the model-response cache; None disables caching")
    parser.add_argument("--cache_requests", type=str, default=None, choices=["true", "refresh", "delete"], help="Cache the building of dataset requests")
    parser.add_argument("--check_integrity", action="store_true", help="Run the relevant test-suite subset for the tasks")
    parser.add_argument("--write_out", "-w", action="store_true", default=False, help="Print prompts of the first few documents")
    parser.add_argument("--log_samples", action="store_true", default=False, help="Write out all model outputs and documents")
    parser.add_argument("--wandb_log_samples", action="store_true", default=False, help="Log all model outputs and documents to W&B")
    parser.add_argument("--log_samples_suffix", type=str, default="model_outputs", help="Suffix for the log_samples file name")
    parser.add_argument("--system_instruction", type=str, default=None, help="System instruction for the prompt")
    parser.add_argument("--apply_chat_template", action="store_true", default=False, help="Apply the chat template to the prompt")
    parser.add_argument("--fewshot_as_multiturn", action="store_true", default=False, help="Use fewshot examples as a multi-turn conversation")
    parser.add_argument("--show_config", action="store_true", default=False, help="Print the full task configs after evaluation")
    parser.add_argument("--include_path", type=str, default=None, help="Additional path to include external task YAMLs")
    parser.add_argument("--gen_kwargs", default="", help="String arguments for generation, e.g. temperature=0,top_p=0.95")
    parser.add_argument("--log_level", type=str, default="INFO", help="Logging verbosity")
    parser.add_argument("--wandb_args", default="", help="Comma-separated arguments for wandb.init, e.g. project=eval_model")
    parser.add_argument("--timezone", default="Europe/Rome", help="Timezone for the datetime string in output filenames")
    parser.add_argument("--hf_hub_log_args", type=str, default="", help="Comma-separated arguments for HF Hub logging")
    parser.add_argument("--predict_only", "-x", action="store_true", default=False, help="Only save model outputs; do not evaluate metrics")
    default_seed_string = "0,1234,1234,1234"
    parser.add_argument(
        "--seed",
        type=partial(_int_or_none_list_arg_type, 3, 4, default_seed_string),
        default=default_seed_string,
        help="Seeds for python random / numpy / torch / fewshot sampling (single int or 4 comma-separated)",
    )
    parser.add_argument("--process_with_media", action="store_true", help="Iterate docs with media during postprocessing")
    return parser


if __name__ == "__main__":
    main()
