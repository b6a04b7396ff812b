"""CLI: offline metric computation on saved ``*_samples_*.jsonl`` files.

The JAX package's ``eval_metrics.py`` on the port, run as ``python -m
lmms_owc_tpu_torch.eval_metrics -i <samples> -m <metrics>``: glob-resolve
inputs, infer task/model from the ``.../{task_name}/{model_name}/*.jsonl``
path convention, run each requested metric, write per-sample intermediate
values back into the jsonl for the four model-based metrics, dedup multiple
runs keeping the larger, and print a per-task/per-model summary. The scoring
models run through :mod:`lmms_owc_tpu_torch.pipelines`: on the card, or on
the device ``LMMS_OWC_SCORING_DEVICE`` names; ``LMMS_OWC_SBERT_PATH`` and
``LMMS_OWC_JUDGE_PATH`` point at their checkpoints (without them the warned
fallbacks score).
"""

from __future__ import annotations

import os
import random
from argparse import ArgumentParser, Namespace
from pathlib import Path

import numpy as np
import pandas as pd

from lmms_owc_tpu_torch import utils
from lmms_owc_tpu_torch.metrics import get_metric_info

log = utils.get_logger(__name__)

# Metrics whose per-sample values are written back into the samples jsonl.
METRICS_TO_SAVE_INTERMEDIATE_VALUES = [
    "concept_semantic_similarity",
    "mean_average_semantic_similarity",
    "semantic_similarity",
    "textual_inclusion_llama32",
]


def _score_file(input_file: str, metric_names: list[str]) -> dict:
    """Compute all requested metrics for one samples file; may mutate the file."""
    df = pd.read_json(input_file, lines=True)
    predictions = df["filtered_resps"].tolist()
    references = df["target"].tolist()

    # Multi-round generation nests an extra list level.
    if isinstance(predictions[0], list) and isinstance(predictions[0][0], list):
        predictions = [prediction[0] for prediction in predictions]

    items = list(zip(references, predictions))
    outputs: dict = {"_num_samples": len(items)}

    for metric_name in metric_names:
        info = get_metric_info(metric_name)
        if info.name == "textual_inclusion":
            last_preds = [
                pred[-1] if isinstance(pred, list) else pred for pred in predictions
            ]
            output = info.builder_fn(last_preds, references)
        elif info.name in METRICS_TO_SAVE_INTERMEDIATE_VALUES:
            log.warning('setting reduce="none" for %s to save intermediate values', info.name)
            output = info.group_fn(info.builder_fn(items), reduce="none")

            extra_columns: dict = {}
            if info.name == "concept_semantic_similarity":
                concepts = [row[0] for row in output]
                similarities = [row[1] for row in output]
                output = [float(np.max(row)) for row in similarities]
                extra_columns["last_resp_concepts"] = concepts
                extra_columns["last_resp_concepts_similarities"] = similarities
            elif info.name == "mean_average_semantic_similarity":
                mass = output.pop("semantic_similarity@avg")
                extra_columns.update(output)
                output = mass

            log.info("saving intermediate values of %s into %s", info.name, input_file)
            df[info.name] = output
            for key, values in extra_columns.items():
                df[key] = values
            df.to_json(input_file, lines=True, orient="records")

            output = float(np.mean(output))
        else:
            output = info.group_fn(info.builder_fn(items))

        if isinstance(output, dict):
            outputs.update(output)
        else:
            outputs[metric_name] = output
    return outputs


def build_parser() -> ArgumentParser:
    parser = ArgumentParser()
    parser.add_argument(
        "-i", "--input", required=True, type=str,
        help="Path (or glob) to the folder/file containing the samples to process",
    )
    parser.add_argument(
        "-m", "--metrics", required=True, type=str,
        help="Comma-separated metrics to evaluate on the data",
    )
    parser.add_argument("--seed", type=int, default=1234, help="Random seed")
    parser.add_argument("--log-level", type=str, default="INFO", help="Logging level")
    return parser


def main(args: Namespace | list[str] | None = None) -> dict:
    """Run the CLI on a parsed namespace or an argument list (``sys.argv[1:]``
    when None); returns ``{task: {model: {metric: value}}}``, as printed."""
    if not isinstance(args, Namespace):
        args = build_parser().parse_args(args)
    os.environ.setdefault("LMMS_OWC_TPU_LOG_LEVEL", args.log_level)
    if args.seed:
        log.info("Setting random seed to %s", args.seed)
        random.seed(args.seed)
        np.random.seed(args.seed)

    input_paths = sorted(Path().glob(args.input)) if "*" in args.input else [Path(args.input)]
    input_files_per_path = [
        list(p.glob("**/*_samples_*.jsonl")) if p.is_dir() else [p] for p in input_paths
    ]
    input_files = sorted(map(str, sum(input_files_per_path, [])))

    log.info("Found %d jsonl files to process", len(input_files))
    log.info("Expecting run paths of the form .../{task_name}/{model_name}/")

    metric_names = args.metrics.split(",")
    tasks_outputs: dict = {}
    for input_file in input_files:
        task_name = Path(input_file).parent.parent.name
        model_name = Path(input_file).parent.name
        metric_outputs = _score_file(input_file, metric_names)

        task_models = tasks_outputs.setdefault(task_name, {})
        if model_name not in task_models:
            task_models[model_name] = metric_outputs
        else:
            prev, curr = task_models[model_name]["_num_samples"], metric_outputs["_num_samples"]
            log.warning(
                "multiple runs for task=%s model=%s (%d vs %d samples);"
                " keeping the larger (or oldest if even)",
                task_name, model_name, prev, curr,
            )
            if curr > prev:
                task_models[model_name] = metric_outputs

    for task_name, task_outputs in tasks_outputs.items():
        all_metric_names = sorted(
            {name for outputs in task_outputs.values() for name in outputs}
        )
        for metric_name in all_metric_names:
            if metric_name.startswith("_"):
                continue
            lines = [f"{metric_name.capitalize().replace('_', ' ')} on {task_name}:"]
            for model_name, outputs in task_outputs.items():
                if metric_name in outputs:
                    lines.append(f"{model_name:<29}: {outputs[metric_name]:.3f}")
            print("\n".join(lines) + "\n")
    return tasks_outputs


if __name__ == "__main__":
    main()
