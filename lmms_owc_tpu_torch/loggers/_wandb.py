"""Weights & Biases logger (the JAX package's ``loggers._wandb``).

Run init from CLI
arg string; results -> W&B summary + eval/group result tables + JSON artifact;
per-sample tables per task AND per group (grouped tasks concatenate into one table
with group/task columns), with per-task sample JSON artifacts. Degrades to a
warning when wandb is not installed.
"""

from __future__ import annotations

import copy
import json
from typing import Any

from lmms_owc_tpu_torch import utils

log = utils.get_logger(__name__)

__all__ = ["WandbLogger"]


def _flatten_results(results: dict, parent_key: str = "", sep: str = "/") -> dict:
    items: dict = {}
    for key, value in results.items():
        new_key = f"{parent_key}{sep}{key}" if parent_key else str(key)
        if isinstance(value, dict):
            items.update(_flatten_results(value, new_key, sep))
        elif isinstance(value, (int, float)):
            items[new_key] = value
    return items


class WandbLogger:
    """Log evaluation results and samples to Weights & Biases."""

    def __init__(self, **kwargs: Any) -> None:
        self.wandb_args = kwargs
        self.run = None
        self.results: dict = {}
        self.task_names: list = []
        self.group_names: list = []
        self.task_configs: dict = {}
        try:
            import wandb

            self._wandb = wandb
            self.run = wandb.init(**kwargs)
        except ImportError:
            self._wandb = None
            log.warning("wandb is not installed; WandbLogger is a no-op")
        except Exception as err:  # noqa: BLE001
            self._wandb = None
            log.warning("wandb.init failed (%s); WandbLogger is a no-op", err)

    def post_init(self, results: dict) -> None:
        self.results = copy.deepcopy(results)
        self.task_names = list(results.get("results", {}).keys())
        self.group_names = list(results.get("groups", {}).keys())
        self.task_configs = results.get("configs", {}) or {}

    # ------------------------------------------------------------------ results

    def _results_table(self, key: str):
        """One row per (task, metric, filter): Version/Filter/n-shot/Value/Stderr."""
        head = "Groups" if key == "groups" else "Tasks"
        table = self._wandb.Table(
            columns=[head, "Version", "Filter", "num_fewshot", "Metric", "Value", "Stderr"]
        )
        for task, metric_dict in self.results.get(key, {}).items():
            if key != "groups" and task in self.group_names:
                continue
            version = self.results.get("versions", {}).get(task)
            version = None if version == "N/A" else version
            n_shot = self.results.get("n-shot", {}).get(task)
            for metric_filter, value in metric_dict.items():
                metric, _, filter_name = str(metric_filter).partition(",")
                if metric == "alias" or metric.endswith("_stderr"):
                    continue
                stderr = metric_dict.get(f"{metric}_stderr,{filter_name}", "")
                if isinstance(stderr, float):
                    stderr = f"{stderr:.4f}"
                elif stderr == "N/A":
                    stderr = ""
                table.add_data(task, version, filter_name, n_shot, metric, str(value), str(stderr))
        return table

    def log_eval_result(self) -> None:
        if self._wandb is None or self.run is None:
            return
        config = self.results.get("config", {})
        self.run.config.update(config, allow_val_change=True)
        wandb_summary = _flatten_results(
            {
                "results": self.results.get("results", {}),
                "groups": self.results.get("groups", {}),
            }
        )
        self.run.summary.update(wandb_summary)
        self.run.log(wandb_summary)
        self.run.log({"evaluation/eval_results": self._results_table("results")})
        if self.results.get("groups"):
            self.run.log({"evaluation/group_eval_results": self._results_table("groups")})
        # Dump the full results blob as an artifact for post-hoc analysis.
        artifact = self._wandb.Artifact("results", type="eval_results")
        with artifact.new_file("results.json", mode="w", encoding="utf-8") as f:
            f.write(json.dumps(self.results, indent=2, default=utils.convert_non_serializable))
        self.run.log_artifact(artifact)

    # ------------------------------------------------------------------ samples

    def _samples_frame(self, task_samples: list[dict], config: dict):
        """Per-output-type sample table: inputs, raw/filtered predictions, metrics."""
        import pandas as pd

        output_type = (config or {}).get("output_type", "generate_until")
        rows = []
        for sample in task_samples:
            # The engine logs "arguments" as a FLAT list of the serializable arg
            # values across the doc's requests (evaluator.py log_samples); the
            # first string is the context. Per-request segmentation is only
            # attempted when the flat list divides evenly by the request count.
            args = sample.get("arguments") or []
            n_req = len(sample.get("resps") or []) or 1
            stride = len(args) // n_req if args and len(args) % n_req == 0 else 0
            instance = str(args[0]) if args else ""
            row = {
                "id": sample.get("doc_id"),
                "data": instance,
                "input_len": len(instance),
                "labels": str(sample.get("target")),
                "output_type": output_type,
            }
            resps = sample.get("resps") or []
            filtered = sample.get("filtered_resps") or []
            if output_type == "loglikelihood":
                if stride > 1 and isinstance(args[1], str):
                    row["labels"] = args[1]
                if resps and resps[0]:
                    loss, greedy = resps[0][0][0], resps[0][0][1]
                    row["raw_predictions"] = (
                        f"loss of continuation is {loss}; greedy match: {bool(greedy)}"
                    )
                if filtered:
                    loss, greedy = filtered[0][0], filtered[0][1]
                    row["filtered_predictions"] = (
                        f"loss of continuation is {loss}; greedy match: {bool(greedy)}"
                    )
            elif output_type == "multiple_choice":
                if stride > 1:
                    row["choices"] = "\n".join(
                        f"{i}. {args[i * stride + 1]}" for i in range(n_req)
                        if isinstance(args[i * stride + 1], str)
                    )
                # Responses hold losses: the selected choice is the argmin.
                if resps:
                    losses = [r[0][0] for r in resps if r]
                    row["raw_predictions"] = int(min(range(len(losses)), key=losses.__getitem__)) if losses else None
                if filtered:
                    losses = [f[0] for f in filtered]
                    row["filtered_predictions"] = int(min(range(len(losses)), key=losses.__getitem__)) if losses else None
            else:  # generate_until / multi-round
                if resps and resps[0]:
                    row["raw_predictions"] = str(resps[0][0])
                if filtered:
                    row["filtered_predictions"] = str(filtered[0])
            for metric_spec in (config or {}).get("metric_list", []) or []:
                name = metric_spec.get("metric") if isinstance(metric_spec, dict) else None
                if name and name in sample:
                    row[name] = sample[name]
            # Fall back to whatever per-sample metric values the engine attached.
            for key, value in sample.items():
                if key not in row and isinstance(value, (int, float, bool)):
                    row[key] = value
            rows.append(row)
        return pd.DataFrame(rows)

    def _log_samples_artifact(self, task_samples: list[dict], task_name: str) -> None:
        dumped = json.dumps(
            task_samples, indent=2, default=utils.convert_non_serializable, ensure_ascii=False
        )
        artifact = self._wandb.Artifact(task_name, type="samples_by_task")
        with artifact.new_file(f"{task_name}_eval_samples.json", mode="w", encoding="utf-8") as f:
            f.write(dumped)
        self.run.log_artifact(artifact)

    def log_eval_samples(self, samples: dict) -> None:
        if self._wandb is None or self.run is None:
            return
        import pandas as pd

        task_names = [t for t in self.task_names if t not in self.group_names]
        by_group: dict[str, list[str]] = {}
        ungrouped: list[str] = []
        for task_name in task_names:
            groups = (self.task_configs.get(task_name) or {}).get("group")
            if groups:
                for group in [groups] if isinstance(groups, str) else list(groups):
                    by_group.setdefault(group, []).append(task_name)
            else:
                ungrouped.append(task_name)

        for task_name in ungrouped:
            task_samples = samples.get(task_name) or []
            if not task_samples:
                continue
            frame = self._samples_frame(task_samples, self.task_configs.get(task_name))
            self.run.log({f"{task_name}_eval_results": frame})
            self._log_samples_artifact(task_samples, task_name)

        for group, group_tasks in by_group.items():
            frames = []
            for task_name in group_tasks:
                task_samples = samples.get(task_name) or []
                if not task_samples:
                    continue
                frame = self._samples_frame(task_samples, self.task_configs.get(task_name))
                frame["group"] = group
                frame["task"] = task_name
                frames.append(frame)
                self._log_samples_artifact(task_samples, task_name)
            if frames:
                self.run.log({f"{group}_eval_results": pd.concat(frames, ignore_index=True)})

    def finish(self) -> None:
        if self._wandb is not None and self.run is not None:
            self.run.finish()
