"""Run-metadata tracking and results/samples IO.

Contract parity with reference src/engine/_tracker.py:
  - ``GeneralConfigTracker``: model-name extraction from the model-args string,
    wall-clock timing, system-prompt/chat-template hashes (:27-122).
  - ``EngineTracker``: writes ``{date}_results.json`` and
    ``{date}_samples_{task}.jsonl`` under ``output_path/model_name_sanitized/``
    (:220-341) with per-task cumulative sample hashes; optional push to HF Hub
    dataset repos (:264-289, :343-378).
"""

from __future__ import annotations

import json
import os
import re
import time
from dataclasses import asdict, dataclass
from pathlib import Path

from lmms_owc_tpu_torch import utils

log = utils.get_logger(__name__)

__all__ = ["EngineTracker", "GeneralConfigTracker"]


def _sanitize_list(items):
    if isinstance(items, list):
        return [_sanitize_list(x) for x in items]
    if isinstance(items, tuple):
        return tuple(_sanitize_list(x) for x in items)
    return str(items)


@dataclass(init=False)
class GeneralConfigTracker:
    """Evaluation-run metadata: model identity, timing, prompt hashes."""

    model_source: str | None = None
    model_name: str | None = None
    model_name_sanitized: str | None = None
    system_instruction: str | None = None
    system_instruction_sha: str | None = None
    fewshot_as_multiturn: bool | None = None
    chat_template: str | None = None
    chat_template_sha: str | None = None
    start_time: float | None = None
    end_time: float | None = None
    total_evaluation_time_seconds: str | None = None

    def __init__(self) -> None:
        self.start_time = time.perf_counter()

    @staticmethod
    def _get_model_name(model_args: str) -> str:
        """Extract the checkpoint name from a ``k=v,...`` model-args string."""
        for prefix in ["peft=", "delta=", "pretrained=", "model=", "path=", "engine="]:
            if prefix in model_args:
                return model_args.split(prefix)[1].split(",")[0]
        return ""

    def log_experiment_args(
        self,
        model_source: str,
        model_args: str,
        system_instruction: str | None,
        chat_template: str | None,
        fewshot_as_multiturn: bool,
    ) -> None:
        self.model_source = model_source
        self.model_name = self._get_model_name(model_args)
        self.model_name_sanitized = utils.sanitize_model_name(self.model_name)
        self.system_instruction = system_instruction
        self.system_instruction_sha = (
            utils.hash_string(system_instruction) if system_instruction else None
        )
        self.chat_template = chat_template
        self.chat_template_sha = utils.hash_string(chat_template) if chat_template else None
        self.fewshot_as_multiturn = fewshot_as_multiturn

    def log_end_time(self) -> None:
        self.end_time = time.perf_counter()
        self.total_evaluation_time_seconds = str(self.end_time - self.start_time)


class EngineTracker:
    """Writes results JSON + samples JSONL, optionally pushing to the HF Hub."""

    def __init__(
        self,
        output_path: str | None = None,
        hub_results_org: str = "",
        hub_repo_name: str = "",
        details_repo_name: str = "",
        results_repo_name: str = "",
        push_results_to_hub: bool = False,
        push_samples_to_hub: bool = False,
        public_repo: bool = False,
        token: str = "",
        leaderboard_url: str = "",
        point_of_contact: str = "",
        gated: bool = False,
    ) -> None:
        self.general_config_tracker = GeneralConfigTracker()
        self.output_path = output_path
        self.push_results_to_hub = push_results_to_hub
        self.push_samples_to_hub = push_samples_to_hub
        self.public_repo = public_repo
        self.leaderboard_url = leaderboard_url
        self.point_of_contact = point_of_contact
        self.gated_repo = gated
        self.date_id: str | None = None

        self.api = None
        if push_results_to_hub or push_samples_to_hub:
            try:
                from huggingface_hub import HfApi

                self.api = HfApi(token=token or os.environ.get("HF_TOKEN"))
            except ImportError:
                log.warning("huggingface_hub unavailable; hub push disabled")

        if (push_results_to_hub or push_samples_to_hub) and not hub_results_org and self.api:
            hub_results_org = self.api.whoami()["name"]

        if hub_repo_name == "":
            details_repo_name = details_repo_name or "lmms-eval-results"
            results_repo_name = results_repo_name or details_repo_name
        else:
            details_repo_name = hub_repo_name
            results_repo_name = hub_repo_name
        self.details_repo = f"{hub_results_org}/{details_repo_name}"
        self.details_repo_private = f"{hub_results_org}/{details_repo_name}-private"
        self.results_repo = f"{hub_results_org}/{results_repo_name}"
        self.results_repo_private = f"{hub_results_org}/{results_repo_name}-private"

    def _output_dir(self) -> Path:
        path = Path(self.output_path if self.output_path else Path.cwd())
        path = path / self.general_config_tracker.model_name_sanitized
        path.mkdir(parents=True, exist_ok=True)
        return path

    def save_results_aggregated(self, results: dict, samples: dict | None, datetime_str: str) -> None:
        """Write ``{date}_results.json`` with task hashes + run metadata appended."""
        self.general_config_tracker.log_end_time()
        if not self.output_path:
            log.info("output path not provided; skipping saving aggregated results")
            return
        try:
            task_hashes = {}
            if samples:
                for task_name, task_samples in samples.items():
                    sample_hashes = [
                        s["doc_hash"] + s["prompt_hash"] + s["target_hash"] for s in task_samples
                    ]
                    task_hashes[task_name] = utils.hash_string("".join(sample_hashes))

            results.update({"task_hashes": task_hashes})
            results.update(asdict(self.general_config_tracker))
            dumped = json.dumps(
                results, indent=2, default=utils.convert_non_serializable, ensure_ascii=False
            )

            path = self._output_dir()
            self.date_id = datetime_str.replace(":", "-")
            (path / f"{self.date_id}_results.json").write_text(dumped, encoding="utf-8")

            if self.api and self.push_results_to_hub:
                repo_id = self.results_repo if self.public_repo else self.results_repo_private
                self.api.create_repo(
                    repo_id=repo_id, repo_type="dataset", private=not self.public_repo, exist_ok=True
                )
                self.api.upload_file(
                    repo_id=repo_id,
                    path_or_fileobj=str(path / f"{self.date_id}_results.json"),
                    path_in_repo=os.path.join(
                        self.general_config_tracker.model_name, f"{self.date_id}_results.json"
                    ),
                    repo_type="dataset",
                    commit_message=f"Adding aggregated results for {self.general_config_tracker.model_name}",
                )
        except (OSError, json.JSONDecodeError, ValueError) as err:
            log.warning("could not save aggregated results: %r", err)

    def save_results_samples(self, task_name: str, samples: list[dict]) -> None:
        """Append per-sample records to ``{date}_samples_{task}.jsonl``."""
        if not self.output_path:
            log.info("output path not provided; skipping saving samples")
            return
        try:
            path = self._output_dir()
            file_path = path / f"{self.date_id}_samples_{task_name}.jsonl"
            with open(file_path, "a", encoding="utf-8") as f:
                for sample in samples:
                    arguments = {}
                    if len(sample["arguments"]) > 1:
                        for key, value in enumerate(sample["arguments"][1]):
                            arguments[key] = value
                    sample["input"] = sample["arguments"][0]
                    sample["resps"] = _sanitize_list(sample["resps"])
                    sample["filtered_resps"] = _sanitize_list(sample["filtered_resps"])
                    sample["arguments"] = arguments
                    sample["target"] = str(sample["target"])
                    f.write(
                        json.dumps(
                            sample, default=utils.convert_non_serializable, ensure_ascii=False
                        )
                        + "\n"
                    )

            if self.api and self.push_samples_to_hub:
                repo_id = self.details_repo if self.public_repo else self.details_repo_private
                self.api.create_repo(
                    repo_id=repo_id, repo_type="dataset", private=not self.public_repo, exist_ok=True
                )
                self.api.upload_file(
                    repo_id=repo_id,
                    path_or_fileobj=str(file_path),
                    path_in_repo=os.path.join(
                        self.general_config_tracker.model_name_sanitized, file_path.name
                    ),
                    repo_type="dataset",
                    commit_message=f"Adding samples for {task_name}",
                )
        except (OSError, ValueError) as err:
            log.warning("could not save samples for %s: %r", task_name, err)

    def recreate_metadata_card(self) -> None:
        """Regenerate the dataset card for the hub results repo (hub-only feature).

        Full-surface parity with reference src/engine/_tracker.py:386-535: the
        card's YAML metadata exposes one config per ``model__task`` (and a
        ``model__results`` config) with per-run datetime splits plus a "latest"
        split, and the body embeds the latest run's aggregated results JSON.
        """
        if not (self.api and (self.push_results_to_hub or self.push_samples_to_hub)):
            return
        repo_id = self.details_repo if self.public_repo else self.details_repo_private
        files = self.api.list_repo_files(repo_id=repo_id, repo_type="dataset")

        latest_results: dict = {}
        latest_results_path = None
        results_files = sorted(f for f in files if f.endswith("_results.json"))
        if results_files:
            latest_results_path = max(
                results_files, key=lambda f: _datetime_from_filename(Path(f).name)
            )
            try:
                from huggingface_hub import hf_hub_download

                local = hf_hub_download(
                    repo_id=repo_id, filename=latest_results_path, repo_type="dataset"
                )
                latest_results = json.loads(Path(local).read_text()).get("results", {})
            except Exception as err:  # noqa: BLE001 — card stays useful without it
                log.warning("could not fetch latest results for the card: %r", err)

        card = build_dataset_card(
            files=files,
            model_name=self.general_config_tracker.model_name,
            model_source=getattr(self.general_config_tracker, "model_source", ""),
            repo_id=repo_id,
            latest_results=latest_results,
            latest_results_path=latest_results_path,
            leaderboard_url=self.leaderboard_url,
            point_of_contact=self.point_of_contact,
        )
        self.api.upload_file(
            repo_id=repo_id,
            path_or_fileobj=card.encode("utf-8"),
            path_in_repo="README.md",
            repo_type="dataset",
            commit_message="Updating dataset card",
        )


def sanitize_task_name_for_filename(task_name: str) -> str:
    return re.sub(r"\W", "_", task_name)


def _datetime_from_filename(filename: str) -> str:
    """``{date}_results.json`` / ``{date}_samples_{task}.jsonl`` -> ``{date}``."""
    return filename.split("_results", 1)[0].split("_samples", 1)[0]


def _task_from_samples_filename(filename: str) -> str:
    return filename.split("_samples_", 1)[1].rsplit(".", 1)[0]


def build_dataset_card(
    files: list[str],
    model_name: str,
    model_source: str,
    repo_id: str,
    latest_results: dict,
    latest_results_path: str | None,
    leaderboard_url: str = "",
    point_of_contact: str = "",
) -> str:
    """Render the results-repo dataset card (pure; unit-testable without the hub).

    Mirrors reference src/engine/_tracker.py:386-535: YAML ``configs`` metadata
    with one ``model__task`` config per task (+ ``model__results``), each exposing
    the latest run as a datetime-named split and a "latest" split; body summary
    embeds the latest aggregated results JSON.
    """
    sanitize = lambda s: re.sub(r"[^\w\.]", "_", s)  # noqa: E731

    # Latest run datetime per config (model__task for samples, model__results).
    latest: dict[str, str] = {}
    file_of: dict[tuple[str, str], str] = {}
    for file_path in files:
        p = Path(file_path)
        model_dir = str(p.parent)
        when = _datetime_from_filename(p.name)
        if p.name.endswith("_results.json"):
            key = f"{model_dir}__results"
        elif "_samples_" in p.name:
            key = f"{model_dir}__{sanitize_task_name_for_filename(_task_from_samples_filename(p.name))}"
        else:
            continue
        if when >= latest.get(key, ""):
            latest[key] = when
            file_of[(key, when)] = p.name
        if key != f"{model_dir}__results":
            results_key = f"{model_dir}__results"
            latest.setdefault(results_key, "")

    configs = []
    for key in sorted(latest):
        when = latest[key]
        name = file_of.get((key, when))
        if name is None:
            continue
        configs.append(
            {
                "config_name": key,
                "data_files": [
                    {"split": sanitize(when), "path": [f"**/{name}"]},
                    {"split": "latest", "path": [f"**/{name}"]},
                ],
            }
        )

    # --- YAML frontmatter (hand-emitted: flat structure, no yaml dep needed)
    lines = ["---", f'pretty_name: "Evaluation run of {model_name}"', "configs:"]
    for cfg in configs:
        lines.append(f"- config_name: {cfg['config_name']}")
        lines.append("  data_files:")
        for df in cfg["data_files"]:
            lines.append(f"  - split: {df['split']}")
            lines.append("    path:")
            for path in df["path"]:
                lines.append(f"    - '{path}'")
    lines.append("---")

    # --- body
    model_link = (
        f"[{model_name}](https://huggingface.co/{model_name})"
        if model_source == "hf"
        else model_name
    )
    n_task_configs = sum(1 for c in configs if not c["config_name"].endswith("__results"))
    n_runs = sum(1 for f in files if f.endswith("_results.json"))
    body = [
        "",
        f"# Dataset Card for Evaluation run of {model_name}",
        "",
        f"Dataset automatically created during the evaluation run of model {model_link}.",
        "",
        f"The dataset is composed of {n_task_configs} configuration(s), each one corresponding"
        " to one of the evaluated tasks.",
        "",
        f"The dataset has been created from {n_runs} run(s). Each run can be found as a"
        " specific split in each configuration, the split being named using the timestamp"
        ' of the run. The "latest" split always points to the latest results.',
        "",
        'An additional configuration "results" stores all the aggregated results of the run.',
        "",
        "To load the details from a run, you can for instance do the following:",
        "```python",
        "from datasets import load_dataset",
        f'data = load_dataset("{repo_id}", name="<config_name>", split="latest")',
        "```",
    ]
    if latest_results:
        summary = {"all": latest_results, **latest_results}
        body += [
            "",
            "## Latest results",
            "",
            f"These are the latest results from run `{latest_results_path}`:",
            "",
            "```python",
            json.dumps(summary, indent=4, default=utils.convert_non_serializable),
            "```",
        ]
    if leaderboard_url:
        body += ["", f"Leaderboard: {leaderboard_url}"]
    if point_of_contact:
        body += ["", f"Point of contact: {point_of_contact}"]
    return "\n".join(lines + body) + "\n"
