"""MUIRBench task hooks (parity: reference src/data/tasks/_examples/muirbench/_muirbench_utils.py).

Multi-image multiple choice; per-sample records carry task metadata so the
aggregation can compute per-task and overall accuracy.
"""

from __future__ import annotations

import re

from lmms_owc_tpu_torch.filters._extraction import MultiChoiceRegexFilter

__all__ = [
    "CustomMultiChoiceRegexFilter",
    "aggregate_muirbench_score",
    "doc_to_text",
    "doc_to_visual",
    "doc_to_target",
    "process_results",
]

_OPTION_LETTER = re.compile(r"^\s*([A-Z])\.")


class CustomMultiChoiceRegexFilter(MultiChoiceRegexFilter):
    def apply(self, resps: list, docs: list) -> list:
        out = []
        for inst in resps:
            filtered = []
            for resp in inst:
                match = _OPTION_LETTER.match(resp)
                filtered.append(match.group(1) if match else resp)
            out.append(filtered[0])
        return out


def aggregate_muirbench_score(results: list[dict]) -> float:
    """Overall accuracy (per-task accuracies computed alongside)."""
    task_num: dict = {}
    task_score: dict = {}
    score = 0
    for result in results:
        task_score.setdefault(result["task"], 0)
        task_num.setdefault(result["task"], 0)
        if result["pred"].lower().strip() == result["answer"].lower().strip():
            task_score[result["task"]] += 1
            score += 1
        task_num[result["task"]] += 1
    return score / len(results)


def doc_to_text(doc: dict, model_specific_kwargs: dict | None = None) -> str:
    question, choices = doc["question"], doc["options"]
    pre = model_specific_kwargs["pre_prompt"]
    post = model_specific_kwargs["post_prompt"]
    letters = [chr(ord("A") + i) for i in range(len(choices))]
    choices_str = "\n".join(f"{letter}. {choice}" for letter, choice in zip(letters, choices))
    return f"{pre}{question}\n{choices_str}{post}"


def doc_to_visual(doc: dict) -> list:
    return [image.convert("RGB") for image in doc["image_list"]]


def doc_to_target(doc: dict) -> str:
    return doc["answer"]


def process_results(doc: dict, result: list[str]) -> dict:
    return {
        "muirbench_score_overall": {
            "pred": result[0],
            "task": doc["task"],
            "idx": doc["idx"],
            "image_relation": doc["image_relation"],
            "answer": doc["answer"],
            "image_type": doc["image_type"],
        }
    }
