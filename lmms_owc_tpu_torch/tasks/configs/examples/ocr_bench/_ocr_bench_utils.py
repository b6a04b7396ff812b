"""OCRBench task hooks (parity: reference src/data/tasks/_examples/ocr_bench/_ocr_bench_utils.py).

Substring matching of the ground-truth answer inside the prediction, with
whitespace-stripped comparison for handwritten math (HME100k); aggregate is the
summed score over the 1000-sample benchmark grouped by question type.
"""

from __future__ import annotations

from collections import defaultdict

__all__ = ["aggregate_accuracy", "doc_to_text", "doc_to_visual", "process_results"]

_RECOGNITION_TYPES = [
    "Regular Text Recognition",
    "Irregular Text Recognition",
    "Artistic Text Recognition",
    "Handwriting Recognition",
    "Digit String Recognition",
    "Non-Semantic Text Recognition",
]
_OTHER_TYPES = [
    "Scene Text-centric VQA",
    "Doc-oriented VQA",
    "Key Information Extraction",
    "Handwritten Mathematical Expression Recognition",
]


def aggregate_accuracy(results: list, args: object = None) -> float:
    scores: dict = defaultdict(int)
    for result in results:
        scores[result["question_type"]] += result["score"]
    final = sum(scores[t] for t in _RECOGNITION_TYPES + _OTHER_TYPES)
    return final / 1000


def doc_to_visual(doc: dict) -> list:
    return [doc["image"].convert("RGB")]


def doc_to_text(doc: dict) -> str:
    return f"{doc['question']}"


def _matches(answer: str, pred: str, strip_spaces: bool) -> bool:
    if strip_spaces:
        answer = answer.strip().replace("\n", " ").replace(" ", "")
        pred = pred.strip().replace("\n", " ").replace(" ", "")
    else:
        answer = answer.lower().strip().replace("\n", " ")
        pred = pred.lower().strip().replace("\n", " ")
    return answer in pred


def process_results(doc: dict, results: list) -> dict:
    pred = results[0].lower().strip()
    gt_ans = doc["answer"]
    strip_spaces = doc["dataset"] == "HME100k"
    answers = gt_ans if isinstance(gt_ans, list) else [gt_ans]
    score = int(any(_matches(ans, pred, strip_spaces) for ans in answers))
    return {
        "ocr_bench_accuracy": {
            "question_type": doc["question_type"],
            "score": score,
            "prediction": pred,
            "ground_truth": gt_ans,
        }
    }
