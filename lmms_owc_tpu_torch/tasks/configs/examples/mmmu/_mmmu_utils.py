"""MMMU task hooks (parity: reference src/data/tasks/_examples/mmmu/_mmmu_utils.py,
which follows the official MMMU-Benchmark evaluation logic).

Multiple-choice answers are parsed with the staged candidate search ((A) -> "A " ->
"A." -> answer-text containment -> random fallback); open answers are normalized
(numbers to rounded floats, short strings space-guarded) and matched against
normalized golds. Aggregation reports instance-level accuracy over subjects.
"""

from __future__ import annotations

import ast
import logging
import os
import random
import re
from collections import defaultdict

import numpy as np

log = logging.getLogger(__name__)

__all__ = ["aggregate_results", "doc_to_text", "doc_to_visual", "doc_to_target", "process_results"]

INTERLEAVED_FORMAT = False

DOMAIN_CAT2SUB_CAT = {
    "Art and Design": ["Art", "Art_Theory", "Design", "Music"],
    "Business": ["Accounting", "Economics", "Finance", "Manage", "Marketing"],
    "Science": ["Biology", "Chemistry", "Geography", "Math", "Physics"],
    "Health and Medicine": [
        "Basic_Medical_Science", "Clinical_Medicine", "Diagnostics_and_Laboratory_Medicine",
        "Pharmacy", "Public_Health",
    ],
    "Humanities and Social Science": ["History", "Literature", "Sociology", "Psychology"],
    "Tech and Engineering": [
        "Agriculture", "Architecture_and_Engineering", "Computer_Science", "Electronics",
        "Energy_and_Power", "Materials", "Mechanical_Engineering",
    ],
}


# ------------------------------------------------------------------ prompting


def _parse_options(options: list[str]) -> str:
    letters = [chr(ord("A") + i) for i in range(len(options))]
    return "\n".join(f"{letter}. {option}" for letter, option in zip(letters, options))


def _construct_prompt(doc: dict, multi_choice_prompt: str = "", open_ended_prompt: str = "") -> str:
    question = doc["question"]
    if doc["question_type"] == "multiple-choice":
        # options is stored as the string repr of a list in the HF dataset.
        parsed = _parse_options(ast.literal_eval(doc["options"]))
        return f"{question}\n{parsed}\n\n{multi_choice_prompt}"
    return f"{question}\n\n{open_ended_prompt}"


def doc_to_text(doc: dict, model_specific_kwargs: dict) -> str:
    question = _construct_prompt(
        doc,
        model_specific_kwargs.get("multiple_choice_prompt", ""),
        model_specific_kwargs.get("open_ended_prompt", ""),
    )
    if INTERLEAVED_FORMAT:
        for i in range(1, 8):
            question = question.replace(f"<image {i}>", "<image>")
    return question


def doc_to_visual(doc: dict) -> list:
    prompt = _construct_prompt(doc)
    image_tokens = sorted(
        {tok.strip("<>").replace(" ", "_") for tok in re.findall(r"<image \d+>", prompt)}
    )
    return [doc[tok].convert("RGB") for tok in image_tokens]


def doc_to_target(doc: dict) -> str:
    return doc["answer"]


# ------------------------------------------------------------------- parsing


def _check_is_number(string: str) -> bool:
    try:
        float(string.replace(",", ""))
        return True
    except ValueError:
        return False


def _normalize_str(string: str) -> list:
    string = string.strip()
    if _check_is_number(string):
        return [round(float(string.replace(",", "")), 2)]
    string = string.lower()
    if len(string) == 1:
        return [" " + string, string + " "]  # space-guard single chars
    return [string]


def _extract_numbers(string: str) -> list[str]:
    with_commas = re.findall(r"-?\b\d{1,3}(?:,\d{3})+\b", string)
    scientific = re.findall(r"-?\d+(?:\.\d+)?[eE][+-]?\d+", string)
    simple = re.findall(r"-?(?:\d+\.\d+|\.\d+|\d+\b)(?![eE][+-]?\d+)(?![,\d])", string)
    return with_commas + scientific + simple


def _parse_open_response(response: str) -> list:
    def key_sub_responses(response: str) -> list[str]:
        response = response.strip().strip(".").lower()
        sub_responses = re.split(r"\.\s(?=[A-Z])|\n", response)
        indicators = ["could be ", "so ", "is ", "thus ", "therefore ", "final ", "answer ", "result "]
        keys = []
        for index, resp in enumerate(sub_responses):
            if index == len(sub_responses) - 1:
                indicators = indicators + ["="]
            shortest = None
            for indicator in indicators:
                if indicator in resp:
                    tail = resp.split(indicator)[-1].strip()
                    if shortest is None or len(tail) < len(shortest):
                        shortest = tail
            if shortest and shortest.strip() not in [":", ",", ".", "!", "?", ";", "'"]:
                keys.append(shortest)
        return keys or [response]

    key_responses = key_sub_responses(response)
    pred_list = list(key_responses)
    for resp in key_responses:
        pred_list.extend(_extract_numbers(resp))
    normalized: list = []
    for pred in pred_list:
        normalized.extend(_normalize_str(pred))
    return list(set(normalized))


def _parse_multi_choice_response(response: str, all_choices: list[str], index2ans: dict) -> str:
    for char in [",", ".", "!", "?", ";", ":", "'"]:
        response = response.strip(char)
    response = f" {response} "

    index_ans = True
    ans_with_brack = False
    candidates = [c for c in all_choices if f"({c})" in response]
    if candidates:
        ans_with_brack = True
    if not candidates:
        candidates = [c for c in all_choices if f"{c} " in response]
    if not candidates:
        candidates = [c for c in all_choices if f"{c}." in response]
    if not candidates and len(response.split()) > 5:
        candidates = [c for c, ans in index2ans.items() if ans.lower() in response.lower()]
        if candidates:
            index_ans = False

    if not candidates:
        return random.choice(all_choices)
    if len(candidates) == 1:
        return candidates[0]

    # Multiple mentions: take the last occurrence.
    starts = []
    for candidate in candidates:
        if index_ans and ans_with_brack:
            starts.append(response.rfind(f"({candidate})"))
        elif index_ans:
            starts.append(response.rfind(f" {candidate} "))
        else:
            starts.append(response.lower().rfind(index2ans[candidate].lower()))
    return candidates[int(np.argmax(starts))]


# ------------------------------------------------------------------- scoring


def _extract_subset_name(input_string: str) -> str:
    split = input_string.split("_")[0]
    match = re.search(rf"^{split}_(.+?)_\d+$", input_string)
    if not match:
        raise ValueError(f"no subset match found in {input_string!r}")
    return match.group(1)


def process_results(doc: dict, results: list[str]) -> dict:
    parsed_preds = []
    for pred in results:
        if doc["question_type"] == "multiple-choice":
            options = ast.literal_eval(doc["options"])
            index2ans = {chr(ord("A") + i): opt for i, opt in enumerate(options)}
            parsed_preds.append(_parse_multi_choice_response(pred, list(index2ans), index2ans))
        else:
            parsed_preds.append(_parse_open_response(pred))
    record = {
        "id": doc["id"],
        "subdomain": _extract_subset_name(doc["id"]),
        "question_type": doc["question_type"],
        "answer": doc["answer"],
        "parsed_pred": parsed_preds,
    }
    return {"mmmu_acc": record}


def _eval_multi_choice(gold, pred: str) -> bool:
    golds = gold if isinstance(gold, list) else [gold]
    return pred in golds


def _eval_open(gold, pred_list: list) -> bool:
    norm_answers: list = []
    for answer in gold if isinstance(gold, list) else [gold]:
        norm_answers.extend(_normalize_str(answer))
    for pred in pred_list:
        if isinstance(pred, str):
            if any(isinstance(ans, str) and ans in pred for ans in norm_answers):
                return True
        elif pred in norm_answers:
            return True
    return False


def _evaluate_mmmu(samples: list[dict]) -> dict:
    correct = 0
    for sample in samples:
        for pred in sample["parsed_pred"]:
            if sample["question_type"] == "multiple-choice":
                hit = _eval_multi_choice(sample["answer"], pred)
            else:
                hit = _eval_open(sample["answer"], pred)
            if hit:
                correct += 1
                break
    return {"acc": correct / len(samples) if samples else 0}


def _instance_level_acc(results: dict) -> float:
    acc, num = 0.0, 0
    for cat in results.values():
        acc += cat["acc"] * cat["num_example"]
        num += cat["num_example"]
    return acc / num if num else 0


def process_reasoning_results(doc: dict, results: list[str]) -> dict:
    """Store the raw reasoning response for post-hoc judge scoring."""
    return {
        "mmmu_judge_acc": {
            "id": doc["id"],
            "subdomain": _extract_subset_name(doc["id"]),
            "question_type": doc["question_type"],
            "answer": doc["answer"],
            "response": results[0],
        }
    }


def _get_chat_response(content: str, max_tokens: int, retries: int = 5) -> str:
    """OpenAI-compatible chat-completions judge call with retry.

    Parity with reference src/data/tasks/_examples/mmmu/_mmmu_utils.py:148-193:
    same system prompt, temperature 0.2, and retry/backoff contract. Talks plain
    HTTP to ``$OPENAI_API_URL`` (``Authorization: Bearer $OPENAI_API_KEY``,
    model ``$MODEL_VERSION``) instead of requiring the openai SDK.
    """
    import time

    import requests

    url = os.getenv("OPENAI_API_URL", "https://api.openai.com/v1/chat/completions")
    payload = {
        "model": os.getenv("MODEL_VERSION", "gpt-4o-2024-08-06"),
        "messages": [
            {
                "role": "system",
                "content": "You are a helpful and precise assistant for checking"
                " the correctness of the answer.",
            },
            {"role": "user", "content": content},
        ],
        "temperature": 0.2,
        "max_tokens": max_tokens,
    }
    headers = {"Authorization": f"Bearer {os.getenv('OPENAI_API_KEY', '')}"}
    for attempt in range(retries):
        try:
            response = requests.post(url, json=payload, headers=headers, timeout=60)
            response.raise_for_status()
            return response.json()["choices"][0]["message"]["content"].strip()
        except Exception as err:  # noqa: BLE001 — same catch-all as the reference
            log.warning("judge request failed on attempt %d: %s", attempt + 1, err)
            if attempt == retries - 1:
                return ""
            time.sleep(10)
    return ""


def aggregate_judge_results(results: list[dict]) -> float:
    """Judge-scored accuracy of free-form reasoning answers.

    When ``OPENAI_API_KEY`` is set, each response is scored 0/1 by the GPT API
    judge exactly like the reference (_get_chat_response); otherwise the local
    Llama-3.2 judge pipeline scores whether each response contains the answer.
    """
    if os.getenv("OPENAI_API_KEY"):
        scores = []
        for r in results:
            prompt = (
                f"Question answer: {r['answer']}\nModel response: {r['response']}\n"
                "Does the model response arrive at the same answer? Reply with"
                ' exactly "1" for yes or "0" for no.'
            )
            verdict = _get_chat_response(prompt, max_tokens=16)
            scores.append(1 if verdict.strip().startswith("1") else 0)
        return float(np.mean(scores)) if scores else 0.0

    from lmms_owc_tpu_torch.pipelines.text import textual_inclusion_llama32

    preds = [r["response"] for r in results]
    refs = [str(r["answer"]) for r in results]
    scores = textual_inclusion_llama32(predictions=preds, references=refs)
    return float(np.mean([int(s) if s in ["0", "1"] else 0 for s in scores]))


def aggregate_results(results: list[dict]) -> float:
    by_subset: dict = defaultdict(list)
    for result in results:
        by_subset[result["subdomain"]].append(result)
    evaluation = {}
    for subset, samples in by_subset.items():
        metric = _evaluate_mmmu(samples)
        metric["num_example"] = len(samples)
        evaluation[subset] = metric
    return round(_instance_level_acc(evaluation), 5)
