"""Per-instance metrics (the JAX package's ``metrics._instance``).

22 registered metrics. Real per-instance computations are ``exact_match``,
``textual_inclusion``, ``anls``, and ``acc_all``; the rest are passthroughs paired
with group aggregations.
"""

from __future__ import annotations

import re
import string

import numpy as np

from lmms_owc_tpu_torch.metrics._api import register_metric

__all__ = [
    "INSTANCE_METRICS",
    "acc",
    "acc_all",
    "acc_mutual_info",
    "acc_norm",
    "anls",
    "bits_per_byte",
    "bleu",
    "brier_score",
    "bypass",
    "byte_perplexity",
    "chrf",
    "concept_semantic_similarity",
    "exact_match",
    "f1",
    "mcc",
    "mean_average_semantic_similarity",
    "perplexity",
    "semantic_similarity",
    "ter",
    "textual_inclusion",
    "textual_inclusion_llama32",
    "word_perplexity",
]

INSTANCE_METRICS = ["acc_all", "anls", "exact_match", "textual_inclusion"]


def _passthrough(items: list) -> list:
    return items


@register_metric(
    group_fn_name="mean", higher_is_better=True, output_types=["loglikelihood", "multiple_choice"]
)
def acc(items: list) -> list:
    """Passthrough; accuracy is reduced by the ``mean`` aggregation."""
    return items


@register_metric(group_fn_name="mean", higher_is_better=True, output_types=["loglikelihood"])
def acc_all(items: list) -> float:
    """Accuracy counting a question correct only if all its answers are labeled correctly."""
    question_scoring: dict[tuple, list] = {}
    preds = [p for p, _ in items]
    docs = [d for _, d in items]
    for doc, pred in zip(docs, preds):
        key = (doc["idx"]["paragraph"], doc["idx"]["question"])
        gold_label = doc["label"] == 1
        question_scoring.setdefault(key, []).append(gold_label == pred)
    return float(np.mean([int(all(x)) for x in question_scoring.values()]))


@register_metric(group_fn_name="mean", higher_is_better=True, output_types=["multiple_choice"])
def acc_mutual_info(items: list) -> list:
    """Passthrough; mutual-information accuracy is reduced by the ``mean`` aggregation."""
    return items


@register_metric(
    group_fn_name="mean", higher_is_better=True, output_types=["loglikelihood", "multiple_choice"]
)
def acc_norm(items: list) -> list:
    """Passthrough; length-normalized accuracy is reduced by the ``mean`` aggregation."""
    return items


def _levenshtein(s1: str, s2: str) -> int:
    """Edit distance (the JAX package takes the ``Levenshtein`` package when it is
    installed; this is its pure-python fallback, the same distance)."""
    if len(s1) > len(s2):
        s1, s2 = s2, s1
    distances = list(range(len(s1) + 1))
    for i2, c2 in enumerate(s2):
        new = [i2 + 1]
        for i1, c1 in enumerate(s1):
            if c1 == c2:
                new.append(distances[i1])
            else:
                new.append(1 + min(distances[i1], distances[i1 + 1], new[-1]))
        distances = new
    return distances[-1]


@register_metric(group_fn_name="mean", higher_is_better=True, output_types=["generate_until"])
def anls(references: list, predictions: list, threshold: float = 0.5) -> dict:
    """Average Normalized Levenshtein Similarity against the closest reference."""
    pred = predictions[0] if isinstance(predictions[0], str) else predictions[0][0]
    values = []
    for answer in references:
        gt = " ".join(answer.strip().lower().split())
        det = " ".join(pred.strip().lower().split())
        dist = _levenshtein(gt, det)
        length = max(len(answer.upper()), len(pred.upper()))
        values.append(0.0 if length == 0 else float(dist) / float(length))
    result = 1 - min(values)
    if result < threshold:
        result = 0
    return {"anls": result}


@register_metric(
    group_fn_name="bits_per_byte", higher_is_better=False, output_types=["loglikelihood_rolling"]
)
def bits_per_byte(items: list) -> list:
    """Passthrough for the ``bits_per_byte`` aggregation."""
    return items


@register_metric(
    group_fn_name="bleu",
    higher_is_better=True,
    output_types=["generate_until", "generate_until_multi_round"],
    can_bootstrap=True,
)
def bleu(items: list) -> list:
    """Passthrough for the corpus ``bleu`` aggregation."""
    return items


@register_metric(group_fn_name="brier_score", higher_is_better=False, output_types=["multiple_choice"])
def brier_score(items: list) -> list:
    """Passthrough for the ``brier_score`` aggregation."""
    return items


@register_metric(
    group_fn_name="bypass",
    higher_is_better=True,
    output_types=["loglikelihood", "multiple_choice", "generate_until", "generate_until_multi_round"],
)
def bypass(items: list) -> list:
    """Passthrough used by --predict_only runs (aggregation returns constant 999)."""
    return items


@register_metric(
    group_fn_name="weighted_perplexity",
    higher_is_better=False,
    output_types=["loglikelihood_rolling"],
)
def byte_perplexity(items: list) -> list:
    """Passthrough for the ``weighted_perplexity`` aggregation."""
    return items


@register_metric(
    group_fn_name="chrf",
    higher_is_better=True,
    output_types=["generate_until", "generate_until_multi_round"],
    can_bootstrap=True,
)
def chrf(items: list) -> list:
    """Passthrough for the corpus ``chrf`` aggregation."""
    return items


@register_metric(
    group_fn_name="concept_semantic_similarity",
    higher_is_better=True,
    output_types=["generate_until"],
)
def concept_semantic_similarity(items: list) -> list:
    """Passthrough; concepts are extracted and batch-encoded in the aggregation."""
    return items


@register_metric(group_fn_name="mean", higher_is_better=True, output_types=["generate_until"])
def exact_match(
    predictions: list,
    references: list,
    regexes_to_ignore: list | None = None,
    ignore_case: bool = False,
    ignore_punctuation: bool = False,
    ignore_numbers: bool = False,
) -> dict:
    """Exact-match score with optional regex/case/punctuation/number normalization."""
    if regexes_to_ignore is not None:
        for pattern in regexes_to_ignore:
            predictions = [re.sub(pattern, "", x) for x in predictions]
            references = [re.sub(pattern, "", x) for x in references]
    predictions = np.asarray(predictions)
    references = np.asarray(references)

    if ignore_case:
        predictions = np.char.lower(predictions)
        references = np.char.lower(references)
    if ignore_punctuation:
        table = str.maketrans("", "", string.punctuation)
        predictions = np.char.translate(predictions, table=table)
        references = np.char.translate(references, table=table)
    if ignore_numbers:
        table = str.maketrans("", "", string.digits)
        predictions = np.char.translate(predictions, table=table)
        references = np.char.translate(references, table=table)

    return {"exact_match": float(np.mean(predictions == references))}


@register_metric(group_fn_name="f1", higher_is_better=True, output_types=["multiple_choice"], can_bootstrap=True)
def f1(items: list) -> list:
    """Passthrough for the sklearn ``f1`` aggregation."""
    return items


@register_metric(
    group_fn_name="matthews_corrcoef",
    higher_is_better=True,
    output_types=["multiple_choice"],
    can_bootstrap=True,
)
def mcc(items: list) -> list:
    """Passthrough for the ``matthews_corrcoef`` aggregation."""
    return items


@register_metric(
    group_fn_name="mean_average_semantic_similarity",
    higher_is_better=True,
    output_types=["generate_until"],
)
def mean_average_semantic_similarity(items: list) -> list:
    """Passthrough; thresholded similarity hit-rates computed in the aggregation."""
    return items


@register_metric(
    group_fn_name="perplexity", higher_is_better=False, output_types=["loglikelihood"], can_bootstrap=True
)
def perplexity(items: list) -> list:
    """Passthrough for the ``perplexity`` aggregation."""
    return items


@register_metric(
    group_fn_name="semantic_similarity", higher_is_better=True, output_types=["generate_until"]
)
def semantic_similarity(items: list) -> list:
    """Passthrough; sentence-embedding similarity is computed in the aggregation."""
    return items


@register_metric(group_fn_name="mean", higher_is_better=True, output_types=["generate_until"])
def textual_inclusion(predictions: list, references: list) -> dict:
    """Whether each (lowercased, stripped) reference appears inside the prediction."""
    scores = [
        ref.lower().strip() in pred.lower().strip()
        for ref, pred in zip(references, predictions)
    ]
    return {"textual_inclusion": float(np.mean(scores))}


@register_metric(
    group_fn_name="textual_inclusion_llama32",
    higher_is_better=True,
    output_types=["generate_until"],
)
def textual_inclusion_llama32(items: list) -> list:
    """Passthrough; the LLM judge runs batched in the aggregation."""
    return items


@register_metric(
    group_fn_name="ter",
    higher_is_better=True,
    output_types=["generate_until", "generate_until_multi_round"],
    can_bootstrap=True,
)
def ter(items: list) -> list:
    """Passthrough for the corpus ``ter`` aggregation."""
    return items


@register_metric(
    group_fn_name="weighted_perplexity",
    higher_is_better=False,
    output_types=["loglikelihood_rolling"],
)
def word_perplexity(items: list) -> list:
    """Passthrough for the ``weighted_perplexity`` aggregation."""
    return items
