"""Group aggregation functions (the JAX package's ``metrics._group``).

16 registered aggregations, under the JAX package's names. The open-world
core (``semantic_similarity``, ``concept_semantic_similarity``,
``mean_average_semantic_similarity``, ``textual_inclusion_llama32``) needs
the scoring models (the SBERT encoder, concept extraction and the Llama
judge), which the port does not carry yet: those four raise
``NotImplementedError`` naming the missing pipeline. ``f1`` and
``matthews_corrcoef`` are computed in numpy, as scikit-learn computes them.
"""

from __future__ import annotations

import math
from collections.abc import Iterable
from typing import Literal

import numpy as np

from lmms_owc_tpu_torch.metrics._api import register_aggregation
from lmms_owc_tpu_torch.utils import get_logger

__all__ = [
    "GROUP_METRICS",
    "bits_per_byte",
    "bleu",
    "brier_score",
    "bypass",
    "chrf",
    "concept_semantic_similarity",
    "f1_score",
    "matthews_corrcoef",
    "mean",
    "mean_average_semantic_similarity",
    "median",
    "perplexity",
    "semantic_similarity",
    "ter",
    "textual_inclusion_llama32",
    "weighted_perplexity",
]

GROUP_METRICS = [
    "bits_per_byte",
    "bleu",
    "brier_score",
    "bypass",
    "chrf",
    "concept_semantic_similarity",
    "f1_score",
    "matthews_corrcoef",
    "mean_average_semantic_similarity",
    "perplexity",
    "semantic_similarity",
    "ter",
    "textual_inclusion_llama32",
    "weighted_perplexity",
]

log = get_logger(__name__)

# Words excluded from extracted prediction concepts (reference _group.py:208-234).
_SKIP_WORDS_GROUPS = {
    "numbers_digits": ["1", "2", "3", "4", "5", "6", "7", "8", "9", "10"],
    "numbers_words": ["one", "two", "three", "four", "five", "six", "seven", "eight", "nine", "ten"],
    "symbols": ["*"],
    "articles": ["a", "the"],
    "generic_nouns": ["image", "object", "photo", "type", "this photo"],
    "personal_pronouns": ["it", "they", "them"],
    "demonstratives": ["that", "this", "those"],
    "wh_words": ["which", "who", "whom", "whose", "where", "when", "what", "why", "how"],
    "quantifiers": ["some"],
}
SKIP_WORDS = [word for group in _SKIP_WORDS_GROUPS.values() for word in group]


def _weighted_mean(items: list) -> float:
    a, b = zip(*items)
    return sum(a) / sum(b)


def _unzip_refs_preds(items: list) -> tuple[list, list]:
    refs = [item[0] for item in items]
    preds = [item[1] for item in items]
    refs = [ref[0] if isinstance(ref, list) else ref for ref in refs]
    preds = [pred[-1] if isinstance(pred, list) else pred for pred in preds]
    return refs, preds


@register_aggregation("bits_per_byte")
def bits_per_byte(items: list) -> float:
    """Corpus bits-per-byte from (loglikelihood, num_bytes) pairs."""
    return -_weighted_mean(items) / math.log(2)


def _sacreformat(refs: list, preds: list) -> tuple:
    """Shape refs/preds for sacrebleu corpus scoring.

    refs -> list of reference streams (transposed so stream i holds every doc's i-th
    reference); preds -> flat list of hypothesis strings. Note: the reference's
    version (src/data/metrics/_group.py:80-102) leaves list-wrapped preds nested,
    which modern sacrebleu rejects; here singleton prediction lists are unwrapped.
    """
    refs = list(refs)
    if not isinstance(refs[0], Iterable) or isinstance(refs[0], str):
        refs = [[ref] for ref in refs]
    refs = list(zip(*refs))

    preds = list(preds)
    preds = [
        pred if isinstance(pred, str) else pred[0]
        for pred in preds
    ]
    return refs, preds


def _sacrebleu():
    try:
        import sacrebleu
    except ImportError as err:
        raise ImportError("the bleu, chrf and ter aggregations need the sacrebleu package") from err
    return sacrebleu


@register_aggregation("bleu")
def bleu(items: list) -> float:
    """Corpus BLEU via sacrebleu."""
    sacrebleu = _sacrebleu()

    refs = [item[0] for item in items]
    preds = [item[1] for item in items]
    refs, preds = _sacreformat(refs, preds)
    return sacrebleu.corpus_bleu(preds, refs).score


@register_aggregation("brier_score")
def brier_score(items: list) -> float:
    """Mean squared error between one-hot gold and predicted class distributions."""
    gold, predictions = zip(*items)
    predictions = np.array(predictions)
    _, num_class = predictions.shape
    gold_one_hot = np.eye(num_class)[list(gold)]
    return float(np.mean(np.sum((predictions - gold_one_hot) ** 2, axis=1)))


@register_aggregation("bypass")
def bypass(arr: list) -> int:
    """Skip aggregation; returns the 999 sentinel (used with --predict_only)."""
    return 999


@register_aggregation("chrf")
def chrf(items: list) -> float:
    """Corpus chrF via sacrebleu."""
    sacrebleu = _sacrebleu()

    refs = [item[0] for item in items]
    preds = [item[1] for item in items]
    refs, preds = _sacreformat(refs, preds)
    return sacrebleu.corpus_chrf(preds, refs).score


def _needs_pipeline(aggregation: str, pipeline: str):
    raise NotImplementedError(
        f"aggregation {aggregation!r} needs the scoring pipeline {pipeline}, which the PyTorch port"
        " does not carry yet"
    )


@register_aggregation("concept_semantic_similarity")
def concept_semantic_similarity(
    items: list, reduce: Literal["none", "max", "mean", "median", "min"] = "max"
) -> float | list[tuple[list, list]]:
    """Similarity between the reference class name and concepts extracted from the
    prediction (needs concept extraction and the SBERT encoder)."""
    _needs_pipeline("concept_semantic_similarity", "concept_extraction + encode_sentence_bert")


@register_aggregation("f1")
def f1_score(items: list) -> float:
    """Binary F1 over (gold, pred) pairs (scikit-learn's ``f1_score``, binary average)."""
    golds, preds = zip(*items)
    golds, preds = np.asarray(golds), np.asarray(preds)
    labels = np.unique(np.concatenate([golds, preds]))
    if len(labels) > 2:
        raise ValueError("f1 takes binary labels; got more than two classes")
    positive = 1
    if positive not in labels and len(labels) == 2:
        raise ValueError(f"pos_label=1 is not a valid label: {labels.tolist()}")
    tp = float(np.sum((golds == positive) & (preds == positive)))
    fp = float(np.sum((golds != positive) & (preds == positive)))
    fn = float(np.sum((golds == positive) & (preds != positive)))
    denom = 2 * tp + fp + fn
    return 0.0 if denom == 0 else 2 * tp / denom


@register_aggregation("matthews_corrcoef")
def matthews_corrcoef(items: list) -> float:
    """Matthews correlation coefficient over (gold, pred) pairs (scikit-learn's
    multiclass form, from the confusion matrix)."""
    golds, preds = zip(*items)
    labels, idx = np.unique(np.concatenate([np.asarray(golds), np.asarray(preds)]), return_inverse=True)
    g, p = idx[: len(golds)], idx[len(golds):]
    cm = np.zeros((len(labels), len(labels)), dtype=np.float64)
    np.add.at(cm, (g, p), 1)
    t_sum, p_sum = cm.sum(axis=1), cm.sum(axis=0)
    n_correct, n = np.trace(cm), cm.sum()
    cov_ytyp = n_correct * n - np.dot(t_sum, p_sum)
    cov_ypyp = n**2 - np.dot(p_sum, p_sum)
    cov_ytyt = n**2 - np.dot(t_sum, t_sum)
    if cov_ypyp * cov_ytyt == 0:
        return 0.0
    return float(cov_ytyp / np.sqrt(cov_ytyt * cov_ypyp))


@register_aggregation("mean")
def mean(arr: list) -> float:
    return sum(arr) / len(arr)


@register_aggregation("mean_average_semantic_similarity")
def mean_average_semantic_similarity(
    items: list, reduce: Literal["none", "mean"] = "mean"
) -> dict:
    """Hit-rate of ref<->pred embedding similarity at thresholds 0.5..0.9 plus
    their average (needs the SBERT encoder)."""
    _needs_pipeline("mean_average_semantic_similarity", "encode_sentence_bert")


@register_aggregation("median", can_bootstrap=True)
def median(arr: list) -> float:
    return arr[len(arr) // 2]


@register_aggregation("perplexity")
def perplexity(items: list) -> float:
    return math.exp(-mean(items))


@register_aggregation("semantic_similarity")
def semantic_similarity(
    items: list, reduce: Literal["none", "mean"] = "mean"
) -> float | list[float]:
    """Cosine similarity of unit-normalized sentence embeddings of refs vs preds
    (needs the SBERT encoder)."""
    _needs_pipeline("semantic_similarity", "encode_sentence_bert")


@register_aggregation("ter")
def ter(items: list) -> float:
    """Corpus translation error rate via sacrebleu."""
    sacrebleu = _sacrebleu()

    refs = [item[0] for item in items]
    preds = [item[1] for item in items]
    refs, preds = _sacreformat(refs, preds)
    return sacrebleu.corpus_ter(preds, refs).score


@register_aggregation("textual_inclusion_llama32")
def textual_inclusion_llama32(
    items: list, reduce: Literal["none", "mean"] = "mean"
) -> float | list[int]:
    """LLM-judge 0/1 inclusion scores (needs the Llama-3.2 judge)."""
    _needs_pipeline("textual_inclusion_llama32", "textual_inclusion_llama32")


@register_aggregation("weighted_perplexity")
def weighted_perplexity(items: list) -> float:
    return math.exp(-_weighted_mean(items))
