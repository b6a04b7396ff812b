"""Group aggregation functions (the JAX package's ``metrics._group``).

16 registered aggregations, under the JAX package's names. The open-world
core (``semantic_similarity``, ``concept_semantic_similarity``,
``mean_average_semantic_similarity``, ``textual_inclusion_llama32``)
delegates embedding and judging to :mod:`lmms_owc_tpu_torch.pipelines` (the
SBERT encoder and the Llama judge on the card); the similarity dot products of
unit-normalized embeddings are computed here in numpy. ``f1`` and
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


@register_aggregation("concept_semantic_similarity")
def concept_semantic_similarity(
    items: list, reduce: Literal["none", "max", "mean", "median", "min"] = "max"
) -> float | list[tuple[list, list]]:
    """Similarity between the reference class name and concepts extracted from the prediction.

    Pipeline (reference _group.py:176-334): extract noun-chunk/entity concepts from each
    prediction (plus the full prediction itself as a concept), dedup the (reference,
    concept) pairs, batch-encode both sides with the sentence encoder, take the
    per-pair cosine similarity, then reduce per sample (max/mean/median/min) and average
    over samples. ``reduce="none"`` returns ``[(concepts, similarities), ...]`` per sample
    for jsonl writeback by eval_metrics.
    """
    from lmms_owc_tpu_torch.pipelines.text import concept_extraction, encode_sentence_bert

    if reduce not in ["none", "max", "mean", "median", "min"]:
        raise ValueError(f"unknown reduce {reduce!r} for concept_semantic_similarity")

    refs, preds = _unzip_refs_preds(items)

    concepts_per_pred = concept_extraction(
        preds, skip_words=SKIP_WORDS, remove_prefix_words=True
    )
    # The full prediction is always included as a concept.
    concepts_per_pred = [c + [p] for c, p in zip(concepts_per_pred, preds)]

    # Dedup (ref, concept) pairs before the expensive encode.
    pair_to_idx: dict[str, int] = {}
    unique_refs: list[str] = []
    unique_concepts: list[str] = []
    for ref, concepts in zip(refs, concepts_per_pred):
        for concept in concepts:
            key = f"{ref} | {concept}"
            if key not in pair_to_idx:
                pair_to_idx[key] = len(unique_refs)
                unique_refs.append(ref)
                unique_concepts.append(concept)

    refs_z = np.asarray(encode_sentence_bert(unique_refs))
    concepts_z = np.asarray(encode_sentence_bert(unique_concepts))
    pair_sims = np.sum(refs_z * concepts_z, axis=-1)

    sims_per_sample = [
        np.array([pair_sims[pair_to_idx[f"{ref} | {concept}"]] for concept in concepts])
        for ref, concepts in zip(refs, concepts_per_pred)
    ]

    if reduce == "max":
        return float(np.mean([s.max() for s in sims_per_sample]))
    if reduce == "mean":
        return float(np.mean([s.mean() for s in sims_per_sample]))
    if reduce == "median":
        # torch.median semantics: lower median for even-length vectors.
        return float(np.mean([np.sort(s)[(len(s) - 1) // 2] for s in sims_per_sample]))
    if reduce == "min":
        return float(np.mean([s.min() for s in sims_per_sample]))
    return [
        (concepts, sims.tolist())
        for concepts, sims in zip(concepts_per_pred, sims_per_sample)
    ]


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
    """Hit-rate of ref<->pred embedding similarity at thresholds 0.5..0.9 plus their average."""
    from lmms_owc_tpu_torch.pipelines.text import encode_sentence_bert

    if reduce not in ["none", "mean"]:
        raise ValueError(f"unknown reduce {reduce!r} for mean_average_semantic_similarity")

    refs, preds = _unzip_refs_preds(items)
    refs_z = np.asarray(encode_sentence_bert(refs))
    preds_z = np.asarray(encode_sentence_bert(preds))
    sims = np.sum(refs_z * preds_z, axis=-1)

    thresholds = [0.5, 0.6, 0.7, 0.8, 0.9]
    if reduce == "mean":
        outputs = {f"semantic_similarity@{t}": float((sims >= t).mean()) for t in thresholds}
        outputs["semantic_similarity@avg"] = float(np.mean(list(outputs.values())))
        return outputs
    outputs = {f"semantic_similarity@{t}": (sims >= t).astype(int).tolist() for t in thresholds}
    outputs["semantic_similarity@avg"] = np.mean(
        [outputs[f"semantic_similarity@{t}"] for t in thresholds], axis=0
    ).tolist()
    return outputs


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
    """Cosine similarity of unit-normalized sentence embeddings of refs vs preds."""
    from lmms_owc_tpu_torch.pipelines.text import encode_sentence_bert

    if reduce not in ["none", "mean"]:
        raise ValueError(f"unknown reduce {reduce!r} for semantic_similarity")

    refs, preds = _unzip_refs_preds(items)
    refs_z = np.asarray(encode_sentence_bert(refs))
    preds_z = np.asarray(encode_sentence_bert(preds))
    sims = np.sum(refs_z * preds_z, axis=-1)

    if reduce == "mean":
        return float(sims.mean())
    return sims.tolist()


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
    """LLM-judge 0/1 inclusion scores (Llama-3.2-3B-Instruct, greedy, 16 new tokens)."""
    from lmms_owc_tpu_torch.pipelines.text import textual_inclusion_llama32 as _judge

    if reduce not in ["none", "mean"]:
        raise ValueError(f"unknown reduce {reduce!r} for textual_inclusion_llama32")

    refs, preds = _unzip_refs_preds(items)
    raw_scores = _judge(predictions=preds, references=refs)
    scores = [int(s) if s in ["0", "1"] else 0 for s in raw_scores]

    if reduce == "mean":
        return float(np.mean(scores))
    return scores


@register_aggregation("weighted_perplexity")
def weighted_perplexity(items: list) -> float:
    return math.exp(-_weighted_mean(items))
