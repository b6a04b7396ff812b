"""Text scoring pipelines: sentence embeddings, concept extraction, LLM judge.

Counterpart of :mod:`lmms_owc_tpu.pipelines.text`, with the same contract:
  - ``encode_sentence_bert``: all-MiniLM-L6-v2 embeddings, mean-pooled over the
    attention mask and L2-normalized (:mod:`lmms_owc_tpu_torch.nn.sbert`, the
    flash kernel K2 on the card). Without weights, the hashed n-gram fallback
    encoder, with a warning, gives the JAX package's fallback numbers.
  - ``concept_extraction``: spaCy ``en_core_web_lg`` noun-chunks + entities with
    article/possessive prefix stripping and skip-word filtering, when spaCy and
    that model are installed; else a deterministic pure-python chunker. The
    model is never downloaded (the card has no network): where the JAX package
    would fetch it and its fetch fails, both run the chunker.
  - ``textual_inclusion_llama32`` / ``elo_score_llama32``: the Llama-3.2-3B-Instruct
    judge (:mod:`lmms_owc_tpu_torch.nn.judge`), greedy, 16 new tokens, with the
    reference's exact prompt templates; without weights, the heuristic judge.

The models load on first use on the card, or on the device that
``LMMS_OWC_SCORING_DEVICE`` names (``cpu`` for a machine without CUDA).
"""

from __future__ import annotations

import os
import re

import numpy as np

from lmms_owc_tpu_torch.utils import get_logger

log = get_logger(__name__)

__all__ = [
    "concept_extraction",
    "encode_sentence_bert",
    "elo_score_llama32",
    "textual_inclusion_llama32",
    "TEXTUAL_INCLUSION_TEMPLATE",
    "ELO_SCORE_TEMPLATE",
]

# Lazy singletons (reference keeps module globals, :10-15).
_sentence_encoder = None
_spacy_model = None
_judge = None

# The device the scoring models load on (default: the card).
SCORING_DEVICE_ENV = "LMMS_OWC_SCORING_DEVICE"

SBERT_MODEL_ID = "sentence-transformers/all-MiniLM-L6-v2"
JUDGE_MODEL_ID = "meta-llama/Llama-3.2-3B-Instruct"

# Exact prompt templates from the reference (parity required for judge determinism).
TEXTUAL_INCLUSION_TEMPLATE = (
    "You are a model that determines whether an answer is a good reply to a question"
    " given also its target value.\n"
    "\n"
    "This is the question: What type of object is in this photo?\n"
    "This is the answer: %s\n"
    "This is the target value: %s\n"
    "\n"
    "If the answer describes the target, reply positively."
    " If the answer includes the target value or a synonym of it, reply positively."
    " If the target is generic but it is related to the answer, reply positively."
    ' Reply only with "1" if yes, or "0" if no.'
)

ELO_SCORE_TEMPLATE = (
    "You are a model that discriminates whether labels A or B better align with a target"
    " value.\n"
    "\n"
    "This is label A: %s\n"
    "This is label B: %s\n"
    "This is the target value: %s\n"
    "\n"
    "Does A align better with the target value? Does B align better with the target value?"
    ' Reply only with "1" if A wins over B, or "0" if B wins over A.'
)


# --------------------------------------------------------------------------------------
# Sentence embeddings
# --------------------------------------------------------------------------------------


def _scoring_device() -> str | None:
    return os.environ.get(SCORING_DEVICE_ENV) or None


def _get_sentence_encoder():
    global _sentence_encoder
    if _sentence_encoder is None:
        from lmms_owc_tpu_torch.nn.sbert import SentenceEncoder, resolve_sbert_weights

        weights_path = resolve_sbert_weights()
        if weights_path is not None:
            _sentence_encoder = SentenceEncoder.from_pretrained(weights_path, device=_scoring_device())
        else:
            log.warning(
                "MiniLM weights not found (set LMMS_OWC_SBERT_PATH or populate the HF"
                " cache); using the deterministic hashed n-gram fallback encoder."
                " Similarity values will NOT match the reference."
            )
            _sentence_encoder = _HashedNgramEncoder()
    return _sentence_encoder


class _HashedNgramEncoder:
    """Deterministic fallback embedding: hashed character n-grams, L2-normalized.

    Identical strings map to identical unit vectors (similarity 1.0); overlapping
    strings get partial similarity. Used only when MiniLM weights are unavailable
    (e.g. air-gapped test environments).
    """

    dim = 384  # matches MiniLM-L6 output dim

    def encode(self, sentences: list[str], batch_size: int = 1024) -> np.ndarray:
        import hashlib

        out = np.zeros((len(sentences), self.dim), dtype=np.float32)
        for i, sentence in enumerate(sentences):
            text = " ".join(sentence.lower().strip().split())
            grams = [text[j : j + 3] for j in range(max(1, len(text) - 2))]
            grams += text.split(" ")
            for gram in grams:
                digest = hashlib.md5(gram.encode("utf-8")).digest()
                idx = int.from_bytes(digest[:4], "little") % self.dim
                sign = 1.0 if digest[4] % 2 == 0 else -1.0
                out[i, idx] += sign
            norm = np.linalg.norm(out[i])
            if norm > 0:
                out[i] /= norm
        return out


def encode_sentence_bert(sentences: list[str], batch_size: int = 1024) -> np.ndarray:
    """Encode sentences to unit-normalized embeddings, shape ``(n, 384)``."""
    if not isinstance(sentences, list):
        raise NotImplementedError("encode_sentence_bert expects a list of strings")
    if not sentences:
        return np.zeros((0, 384), dtype=np.float32)
    return _get_sentence_encoder().encode(sentences, batch_size=batch_size)


# --------------------------------------------------------------------------------------
# Concept extraction (host-side string processing)
# --------------------------------------------------------------------------------------

_PREFIX_WORDS = ["a", "an", "the", "his", "her", "its", "their"]

# Function words for the fallback chunker (word classes that terminate a noun chunk).
_FALLBACK_BOUNDARY_WORDS = frozenset(
    """is are was were be been being am do does did have has had will would shall should
    can could may might must of in on at by for with from to as and or but if while
    that which who whom whose where when what why how not no nor so than then there
    here very really quite just also too it they them he she we you i this these
    those""".split()
)


def _strip_prefix(concept: str) -> str:
    for term in _PREFIX_WORDS:
        if concept.startswith(term + " "):
            return concept[len(term) + 1 :]
    return concept


def _load_spacy():
    """spaCy's ``en_core_web_lg``, loaded once; None when spaCy or the model is
    not installed (the JAX package downloads a missing model; the port never
    reaches the network, so it runs the fallback chunker instead)."""
    global _spacy_model
    if _spacy_model is None:
        try:
            import spacy
        except ImportError:
            return None
        try:
            _spacy_model = spacy.load("en_core_web_lg")
        except OSError:
            log.warning("spaCy model en_core_web_lg is not installed; concepts come from the fallback chunker")
            return None
    return _spacy_model


def _concepts_spacy(texts: list[str], skip_words: list[str], remove_prefix_words: bool) -> list[list[str]]:
    if _load_spacy() is None:
        raise LookupError("spaCy en_core_web_lg is not available")
    all_concepts = []
    for doc in _spacy_model.pipe(texts, batch_size=max(1, len(texts))):
        concepts: list[str] = []
        for chunk in doc.noun_chunks:
            concept = chunk.text.lower()
            if remove_prefix_words:
                concept = _strip_prefix(concept)
                if concept in skip_words:
                    continue
                concepts.append(concept)
        for ent in doc.ents:
            concept = ent.text.lower()
            if remove_prefix_words:
                concept = _strip_prefix(concept)
                if concept in skip_words:
                    continue
            if concept not in concepts:
                concepts.append(concept)
        all_concepts.append(concepts)
    return all_concepts


def _concepts_fallback(texts: list[str], skip_words: list[str], remove_prefix_words: bool) -> list[list[str]]:
    """Pure-python noun-chunk approximation: maximal spans of content words."""
    all_concepts = []
    for text in texts:
        concepts: list[str] = []
        for clause in re.split(r"[.,;:!?()\[\]\n]+", text.lower()):
            tokens = clause.split()
            span: list[str] = []
            for token in tokens + [""]:
                if token and token not in _FALLBACK_BOUNDARY_WORDS:
                    span.append(token)
                    continue
                if span:
                    concept = " ".join(span)
                    if remove_prefix_words:
                        concept = _strip_prefix(concept)
                        if concept in skip_words or not concept:
                            span = []
                            continue
                    if concept not in concepts:
                        concepts.append(concept)
                    span = []
        all_concepts.append(concepts)
    return all_concepts


def concept_extraction(
    texts: list[str],
    skip_words: list[str] | None = None,
    remove_prefix_words: bool = False,
) -> list[list[str]]:
    """Extract lowercase noun-chunk/entity concepts from each text."""
    skip_words = skip_words or []
    try:
        return _concepts_spacy(texts, skip_words, remove_prefix_words)
    except Exception:
        return _concepts_fallback(texts, skip_words, remove_prefix_words)


# --------------------------------------------------------------------------------------
# Llama-3.2 judge
# --------------------------------------------------------------------------------------


def _get_judge():
    global _judge
    if _judge is None:
        from lmms_owc_tpu_torch.nn.judge import JudgeModel, resolve_judge_weights

        weights_path = resolve_judge_weights()
        if weights_path is not None:
            _judge = JudgeModel.from_pretrained(weights_path, device=_scoring_device())
        else:
            log.warning(
                "Llama-3.2 judge weights not found (set LMMS_OWC_JUDGE_PATH or populate"
                " the HF cache); using the heuristic inclusion fallback."
                " Judge scores will NOT match the reference."
            )
            _judge = _HeuristicJudge()
    return _judge


class _HeuristicJudge:
    """Fallback judge when Llama weights are unavailable: substring inclusion for
    pair scoring; hashed-embedding similarity for triplet (A/B) comparison."""

    def score_pairs(self, prompts: list[str], predictions: list[str], references: list[str]) -> list[str]:
        return [
            "1" if ref.lower().strip() in pred.lower().strip() else "0"
            for pred, ref in zip(predictions, references)
        ]

    def score_triplets(
        self, prompts: list[str], a: list[str], b: list[str], references: list[str]
    ) -> list[str]:
        za = encode_sentence_bert(a)
        zb = encode_sentence_bert(b)
        zr = encode_sentence_bert(references)
        sim_a = np.sum(za * zr, axis=-1)
        sim_b = np.sum(zb * zr, axis=-1)
        return ["1" if sa >= sb else "0" for sa, sb in zip(sim_a, sim_b)]


def textual_inclusion_llama32(
    predictions: list[str],
    references: list[str],
    question_template: str = TEXTUAL_INCLUSION_TEMPLATE,
) -> list[str]:
    """Score (prediction, reference) pairs 0/1 with the Llama-3.2 judge."""
    prompts = [question_template % (pred, ref) for pred, ref in zip(predictions, references)]
    return _get_judge().score_pairs(prompts, predictions, references)


def elo_score_llama32(
    predictions_a: list[str],
    predictions_b: list[str],
    references: list[str],
    question_template: str = ELO_SCORE_TEMPLATE,
) -> list[str]:
    """Score (A, B, reference) triplets: "1" if A wins, "0" if B wins."""
    prompts = [
        question_template % (a, b, ref)
        for a, b, ref in zip(predictions_a, predictions_b, references)
    ]
    return _get_judge().score_triplets(prompts, predictions_a, predictions_b, references)
