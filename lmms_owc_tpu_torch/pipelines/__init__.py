"""Scoring-model pipelines (the JAX package's ``pipelines``).

Text: sentence embedding (MiniLM), concept extraction (spaCy on the host when
its model is installed, else a pure-python chunker), the Llama-3.2 judge. The
scoring models are lazy module-level singletons, loaded on first use on the
card, or on the device that ``LMMS_OWC_SCORING_DEVICE`` names. CLIP
(``pipelines/image.py``) is not ported yet.
"""

from lmms_owc_tpu_torch.pipelines import text

__all__ = ["text"]
