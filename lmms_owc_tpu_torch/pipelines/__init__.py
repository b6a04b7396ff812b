"""Scoring-model pipelines (the JAX package's ``pipelines``).

Text: sentence embedding (MiniLM), concept extraction (spaCy on the host when
its model is installed, else a pure-python chunker), the Llama-3.2 judge.
Image: CLIP image-text logits (``encode_clip``). The scoring models are lazy
module-level singletons, loaded on first use on the card, or on the device
that ``LMMS_OWC_SCORING_DEVICE`` names.
"""

from lmms_owc_tpu_torch.pipelines import image, text

__all__ = ["image", "text"]
