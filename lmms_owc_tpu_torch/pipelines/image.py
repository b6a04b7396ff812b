"""Image scoring pipeline: CLIP image-text logits.

Counterpart of :mod:`lmms_owc_tpu.pipelines.image` (``encode_clip``: CLIP
ViT-L/14 image-text logits; unused by the main eval path), backed by the
port's CLIP (:class:`~lmms_owc_tpu_torch.nn.clip.ClipScorer`) when weights are
resolvable: ``LMMS_OWC_CLIP_PATH``, else the Hugging Face cache. The scorer is
a lazy module-level singleton in f32, loaded on first use on the card, or on
the device that ``LMMS_OWC_SCORING_DEVICE`` names.
"""

from __future__ import annotations

import numpy as np

from lmms_owc_tpu_torch.utils import get_logger

log = get_logger(__name__)

__all__ = ["encode_clip"]

_clip = None

CLIP_MODEL_ID = "openai/clip-vit-large-patch14"


def encode_clip(images: list, texts: list[str]) -> np.ndarray:
    """Return image-text logits of shape ``(n_images, n_texts)``."""
    global _clip
    if _clip is None:
        from lmms_owc_tpu_torch.nn.clip import ClipScorer, resolve_clip_weights
        from lmms_owc_tpu_torch.pipelines.text import _scoring_device

        weights_path = resolve_clip_weights()
        if weights_path is None:
            raise RuntimeError("CLIP weights not found; set LMMS_OWC_CLIP_PATH or populate the HF cache")
        _clip = ClipScorer.from_pretrained(weights_path, device=_scoring_device())
    return _clip.score(images, texts)
