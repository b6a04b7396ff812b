"""Model adapters of the port, registered in the port's own registry."""

from lmms_owc_tpu_torch.models._api import (
    MODELS,
    get_model,
    get_model_info,
    register_model,
)
from lmms_owc_tpu_torch.models._base import Model
from lmms_owc_tpu_torch.models import fake, idefics2, llava_hf, llava_onevision, qwen2_vl  # noqa: F401  (register the adapters)

__all__ = [
    "MODELS",
    "Model",
    "get_model",
    "get_model_info",
    "register_model",
]
