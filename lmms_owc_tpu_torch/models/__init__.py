"""Model adapters of the port, registered in the port's own registry."""

from lmms_owc_tpu_torch.models._api import (
    MODELS,
    get_model,
    get_model_info,
    register_model,
)
from lmms_owc_tpu_torch.models._base import Model
from lmms_owc_tpu_torch.models import qwen2_vl  # noqa: F401  (registers the Qwen2-VL adapters)

__all__ = [
    "MODELS",
    "Model",
    "get_model",
    "get_model_info",
    "register_model",
]
