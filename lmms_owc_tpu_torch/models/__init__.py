"""Model adapters of the port, registered in the port's own registry."""

from lmms_owc_tpu_torch.models._api import (
    MODELS,
    get_model,
    get_model_info,
    register_model,
)
from lmms_owc_tpu_torch.models._base import Model
from lmms_owc_tpu_torch.models import (  # noqa: F401  (register the adapters)
    fake,
    idefics2,
    instructblip,
    internvl2,
    llava_hf,
    llava_onevision,
    phi3v,
    qwen2_vl,
)


def _model_types() -> dict:
    """Family name -> adapter class (the JAX package's map, and the
    reference's ``MODEL_TYPES``, src/models/__init__.py:38-46)."""
    from lmms_owc_tpu_torch.models.idefics2 import Idefics2
    from lmms_owc_tpu_torch.models.instructblip import InstructBlip
    from lmms_owc_tpu_torch.models.internvl2 import InternVL2
    from lmms_owc_tpu_torch.models.llava_hf import LlavaHf
    from lmms_owc_tpu_torch.models.qwen2_vl import Qwen2VL

    return {
        "idefics2": Idefics2,
        "instructblip": InstructBlip,
        "internvl2": InternVL2,
        "llava": LlavaHf,
        "qwen2-vl": Qwen2VL,
    }


@register_model("custom-model")
def custom_model(model_type: str, model_name_or_path: str | None = None, **model_kwargs):
    """Dispatch an arbitrary checkpoint to a model-family adapter by ``model_type``
    (reference: src/models/__init__.py:49-56)."""
    model_cls = _model_types().get(model_type)
    if model_cls is None:
        raise ValueError(
            f"Model type {model_type!r} not found. Available: {sorted(_model_types())}"
        )
    return model_cls(pretrained=model_name_or_path, **model_kwargs)


__all__ = [
    "MODELS",
    "Model",
    "get_model",
    "get_model_info",
    "register_model",
]
