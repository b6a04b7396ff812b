"""Model registry of the port (counterpart of :mod:`lmms_owc_tpu.models._api`).

A registry of its own: importing ``lmms_owc_tpu.models`` would import every JAX
adapter, and JAX with them.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Callable

from lmms_owc_tpu_torch.schema import ModelInfo

if TYPE_CHECKING:
    from lmms_owc_tpu_torch.models._base import Model

__all__ = ["MODELS", "get_model", "get_model_info", "register_model"]

MODELS: dict[str, ModelInfo] = {}


def register_model(*names: str) -> Callable:
    """Register a model builder (class or factory fn) under one or more IDs."""

    def decorate(builder):
        for name in names:
            if name in MODELS:
                raise ValueError(f"model {name!r} already registered")
            MODELS[name] = ModelInfo(
                name=name,
                model_cls=builder,
                description=(builder.__doc__ or "").split("\n")[0],
            )
        return builder

    return decorate


def get_model_info(model_id: str) -> ModelInfo:
    if model_id not in MODELS:
        raise KeyError(f"unknown model {model_id!r}; available: {sorted(MODELS)}")
    return MODELS[model_id]


def get_model(model_id: str, **kwargs) -> "Model":
    """Instantiate a registered model adapter."""
    return get_model_info(model_id).model_cls(**kwargs)
