"""Registry records of the port (counterpart of :mod:`lmms_owc_tpu.schema`).

Only the record the port's model registry uses, with the JAX package's fields
and defaults, as a dataclass.
"""

from __future__ import annotations

import dataclasses
from typing import Any

__all__ = ["ModelInfo"]


@dataclasses.dataclass
class ModelInfo:
    """Registry record for a model adapter."""

    name: str
    model_cls: Any = dataclasses.field(repr=False)
    description: str = ""
