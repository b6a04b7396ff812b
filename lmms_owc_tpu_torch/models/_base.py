"""Model adapter base class of the port (counterpart of :mod:`lmms_owc_tpu.models._base`).

The engine is not ported yet, so this base keeps what the adapters of the
slice use: the constructor contract (batch size, dtype, device, the
``load_in_8bit``/``load_in_4bit`` flags), ``rank`` and ``world_size``, the
request handlers, and the chunk pipeline. Each adapter's ``load_model``
applies the quantization flags.
"""

from __future__ import annotations

import abc

import torch

from lmms_owc_tpu_torch._device import get_device
from lmms_owc_tpu_torch.utils import foreach_chunk_pipelined

__all__ = ["Model"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class Model(abc.ABC):
    """Base class for the port's model adapters.

    ``device`` defaults to ``"cuda"`` and raises when CUDA is absent; pass
    ``device="cpu"`` to run the plain PyTorch versions of the kernels.
    """

    def __init__(
        self,
        model_id: str | None = None,
        batch_size: int = 8,
        dtype: str = "bfloat16",
        device: str | None = None,
        load_in_8bit: bool = False,
        load_in_4bit: bool = False,
        **kwargs,
    ) -> None:
        # Weight-only int8/int4 (the bitsandbytes load_in_8bit/load_in_4bit
        # equivalents of the JAX package, lmms_owc_tpu_torch.ops.quant).
        self.load_in_8bit = bool(load_in_8bit)
        self.load_in_4bit = bool(load_in_4bit)
        if self.load_in_8bit and self.load_in_4bit:
            raise ValueError("load_in_8bit and load_in_4bit are mutually exclusive")
        if dtype not in _DTYPES:
            raise ValueError(f"dtype {dtype!r} not supported; choose from {sorted(_DTYPES)}")
        self.model_id = model_id
        self.batch_size = int(batch_size)
        self.dtype = dtype
        self.torch_dtype = _DTYPES[dtype]
        self.device = get_device(device)
        self._extra_kwargs = kwargs
        self.task_dict: dict = {}
        self.load_model()

    @property
    def rank(self) -> int:
        """Process rank from ``torch.distributed`` when it is initialised, else 0."""
        dist = torch.distributed
        return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0

    @property
    def world_size(self) -> int:
        dist = torch.distributed
        return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1

    @abc.abstractmethod
    def load_model(self) -> None:
        """Build the modules and load or generate the weights."""

    @abc.abstractmethod
    def loglikelihood(self, requests) -> list[tuple[float, bool]]:
        """Return (loss, is_greedy) per request; loss is the continuation NLL."""

    @abc.abstractmethod
    def generate_until(self, requests) -> list[str]:
        """Generate free-text responses for each request."""

    def _foreach_chunk_pipelined(self, chunks: list, prepare, run, depth: int = 2, finish=None) -> list:
        """Process chunks with up to ``depth`` chunks' preparation in flight.

        ``prepare(chunk)`` does host preprocessing and the vision encode in a
        worker thread; ``run(chunk, prepared)`` decodes. See
        :func:`lmms_owc_tpu_torch.utils.foreach_chunk_pipelined`.
        """
        return foreach_chunk_pipelined(chunks, prepare, run, depth=depth, finish=finish)

    def apply_chat_template(self, messages: list[dict]) -> str:
        rendered = "".join(f"{m['role']}: {m['content']}\n" for m in messages)
        return rendered + "assistant:"

    @property
    def chat_template(self) -> str:
        return type(self).__name__
