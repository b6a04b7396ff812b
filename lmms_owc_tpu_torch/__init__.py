"""lmms_owc_tpu_torch — the PyTorch/CUDA port of :mod:`lmms_owc_tpu` for one NVIDIA H100.

The JAX package stays the reference; this package mirrors its module names so
each counterpart is easy to find, and never imports JAX:

  - ``lmms_owc_tpu_torch.ops``     hand-written Hopper kernels (``csrc/*.cu``,
                                   built at first use) behind wrappers that take
                                   their plain PyTorch versions for CPU tensors.
  - ``lmms_owc_tpu_torch.nn``      the model stack as ``nn.Module``s and tensor
                                   functions (Qwen2-VL vision tower, prefill, decode).
  - ``lmms_owc_tpu_torch.models``  the adapter registry and the ``Qwen2VL`` adapter.

It imports nothing of the JAX package either: the host helpers it shares with
it (request collation, logging, the chunk pipeline, the model record and the
native resizer) are copies in ``lmms_owc_tpu_torch.utils``, ``.schema`` and
``.native``.
"""

from lmms_owc_tpu_torch._device import get_device, no_tf32

__version__ = "0.1.0"

__all__ = ["get_device", "no_tf32"]
