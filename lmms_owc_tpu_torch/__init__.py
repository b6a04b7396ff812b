"""lmms_owc_tpu_torch — the PyTorch/CUDA port of :mod:`lmms_owc_tpu` for one NVIDIA H100.

The JAX package stays the reference; this package mirrors its module names so
each counterpart is easy to find, and never imports JAX:

  - ``lmms_owc_tpu_torch.ops``     hand-written Hopper kernels (``csrc/*.cu``,
                                   built at first use) behind wrappers that take
                                   their plain PyTorch versions for CPU tensors.
  - ``lmms_owc_tpu_torch.nn``      the model stack as ``nn.Module``s and tensor
                                   functions (Qwen2-VL vision tower, prefill, decode).
  - ``lmms_owc_tpu_torch.models``  the adapter registry, the ``Qwen2VL`` adapter
                                   and the fake model.
  - ``lmms_owc_tpu_torch.tasks``, ``.filters``, ``.metrics``, ``.samplers``,
    ``.engine``, ``.loggers``      the evaluation engine, driven by the CLI
                                   ``python -m lmms_owc_tpu_torch.eval_model``.

It imports nothing of the JAX package either: the host layers it shares with
it are copies (``utils``, ``schema``, ``native`` and the engine's packages).
"""

from lmms_owc_tpu_torch._device import get_device, no_tf32

__version__ = "0.1.0"

__all__ = ["get_device", "no_tf32"]
