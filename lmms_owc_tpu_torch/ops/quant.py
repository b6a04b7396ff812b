"""Weight quantization of the port: int8 per output channel, int4 groupwise.

Counterpart of :mod:`lmms_owc_tpu.ops.quant`, same rules in the port's
``[out, in]`` layout (the JAX ``[in, out]`` kernels transposed):

  - int8: symmetric per output channel, ``scale[o] = max|w[o, :]| / 127``
    (floored at 1e-12), ``q = clip(round(w / scale), -127, 127)``;
    ``q`` int8 ``[..., out, in]``, ``scale`` f32 ``[..., out]``.
  - int4: symmetric to [-7, 7] per (output channel, group of ``group`` input
    columns); ``q4`` int8 ``[..., out, in/2]`` in the HALVES layout (byte
    ``j`` of a row holds input column ``j`` in its low nibble and column
    ``j + in/2`` in its high nibble), ``scale`` f32 ``[..., out, in/group]``.

``round`` is half-to-even on both sides. The module-tree functions replace
:class:`~lmms_owc_tpu_torch.nn.layers.Linear` children by their int8/int4
siblings; parents named in ``exclude`` (``DEFAULT_EXCLUDE``, as in the JAX
package) keep full precision, and ``lm_head`` is quantized. The JAX package's
``stream_quantize_to_device`` feeds a TPU over its host link and has no
counterpart here.
"""

from __future__ import annotations

from itertools import chain

import torch
from torch import nn

__all__ = [
    "DEFAULT_EXCLUDE",
    "dequantize_int4",
    "dequantize_int8",
    "init_quantized_on_device",
    "quantize_int4",
    "quantize_int8",
    "quantize_params_int4",
    "quantize_params_int8",
    "unpack_int4",
]

DEFAULT_EXCLUDE = ("patch_embed", "embed_tokens", "visual_projection", "text_projection")


def quantize_int8(w: torch.Tensor) -> dict:
    """[..., out, in] weight -> {"q": int8 [..., out, in], "scale": f32 [..., out]}."""
    wf = w.float()
    scale = torch.clamp(wf.abs().amax(dim=-1) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(wf / scale[..., None]), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


def dequantize_int8(qp: dict, dtype=torch.float32) -> torch.Tensor:
    return (qp["q"].float() * qp["scale"][..., None]).to(dtype)


def quantize_int4(w: torch.Tensor, group: int = 128) -> dict:
    """[..., out, in] weight -> {"q4": int8 [..., out, in/2], "scale": f32 [..., out, in/group]}.

    An input width that ``group`` does not divide is one group (tiny test dims).
    """
    *lead, d_out, d_in = w.shape
    if d_in % group:
        group = d_in
    wf = w.float().reshape(*lead, d_out, d_in // group, group)
    scale = torch.clamp(wf.abs().amax(dim=-1) / 7.0, min=1e-12)
    q = torch.clamp(torch.round(wf / scale[..., None]), -7, 7).to(torch.int8)
    q = q.reshape(*lead, d_out, d_in)
    half = d_in // 2
    lo, hi = q[..., :half], q[..., half:]
    packed = torch.bitwise_or(torch.bitwise_left_shift(hi, 4), torch.bitwise_and(lo, 0xF))
    return {"q4": packed.to(torch.int8), "scale": scale}


def unpack_int4(qp: dict) -> torch.Tensor:
    """Packed int4 -> int8 values in [-7, 7], shape [..., out, in] (halves: lo, then hi)."""
    p = qp["q4"].to(torch.int32)
    lo = torch.bitwise_right_shift(torch.bitwise_left_shift(p, 28), 28)  # sign-extend
    hi = torch.bitwise_right_shift(p, 4)
    return torch.cat([lo, hi], dim=-1).to(torch.int8)


def dequantize_int4(qp: dict, dtype=torch.float32) -> torch.Tensor:
    q = unpack_int4(qp).float()
    *lead, d_out, d_in = q.shape
    n_groups = qp["scale"].shape[-1]
    grouped = q.reshape(*lead, d_out, n_groups, d_in // n_groups)
    return (grouped * qp["scale"][..., None]).reshape(*lead, d_out, d_in).to(dtype)


# ------------------------------------------------------------------ module trees


def _replace_linears(module: nn.Module, make, exclude: tuple[str, ...]) -> None:
    """Replace each float ``Linear`` child named outside ``exclude`` by ``make(child)``
    (None keeps it), depth first."""
    from lmms_owc_tpu_torch.nn.layers import Linear

    for name, child in list(module.named_children()):
        if isinstance(child, Linear):
            new = None if name in exclude else make(child)
            if new is not None:
                setattr(module, name, new)
        else:
            _replace_linears(child, make, exclude)


def quantize_params_int8(model: nn.Module, exclude: tuple[str, ...] = DEFAULT_EXCLUDE) -> nn.Module:
    """Replace every eligible ``Linear`` of ``model`` by an ``Int8Linear``, in place."""
    from lmms_owc_tpu_torch.nn.layers import Int8Linear

    _replace_linears(model, Int8Linear.from_linear, exclude)
    return model


def quantize_params_int4(
    model: nn.Module, exclude: tuple[str, ...] = DEFAULT_EXCLUDE, group: int = 128
) -> nn.Module:
    """Replace every eligible ``Linear`` (even input width) by an ``Int4Linear``, in place."""
    from lmms_owc_tpu_torch.nn.layers import Int4Linear

    def make(lin):
        return Int4Linear.from_linear(lin, group) if lin.weight.shape[1] % 2 == 0 else None

    _replace_linears(model, make, exclude)
    return model


@torch.no_grad()
def init_quantized_on_device(
    model: nn.Module,
    generator: torch.Generator,
    bits: int = 8,
    exclude: tuple[str, ...] = DEFAULT_EXCLUDE,
    dtype=torch.bfloat16,
) -> nn.Module:
    """Random-init ``model``, built on the ``meta`` device, on the generator's
    device with its eligible linear layers int8 or int4.

    Each eligible weight is drawn as ``N(0, 1) * 0.02`` in ``dtype`` on the
    device and quantized at once, one layer at a time, so the full-precision
    tree never exists (a 7B model is about 16.6 GB in bf16, 8.8 GB in int8).
    The other tensors follow the JAX package's convention by name: biases
    zero, norm scales one, everything else ``N(0, 1) * 0.02``. Values differ
    from the JAX stream; the distribution is the same.
    """
    from lmms_owc_tpu_torch.nn.layers import Int4Linear, Int8Linear, LayerNorm, RMSNorm

    device = generator.device

    def draw(shape):
        return (torch.randn(shape, generator=generator, device=device) * 0.02).to(dtype)

    def make(lin):
        d_out, d_in = lin.weight.shape
        if bits == 4 and d_in % 2:
            return None
        cls = Int8Linear if bits == 8 else Int4Linear
        return cls.from_weight(draw((d_out, d_in)), lin.bias is not None, dtype)  # bias starts at zero

    _replace_linears(model, make, exclude)
    for mod in model.modules():
        own = list(chain(mod.named_parameters(recurse=False), mod.named_buffers(recurse=False)))
        if not any(t.is_meta for _, t in own):
            continue
        mod.to_empty(device=device, recurse=False)
        for name, t in chain(mod.named_parameters(recurse=False), mod.named_buffers(recurse=False)):
            if name == "bias":
                t.zero_()
            elif isinstance(mod, (LayerNorm, RMSNorm)):
                t.fill_(1.0)
            else:
                t.copy_(draw(t.shape))
    return model
