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
``stream_quantize_to_device`` feeds a TPU over its host link; its counterpart
for checkpoints here is :func:`load_quantized_on_device`, which quantizes on
the device one layer at a time.
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
    "load_quantized_on_device",
    "materialize_on_device",
    "pack_int4",
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
    return {"q4": pack_int4(q.reshape(*lead, d_out, d_in)), "scale": scale}


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int8 values in [-7, 7], [..., out, in] -> the halves layout [..., out, in/2]."""
    half = q.shape[-1] // 2
    lo, hi = q[..., :half], q[..., half:]
    return torch.bitwise_or(torch.bitwise_left_shift(hi, 4), torch.bitwise_and(lo, 0xF)).to(torch.int8)


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


def _replace_linears(module: nn.Module, make, exclude: tuple[str, ...], prefix: str = "") -> None:
    """Replace each float ``Linear`` child named outside ``exclude`` by
    ``make(qualified_name, child)`` (None keeps it), depth first."""
    from lmms_owc_tpu_torch.nn.layers import Linear

    for name, child in list(module.named_children()):
        if isinstance(child, Linear):
            new = None if name in exclude else make(prefix + name, child)
            if new is not None:
                setattr(module, name, new)
        else:
            _replace_linears(child, make, exclude, f"{prefix}{name}.")


def quantize_params_int8(model: nn.Module, exclude: tuple[str, ...] = DEFAULT_EXCLUDE) -> nn.Module:
    """Replace every eligible ``Linear`` of ``model`` by an ``Int8Linear``, in place."""
    from lmms_owc_tpu_torch.nn.layers import Int8Linear

    _replace_linears(model, lambda _, lin: Int8Linear.from_linear(lin), exclude)
    return model


def quantize_params_int4(
    model: nn.Module, exclude: tuple[str, ...] = DEFAULT_EXCLUDE, group: int = 128
) -> nn.Module:
    """Replace every eligible ``Linear`` (even input width) by an ``Int4Linear``, in place."""
    from lmms_owc_tpu_torch.nn.layers import Int4Linear

    def make(_, lin):
        return Int4Linear.from_linear(lin, group) if lin.weight.shape[1] % 2 == 0 else None

    _replace_linears(model, make, exclude)
    return model


@torch.no_grad()
def materialize_on_device(model: nn.Module, device, fill, after=None, only_meta: bool = False) -> nn.Module:
    """Bring ``model`` to ``device`` one module at a time, in module order. A
    module with a tensor on ``meta`` has its own tensors allocated on
    ``device``, each written by ``fill(name, tensor, module)``; any other
    module has its own parameters written (none with ``only_meta``). Then
    ``after(name, module)`` runs: tensor parallelism's shard hook, which may
    replace the module by its slice. Names are qualified parameter and module
    names. The walk holds no module it has passed, so a module that ``after``
    replaces is freed at once."""
    for mod_name, mod in model.named_modules(remove_duplicate=False):
        own = list(chain(mod.named_parameters(recurse=False), mod.named_buffers(recurse=False)))
        if any(t.is_meta for _, t in own):
            mod.to_empty(device=device, recurse=False)
            targets = list(chain(mod.named_parameters(recurse=False), mod.named_buffers(recurse=False)))
        else:
            targets = [] if only_meta else list(mod.named_parameters(recurse=False))
        for name, t in targets:
            fill(f"{mod_name}.{name}" if mod_name else name, t, mod)
        if after is not None:
            after(mod_name, mod)
    return model


@torch.no_grad()
def _materialize_quantized(model: nn.Module, device, bits: int, exclude: tuple[str, ...], dtype, weight, fill,
                           after=None):
    """The walk shared by :func:`init_quantized_on_device` and
    :func:`load_quantized_on_device`: ``model`` (built on ``meta``) comes to
    ``device`` one module at a time. Each eligible ``Linear`` (int4: even
    input width) becomes an ``Int8Linear``/``Int4Linear`` made from
    ``weight(name, (out, in))``, a ``dtype`` tensor on ``device`` that is
    dropped once quantized; every other tensor is allocated on ``device`` and
    written by ``fill(name, tensor, module)``. Names are the model's
    qualified parameter names. ``after(name, module)`` (tensor parallelism's
    shard hook) runs on each quantized module once it is made, and on every
    other module once its tensors are written (:func:`materialize_on_device`);
    it returns the module or the slice that replaces it, and leaves the
    modules it made alone."""
    from lmms_owc_tpu_torch.nn.layers import Int4Linear, Int8Linear

    cls = Int8Linear if bits == 8 else Int4Linear

    def make(name, lin):
        d_out, d_in = lin.weight.shape
        if bits == 4 and d_in % 2:
            return None
        new = cls.from_weight(weight(f"{name}.weight", (d_out, d_in)), lin.bias is not None, dtype)
        if new.bias is not None:
            fill(f"{name}.bias", new.bias, new)
        return new if after is None else after(name, new)

    _replace_linears(model, make, exclude)
    return materialize_on_device(model, device, fill, after, only_meta=True)


def init_quantized_on_device(
    model: nn.Module,
    generator: torch.Generator,
    bits: int = 8,
    exclude: tuple[str, ...] = DEFAULT_EXCLUDE,
    dtype=torch.bfloat16,
    after=None,
) -> nn.Module:
    """Random-init ``model``, built on the ``meta`` device, on the generator's
    device with its eligible linear layers int8 or int4.

    Each eligible weight is drawn as ``N(0, 1) * 0.02`` in ``dtype`` on the
    device and quantized at once, one layer at a time, so the full-precision
    tree never exists (a 7B model is about 16.6 GB in bf16, 8.8 GB in int8).
    The other tensors follow the JAX package's convention by name: biases
    zero, norm scales one, everything else ``N(0, 1) * 0.02``. Values differ
    from the JAX stream; the distribution is the same. ``after`` is
    :func:`_materialize_quantized`'s shard hook: a sharded model draws the
    full tensors in the same order and keeps its slices.
    """
    from lmms_owc_tpu_torch.nn.layers import LayerNorm, RMSNorm

    device = generator.device

    def draw(_, shape):
        return (torch.randn(shape, generator=generator, device=device) * 0.02).to(dtype)

    def fill(name, t, mod):
        if name.endswith("bias"):
            t.zero_()
        elif isinstance(mod, (LayerNorm, RMSNorm)):
            t.fill_(1.0)
        else:
            t.copy_(draw(name, t.shape))

    return _materialize_quantized(model, device, bits, exclude, dtype, draw, fill, after)


def load_quantized_on_device(
    model: nn.Module,
    state,
    bits: int = 8,
    exclude: tuple[str, ...] = DEFAULT_EXCLUDE,
    dtype=torch.bfloat16,
    device="cuda",
    after=None,
) -> nn.Module:
    """Load ``model``, built on the ``meta`` device, from a checkpoint's lazy
    ``state`` onto ``device`` with its eligible linear layers int8 or int4.

    One module at a time: each eligible weight is read from the checkpoint
    (``model.hf_tensor(state, name)``), cast to ``dtype`` (on the host, the
    copy then carries ``dtype`` bytes), quantized on the device and dropped,
    so the full-precision tree never exists there; the device holds the
    quantized model plus one weight in ``dtype`` and the quantizer's blocks.
    The int leaves are those of the JAX package's ``quantize_int8`` /
    ``quantize_int4`` applied to the weight cast to ``dtype``. Every other
    tensor is copied in, cast to its module's dtype. ``after`` is
    :func:`_materialize_quantized`'s shard hook.
    """
    from lmms_owc_tpu_torch.nn.loader import copy_checkpoint_tensor

    device = torch.device(device)

    def weight(name, shape):
        w = model.hf_tensor(state, name)
        if tuple(w.shape) != tuple(shape):
            raise ValueError(f"{name}: checkpoint shape {tuple(w.shape)} does not fit {tuple(shape)}")
        return w.to(device=device, dtype=dtype)

    def fill(name, t, _mod):
        copy_checkpoint_tensor(t, model.hf_tensor(state, name), name)

    return _materialize_quantized(model, device, bits, exclude, dtype, weight, fill, after)
