"""Transformer layers as functions on tensors, plus thin parameter-holding modules.

Counterpart of :mod:`lmms_owc_tpu.nn.layers` (bf16/f32 forms; the int8, W8A8
and int4 branches of ``dense`` are not ported yet). Layout rule: the JAX
package stores a linear kernel ``w`` as ``[in, out]``; the port stores
``weight = w.T`` as ``[out, in]`` (the ``nn.Linear`` layout) and computes
``x @ weight.T (+ bias)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "LayerNorm",
    "Linear",
    "RMSNorm",
    "apply_rope",
    "dense",
    "embedding",
    "gelu",
    "layer_norm",
    "mlp_swiglu",
    "quick_gelu",
    "rms_norm",
]


def dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None) -> torch.Tensor:
    """``x @ weight.T (+ bias)`` with ``weight`` [out, in], in the dtype of ``x``."""
    out = torch.matmul(x, weight.t())
    if bias is not None:
        out = out + bias
    return out


def embedding(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return F.embedding(ids, table)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, as ``jax.nn.gelu(approximate=False)``."""
    return F.gelu(x)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def layer_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-12
) -> torch.Tensor:
    """LayerNorm in f32, cast back to the input dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    normed = (xf - mean) * torch.rsqrt(var + eps)
    return (normed * weight.float() + bias.float()).to(x.dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in f32 (Qwen family), cast back to the input dtype."""
    xf = x.float()
    normed = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (normed * weight.float()).to(x.dtype)


def mlp_swiglu(
    x: torch.Tensor, gate: torch.Tensor, up: torch.Tensor, down: torch.Tensor
) -> torch.Tensor:
    """Gated MLP ``(silu(x @ gate.T) * x @ up.T) @ down.T`` (weights [out, in])."""
    return dense(F.silu(dense(x, gate)) * dense(x, up), down)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate [B, H, L, D] by position tables [L, D/2] or [B, L, D/2] (HF half-split).

    The rotation runs in f32 and the result is cast back to ``x.dtype``.
    """
    if cos.dim() == 2:
        cos, sin = cos[None, None], sin[None, None]
    elif cos.dim() == 3:
        cos, sin = cos[:, None], sin[:, None]
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _param(shape, dtype, device, fill: float | None = None) -> nn.Parameter:
    t = torch.empty(shape, dtype=dtype, device=device)
    if fill is not None:
        t.fill_(fill)
    return nn.Parameter(t, requires_grad=False)


class Linear(nn.Module):
    """``weight`` [out, in], optional ``bias`` [out]; forward is :func:`dense`.

    The weight is left uninitialised: the model's ``init_params`` or
    ``params_from_jax`` fills it. Biases start at zero.
    """

    def __init__(self, d_in: int, d_out: int, bias: bool, dtype, device) -> None:
        super().__init__()
        self.weight = _param((d_out, d_in), dtype, device)
        self.bias = _param((d_out,), dtype, device, 0.0) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.weight, self.bias)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float, dtype, device) -> None:
        super().__init__()
        self.eps = eps
        self.weight = _param((dim,), dtype, device, 1.0)
        self.bias = _param((dim,), dtype, device, 0.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, dtype, device) -> None:
        super().__init__()
        self.eps = eps
        self.weight = _param((dim,), dtype, device, 1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps)
