"""Transformer layers as functions on tensors, plus thin parameter-holding modules.

Counterpart of :mod:`lmms_owc_tpu.nn.layers`. Layout rule: the JAX package
stores a linear kernel ``w`` as ``[in, out]``; the port stores ``weight = w.T``
as ``[out, in]`` (the ``nn.Linear`` layout) and computes ``x @ weight.T (+ bias)``.
The quantized branches of the JAX ``dense`` are :func:`dense_q8` (weight-only
int8, or W8A8 under :func:`set_int8_activations`) and :func:`dense_q4` (int4,
through the K4 kernel at decode row counts on the card), held by the
:class:`Int8Linear` and :class:`Int4Linear` siblings of :class:`Linear`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from lmms_owc_tpu_torch.ops.int4_matmul import int4_matmul, int4_matmul_supported
from lmms_owc_tpu_torch.ops.quant import quantize_int4, quantize_int8, unpack_int4

__all__ = [
    "Int4Linear",
    "Int8Linear",
    "LayerNorm",
    "Linear",
    "RMSNorm",
    "RowParallel",
    "apply_rope",
    "dense",
    "dense_q4",
    "dense_q8",
    "embedding",
    "gelu",
    "layer_norm",
    "mlp_gelu",
    "mlp_swiglu",
    "multi_head_attention",
    "quick_gelu",
    "rms_norm",
    "row_invariant",
    "set_int8_activations",
]

# W8A8 (per-token int8 activations against int8 weights): process-wide, as in
# the JAX package, and read by every dense_q8 call (nothing caches it).
_INT8_ACTIVATIONS = False


def set_int8_activations(value: bool) -> None:
    """Set the process-wide W8A8 mode of :func:`dense_q8`."""
    global _INT8_ACTIVATIONS
    _INT8_ACTIVATIONS = bool(value)


def dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None) -> torch.Tensor:
    """``x @ weight.T (+ bias)`` with ``weight`` [out, in], in the dtype of ``x``."""
    out = torch.matmul(x, weight.t())
    if bias is not None:
        out = out + bias
    return out


def _int_mm_operands(a: torch.Tensor, q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``a`` [M, K] and ``q`` [N, K] zero-padded to the shapes ``torch._int_mm``
    takes on CUDA: M > 16 and K, N multiples of 8 (the Qwen2.5-VL tower's MLP
    is 3420 wide). Zero columns add nothing to the int32 sums, so the product's
    first M rows and N columns are exact."""
    m, k = a.shape
    pad_m, pad_k, pad_n = 32 - m if m <= 16 else 0, -k % 8, -q.shape[0] % 8
    if pad_m or pad_k:
        a = F.pad(a, (0, pad_k, 0, pad_m))
    if pad_k or pad_n:
        q = F.pad(q, (0, pad_k, 0, pad_n))
    return a, q


def _int8_mm(a: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Exact s8 x s8 -> s32 product ``a @ q.T`` for a [M, K] and q [N, K].

    On CUDA the operands are zero-padded to the shapes ``torch._int_mm``
    takes (:func:`_int_mm_operands`) and the result cut back. There is no
    float fallback.
    """
    m, n = a.shape[0], q.shape[0]
    if a.device.type != "cpu":
        a, q = _int_mm_operands(a, q)
    return torch._int_mm(a, q.t())[:m, :n]


def _quantize_tokens(x: torch.Tensor, reduce_amax=None) -> tuple[torch.Tensor, torch.Tensor]:
    """W8A8's per-token activation quantizer: (int8 values, f32 scales [..., 1])
    with scale ``max(amax, 1e-6) / 127``. ``reduce_amax(amax)`` first reduces
    the per-token amax in place (a row-parallel product sees a slice of K)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    if reduce_amax is not None:
        reduce_amax(amax)
    sx = torch.clamp(amax, min=1e-6) / 127.0
    return torch.round(xf / sx).to(torch.int8), sx


def dense_q8(
    x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor | None = None
) -> torch.Tensor:
    """int8 ``dense``: ``q`` [out, in] int8, ``scale`` [out] f32; result in ``x.dtype``.

    Weight-only: ``(x @ q.T) * scale`` in ``x.dtype``. Under W8A8
    (:func:`set_int8_activations`): per-token ``amax / 127`` (floored at 1e-6)
    quantizes ``x`` to int8, the s8 x s8 product accumulates in int32, and
    ``(acc * sx) * scale`` in f32 is cast to ``x.dtype``, as the JAX package.
    """
    if _INT8_ACTIVATIONS:
        xq, sx = _quantize_tokens(x)
        acc = _int8_mm(xq.reshape(-1, x.shape[-1]), q).reshape(*x.shape[:-1], q.shape[0])
        out = (acc.float() * sx * scale).to(x.dtype)
    else:
        out = torch.matmul(x, q.to(x.dtype).t()) * scale.to(x.dtype)
    if bias is not None:
        out = out + bias
    return out


# K4 takes at most this many rows; more go through the dequantized product.
INT4_KERNEL_MAX_ROWS = 256


def _int4_kernel_takes(q4: torch.Tensor, scale: torch.Tensor, m_rows: int) -> bool:
    """Whether :func:`dense_q4` launches K4 for ``m_rows`` rows against ``q4``."""
    return (
        q4.device.type != "cpu"
        and q4.dim() == 2
        and m_rows <= INT4_KERNEL_MAX_ROWS
        and int4_matmul_supported(2 * q4.shape[-1], q4.shape[-2], scale.shape[-1])
    )


def dense_q4(
    x: torch.Tensor, q4: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor | None = None
) -> torch.Tensor:
    """int4 ``dense``: ``q4`` [out, in/2] (halves layout), ``scale`` [out, in/group] f32.

    Off the CPU, at most 256 rows and a shape K4 takes launch
    :func:`~lmms_owc_tpu_torch.ops.int4_matmul.int4_matmul`, as the JAX
    package dispatches its Pallas kernel; otherwise (and always on the CPU,
    where the JAX package has no kernel either) the weight is dequantized in
    ``x.dtype`` and multiplied.
    """
    d_in, n_groups = 2 * q4.shape[-1], scale.shape[-1]
    if _int4_kernel_takes(q4, scale, x.numel() // d_in):
        out = int4_matmul(x, q4, scale)
    else:
        w_int = unpack_int4({"q4": q4, "scale": scale})
        w = (
            w_int.reshape(*w_int.shape[:-1], n_groups, d_in // n_groups).to(x.dtype)
            * scale[..., None].to(x.dtype)
        ).reshape(*w_int.shape)
        out = torch.matmul(x, w.transpose(-1, -2))
    if bias is not None:
        out = out + bias
    return out


def row_invariant(lin: nn.Module, m_rows: int) -> bool:
    """Whether ``lin``'s product over ``m_rows`` rows gives each row the same
    bits at any row count: W8A8's s8 x s8 -> s32 product is exact, and K4
    splits K by K and N only. cuBLAS's float products (a :class:`Linear`, and
    the float copy of a weight-only int8 matrix) pick their split of K by
    the row count, as does the dequantized int4 product past K4's rows. A
    :class:`RowParallel` product is its slice's."""
    lin = getattr(lin, "inner", lin)
    if isinstance(lin, Int8Linear):
        return _INT8_ACTIVATIONS
    if isinstance(lin, Int4Linear):
        return _int4_kernel_takes(lin.q4, lin.scale, m_rows)
    return False


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


def mlp_gelu(x: torch.Tensor, up: nn.Module, down: nn.Module) -> torch.Tensor:
    """BERT/ViT-style MLP: ``down(gelu(up(x)))`` through the projection modules."""
    return down(gelu(up(x)))


def multi_head_attention(
    x: torch.Tensor,
    q: nn.Module,
    k: nn.Module,
    v: nn.Module,
    o: nn.Module,
    *,
    num_heads: int,
    num_kv_heads: int | None = None,
    causal: bool = False,
    kv_mask: torch.Tensor | None = None,
    kv_mask_contiguous: bool = False,
    rope_cos: torch.Tensor | None = None,
    rope_sin: torch.Tensor | None = None,
) -> torch.Tensor:
    """Self-attention block (no residual or norm) over [B, L, hidden] ``x`` with
    the projection modules ``q``/``k``/``v``/``o``. The heads go to
    :func:`~lmms_owc_tpu_torch.ops.attention.flash_attention` (K2) as
    [B, H, L, D] views, the KV heads unrepeated; ``kv_mask`` [B, L] marks valid
    keys, and ``kv_mask_contiguous`` promises one run of ones per row (BERT's
    right padding), which the kernel reads as (start, end) scalars."""
    from lmms_owc_tpu_torch.ops.attention import flash_attention

    b, l, _ = x.shape
    kvh = num_kv_heads or num_heads
    qh = q(x).view(b, l, num_heads, -1).transpose(1, 2)
    kh = k(x).view(b, l, kvh, -1).transpose(1, 2)
    vh = v(x).view(b, l, kvh, -1).transpose(1, 2)
    if rope_cos is not None:
        qh, kh = apply_rope(qh, rope_cos, rope_sin), apply_rope(kh, rope_cos, rope_sin)
    out = flash_attention(qh, kh, vh, causal=causal, kv_mask=kv_mask, kv_mask_contiguous=kv_mask_contiguous)
    return o(out.transpose(1, 2).reshape(b, l, -1))


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


# Quantizers run over blocks of output rows of at most this many weights, so
# their f32 temporaries stay near 0.5 GB even for a 7B model's vocab head; each
# row's values depend on that row alone, so the result is the same.
_QUANT_BLOCK = 1 << 25


def _row_blocks(d_out: int, d_in: int) -> list[slice]:
    step = max(1, _QUANT_BLOCK // max(d_in, 1))
    return [slice(r, min(r + step, d_out)) for r in range(0, d_out, step)]


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


class Int8Linear(nn.Module):
    """int8 sibling of :class:`Linear`: buffers ``q`` [out, in] int8 and
    ``scale`` [out] f32, optional ``bias`` [out] in the compute dtype; forward
    is :func:`dense_q8`."""

    def __init__(self, d_in: int, d_out: int, bias: bool, dtype, device) -> None:
        super().__init__()
        self.register_buffer("q", torch.empty((d_out, d_in), dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.empty((d_out,), dtype=torch.float32, device=device))
        self.bias = _param((d_out,), dtype, device, 0.0) if bias else None

    @classmethod
    @torch.no_grad()
    def from_weight(cls, weight: torch.Tensor, bias: bool, dtype) -> "Int8Linear":
        d_out, d_in = weight.shape
        new = cls(d_in, d_out, bias, dtype, weight.device)
        for rows in _row_blocks(d_out, d_in):
            qp = quantize_int8(weight[rows])
            new.q[rows] = qp["q"]
            new.scale[rows] = qp["scale"]
        return new

    @classmethod
    @torch.no_grad()
    def from_linear(cls, lin: Linear) -> "Int8Linear":
        new = cls.from_weight(lin.weight, lin.bias is not None, lin.weight.dtype)
        if lin.bias is not None:
            new.bias.copy_(lin.bias)
        return new

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense_q8(x, self.q, self.scale, self.bias)


class Int4Linear(nn.Module):
    """int4 sibling of :class:`Linear`: buffers ``q4`` [out, in/2] int8 (byte
    ``j`` of row ``o`` holds input column ``j`` in its low nibble and column
    ``j + in/2`` in its high nibble) and ``scale`` [out, in/group] f32, optional
    ``bias`` [out]; forward is :func:`dense_q4`."""

    def __init__(self, d_in: int, d_out: int, bias: bool, dtype, device, group: int = 128) -> None:
        super().__init__()
        groups = d_in // group if d_in % group == 0 else 1
        self.register_buffer("q4", torch.empty((d_out, d_in // 2), dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.empty((d_out, groups), dtype=torch.float32, device=device))
        self.bias = _param((d_out,), dtype, device, 0.0) if bias else None

    @classmethod
    @torch.no_grad()
    def from_weight(cls, weight: torch.Tensor, bias: bool, dtype, group: int = 128) -> "Int4Linear":
        d_out, d_in = weight.shape
        new = cls(d_in, d_out, bias, dtype, weight.device, group)
        for rows in _row_blocks(d_out, d_in):
            qp = quantize_int4(weight[rows], group)
            new.q4[rows] = qp["q4"]
            new.scale[rows] = qp["scale"]
        return new

    @classmethod
    @torch.no_grad()
    def from_linear(cls, lin: Linear, group: int = 128) -> "Int4Linear":
        new = cls.from_weight(lin.weight, lin.bias is not None, lin.weight.dtype, group)
        if lin.bias is not None:
            new.bias.copy_(lin.bias)
        return new

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense_q4(x, self.q4, self.scale, self.bias)


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


class RowParallel(nn.Module):
    """The row-parallel projection of tensor parallelism (``o``, ``down``, a
    tower's ``proj`` and ``fc2``): ``inner`` (a bias-free :class:`Linear`,
    :class:`Int8Linear` or :class:`Int4Linear`) holds this rank's slice of the
    input columns, ``group`` (a :class:`~lmms_owc_tpu_torch.parallel.mesh.ModelGroup`)
    sums the partial products of the model group, then the full ``bias`` is
    added. The float partials are summed in f32 and cast back once. Under
    W8A8 the per-token amax is all-reduced (MAX) before quantizing, and the
    int32 partials are summed before ``* sx * scale``: the product the JAX
    package's sharded ``einsum`` reduces, so it equals the unsharded one."""

    def __init__(self, inner: nn.Module, bias: torch.Tensor | None, group) -> None:
        super().__init__()
        self.inner = inner
        self.bias = None if bias is None else nn.Parameter(bias, requires_grad=False)
        self.group = group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inner = self.inner
        if isinstance(inner, Int8Linear) and _INT8_ACTIVATIONS:
            xq, sx = _quantize_tokens(x, lambda amax: self.group.all_reduce(amax, "max"))
            acc = _int8_mm(xq.reshape(-1, x.shape[-1]), inner.q).contiguous()
            acc = self.group.all_reduce(acc).reshape(*x.shape[:-1], inner.q.shape[0])
            out = (acc.float() * sx * inner.scale).to(x.dtype)
        else:
            out = self.group.all_reduce(inner(x).float().contiguous()).to(x.dtype)
        if self.bias is not None:
            out = out + self.bias
        return out
