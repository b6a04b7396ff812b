"""Attention: hand-written CUDA kernels for Hopper, and their plain PyTorch versions.

Counterpart of :mod:`lmms_owc_tpu.ops.attention`. Five entries carry the
Qwen2-VL and Qwen2.5-VL paths:

  - :func:`flash_attention` — decoder prefill (port of the Pallas ``_flash_kernel``,
    K2): causal GQA with contiguous or gappy key masks, ``csrc/flash_attn.cu``.
  - :func:`fused_qkv_attention` — K2's combined-heads entry: q, k and v are
    head-offset views of one qkv array (head- or token-major); the Qwen2.5-VL
    tower's window and global layers, rope in the kernel; same CUDA kernel.
  - :func:`vision_qkv_attention` — the Qwen2-VL ViT (port of ``_flash_kernel_fm``,
    K1, token-major): reads q/k/v in place from the qkv projection output, rope
    in the kernel; same CUDA kernel.
  - :func:`packed_vision_attention` — the ViT over a qkv projection whose heads
    are zero-padded to 128 columns (port of ``_packed_kernel``, K5); same CUDA
    kernel, reading the padded heads in place.
  - :func:`gqa_decode_attention` — decode (port of ``_decode_kernel``, K3) against
    one layer of the stacked KV cache, bf16/f32 or int8 with per-position
    scales, ``csrc/decode_attn.cu``; the key axis is split across a cluster
    of CTAs by :func:`decode_split_plan`, a function of the cache length only,
    up to 2048 positions; longer caches run a general kernel whose f32 score
    rows go to a device-memory workspace where shared memory cannot hold them
    (:func:`decode_needs_workspace`).

Each wrapper takes its plain version (``*_plain`` or
:func:`packed_attention_reference`, built on :func:`attention_reference` and
:func:`gqa_attention_reference`) only when the tensors lie on the CPU. For a
CUDA tensor it launches the kernel or raises; it never falls back. Every launch
adds one to :data:`launch_counts` under the wrapper's name (the int8-cache
decode under ``gqa_decode_attention_int8``); a flash launch that carried a
gappy ``[B, Lk]`` mask tensor also adds one under
``flash_attention_tensor_mask``, whichever entry made it.
"""

from __future__ import annotations

import ctypes
import math

import torch

from lmms_owc_tpu_torch.nn.layers import apply_rope
from lmms_owc_tpu_torch.ops import _build

__all__ = [
    "attention_reference",
    "decode_needs_workspace",
    "decode_split_plan",
    "flash_attention",
    "flash_attention_plain",
    "fused_qkv_attention",
    "fused_qkv_attention_plain",
    "gqa_attention_reference",
    "gqa_decode_attention",
    "gqa_decode_attention_plain",
    "launch_counts",
    "packed_attention_reference",
    "packed_vision_attention",
    "reset_launch_counts",
    "vision_qkv_attention",
    "vision_qkv_attention_plain",
]

_NEG_INF = -1e30
_LOG2E = 1.4426950408889634
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_FLASH_HEAD_DIMS = (16, 32, 64, 72, 80, 88, 96, 128)
# The decode kernel's limits (csrc/decode_attn.cu): the Hopper instances take a
# bf16 query at these head dims, groups up to 8 and a split plan of at most 8
# splits (the portable thread-block cluster size) of at most 256 keys; the
# general kernel keeps the group's f32 score rows in at most this much shared
# memory and otherwise in a workspace.
_DECODE_MAX_SPLITS = 8
_DECODE_MAX_SPLIT_KEYS = 256
_DECODE_HOPPER_HEAD_DIMS = (64, 128)
_DECODE_MAX_GROUP = 8
_DECODE_MAX_SMEM = 232448

launch_counts: dict[str, int] = {
    "flash_attention": 0,
    "flash_attention_tensor_mask": 0,
    "fused_qkv_attention": 0,
    "vision_qkv_attention": 0,
    "packed_vision_attention": 0,
    "gqa_decode_attention": 0,
    "gqa_decode_attention_int8": 0,
}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


# ----------------------------------------------------------------- plain versions


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    kv_mask: torch.Tensor | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Plain attention, q/k/v [B, H, L, D]: f32 scores, ``-1e30`` masking, f32
    softmax cast to the v dtype before the PV product (as the JAX reference)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        lq, lk = q.shape[2], k.shape[2]
        q_idx = torch.arange(lq, device=q.device)[:, None] + (lk - lq)
        k_idx = torch.arange(lk, device=q.device)[None, :]
        scores = scores.masked_fill(k_idx > q_idx, _NEG_INF)
    if kv_mask is not None:
        scores = scores.masked_fill(~kv_mask.bool()[:, None, None, :], _NEG_INF)
    weights = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", weights.to(v.dtype), v)


def gqa_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    kv_mask: torch.Tensor | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Grouped-query plain attention: q [B, H, Lq, D], k/v [B, KVH, Lk, D] with
    H % KVH == 0 (consecutive query heads share a KV head); no repeated KV."""
    b, h, lq, d = q.shape
    kvh = k.shape[1]
    g = h // kvh
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, kvh, g, lq, d)
    scores = torch.einsum("bkgqd,bkld->bkgql", qg.float(), k.float()) * scale
    if causal:
        lk = k.shape[2]
        q_idx = torch.arange(lq, device=q.device)[:, None] + (lk - lq)
        k_idx = torch.arange(lk, device=q.device)[None, :]
        scores = scores.masked_fill(k_idx > q_idx, _NEG_INF)
    if kv_mask is not None:
        scores = scores.masked_fill(~kv_mask.bool()[:, None, None, None, :], _NEG_INF)
    weights = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgql,bkld->bkgqd", weights.to(v.dtype), v)
    return out.reshape(b, h, lq, d)


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    kv_mask: torch.Tensor | None = None,
    scale: float | None = None,
    rope_cos: torch.Tensor | None = None,
    rope_sin: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain version of :func:`flash_attention`: rotate, then plain (GQA) attention."""
    if rope_cos is not None:
        q = apply_rope(q, rope_cos, rope_sin)
        k = apply_rope(k, rope_cos, rope_sin)
    if k.shape[1] != q.shape[1]:
        return gqa_attention_reference(q, k, v, causal=causal, kv_mask=kv_mask, scale=scale)
    return attention_reference(q, k, v, causal=causal, kv_mask=kv_mask, scale=scale)


def _fused_views(qkvh: torch.Tensor, h: int, kvh: int, token_major: bool):
    """q [B, H, L, D], k and v [B, KVH, L, D] as head-offset views of a combined
    [B, H + 2*KVH, L, D] array, or of its token-major [B, L, H + 2*KVH, D] form."""
    total = qkvh.shape[2] if token_major else qkvh.shape[1]
    if total != h + 2 * kvh or h % kvh != 0:
        raise ValueError(f"qkvh head axis {total} != {h} + 2*{kvh}")
    heads = qkvh.permute(0, 2, 1, 3) if token_major else qkvh
    return heads[:, :h], heads[:, h : h + kvh], heads[:, h + kvh :]


def fused_qkv_attention_plain(
    qkvh: torch.Tensor,
    num_q_heads: int,
    num_kv_heads: int,
    *,
    causal: bool = False,
    kv_mask: torch.Tensor | None = None,
    scale: float | None = None,
    rope_cos: torch.Tensor | None = None,
    rope_sin: torch.Tensor | None = None,
    token_major: bool = False,
) -> torch.Tensor:
    """Plain version of :func:`fused_qkv_attention`: slice the roles apart, then
    :func:`flash_attention_plain` (the JAX fallback)."""
    q, k, v = _fused_views(qkvh, num_q_heads, num_kv_heads, token_major)
    out = flash_attention_plain(
        q, k, v, causal=causal, kv_mask=kv_mask, scale=scale, rope_cos=rope_cos, rope_sin=rope_sin
    )
    if token_major:
        b, h, l, d = out.shape
        return out.permute(0, 2, 1, 3).reshape(b, l, h * d)
    return out


def packed_attention_reference(
    qkv: torch.Tensor,
    num_heads: int,
    head_dim: int,
    *,
    kv_mask: torch.Tensor | None = None,
    freqs: torch.Tensor | None = None,
    scale: float | None = None,
    rope_cos: torch.Tensor | None = None,
    rope_sin: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain version of :func:`packed_vision_attention` (the JAX ground truth):
    unpack [B, L, 3*NH*HP] into [B, NH, L, head_dim] q/k/v, rotate, attend, and
    re-pack [B, L, NH*HP] with zero padding columns. Rope comes from ``freqs``
    (cos/sin in f32) or from ready ``rope_cos``/``rope_sin`` tables."""
    b, l, width = qkv.shape
    hp = width // (3 * num_heads)
    x = qkv.view(b, l, 3, num_heads, hp)
    q, k, v = (x[:, :, i].permute(0, 2, 1, 3)[..., :head_dim] for i in range(3))
    if freqs is not None:
        rope_cos, rope_sin = torch.cos(freqs.float()), torch.sin(freqs.float())
    out = flash_attention_plain(q, k, v, kv_mask=kv_mask, scale=scale, rope_cos=rope_cos, rope_sin=rope_sin)
    out = torch.nn.functional.pad(out, (0, hp - head_dim))
    return out.permute(0, 2, 1, 3).reshape(b, l, num_heads * hp)


def vision_qkv_attention_plain(
    qkv: torch.Tensor,
    num_heads: int,
    head_dim: int,
    *,
    kv_mask: torch.Tensor | None = None,
    scale: float | None = None,
    rope_cos: torch.Tensor | None = None,
    rope_sin: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain version of :func:`vision_qkv_attention`: [N, P, 3*H*D] -> [N, P, H*D]."""
    n, p, _ = qkv.shape
    return fused_qkv_attention_plain(
        qkv.view(n, p, 3 * num_heads, head_dim), num_heads, num_heads, kv_mask=kv_mask,
        scale=scale, rope_cos=rope_cos, rope_sin=rope_sin, token_major=True,
    )


def gqa_decode_attention_plain(
    q: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    layer_idx: int,
    kv_mask: torch.Tensor,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
    *,
    scale: float | None = None,
) -> torch.Tensor:
    """Plain version of :func:`gqa_decode_attention`: [B, H, D] against ``cache[layer_idx]``.

    An int8 cache is dequantized to ``q.dtype`` first (values times scales in
    f32), as the JAX package's fallback does.
    """
    ck, cv = cache_k[layer_idx], cache_v[layer_idx]
    if k_scale is not None:
        ck = (ck.float() * k_scale[layer_idx][..., None]).to(q.dtype)
        cv = (cv.float() * v_scale[layer_idx][..., None]).to(q.dtype)
    out = gqa_attention_reference(q[:, :, None, :], ck, cv, kv_mask=kv_mask, scale=scale)
    return out[:, :, 0, :]


# ----------------------------------------------------------------- kernel launches


def _check_operands(tensors: dict[str, torch.Tensor]) -> torch.dtype:
    first = next(iter(tensors.values()))
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != first.device:
            raise ValueError(f"{name}: expected a CUDA tensor on {first.device}, got {t.device}")
        if t.dtype not in _DTYPE_CODES or t.dtype != first.dtype:
            raise ValueError(f"{name}: expected bf16 or f32 matching q, got {t.dtype}")
    return first.dtype


def _stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on_error(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with cudaError {code}")


def _mask_start_end(kv_mask: torch.Tensor) -> torch.Tensor:
    """[B, L] mask with one contiguous run of ones per row -> [B, 2] int32 (start, end)."""
    m = kv_mask.to(torch.int32)
    first = torch.argmax(m, dim=1).to(torch.int32)
    count = m.sum(dim=1, dtype=torch.int32)
    return torch.stack([first, first + count], dim=1).contiguous()


def _rope_table(table: torch.Tensor, batch: int, length: int, half: int) -> torch.Tensor:
    table = table.to(torch.float32).contiguous()
    if table.dim() == 2:
        table = table[None]
    if table.shape[1:] != (length, half) or table.shape[0] not in (1, batch):
        raise ValueError(f"rope table {tuple(table.shape)} does not fit [{batch}, {length}, {half}]")
    return table


def _launch_flash(
    name: str,
    q: torch.Tensor,  # [B, H, Lq, D] any strides, unit last stride
    k: torch.Tensor,  # [B, KVH, Lk, D]
    v: torch.Tensor,
    out: torch.Tensor,  # [B, H, Lq, D] view of the output
    *,
    causal: bool,
    kv_mask: torch.Tensor | None,
    kv_mask_contiguous: bool,
    scale: float,
    rope_cos: torch.Tensor | None,
    rope_sin: torch.Tensor | None,
) -> None:
    """Launch the flash kernel and count it under ``name``. A contiguous mask
    goes to the kernel as (start, end) per row, any other as an int32 tensor."""
    lib = _build.load_library()
    dtype = _check_operands({"q": q, "k": k, "v": v, "out": out})
    b, h, lq, d = q.shape
    kvh, lk = k.shape[1], k.shape[2]
    if k.shape != (b, kvh, lk, d) or v.shape != k.shape or out.shape != q.shape:
        raise ValueError(f"shape mismatch: q {q.shape}, k {k.shape}, v {v.shape}, out {out.shape}")
    if h % kvh != 0:
        raise ValueError(f"{h} query heads are not a multiple of {kvh} KV heads")
    if d not in _FLASH_HEAD_DIMS:
        raise ValueError(f"head_dim {d} not built; supported: {_FLASH_HEAD_DIMS}")
    for role, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if t.stride(-1) != 1:
            raise ValueError(f"{role}: head_dim must be the unit-stride axis, strides {t.stride()}")
    if dtype == torch.bfloat16:
        for role, t in (("q", q), ("k", k), ("v", v)):
            # Tiles are read from shared memory as bf16 pairs: keep rows 4-byte aligned.
            if t.data_ptr() % 4 or any(s % 2 for s in t.stride()[:-1]):
                raise ValueError(f"{role}: bf16 rows must be 4-byte aligned, strides {t.stride()}")
    mask_se = mask = cos = sin = None
    if kv_mask is not None:
        if kv_mask.shape != (b, lk):
            raise ValueError(f"kv_mask {tuple(kv_mask.shape)} != [{b}, {lk}]")
        if kv_mask_contiguous:
            mask_se = _mask_start_end(kv_mask.to(q.device))
        else:
            mask = kv_mask.to(device=q.device, dtype=torch.int32).contiguous()
    k_rot = None
    if rope_cos is not None:
        if lq != lk:
            raise ValueError("fused rope expects self-attention (Lq == Lk)")
        cos = _rope_table(rope_cos, b, lq, d // 2).to(q.device)
        sin = _rope_table(rope_sin, b, lq, d // 2).to(q.device)
        if dtype == torch.bfloat16:  # the Hopper instances rotate the keys once into this scratch
            k_rot = torch.empty((b, kvh, lk, d), dtype=dtype, device=q.device)
    args = _build.FlashArgs(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        mask_se.data_ptr() if mask_se is not None else None,
        mask.data_ptr() if mask is not None else None,
        cos.data_ptr() if cos is not None else None,
        sin.data_ptr() if sin is not None else None,
        0 if cos is None or cos.shape[0] == 1 else cos.stride(0),
        b, h, kvh, lq, lk, d, int(causal), _DTYPE_CODES[dtype],
        scale * _LOG2E,
        k_rot.data_ptr() if k_rot is not None else None,
    )
    code = lib.owc_flash_attention(ctypes.byref(args), _stream_handle(q.device))
    _raise_on_error(code, name)
    launch_counts[name] += 1
    if mask is not None:
        launch_counts["flash_attention_tensor_mask"] += 1


def _launch_combined(
    name: str, qkvh: torch.Tensor, h: int, kvh: int, *, token_major: bool, **kw
) -> torch.Tensor:
    """Launch the flash kernel on the head-offset views of a combined qkv array;
    the result is [B, H, L, D], or [B, L, H*D] for a token-major input."""
    q, k, v = _fused_views(qkvh, h, kvh, token_major)
    b, _, l, d = q.shape
    if token_major:
        out = torch.empty((b, l, h * d), dtype=qkvh.dtype, device=qkvh.device)
        out_view = out.view(b, l, h, d).permute(0, 2, 1, 3)
    else:
        out = out_view = torch.empty(q.shape, dtype=qkvh.dtype, device=qkvh.device)
    _launch_flash(name, q, k, v, out_view, **kw)
    return out


def _launch_decode(
    q: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    layer_idx: int,
    kv_mask: torch.Tensor,
    k_scale: torch.Tensor | None,
    v_scale: torch.Tensor | None,
    scale: float,
) -> torch.Tensor:
    """Check the operands, launch the decode kernel with the split plan of the
    cache length, and count it (the int8 cache under ``gqa_decode_attention_int8``)."""
    b, h, d = q.shape
    int8 = cache_k.dtype == torch.int8
    lib = _build.load_library()
    if int8:
        dtype = _check_operands({"q": q})
        for name, t in (("cache_k", cache_k), ("cache_v", cache_v), ("k_scale", k_scale), ("v_scale", v_scale)):
            if t.device != q.device:
                raise ValueError(f"{name}: expected a tensor on {q.device}, got {t.device}")
        if cache_v.dtype != torch.int8 or k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
            raise ValueError("an int8 cache takes int8 k/v and f32 scales")
    else:
        dtype = _check_operands({"q": q, "cache_k": cache_k, "cache_v": cache_v})
    layers, cb, kvh, s, cd = cache_k.shape
    if cb != b or cd != d or cache_v.shape != cache_k.shape or h % kvh != 0:
        raise ValueError(f"shape mismatch: q {q.shape}, cache {cache_k.shape} / {cache_v.shape}")
    if int8 and (k_scale.shape != (layers, b, kvh, s) or v_scale.shape != k_scale.shape):
        raise ValueError(f"scales {tuple(k_scale.shape)} / {tuple(v_scale.shape)} != [{layers}, {b}, {kvh}, {s}]")
    if not 0 <= layer_idx < layers:
        raise ValueError(f"layer_idx {layer_idx} outside [0, {layers})")
    vec = 16 // cache_k.element_size()  # the kernel reads cache rows as 16-byte vectors
    if h // kvh > 8 or d > 128 or d % vec:
        raise ValueError(
            f"decode kernel takes groups <= 8 and head_dim <= 128 divisible by {vec}, "
            f"got {h // kvh}, {d}"
        )
    operands = (("q", q), ("cache_k", cache_k), ("cache_v", cache_v))
    if int8:
        operands += (("k_scale", k_scale), ("v_scale", v_scale))
    for name, t in operands:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if cache_k.data_ptr() % 16 or cache_v.data_ptr() % 16:
        raise ValueError("the caches must start 16-byte aligned")
    if kv_mask.shape != (b, s):
        raise ValueError(f"kv_mask {tuple(kv_mask.shape)} != [{b}, {s}]")
    mask = kv_mask.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    workspace = None
    if decode_needs_workspace(dtype == torch.bfloat16, d, h // kvh, s):
        workspace = torch.empty((b, kvh, h // kvh, s), dtype=torch.float32, device=q.device)
    args = _build.DecodeArgs(
        q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(), mask.data_ptr(), out.data_ptr(),
        k_scale.data_ptr() if int8 else None, v_scale.data_ptr() if int8 else None,
        layers, b, h, kvh, s, d, int(layer_idx), _DTYPE_CODES[dtype], int(int8), scale,
        *decode_split_plan(s),
        workspace.data_ptr() if workspace is not None else None,
    )
    code = lib.owc_gqa_decode_attention(ctypes.byref(args), _stream_handle(q.device))
    name = "gqa_decode_attention_int8" if int8 else "gqa_decode_attention"
    _raise_on_error(code, name)
    launch_counts[name] += 1
    return out


# ----------------------------------------------------------------- public entries


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    kv_mask: torch.Tensor | None = None,
    kv_mask_contiguous: bool = False,
    scale: float | None = None,
    rope_cos: torch.Tensor | None = None,
    rope_sin: torch.Tensor | None = None,
) -> torch.Tensor:
    """Multi-head attention, q [B, H, Lq, D], k/v [B, KVH, Lk, D] (GQA when KVH < H).

    ``causal`` aligns the diagonal to the sequence end. ``kv_mask`` [B, Lk] marks
    valid keys (nonzero = attend); ``kv_mask_contiguous`` promises one
    contiguous run per row, which the CUDA kernel then reads as (start, end)
    scalars; any other mask goes to the kernel as an int32 tensor.
    ``rope_cos``/``rope_sin`` [B or 1, L, D/2] rotate q and k (self-attention).
    Inputs may be strided views with a unit stride along D; the result is a new
    contiguous [B, H, Lq, D]. Query rows with no valid key are zeros on the
    card (the plain version averages over all keys there); callers never read them.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if rope_cos is not None and q.shape[2] != k.shape[2]:
        raise ValueError("fused rope expects self-attention (Lq == Lk)")
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, causal=causal, kv_mask=kv_mask, scale=scale,
            rope_cos=rope_cos, rope_sin=rope_sin,
        )
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch_flash(
        "flash_attention", q, k, v, out, causal=causal, kv_mask=kv_mask,
        kv_mask_contiguous=kv_mask_contiguous, scale=scale, rope_cos=rope_cos, rope_sin=rope_sin,
    )
    return out


def fused_qkv_attention(
    qkvh: torch.Tensor,
    num_q_heads: int,
    num_kv_heads: int,
    *,
    causal: bool = False,
    kv_mask: torch.Tensor | None = None,
    kv_mask_contiguous: bool = False,
    scale: float | None = None,
    rope_cos: torch.Tensor | None = None,
    rope_sin: torch.Tensor | None = None,
    token_major: bool = False,
) -> torch.Tensor:
    """Self-attention over a combined-heads qkv array, with no q/k/v slice copies.

    ``qkvh`` is [B, H + 2*KVH, L, D]: q heads at [0, H), k heads at [H, H+KVH),
    v heads after. The kernel reads q, k and v as head-offset views of it; the
    result is [B, H, L, D]. With ``token_major`` the input is the [B, L,
    H + 2*KVH, D] view of a qkv dense output and the result is [B, L, H*D],
    the layout the output projection takes, so neither side is transposed.
    The other arguments are :func:`flash_attention`'s.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(qkvh.shape[-1])
    kw = dict(causal=causal, kv_mask=kv_mask, scale=scale, rope_cos=rope_cos, rope_sin=rope_sin)
    if qkvh.device.type == "cpu":
        return fused_qkv_attention_plain(qkvh, num_q_heads, num_kv_heads, token_major=token_major, **kw)
    return _launch_combined(
        "fused_qkv_attention", qkvh, num_q_heads, num_kv_heads, token_major=token_major,
        kv_mask_contiguous=kv_mask_contiguous, **kw,
    )


def packed_vision_attention(
    qkv: torch.Tensor,
    num_heads: int,
    head_dim: int,
    *,
    kv_mask: torch.Tensor | None = None,
    freqs: torch.Tensor | None = None,
    scale: float | None = None,
    rope_cos: torch.Tensor | None = None,
    rope_sin: torch.Tensor | None = None,
) -> torch.Tensor:
    """Non-causal MHA over a packed qkv projection output (K5's entry).

    ``qkv`` [B, L, 3*NH*HP] holds each head's ``head_dim`` columns zero-padded
    to HP (a multiple of 128): column (role, head, c) at role*NH*HP + head*HP + c.
    The kernel reads q, k and v as [..., :head_dim] views of it in place and
    writes [B, L, NH*HP] with exact zeros in the padding columns, the layout a
    row-padded output projection takes. ``kv_mask`` [B, L] must hold one
    contiguous run per row (vision prefix padding). Rope comes from ``freqs``
    [B, L, head_dim/2] (cos/sin in f32 per call, as the TPU kernel computes
    them) or from ``rope_cos``/``rope_sin`` tables a caller computed once.
    """
    b, l, width = qkv.shape
    hp = width // (3 * num_heads)
    if width != 3 * num_heads * hp or hp % 128 != 0 or head_dim > hp:
        raise ValueError(f"packed qkv width {width} not 3*{num_heads}*128k")
    if freqs is not None and rope_cos is not None:
        raise ValueError("pass freqs or rope_cos/rope_sin, not both")
    if scale is None:
        scale = 1.0 / math.sqrt(head_dim)
    if qkv.device.type == "cpu":
        return packed_attention_reference(
            qkv, num_heads, head_dim, kv_mask=kv_mask, freqs=freqs, scale=scale,
            rope_cos=rope_cos, rope_sin=rope_sin,
        )
    if freqs is not None:
        rope_cos, rope_sin = torch.cos(freqs.float()), torch.sin(freqs.float())
    x = qkv.view(b, l, 3, num_heads, hp)
    q, k, v = (x[:, :, i, :, :head_dim].permute(0, 2, 1, 3) for i in range(3))
    out = torch.zeros((b, l, num_heads * hp), dtype=qkv.dtype, device=qkv.device)
    _launch_flash(
        "packed_vision_attention", q, k, v,
        out.view(b, l, num_heads, hp)[..., :head_dim].permute(0, 2, 1, 3),
        causal=False, kv_mask=kv_mask, kv_mask_contiguous=True, scale=scale,
        rope_cos=rope_cos, rope_sin=rope_sin,
    )
    return out


def vision_qkv_attention(
    qkv: torch.Tensor,
    num_heads: int,
    head_dim: int,
    *,
    kv_mask: torch.Tensor | None = None,
    scale: float | None = None,
    rope_cos: torch.Tensor | None = None,
    rope_sin: torch.Tensor | None = None,
) -> torch.Tensor:
    """Non-causal self-attention over a combined qkv projection output.

    ``qkv`` [N, P, 3*H*D] is the token-major output of the vision tower's qkv
    dense, role-major (q heads, then k, then v). The kernel reads q, k and v as
    strided views of it in place and writes [N, P, H*D] for the output
    projection: no transposes. ``kv_mask`` [N, P] holds one contiguous valid run
    per row (the ``[:num_patches]`` prefix); ``rope_cos``/``rope_sin`` are
    [N or 1, P, D/2] f32.
    """
    n, p, c = qkv.shape
    h, d = num_heads, head_dim
    if c != 3 * h * d:
        raise ValueError(f"qkv channels {c} != 3*{h}*{d}")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if qkv.device.type == "cpu":
        return vision_qkv_attention_plain(
            qkv, h, d, kv_mask=kv_mask, scale=scale, rope_cos=rope_cos, rope_sin=rope_sin
        )
    return _launch_combined(
        "vision_qkv_attention", qkv.view(n, p, 3 * h, d), h, h, token_major=True,
        causal=False, kv_mask=kv_mask, kv_mask_contiguous=True, scale=scale,
        rope_cos=rope_cos, rope_sin=rope_sin,
    )


def decode_split_plan(seq: int) -> tuple[int, int]:
    """(splits, keys per split) of the decode kernel's key axis for a cache of
    ``seq`` positions: one CTA per 64 positions, at most 8, keys a multiple of 16.
    A function of the cache length alone, never of the batch, so a pooled and
    an unpooled batch split alike and give the same bits."""
    splits = max(1, min(_DECODE_MAX_SPLITS, -(-seq // 64)))
    keys = -(-(-(-seq // splits)) // 16) * 16  # ceil(seq / splits), rounded up to 16
    return -(-seq // keys), keys  # rounding can leave the last split empty: drop it


def decode_needs_workspace(bf16: bool, head_dim: int, group: int, seq: int) -> bool:
    """Whether a decode launch needs the f32 score workspace [B, KVH, G, S]:
    the Hopper instances do not take it (``sm90::takes`` in
    csrc/decode_attn.cu: a bf16 query, a head dim they are built for, a group
    that fits their 8 rows, and a split plan of ``seq`` they hold, i.e.
    ``seq`` <= 2048), so the general kernel runs, and its shared memory, q and
    the output accumulator [G, D] plus the score rows [G, S] in f32, would
    exceed the card's limit."""
    splits, keys = decode_split_plan(seq)
    hopper = (bf16 and head_dim in _DECODE_HOPPER_HEAD_DIMS and group <= _DECODE_MAX_GROUP
              and splits <= _DECODE_MAX_SPLITS and keys <= _DECODE_MAX_SPLIT_KEYS)
    return not hopper and 4 * (2 * group * head_dim + group * seq) > _DECODE_MAX_SMEM


def gqa_decode_attention(
    q: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    layer_idx: int,
    kv_mask: torch.Tensor,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
    *,
    scale: float | None = None,
) -> torch.Tensor:
    """Single-token GQA attention against layer ``layer_idx`` of a stacked cache.

    Args:
        q: [B, H, D] current-token queries (consecutive query heads share a KV head).
        cache_k, cache_v: [L, B, KVH, S, D] stacked caches (contiguous on the card),
            in q's dtype or int8.
        layer_idx: the layer to attend against (a host int).
        kv_mask: [B, S], nonzero = attend.
        k_scale, v_scale: [L, B, KVH, S] f32 per-position dequant scales of an
            int8 cache (the JAX package's [L, B, KVH, 8, S] without the TPU
            sublane replication); required with an int8 cache.
    Returns: [B, H, D] in q.dtype.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    int8 = cache_k.dtype == torch.int8
    if int8 != (k_scale is not None) or (k_scale is None) != (v_scale is None):
        raise ValueError("an int8 cache takes k_scale and v_scale, a float cache neither")
    if q.device.type == "cpu":
        return gqa_decode_attention_plain(
            q, cache_k, cache_v, layer_idx, kv_mask, k_scale, v_scale, scale=scale
        )
    return _launch_decode(q, cache_k, cache_v, layer_idx, kv_mask, k_scale, v_scale, scale)
