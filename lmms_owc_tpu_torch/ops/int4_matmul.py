"""Matmul against a packed int4 groupwise weight: the K4 kernel and its plain version.

Counterpart of :mod:`lmms_owc_tpu.ops.int4_matmul` (the Pallas ``_kernel``).
``x [..., K] @ dequant(q4, scale)`` with the weight in the port's layout:
``q4`` int8 [N, K/2] in the halves layout (byte ``j`` of row ``n`` holds input
column ``j`` in its low nibble and column ``j + K/2`` in its high nibble) and
``scale`` f32 [N, K/group]. As the TPU kernel, each nibble is sign-extended,
multiplied by its group scale in f32 and rounded to bf16; ``x`` is rounded to
bf16; the product accumulates in f32 and is cast to ``x.dtype``.

:func:`int4_matmul` launches ``csrc/int4_matmul.cu`` for a CUDA tensor (or
raises) and takes :func:`int4_matmul_plain` for a CPU tensor. Every launch adds
one to ``launch_counts["int4_matmul"]``. The kernel splits K by
:func:`int4_split_plan`, a function of (K, N) only, and adds the splits'
partials in split order, so a row's bits never depend on the rows beside it.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from lmms_owc_tpu_torch.ops import _build

__all__ = [
    "int4_matmul",
    "int4_matmul_plain",
    "int4_matmul_supported",
    "int4_split_plan",
    "launch_counts",
    "pick_blocks",
    "reset_launch_counts",
]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# The split-K plan: H100 SXM's SM count (the plan aims at two waves of CTAs),
# and the unit a split is cut in: 128 packed bytes hold one 128-column scale
# group of each half of the input and a whole number of the kernel's k steps.
_SMS = 132
_SPLIT_UNIT = 128

launch_counts: dict[str, int] = {"int4_matmul": 0}


def reset_launch_counts() -> None:
    launch_counts["int4_matmul"] = 0


def pick_blocks(k: int, n: int, groups: int) -> tuple[int, int] | None:
    """The TPU kernel's (block_k, block_n) for these dims, or None: the shape
    contract the JAX ``dense`` dispatch applies (``ops/int4_matmul.py:46``)."""
    if k % 2:
        return None
    k2 = k // 2
    group = k // groups if groups else 0
    if group <= 0 or k2 % group:
        return None
    block_k = next((b for b in (512, 384, 256, 128) if k2 % b == 0 and b % group == 0), None)
    block_n = next((b for b in (1024, 512, 256, 128) if n % b == 0), None)
    if block_k is None or block_n is None:
        return None
    return block_k, block_n


class Int4SplitPlan(NamedTuple):
    """The kernel's split-K plan (its fields go to ``Int4MatmulArgs`` in order)."""

    splits: int  # CTAs along K per output tile
    split_bytes: int  # packed bytes (input column pairs) each split walks
    block_n: int  # output columns per CTA: 64, or 32 where 64 leaves the card under one wave


def int4_split_plan(k: int, n: int) -> Int4SplitPlan:
    """How the kernel cuts the product: ``n // block_n`` column tiles, each
    split over K into ``splits`` CTAs that walk ``split_bytes`` packed bytes
    (whole 128-byte units; the last split may be shorter), so that tiles x
    splits makes about two waves of the card's SMs. A function of (K, N)
    alone, never of the row count: a row's sum runs in the same order, and
    gives the same bits, whether it comes alone or with 95 others."""
    units = max(1, (k // 2) // _SPLIT_UNIT)
    block_n = 64 if (n // 64) * units >= _SMS else 32
    tiles = n // block_n
    splits = max(1, min(units, -(-2 * _SMS // tiles)))
    split_bytes = -(-units // splits) * _SPLIT_UNIT
    return Int4SplitPlan(-(-(k // 2) // split_bytes), split_bytes, block_n)  # no empty split


def int4_matmul_supported(k: int, n: int, groups: int) -> bool:
    """Whether K4 takes these dims (the JAX contract: K/2 and N in 128-blocks,
    groups that tile K/2). The CUDA kernel covers every shape this admits."""
    return pick_blocks(k, n, groups) is not None


def int4_matmul_plain(x: torch.Tensor, q4: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`int4_matmul`: bf16 operands, f32 accumulation."""
    from lmms_owc_tpu_torch.ops.quant import unpack_int4

    n, k2 = q4.shape
    n_groups = scale.shape[-1]
    w = unpack_int4({"q4": q4, "scale": scale}).float().reshape(n, n_groups, 2 * k2 // n_groups)
    w = (w * scale[..., None]).reshape(n, 2 * k2).to(torch.bfloat16)
    x2 = x.reshape(-1, 2 * k2).to(torch.bfloat16)
    if x.is_cuda:
        out = torch.mm(x2, w.t(), out_dtype=torch.float32)
    else:
        out = torch.matmul(x2.float(), w.float().t())
    return out.to(x.dtype).reshape(*x.shape[:-1], n)


def int4_matmul(x: torch.Tensor, q4: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``x [..., K] @ dequant(q4 [N, K/2], scale [N, G])`` -> [..., N] in ``x.dtype``.

    On the card the shape must satisfy :func:`int4_matmul_supported`; the
    kernel takes any row count (``dense_q4`` sends it at most 256).
    """
    if x.device.type == "cpu":
        return int4_matmul_plain(x, q4, scale)
    _build.load_library()  # raises first when the kernels cannot be built
    n, k2 = q4.shape
    k = 2 * k2
    groups = scale.shape[-1]
    if x.shape[-1] != k or scale.shape != (n, groups):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, q4 {tuple(q4.shape)}, scale {tuple(scale.shape)}")
    if not int4_matmul_supported(k, n, groups):
        raise ValueError(f"int4_matmul: unsupported dims K={k} N={n} groups={groups}")
    if x.dtype not in _DTYPE_CODES or q4.dtype != torch.int8 or scale.dtype != torch.float32:
        raise ValueError(f"dtypes: x {x.dtype} (bf16/f32), q4 {q4.dtype} (int8), scale {scale.dtype} (f32)")
    for name, t in (("q4", q4), ("scale", scale)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous tensor on {x.device}")
    x2 = x.reshape(-1, k).contiguous()
    if x2.data_ptr() % 16 or q4.data_ptr() % 16:
        raise ValueError("x and q4 must start 16-byte aligned")
    return _launch_int4(x2, q4, scale).reshape(*x.shape[:-1], n)


def _stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _launch_int4(x2: torch.Tensor, q4: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on checked operands, x2 [M, K], with the split plan of
    (K, N) and, for more than one split, an f32 workspace [splits, M, N] that
    the kernel's second launch adds up in split order; count the launch."""
    lib = _build.load_library()
    m, k = x2.shape
    n = q4.shape[0]
    out = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
    plan = int4_split_plan(k, n)
    workspace = None
    if plan.splits > 1:
        workspace = torch.empty((plan.splits, m, n), dtype=torch.float32, device=x2.device)
    args = _build.Int4MatmulArgs(
        x2.data_ptr(), q4.data_ptr(), scale.data_ptr(), out.data_ptr(),
        workspace.data_ptr() if workspace is not None else None,
        m, n, k, scale.shape[-1], _DTYPE_CODES[x2.dtype], *plan,
    )
    code = lib.owc_int4_matmul(ctypes.byref(args), _stream_handle(x2.device))
    if code != 0:
        raise RuntimeError(f"int4_matmul: CUDA kernel launch failed with cudaError {code}")
    launch_counts["int4_matmul"] += 1
    return out
