"""Image preprocessing: smart-resize on the host, normalize + patchify in torch.

Counterpart of :mod:`lmms_owc_tpu.ops.image`, which imports JAX, so its host
helpers need a JAX-free home here. ``smart_resize`` reproduces the HF Qwen2-VL
sizing rule; ``resize_host`` runs the port's copy of the JAX package's native
C++ bicubic resizer (:mod:`lmms_owc_tpu_torch.native`) or PIL, with the same
identity fast path, so the pixels equal the JAX package's.
``patchify_images_batch`` runs the rescale, CLIP normalisation and the 9-D
patch transpose on the tensor's device.
"""

from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from lmms_owc_tpu_torch.native import native_resizer

__all__ = [
    "OPENAI_CLIP_MEAN",
    "OPENAI_CLIP_STD",
    "patchify_images_batch",
    "resize_host",
    "resize_host_batch",
    "smart_resize",
]

OPENAI_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def smart_resize(
    height: int,
    width: int,
    factor: int = 28,
    min_pixels: int = 56 * 56,
    max_pixels: int = 14 * 14 * 4 * 1280,
) -> tuple[int, int]:
    """HF-exact sizing: dims divisible by factor, pixels within [min, max]."""
    if max(height, width) / min(height, width) > 200:
        raise ValueError(
            f"absolute aspect ratio must be smaller than 200, got {max(height, width) / min(height, width)}"
        )
    h_bar = round(height / factor) * factor
    w_bar = round(width / factor) * factor
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = max(factor, math.floor(height / beta / factor) * factor)
        w_bar = max(factor, math.floor(width / beta / factor) * factor)
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = math.ceil(height * beta / factor) * factor
        w_bar = math.ceil(width * beta / factor) * factor
    return h_bar, w_bar


def patchify_images_batch(
    pixels_u8: torch.Tensor,
    patch_size: int = 14,
    temporal_patch_size: int = 2,
    merge_size: int = 2,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """uint8 [N, C, H, W] still images -> packed patches [N, grid_h*grid_w, C*t*p*p].

    Layout as the HF processor: spatial-merge windows contiguous; each still
    image is repeated ``temporal_patch_size`` times.
    """
    n, c, h, w = pixels_u8.shape
    frames = pixels_u8[:, None].expand(n, temporal_patch_size, c, h, w)
    mean = torch.tensor(OPENAI_CLIP_MEAN, dtype=torch.float32, device=pixels_u8.device)
    std = torch.tensor(OPENAI_CLIP_STD, dtype=torch.float32, device=pixels_u8.device)
    x = (frames.float() / 255.0 - mean.view(1, 1, c, 1, 1)) / std.view(1, 1, c, 1, 1)
    grid_h, grid_w = h // patch_size, w // patch_size
    x = x.reshape(
        n, temporal_patch_size, c,
        grid_h // merge_size, merge_size, patch_size,
        grid_w // merge_size, merge_size, patch_size,
    )
    x = x.permute(0, 3, 6, 4, 7, 2, 1, 5, 8)
    return x.reshape(n, grid_h * grid_w, c * temporal_patch_size * patch_size**2).to(out_dtype)


def _native_resizer():
    """The port's native resizer, or None when ``LMMS_OWC_NATIVE_LOADER=0`` or it
    cannot be built (read per call)."""
    if os.environ.get("LMMS_OWC_NATIVE_LOADER", "1") == "0":
        return None
    return native_resizer()


def resize_host(
    image,
    min_pixels: int = 4 * 28 * 28,
    max_pixels: int = 1024 * 28 * 28,
    factor: int = 28,
) -> tuple[np.ndarray, tuple[int, int]]:
    """Host-side bicubic smart-resize -> (uint8 [C, H, W], (H, W)).

    Same pixels as :func:`lmms_owc_tpu.ops.image.resize_host`: the identity
    size is a plain copy; otherwise the native resizer when it builds
    (``LMMS_OWC_NATIVE_LOADER=0`` forces PIL), else PIL bicubic.
    """
    from PIL import Image

    image = image.convert("RGB")
    width, height = image.size
    resized_h, resized_w = smart_resize(
        height, width, factor=factor, min_pixels=min_pixels, max_pixels=max_pixels
    )
    if (resized_h, resized_w) == (height, width):
        return np.asarray(image).transpose(2, 0, 1), (resized_h, resized_w)
    loader = _native_resizer()
    if loader is not None:
        return loader.resize_u8(np.asarray(image), resized_h, resized_w), (resized_h, resized_w)
    resized = image.resize((resized_w, resized_h), Image.BICUBIC)
    return np.asarray(resized).transpose(2, 0, 1), (resized_h, resized_w)


class _ResizePool:
    """Thread pool shared by :func:`resize_host_batch` calls, created on first use."""

    def __init__(self) -> None:
        self._pool: ThreadPoolExecutor | None = None

    def map(self, fn, items: list, workers: int) -> list:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=workers)
        return list(self._pool.map(fn, items))


_POOL = _ResizePool()


def resize_host_batch(
    images: list,
    min_pixels: int = 4 * 28 * 28,
    max_pixels: int = 1024 * 28 * 28,
    factor: int = 28,
) -> list:
    """Map :func:`resize_host` over a shared thread pool, preserving order.

    Both resizers release the GIL. ``LMMS_OWC_RESIZE_THREADS=1`` runs serially.
    """
    n_workers = int(os.environ.get("LMMS_OWC_RESIZE_THREADS", "0")) or min(8, os.cpu_count() or 1)
    if n_workers <= 1 or len(images) <= 1:
        return [resize_host(img, min_pixels, max_pixels, factor) for img in images]
    return _POOL.map(
        lambda img: resize_host(img, min_pixels, max_pixels, factor), images, n_workers
    )
