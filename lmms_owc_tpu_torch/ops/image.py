"""Image preprocessing: smart-resize on the host, normalize + patchify in torch.

Counterpart of :mod:`lmms_owc_tpu.ops.image`, which imports JAX, so its host
helpers need a JAX-free home here. ``smart_resize`` reproduces the HF Qwen2-VL
sizing rule; ``resize_host`` runs the port's copy of the JAX package's native
C++ bicubic resizer (:mod:`lmms_owc_tpu_torch.native`) or PIL, with the same
identity fast path, so the pixels equal the JAX package's.
``patchify_images_batch`` runs the rescale, CLIP normalisation and the 9-D
patch transpose on the tensor's device. :class:`ClipImageProcessor` is
``transformers``' ``CLIPImageProcessor`` (the one the JAX package's CLIP
scorer gets from ``AutoProcessor``), step for step on the host with PIL and
numpy.
"""

from __future__ import annotations

import json
import math
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from lmms_owc_tpu_torch.native import native_resizer

__all__ = [
    "ClipImageProcessor",
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


def _size_pair(size, default: int) -> tuple[int, int]:
    """(height, width) of an HF ``size``/``crop_size`` setting: an int or a dict."""
    if size is None:
        return default, default
    if isinstance(size, int):
        return size, size
    return int(size["height"]), int(size["width"])


class ClipImageProcessor:
    """``CLIPImageProcessor``: RGB, a PIL resize of the shortest edge to
    ``shortest_edge`` (the other edge ``int(shortest_edge * long / short)``,
    HF's truncation) or to a fixed ``(height, width)``, a centre crop (zero
    padding where the image is smaller), rescale in f64 then f32, and the
    per-channel normalisation in f32. Returns f32 [N, 3, H, W]."""

    def __init__(
        self,
        shortest_edge: int | None = 224,
        size_hw: tuple[int, int] | None = None,
        crop_hw: tuple[int, int] = (224, 224),
        do_resize: bool = True,
        do_center_crop: bool = True,
        do_rescale: bool = True,
        rescale_factor: float = 1 / 255,
        do_normalize: bool = True,
        image_mean=OPENAI_CLIP_MEAN,
        image_std=OPENAI_CLIP_STD,
        resample: int = 3,
        do_convert_rgb: bool = True,
    ) -> None:
        self.shortest_edge, self.size_hw, self.crop_hw = shortest_edge, size_hw, crop_hw
        self.do_resize, self.do_center_crop = do_resize, do_center_crop
        self.do_rescale, self.rescale_factor = do_rescale, rescale_factor
        self.do_normalize, self.do_convert_rgb = do_normalize, do_convert_rgb
        self.image_mean, self.image_std = tuple(image_mean), tuple(image_std)
        self.resample = int(resample)

    @classmethod
    def from_pretrained(cls, path: str | Path) -> "ClipImageProcessor":
        """Read ``preprocessor_config.json`` (HF's defaults for what it leaves out)."""
        cfg = json.loads((Path(path) / "preprocessor_config.json").read_text())
        size = cfg.get("size", {"shortest_edge": 224})
        shortest = size if isinstance(size, int) else size.get("shortest_edge")
        return cls(
            shortest_edge=shortest,
            size_hw=None if shortest is not None else _size_pair(size, 224),
            crop_hw=_size_pair(cfg.get("crop_size"), 224),
            do_resize=cfg.get("do_resize", True),
            do_center_crop=cfg.get("do_center_crop", True),
            do_rescale=cfg.get("do_rescale", True),
            rescale_factor=cfg.get("rescale_factor", 1 / 255),
            do_normalize=cfg.get("do_normalize", True),
            image_mean=cfg.get("image_mean", OPENAI_CLIP_MEAN),
            image_std=cfg.get("image_std", OPENAI_CLIP_STD),
            resample=cfg.get("resample", 3),
            do_convert_rgb=cfg.get("do_convert_rgb", True),
        )

    def _output_size(self, height: int, width: int) -> tuple[int, int]:
        if self.shortest_edge is None:
            return self.size_hw
        short, long = (width, height) if width <= height else (height, width)
        new_short, new_long = self.shortest_edge, int(self.shortest_edge * long / short)
        return (new_long, new_short) if width <= height else (new_short, new_long)

    def _center_crop(self, arr: np.ndarray) -> np.ndarray:
        """HF ``center_crop`` of [H, W, C]: a zero-padded canvas where the crop
        is larger than the image."""
        crop_h, crop_w = self.crop_hw
        h, w = arr.shape[:2]
        top, left = (h - crop_h) // 2, (w - crop_w) // 2
        if top >= 0 and left >= 0 and top + crop_h <= h and left + crop_w <= w:
            return arr[top : top + crop_h, left : left + crop_w]
        new_h, new_w = max(crop_h, h), max(crop_w, w)
        canvas = np.zeros((new_h, new_w, arr.shape[2]), arr.dtype)
        top_pad, left_pad = math.ceil((new_h - h) / 2), math.ceil((new_w - w) / 2)
        canvas[top_pad : top_pad + h, left_pad : left_pad + w] = arr
        top, left = top + top_pad, left + left_pad
        return canvas[max(0, top) : min(new_h, top + crop_h), max(0, left) : min(new_w, left + crop_w)]

    def preprocess_one(self, image) -> np.ndarray:
        if self.do_convert_rgb:
            image = image.convert("RGB")
        if self.do_resize:
            height, width = self._output_size(image.height, image.width)
            image = image.resize((width, height), resample=self.resample, reducing_gap=None)
        arr = np.asarray(image)
        if self.do_center_crop:
            arr = self._center_crop(arr)
        if self.do_rescale:
            arr = (arr.astype(np.float64) * self.rescale_factor).astype(np.float32)
        if self.do_normalize:
            arr = arr.astype(np.float32)
            arr = (arr - np.asarray(self.image_mean, np.float32)) / np.asarray(self.image_std, np.float32)
        return np.ascontiguousarray(arr.transpose(2, 0, 1), dtype=np.float32)

    def __call__(self, images: list) -> np.ndarray:
        return np.stack([self.preprocess_one(image) for image in images])
