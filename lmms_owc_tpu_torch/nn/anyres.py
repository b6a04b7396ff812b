"""AnyRes (dynamic high-resolution) image helpers of the LLaVA-NeXT /
LLaVA-OneVision families.

Counterpart of :mod:`lmms_owc_tpu.nn.anyres`. Host side (PIL): best-resolution
selection from grid pinpoints, resize + pad, tile division. Feature packing
(grid reassembly, aspect unpadding, optional downscale, newline tokens,
matching HF's llava_next / llava_onevision semantics) runs in torch on the
features' device, so the tower's output never leaves the card; numpy inputs
are taken too. The ``max_patches`` downscale is
:func:`resize_bilinear_antialiased`, the port's copy of
``jax.image.resize(method="bilinear")``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "anyres_grid_shape",
    "default_grid_pinpoints",
    "divide_to_patches",
    "pack_anyres_features",
    "resize_and_pad",
    "resize_bilinear_antialiased",
    "select_best_resolution",
    "unpad_feature",
]


def default_grid_pinpoints(tile_size: int, max_tiles: int = 6) -> list[list[int]]:
    return [
        [tile_size * i, tile_size * j]
        for i in range(1, max_tiles + 1)
        for j in range(1, max_tiles + 1)
        if i * j <= max_tiles * max_tiles
    ]


def select_best_resolution(orig_hw: tuple[int, int], pinpoints: list) -> tuple[int, int]:
    """HF select_best_resolution: maximize effective resolution, minimize waste."""
    orig_h, orig_w = orig_hw
    best_fit = None
    max_effective = 0
    min_waste = float("inf")
    for h, w in pinpoints:
        scale = min(w / orig_w, h / orig_h)
        down_w, down_h = int(orig_w * scale), int(orig_h * scale)
        effective = min(down_w * down_h, orig_w * orig_h)
        waste = (w * h) - effective
        if effective > max_effective or (effective == max_effective and waste < min_waste):
            max_effective = effective
            min_waste = waste
            best_fit = (h, w)
    return best_fit


def resize_and_pad(image, target_hw: tuple[int, int]):
    """Aspect-preserving resize then center-pad to the target resolution (PIL)."""
    from PIL import Image

    target_h, target_w = target_hw
    orig_w, orig_h = image.size
    scale_w, scale_h = target_w / orig_w, target_h / orig_h
    if scale_w < scale_h:
        new_w, new_h = target_w, min(math.ceil(orig_h * scale_w), target_h)
    else:
        new_w, new_h = min(math.ceil(orig_w * scale_h), target_w), target_h
    resized = image.resize((new_w, new_h), Image.BICUBIC)
    canvas = Image.new("RGB", (target_w, target_h), (0, 0, 0))
    canvas.paste(resized, ((target_w - new_w) // 2, (target_h - new_h) // 2))
    return canvas


def divide_to_patches(image, patch_size: int) -> list:
    """Split a padded canvas into patch_size x patch_size tiles (row-major)."""
    patches = []
    width, height = image.size
    for top in range(0, height, patch_size):
        for left in range(0, width, patch_size):
            patches.append(image.crop((left, top, left + patch_size, top + patch_size)))
    return patches


def anyres_grid_shape(orig_hw: tuple[int, int], pinpoints: list, tile_size: int) -> tuple[int, int]:
    h, w = select_best_resolution(orig_hw, pinpoints)
    return h // tile_size, w // tile_size


def unpad_feature(feature, orig_hw: tuple[int, int]):
    """Remove padding rows/cols from a [C, H, W] feature grid (HF unpad_image)."""
    orig_h, orig_w = orig_hw
    _, cur_h, cur_w = feature.shape
    original_ar = orig_w / orig_h
    current_ar = cur_w / cur_h
    if original_ar > current_ar:
        scale = cur_w / orig_w
        new_h = int(round(orig_h * scale, 7))
        pad = (cur_h - new_h) // 2
        return feature[:, pad : cur_h - pad, :]
    scale = cur_h / orig_h
    new_w = int(round(orig_w * scale, 7))
    pad = (cur_w - new_w) // 2
    return feature[:, :, pad : cur_w - pad]


def _linear_weights(in_size: int, out_size: int, device) -> torch.Tensor:
    """[in, out] weights of ``jax.image``'s ``compute_weight_mat`` for the
    triangle kernel with antialiasing (scale ``out / in``, no translation), f32."""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(in_size, dtype=torch.float32, device=device)[:, None]).abs() / kernel_scale
    weights = torch.clamp(1.0 - x, min=0.0)
    total = weights.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    weights = torch.where(total.abs() > eps, weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], weights, 0.0)


def resize_bilinear_antialiased(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """[C, H, W] -> [C, out_h, out_w] as ``jax.image.resize(method="bilinear")``
    (antialiased when shrinking: the triangle kernel widened by the scale),
    computed in f32 and returned in ``x.dtype``."""
    _, h, w = x.shape
    wh = _linear_weights(h, out_hw[0], x.device)
    ww = _linear_weights(w, out_hw[1], x.device)
    return torch.einsum("chw,hH,wW->cHW", x.float(), wh, ww).to(x.dtype)


def pack_anyres_features(
    tile_features,
    orig_hw: tuple[int, int],
    pinpoints: list,
    tile_size: int,
    patch_size: int,
    image_newline,
    max_patches: int | None = 9,
) -> torch.Tensor:
    """HF pack_image_features for one image.

    Args:
        tile_features: [num_tiles, tokens_per_tile, D] (tensor or array) —
            tile 0 is the base image.
        orig_hw: original image (H, W).
        image_newline: [D] newline embedding or None.
        max_patches: anyres_max_N downscale bound (None disables, llava-next mode).
    Returns packed [total_tokens, D] on the features' device, in their dtype.
    """
    tile_features = torch.as_tensor(tile_features)
    if image_newline is not None:
        image_newline = torch.as_tensor(image_newline).to(device=tile_features.device, dtype=tile_features.dtype)
    side = tile_size // patch_size
    if tile_features.shape[0] == 1:
        feature = tile_features[0]
        if image_newline is not None:
            feature = torch.cat([feature, image_newline[None]], dim=0)
        return feature

    base = tile_features[0]
    tiles = tile_features[1:]
    n_h, n_w = anyres_grid_shape(orig_hw, pinpoints, tile_size)
    d = tiles.shape[-1]
    grid = tiles.reshape(n_h, n_w, side, side, d)
    grid = grid.permute(4, 0, 2, 1, 3).reshape(d, n_h * side, n_w * side)
    grid = unpad_feature(grid, orig_hw)

    if max_patches is not None:
        _, cur_h, cur_w = grid.shape
        ratio = math.sqrt(cur_h * cur_w / (max_patches * side**2))
        if ratio > 1.1:
            grid = resize_bilinear_antialiased(grid, (int(cur_h // ratio), int(cur_w // ratio)))

    if image_newline is not None:
        newline_col = image_newline[:, None, None].expand(d, grid.shape[1], 1)
        grid = torch.cat([grid, newline_col], dim=-1)
    packed = grid.reshape(d, -1).T
    return torch.cat([base, packed], dim=0)
