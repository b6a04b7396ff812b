"""Qwen2.5-VL vision tower in PyTorch (the decoder is shared with Qwen2-VL).

Counterpart of :mod:`lmms_owc_tpu.nn.qwen2_5_vl`. Differences from the
Qwen2-VL tower: RMSNorm block norms, a SiLU-gated MLP with biases, window
attention (tokens reordered into ``window_size``-pixel windows at
spatial-merge granularity; only the ``fullatt_block_indexes`` layers attend
across the whole image), and an RMSNorm patch merger projecting to
``out_hidden_size``.

Tokens are laid out as a uniformly padded ``[N, W, S]`` grid (every window the
same token count, edge windows padded; :func:`get_window_layout`). Window
layers attend over ``[N*W, S]`` and global layers over ``[N, W*S]``; both are
views of one token buffer, one qkv output per layer and one mask built per
tower call. Every layer goes through
:func:`~lmms_owc_tpu_torch.ops.attention.fused_qkv_attention` (K2's
combined-qkv entry, token-major, rope in the kernel); a padded window's mask
has gaps inside the global layers' key run, so they take K2's tensor-mask form.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from lmms_owc_tpu_torch.nn.layers import Linear, RMSNorm, gelu
from lmms_owc_tpu_torch.ops.attention import fused_qkv_attention

__all__ = [
    "Qwen25VisionConfig",
    "Vision25Block",
    "Vision25Tower",
    "get_window_layout",
    "get_window_order",
    "load_hf_vision25_weights",
    "vision25_params_from_jax",
    "vision25_rope_freqs",
]


@dataclass(frozen=True)
class Qwen25VisionConfig:
    depth: int = 32
    hidden_size: int = 1280
    num_heads: int = 16
    intermediate_size: int = 3420
    out_hidden_size: int = 2048
    in_channels: int = 3
    patch_size: int = 14
    temporal_patch_size: int = 2
    spatial_merge_size: int = 2
    window_size: int = 112
    fullatt_block_indexes: tuple = (7, 15, 23, 31)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def patch_dim(self) -> int:
        return self.in_channels * self.temporal_patch_size * self.patch_size**2

    @classmethod
    def from_hf_dict(cls, vis: dict) -> "Qwen25VisionConfig":
        return cls(
            depth=vis.get("depth", 32),
            hidden_size=vis.get("hidden_size", 1280),
            num_heads=vis.get("num_heads", 16),
            intermediate_size=vis.get("intermediate_size", 3420),
            out_hidden_size=vis.get("out_hidden_size", 2048),
            in_channels=vis.get("in_channels", vis.get("in_chans", 3)),
            patch_size=vis.get("patch_size", 14),
            temporal_patch_size=vis.get("temporal_patch_size", 2),
            spatial_merge_size=vis.get("spatial_merge_size", 2),
            window_size=vis.get("window_size", 112),
            fullatt_block_indexes=tuple(vis.get("fullatt_block_indexes", (7, 15, 23, 31))),
        )


# ------------------------------------------------------------------- host prep


def _padded_unit_grid(grid: tuple[int, int, int], config: Qwen25VisionConfig, fill: int):
    """Merge-unit indices on the window-padded grid, [t, windows, win, win]."""
    t, h, w = grid
    merge = config.spatial_merge_size
    llm_h, llm_w = h // merge, w // merge
    win = config.window_size // merge // config.patch_size
    num_h, num_w = -(-llm_h // win), -(-llm_w // win)
    padded = np.full((t, num_h * win, num_w * win), fill, np.int64)
    padded[:, :llm_h, :llm_w] = np.arange(t * llm_h * llm_w).reshape(t, llm_h, llm_w)
    padded = padded.reshape(t, num_h, win, num_w, win).transpose(0, 1, 3, 2, 4)
    return padded.reshape(t, num_h * num_w, win, win), win


def get_window_order(grid: tuple[int, int, int], config: Qwen25VisionConfig):
    """Window reorder for one image (HF ``get_window_index`` semantics).

    Returns (window_index [P/mu] merge-unit permutation, window_ids [P] per-token
    window id after reordering) where mu = spatial_merge_size^2.
    """
    mu = config.spatial_merge_size**2
    padded, _ = _padded_unit_grid(grid, config, -100)
    seqlens = (padded != -100).sum(axis=(2, 3)).reshape(-1)  # merge units per window
    flat = padded.reshape(-1)
    window_ids = np.repeat(np.arange(len(seqlens)), seqlens * mu)
    return flat[flat != -100], window_ids


def get_window_layout(grid: tuple[int, int, int], config: Qwen25VisionConfig):
    """Uniform padded window layout for one grid.

    Every window gets the same token count; edge windows carry padding slots.
    Merge units stay contiguous (mu tokens each), matching the patchify order,
    so the gather of a slot's tokens is ``slot_src * mu + arange(mu)``.

    Returns (slot_src [num_windows * win^2] source merge unit per slot, -1 =
    pad; num_windows; tokens_per_window = win^2 * merge^2).
    """
    padded, win = _padded_unit_grid(grid, config, -1)
    return padded.reshape(-1), padded.shape[0] * padded.shape[1], win * win * config.spatial_merge_size**2


def vision25_rope_freqs(grid: tuple[int, int, int], config: Qwen25VisionConfig) -> np.ndarray:
    """2D rotary table per packed patch [P, head_dim/2] (pre-reorder order)."""
    from lmms_owc_tpu_torch.nn.qwen2_vl import Qwen2VLVisionConfig, vision_rope_cos_sin

    proxy = Qwen2VLVisionConfig(
        embed_dim=config.hidden_size,
        num_heads=config.num_heads,
        patch_size=config.patch_size,
        temporal_patch_size=config.temporal_patch_size,
        spatial_merge_size=config.spatial_merge_size,
    )
    return vision_rope_cos_sin([grid], proxy)


# -------------------------------------------------------------------- modules


class Vision25Block(nn.Module):
    def __init__(self, v: Qwen25VisionConfig, dtype, device) -> None:
        super().__init__()
        e, inter = v.hidden_size, v.intermediate_size
        self.norm1 = RMSNorm(e, 1e-6, dtype, device)
        self.qkv = Linear(e, 3 * e, True, dtype, device)
        self.proj = Linear(e, e, True, dtype, device)
        self.norm2 = RMSNorm(e, 1e-6, dtype, device)
        self.mlp_gate = Linear(e, inter, True, dtype, device)
        self.mlp_up = Linear(e, inter, True, dtype, device)
        self.mlp_down = Linear(inter, e, True, dtype, device)


class Vision25Merger(nn.Module):
    def __init__(self, v: Qwen25VisionConfig, dtype, device) -> None:
        super().__init__()
        merged = v.hidden_size * v.spatial_merge_size**2
        self.ln_q = RMSNorm(v.hidden_size, 1e-6, dtype, device)
        self.fc1 = Linear(merged, merged, True, dtype, device)
        self.fc2 = Linear(merged, v.out_hidden_size, True, dtype, device)


_HF_BLOCK_ROLES = {
    "norm1": "norm1", "norm2": "norm2", "qkv": "attn.qkv", "proj": "attn.proj",
    "mlp_gate": "mlp.gate_proj", "mlp_up": "mlp.up_proj", "mlp_down": "mlp.down_proj",
}


class Vision25Tower(nn.Module):
    """Qwen2.5-VL ViT with window attention, plus the RMSNorm patch merger."""

    def __init__(self, v: Qwen25VisionConfig, dtype, device) -> None:
        super().__init__()
        self.config = v
        self.patch_embed = Linear(v.patch_dim, v.hidden_size, False, dtype, device)
        self.blocks = nn.ModuleList(Vision25Block(v, dtype, device) for _ in range(v.depth))
        self.merger = Vision25Merger(v, dtype, device)

    def hf_tensor(self, state, name: str) -> torch.Tensor:
        """The checkpoint tensor of parameter ``name`` (``convert_hf_vision25_weights``'s names)."""
        from lmms_owc_tpu_torch.nn.qwen2_vl import hf_vision_tensor

        return hf_vision_tensor(state, name, _HF_BLOCK_ROLES)

    @torch.inference_mode()
    def forward(
        self,
        patches: torch.Tensor,
        rope_freqs: torch.Tensor,
        valid_mask: torch.Tensor | None,
    ) -> torch.Tensor:
        """Tower over a batch of same-grid images in window layout (``vision25_encode``).

        Args:
            patches: [N, W, S, patch_dim]: N images, W windows, S tokens per
                window (:func:`get_window_layout`; padding slots zero).
            rope_freqs: [N, W, S, head_dim/2] (same layout, zero at padding).
            valid_mask: [N, W, S] 1 = real patch, or None when every slot is real.
        Returns: [N, W*S/merge^2, out_hidden_size] merged embeddings in slot
            order (padding units garbage; the caller drops them).
        """
        v = self.config
        n, wn, s, _ = patches.shape
        tn = n * wn * s
        nh, hd = v.num_heads, v.head_dim
        x = self.patch_embed(patches.to(self.patch_embed.weight.dtype).reshape(tn, -1))
        freqs = rope_freqs.float().reshape(tn, -1)
        cos, sin = torch.cos(freqs), torch.sin(freqs)
        mask = None if valid_mask is None else valid_mask.reshape(tn).to(torch.int32)
        full = set(v.fullatt_block_indexes)
        for i, blk in enumerate(self.blocks):
            b, l = (n, wn * s) if i in full else (n * wn, s)
            # The kernel reads q/k/v in place from the token-major qkv output
            # and writes the [b, l, nh*hd] layout proj takes; rope rides its
            # q/k tile loads.
            attn = fused_qkv_attention(
                blk.qkv(blk.norm1(x)).view(b, l, 3 * nh, hd), nh, nh,
                kv_mask=None if mask is None else mask.view(b, l),
                rope_cos=cos.view(b, l, -1), rope_sin=sin.view(b, l, -1), token_major=True,
            )
            x = x + blk.proj(attn.view(tn, nh * hd))
            h = blk.norm2(x)
            x = x + blk.mlp_down(torch.nn.functional.silu(blk.mlp_gate(h)) * blk.mlp_up(h))
        merged_dim = v.hidden_size * v.spatial_merge_size**2
        x = self.merger.ln_q(x).reshape(-1, merged_dim)
        x = self.merger.fc2(gelu(self.merger.fc1(x)))
        return x.reshape(n, (wn * s) // v.spatial_merge_size**2, -1)


# -------------------------------------------------------------------- weights


@torch.no_grad()
def vision25_params_from_jax(tower: Vision25Tower, tree: dict) -> Vision25Tower:
    """Load the JAX ``vision`` subtree (``init_vision25_params`` /
    ``convert_hf_vision25_weights`` layout, float or quantized leaves) in place,
    by the layout rule of :func:`lmms_owc_tpu_torch.nn.qwen2_vl.params_from_jax`."""
    from lmms_owc_tpu_torch.nn.qwen2_vl import _load_linear, _load_norm

    if "mlp_gate" not in tree["layers"]:
        raise ValueError("not a Qwen2.5-VL vision tree (no mlp_gate leaves)")
    _load_linear(tower, "patch_embed", tree["patch_embed"])
    layers = tree["layers"]
    for i, blk in enumerate(tower.blocks):
        _load_norm(blk.norm1, layers["norm1"], i)
        _load_norm(blk.norm2, layers["norm2"], i)
        for role in ("qkv", "proj", "mlp_gate", "mlp_up", "mlp_down"):
            _load_linear(blk, role, layers[role], i)
    _load_norm(tower.merger.ln_q, tree["merger"]["ln_q"])
    _load_linear(tower.merger, "fc1", tree["merger"]["fc1"])
    _load_linear(tower.merger, "fc2", tree["merger"]["fc2"])
    return tower


def load_hf_vision25_weights(tower: Vision25Tower, state) -> Vision25Tower:
    """Fill the tower from an HF Qwen2.5-VL checkpoint's tensors (counterpart of
    ``convert_hf_vision25_weights``), cast to the tower's dtype, in place. The
    port's ``[out, in]`` layout is the checkpoint's, so nothing is transposed."""
    from lmms_owc_tpu_torch.nn.loader import load_hf_tensors

    return load_hf_tensors(tower, state)
