"""Qwen2-VL in PyTorch: vision tower, M-RoPE decoder prefill and KV-cache decode.

Counterpart of :mod:`lmms_owc_tpu.nn.qwen2_vl` (token-major vision tower, or
the packed one under ``LMMS_OWC_VISION_PACKED``; bf16/f32 weights or their
int8/int4 forms from :mod:`lmms_owc_tpu_torch.ops.quant`; unpooled and pooled
decode; bf16/f32 or int8 KV cache). A Qwen2.5-VL model shares the decoder and
carries the tower of :mod:`lmms_owc_tpu_torch.nn.qwen2_5_vl`. The JAX package
stacks decoder layers on a leading axis for ``lax.scan``; here each layer is
its own module in a ``ModuleList`` and the loops are Python loops. Attention
goes through :mod:`lmms_owc_tpu_torch.ops.attention`: the vision tower through
``vision_qkv_attention`` (port of K1) or ``packed_vision_attention`` (K5), the
prefill through ``flash_attention`` (K2), each decode step through
``gqa_decode_attention`` (K3).

Prompts are left-padded to shape buckets so decode writes the KV cache at one
position for the whole batch. The KV cache is one stacked ``[L, B, KVH, S, D]``
tensor per role, updated in place; an int8 cache (``LMMS_OWC_KV_INT8``) adds
one ``[L, B, KVH, S]`` f32 scale tensor per role.
"""

from __future__ import annotations

import os
import threading
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from itertools import chain

import numpy as np
import torch
from torch import nn

from lmms_owc_tpu_torch._device import capture_lock
from lmms_owc_tpu_torch.nn import layers as _layers
from lmms_owc_tpu_torch.nn.layers import (
    Int4Linear,
    Int8Linear,
    LayerNorm,
    Linear,
    RMSNorm,
    apply_rope,
    embedding,
    gelu,
    quick_gelu,
    row_invariant,
)
from lmms_owc_tpu_torch.nn.loader import find_tensor, load_hf_tensors
from lmms_owc_tpu_torch.nn.qwen2_5_vl import (
    Qwen25VisionConfig,
    Vision25Tower,
    vision25_params_from_jax,
)
from lmms_owc_tpu_torch.ops.attention import (
    flash_attention,
    gqa_decode_attention,
    packed_vision_attention,
    vision_qkv_attention,
)
from lmms_owc_tpu_torch.ops.quant import materialize_on_device
from lmms_owc_tpu_torch.utils import _hostprof
from lmms_owc_tpu_torch.utils._hostprof import hostprof

__all__ = [
    "Qwen2VLConfig",
    "Qwen2VLModel",
    "Qwen2VLVisionConfig",
    "StepGraphs",
    "VisionTower",
    "decode_pool",
    "decode_step",
    "embed_tokens",
    "get_rope_index",
    "greedy_generate",
    "init_params",
    "kv_cache_int8_enabled",
    "kv_int8_cache",
    "load_hf_weights",
    "mrope_cos_sin",
    "params_from_jax",
    "prefill",
    "prefill_logits",
    "quantize_kv_cache",
    "rope_inv_freq",
    "score_continuation",
    "vision_rope_cos_sin",
    "write_pool",
    "write_pool_rows",
]


@dataclass(frozen=True)
class Qwen2VLVisionConfig:
    depth: int = 32
    embed_dim: int = 1280
    num_heads: int = 16
    mlp_ratio: float = 4.0
    in_channels: int = 3
    patch_size: int = 14
    temporal_patch_size: int = 2
    spatial_merge_size: int = 2
    hidden_act: str = "quick_gelu"

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def patch_dim(self) -> int:
        return self.in_channels * self.temporal_patch_size * self.patch_size**2

    @property
    def mlp_hidden(self) -> int:
        return int(self.embed_dim * self.mlp_ratio)


@dataclass(frozen=True)
class Qwen2VLConfig:
    vocab_size: int = 151936
    hidden_size: int = 1536
    num_layers: int = 28
    num_heads: int = 12
    num_kv_heads: int = 2
    intermediate_size: int = 8960
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1000000.0
    max_position_embeddings: int = 32768
    tie_word_embeddings: bool = True
    mrope_section: tuple = (16, 24, 24)
    image_token_id: int = 151655
    video_token_id: int = 151656
    vision_start_token_id: int = 151652
    eos_token_id: int = 151645
    pad_token_id: int = 151643
    # Llama3-style RoPE frequency scaling: (factor, low_freq_factor, high_freq_factor,
    # original_max_position_embeddings), or None for plain RoPE.
    rope_llama3: tuple | None = None
    # Phi-3 longrope scaling: (attention_factor, per-dim rescale factors tuple).
    rope_longrope: tuple | None = None
    vision: Qwen2VLVisionConfig = field(default_factory=Qwen2VLVisionConfig)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @classmethod
    def from_hf_dict(cls, cfg: dict) -> "Qwen2VLConfig":
        """Build from an HF config.json dict (qwen2_vl)."""
        text = cfg.get("text_config", cfg)
        vis = cfg.get("vision_config", {})
        vision = Qwen2VLVisionConfig(
            depth=vis.get("depth", 32),
            embed_dim=vis.get("embed_dim", vis.get("hidden_size", 1280)),
            num_heads=vis.get("num_heads", 16),
            mlp_ratio=vis.get("mlp_ratio", 4.0),
            in_channels=vis.get("in_channels", vis.get("in_chans", 3)),
            patch_size=vis.get("patch_size", 14),
            temporal_patch_size=vis.get("temporal_patch_size", 2),
            spatial_merge_size=vis.get("spatial_merge_size", 2),
            hidden_act=vis.get("hidden_act", "quick_gelu"),
        )
        rope_scaling = text.get("rope_scaling") or {}
        eos = text.get("eos_token_id", 151645)
        return cls(
            vocab_size=text["vocab_size"],
            hidden_size=text["hidden_size"],
            num_layers=text["num_hidden_layers"],
            num_heads=text["num_attention_heads"],
            num_kv_heads=text.get("num_key_value_heads", text["num_attention_heads"]),
            intermediate_size=text["intermediate_size"],
            rms_norm_eps=text.get("rms_norm_eps", 1e-6),
            rope_theta=text.get("rope_theta", 1000000.0),
            max_position_embeddings=text.get("max_position_embeddings", 32768),
            tie_word_embeddings=cfg.get("tie_word_embeddings", text.get("tie_word_embeddings", False)),
            mrope_section=tuple(rope_scaling.get("mrope_section", (16, 24, 24))),
            image_token_id=cfg.get("image_token_id", 151655),
            video_token_id=cfg.get("video_token_id", 151656),
            vision_start_token_id=cfg.get("vision_start_token_id", 151652),
            eos_token_id=eos[0] if isinstance(eos, list) else eos,
            pad_token_id=cfg.get("pad_token_id", 151643) or 151643,
            vision=vision,
        )


_VISION_ACTS = {"quick_gelu": quick_gelu, "gelu": gelu, "silu": torch.nn.functional.silu}
_PACKED_HEAD_WIDTH = 128  # K5's padded head width (the TPU lane width)


def _vision_packed_enabled(qkv: nn.Module, device: torch.device) -> bool:
    """Packed-qkv vision attention gate (``LMMS_OWC_VISION_PACKED``), read on every call.

    ``force`` enables it anywhere (CPU parity tests), ``1`` on CUDA; an int4
    qkv projection never packs (its nibble layout does not re-pad), nor does
    a tensor-parallel tower (its proj is row-parallel). Off by
    default, as in the JAX package: padding head_dim 80 to 128 widens the qkv
    product by 60% and the output projection's contraction likewise.
    """
    mode = os.environ.get("LMMS_OWC_VISION_PACKED", "")
    if isinstance(qkv, Int4Linear) or getattr(qkv, "tp_sharded", False):
        return False
    if mode == "force":
        return True
    return mode == "1" and torch.device(device).type == "cuda"


def _pad_heads(t: torch.Tensor, dim: int, hd: int, hp: int, fill: float = 0) -> torch.Tensor:
    """Pad every run of ``hd`` entries along ``dim`` to ``hp`` entries with ``fill``."""
    a = t.unflatten(dim, (t.shape[dim] // hd, hd))
    pad_shape = list(a.shape)
    pad_shape[dim + 1] = hp - hd
    return torch.cat([a, a.new_full(pad_shape, fill)], dim=dim + 1).flatten(dim, dim + 1)


def _pad_linear(lin: nn.Module, dim: int, hd: int, hp: int) -> nn.Module:
    """Copy of a ``Linear``/``Int8Linear`` whose runs of ``hd`` output (``dim``
    0) or input (``dim`` 1) channels are zero-padded to ``hp``; an int8 scale
    of a padded output is one, as the JAX package pads it."""
    int8 = isinstance(lin, Int8Linear)
    w = _pad_heads(lin.q if int8 else lin.weight, dim, hd, hp)
    has_bias = lin.bias is not None
    dtype = (lin.bias.dtype if has_bias else torch.float32) if int8 else w.dtype
    new = type(lin)(w.shape[1], w.shape[0], has_bias, dtype, w.device)
    if int8:
        new.q.copy_(w)
        new.scale.copy_(_pad_heads(lin.scale, 0, hd, hp, 1.0) if dim == 0 else lin.scale)
    else:
        new.weight.copy_(w)
    if has_bias:
        new.bias.copy_(_pad_heads(lin.bias, 0, hd, hp) if dim == 0 else lin.bias)
    return new


def _pad_vision_attn_params(blocks, hd: int, hp: int) -> list[tuple[nn.Module, nn.Module]]:
    """Per block, the packed kernel's (qkv, proj): each head's qkv output
    columns padded hd -> hp with zeros, and the output projection's input
    columns to match. Padding columns come out of the attention as exact zeros
    and meet zero weights in proj, so the math is unchanged."""
    return [(_pad_linear(blk.qkv, 0, hd, hp), _pad_linear(blk.proj, 1, hd, hp)) for blk in blocks]


# ======================================================================== modules


class VisionBlock(nn.Module):
    def __init__(self, v: Qwen2VLVisionConfig, dtype, device) -> None:
        super().__init__()
        e = v.embed_dim
        self.norm1 = LayerNorm(e, 1e-6, dtype, device)
        self.qkv = Linear(e, 3 * e, True, dtype, device)
        self.proj = Linear(e, e, True, dtype, device)
        self.norm2 = LayerNorm(e, 1e-6, dtype, device)
        self.fc1 = Linear(e, v.mlp_hidden, True, dtype, device)
        self.fc2 = Linear(v.mlp_hidden, e, True, dtype, device)


class PatchMerger(nn.Module):
    def __init__(self, v: Qwen2VLVisionConfig, hidden_size: int, dtype, device) -> None:
        super().__init__()
        merge_dim = v.embed_dim * v.spatial_merge_size**2
        self.ln_q = LayerNorm(v.embed_dim, 1e-6, dtype, device)
        self.fc1 = Linear(merge_dim, merge_dim, True, dtype, device)
        self.fc2 = Linear(merge_dim, hidden_size, True, dtype, device)


HF_DECODER_PREFIXES = (
    "", "model.", "model.language_model.", "language_model.", "language_model.model.", "model.text_model.",
)
HF_VISION_PREFIXES = ("visual.", "model.visual.")
_HF_DECODER_ROLES = {
    "input_ln": "input_layernorm", "post_ln": "post_attention_layernorm",
    "q": "self_attn.q_proj", "k": "self_attn.k_proj", "v": "self_attn.v_proj", "o": "self_attn.o_proj",
    "gate": "mlp.gate_proj", "up": "mlp.up_proj", "down": "mlp.down_proj",
}
_HF_BLOCK_ROLES = {
    "norm1": "norm1", "norm2": "norm2", "qkv": "attn.qkv", "proj": "attn.proj", "fc1": "mlp.fc1", "fc2": "mlp.fc2",
}
_HF_MERGER_ROLES = {"ln_q": "ln_q", "fc1": "mlp.0", "fc2": "mlp.2"}


def hf_vision_tensor(state, name: str, block_roles: dict[str, str]) -> torch.Tensor:
    """The checkpoint tensor (``visual.`` or ``model.visual.`` names) of a
    tower's parameter ``name``, either tower: ``block_roles`` maps a block's
    module names to the checkpoint's. The Conv3d patch kernel ``[embed, 3, t,
    p, p]`` comes flattened to ``[embed, 3*t*p*p]``, the port's layout."""
    parts = name.split(".")
    if parts[0] == "patch_embed":
        w = find_tensor(state, "patch_embed.proj.weight", HF_VISION_PREFIXES)
        return w.reshape(w.shape[0], -1)
    if parts[0] == "blocks":
        hf = f"blocks.{parts[1]}.{block_roles[parts[2]]}.{parts[3]}"
    else:
        hf = f"merger.{_HF_MERGER_ROLES[parts[1]]}.{parts[2]}"
    return find_tensor(state, hf, HF_VISION_PREFIXES)


class VisionTower(nn.Module):
    """Token-major Qwen2-VL ViT plus the patch merger."""

    def __init__(self, v: Qwen2VLVisionConfig, hidden_size: int, dtype, device) -> None:
        super().__init__()
        self.config = v
        self.patch_embed = Linear(v.patch_dim, v.embed_dim, False, dtype, device)
        self.blocks = nn.ModuleList(VisionBlock(v, dtype, device) for _ in range(v.depth))
        self.merger = PatchMerger(v, hidden_size, dtype, device)
        self.heads = v.num_heads  # this rank's attention heads (fewer under tensor parallelism)
        self._packed: tuple[tuple, list] | None = None  # (source key, padded (qkv, proj) per block)

    def hf_tensor(self, state, name: str) -> torch.Tensor:
        """The checkpoint tensor of parameter ``name`` (``convert_hf_weights``'s names)."""
        return hf_vision_tensor(state, name, _HF_BLOCK_ROLES)

    def _packed_attn_layers(self) -> list[tuple[nn.Module, nn.Module]]:
        """The padded attention weights of the packed path, built once per set
        of weights (about 0.7 GB at the 7B tower) and rebuilt when a qkv or
        proj tensor is replaced or written in place."""
        key = tuple(
            (t.data_ptr(), t.dtype, t._version)
            for blk in self.blocks for lin in (blk.qkv, blk.proj)
            for t in chain(lin.parameters(), lin.buffers())
        )
        if self._packed is None or self._packed[0] != key:
            self._packed = None  # drop the old copies before building new ones
            v = self.config
            self._packed = (key, _pad_vision_attn_params(self.blocks, v.head_dim, _PACKED_HEAD_WIDTH))
        return self._packed[1]

    @torch.inference_mode()
    def forward(
        self,
        patches: torch.Tensor,
        rope_freqs: torch.Tensor,
        patch_mask: torch.Tensor | None,
    ) -> torch.Tensor:
        """Vision tower over a batch of images' packed (padded) patches.

        Counterpart of the token-major branch of ``vision_encode_batch``: images
        never attend across each other, so independently padded rows are exact.

        Args:
            patches: [N, P, patch_dim] flattened conv patches (P padded to a bucket).
            rope_freqs: [N, P, head_dim/2] from :func:`vision_rope_cos_sin`.
            patch_mask: [N, P] 1 = real patch (a prefix run), or None when all are real.
        Returns: [N, P/merge^2, hidden_size] merged embeddings (padding rows garbage).
        """
        v = self.config
        act = _VISION_ACTS[v.hidden_act]
        x = self.patch_embed(patches.to(self.patch_embed.weight.dtype))
        n = x.shape[0]
        freqs = rope_freqs.float()
        cos, sin = torch.cos(freqs), torch.sin(freqs)
        packed = _vision_packed_enabled(self.blocks[0].qkv, x.device)
        if packed:
            # Packed path (K5): the qkv product writes each head padded to 128
            # columns, the kernel reads them in place and writes the padded
            # layout that the row-padded proj consumes.
            attn_layers = self._packed_attn_layers()
        else:
            attn_layers = [(blk.qkv, blk.proj) for blk in self.blocks]
        attend = packed_vision_attention if packed else vision_qkv_attention
        for blk, (qkv, proj) in zip(self.blocks, attn_layers):
            # The kernel reads q/k/v in place from the qkv output and writes the
            # layout proj consumes; rope rides its q/k tile loads.
            attn = attend(
                qkv(blk.norm1(x)), self.heads, v.head_dim,
                kv_mask=patch_mask, rope_cos=cos, rope_sin=sin,
            )
            x = x + proj(attn)
            x = x + blk.fc2(act(blk.fc1(blk.norm2(x))))
        merged_dim = v.embed_dim * v.spatial_merge_size**2
        x = self.merger.ln_q(x).reshape(n, -1, merged_dim)
        return self.merger.fc2(gelu(self.merger.fc1(x)))


class DecoderLayer(nn.Module):
    def __init__(self, c: "Qwen2VLConfig", dtype, device, attn_bias: bool = True) -> None:
        super().__init__()
        h, hd = c.hidden_size, c.head_dim
        # This rank's query and KV heads (fewer under tensor parallelism).
        self.heads, self.kv_heads = c.num_heads, c.num_kv_heads
        self.input_ln = RMSNorm(h, c.rms_norm_eps, dtype, device)
        self.q = Linear(h, c.num_heads * hd, attn_bias, dtype, device)
        self.k = Linear(h, c.num_kv_heads * hd, attn_bias, dtype, device)
        self.v = Linear(h, c.num_kv_heads * hd, attn_bias, dtype, device)
        self.o = Linear(c.num_heads * hd, h, False, dtype, device)
        self.post_ln = RMSNorm(h, c.rms_norm_eps, dtype, device)
        self.gate = Linear(h, c.intermediate_size, False, dtype, device)
        self.up = Linear(h, c.intermediate_size, False, dtype, device)
        self.down = Linear(c.intermediate_size, h, False, dtype, device)

    def products(self) -> tuple:
        """The products a decode step runs over the batch's rows (``decode_step``'s row blocks)."""
        return (self.q, self.k, self.v, self.o, self.gate, self.up, self.down)

    def mlp(self, x: torch.Tensor) -> torch.Tensor:
        """Gated MLP on the post-attention norm (``mlp_swiglu`` through the modules,
        so int8/int4 projections take their own dense)."""
        h = self.post_ln(x)
        return self.down(torch.nn.functional.silu(self.gate(h)) * self.up(h))

    def prefill_attention(self, x, cos, sin, attention_mask, keep, config) -> torch.Tensor:
        """The attention block's output (o-projected) over the left-padded
        prompt x [B, L, hidden]; ``keep(k, v)`` receives the rotated K and V,
        [B, KVH, L, D], the layer's share of the cache."""
        b, l, _ = x.shape
        q, k, v = _qkv(self, self.input_ln(x), config)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        if keep is not None:
            keep(k, v)
        # The padding mask is one contiguous run per row, so the kernel reads
        # it as (start, end) scalars.
        attn = flash_attention(q, k, v, causal=True, kv_mask=attention_mask, kv_mask_contiguous=True)
        return self.o(attn.transpose(1, 2).reshape(b, l, -1))

    def step_query(self, i, x, cos, sin, pos, cache, rows, config) -> torch.Tensor:
        """A decode step's query [B, H, D] of layer ``i`` (x [B, 1, hidden]),
        its new K and V (quantized per vector for an int8 cache, with their
        scales) written IN PLACE at the cache position ``pos``."""
        cache_k, cache_v, *scales = cache
        q, k, v = _row_blocks(lambda t: _qkv(self, self.input_ln(t), config), rows, x)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        writes = [(cache_k, k), (cache_v, v)]
        if scales:
            (kq, k_sc), (vq, v_sc) = _quantize_kv(k), _quantize_kv(v)
            writes = [(cache_k, kq), (cache_v, vq), (scales[0], k_sc), (scales[1], v_sc)]
        for dst, src in writes:
            dst[i].index_copy_(2, pos, src.to(dst.dtype))
        return q[:, :, 0]

    def step_attention(self, i, q, cache, kv_mask, **out) -> torch.Tensor:
        """Layer ``i``'s decode attention (K3) over the cache."""
        cache_k, cache_v, *scales = cache
        return gqa_decode_attention(q, cache_k, cache_v, i, kv_mask, *scales, **out)

    def step_post(self, x, attn, rows) -> torch.Tensor:
        """The o-projection, residual and MLP of a decode step after the attention."""

        def post(t, a):
            t = t + self.o(a)
            return t + self.mlp(t)

        return _row_blocks(post, rows, x, attn.reshape(x.shape[0], 1, -1))


class Qwen2VLModel(nn.Module):
    """Qwen2-VL decoder plus vision tower. Parameters are uninitialised until
    :func:`init_params` or :func:`params_from_jax` fills them. With ``vision25``
    (a Qwen2.5-VL preset) the tower is a :class:`Vision25Tower`; with
    ``text_only`` (a Llama decoder, :mod:`lmms_owc_tpu_torch.nn.llama`) there
    is none and :attr:`vision` is None. ``attn_bias`` gives the q/k/v
    projections biases (Qwen2's; a Llama decoder has none), as the JAX
    package's ``init_decoder_params`` argument of that name."""

    def __init__(
        self,
        config: Qwen2VLConfig,
        dtype=torch.bfloat16,
        device="cpu",
        vision25: Qwen25VisionConfig | None = None,
        text_only: bool = False,
        attn_bias: bool = True,
    ) -> None:
        super().__init__()
        self.config = config
        c = config
        self.embed_tokens = nn.Parameter(
            torch.empty(c.vocab_size, c.hidden_size, dtype=dtype, device=device), requires_grad=False
        )
        self.layers = nn.ModuleList(DecoderLayer(c, dtype, device, attn_bias) for _ in range(c.num_layers))
        self.final_norm = RMSNorm(c.hidden_size, c.rms_norm_eps, dtype, device)
        self.lm_head = (
            None if c.tie_word_embeddings else Linear(c.hidden_size, c.vocab_size, False, dtype, device)
        )
        if text_only:
            self.vision = None
        elif vision25 is not None:
            self.vision = Vision25Tower(vision25, dtype, device)
        else:
            self.vision = VisionTower(c.vision, c.hidden_size, dtype, device)
        # Tensor parallelism (:mod:`lmms_owc_tpu_torch.parallel.sharding`): the
        # model group, and the first vocabulary row of this rank's slice of
        # the embedding and head when the vocabulary is sharded.
        self.tp = None
        self.vocab_start: int | None = None

    @property
    def dtype(self) -> torch.dtype:
        return self.embed_tokens.dtype

    @property
    def kv_heads(self) -> int:
        """The KV heads of this rank's cache."""
        return self.layers[0].kv_heads

    @property
    def device(self) -> torch.device:
        return self.embed_tokens.device

    def rope_inv_freq(self, device: torch.device) -> torch.Tensor:
        return rope_inv_freq(self.config, device)

    def rope_tables(self, position_ids: torch.Tensor, inv_freq: torch.Tensor | None = None):
        """cos, sin [B, L, head_dim/2] of ``position_ids`` [3, B, L] (:func:`mrope_cos_sin`)."""
        return mrope_cos_sin(position_ids, self.config, inv_freq)

    # The int8 KV cache (``LMMS_OWC_KV_INT8``, :func:`kv_int8_cache`) quantizes K and V.
    cache_quantizes = True

    def cache_shapes(self, batch: int, cache_len: int) -> tuple:
        """The shapes of the decode cache's tensors: K and V, each [L, B, KVH, S, D]."""
        c = self.config
        shape = (c.num_layers, batch, self.kv_heads, cache_len, c.head_dim)
        return shape, shape

    def hf_tensor(self, state, name: str) -> torch.Tensor:
        """The HF checkpoint tensor of this model's parameter ``name``, found
        under the prefixes of ``convert_hf_decoder_weights`` (decoder) or
        ``visual.``/``model.visual.`` (the tower, which names its own)."""
        parts = name.split(".")
        if parts[0] == "vision":
            return self.vision.hf_tensor(state, ".".join(parts[1:]))
        if parts[0] == "layers":
            hf = f"layers.{parts[1]}.{_HF_DECODER_ROLES[parts[2]]}.{parts[3]}"
        else:
            hf = {"embed_tokens": "embed_tokens.weight", "final_norm": "norm.weight", "lm_head": "lm_head.weight"}[parts[0]]
        return find_tensor(state, hf, HF_DECODER_PREFIXES)


# ======================================================================== weights


@torch.no_grad()
def init_params(model: Qwen2VLModel, generator: torch.Generator, after=None) -> Qwen2VLModel:
    """Random-init in place on the generator's device: the token embedding,
    then every linear weight in module order ~ N(0, 1) * 0.02, biases zero,
    norm scales one (the distribution of the JAX ``init_params``; the values
    differ).

    ``generator`` must live on the model's device; a 7B model is then drawn on
    the card in seconds instead of minutes on the host. A model built on
    ``meta`` comes to the device one module at a time, and ``after`` (tensor
    parallelism's shard hook, see
    :func:`~lmms_owc_tpu_torch.ops.quant.materialize_on_device`) may keep a
    slice of each module once drawn: the same draws, so the same weights as
    an unsharded model from the same seed.
    """

    def fill(name, t, module):
        if isinstance(module, Linear):
            t.normal_(0.0, 0.02, generator=generator) if name.endswith("weight") else t.zero_()
        elif isinstance(module, (LayerNorm, RMSNorm)):
            t.fill_(1.0) if name.endswith("weight") else t.zero_()
        elif module is model and name == "embed_tokens":
            t.normal_(0.0, 0.02, generator=generator)

    return materialize_on_device(model, generator.device, fill, after)


def _copy(dst: torch.Tensor, src: np.ndarray) -> None:
    t = torch.from_numpy(np.array(src, dtype=np.float32))
    if tuple(t.shape) != tuple(dst.shape):
        raise ValueError(f"shape {tuple(t.shape)} does not fit parameter {tuple(dst.shape)}")
    dst.copy_(t.to(dtype=dst.dtype))


def _copy_exact(dst: torch.Tensor, src: np.ndarray) -> None:
    """Copy an int8 or f32 quantization leaf without a round trip through another type."""
    t = torch.from_numpy(np.array(src))
    if tuple(t.shape) != tuple(dst.shape) or t.dtype != dst.dtype:
        raise ValueError(f"{tuple(t.shape)} {t.dtype} does not fit {tuple(dst.shape)} {dst.dtype}")
    dst.copy_(t)


def _load_linear(parent: nn.Module, role: str, tree: dict, layer: int | None = None) -> None:
    """Load ``parent.<role>`` from a JAX dense leaf-dict: ``w`` into the float
    ``Linear``; ``w_q8`` / ``w_q4`` into a new ``Int8Linear`` / ``Int4Linear``
    that replaces it (the JAX ``[in, out]``, ``[in/2, out]`` and
    ``[groups, out]`` leaves transposed)."""
    pick = (lambda a: np.asarray(a)) if layer is None else (lambda a: np.asarray(a)[layer])
    lin = getattr(parent, role)
    if not isinstance(lin, Linear):
        raise ValueError(f"{role}: expected the model's float Linear, got {type(lin).__name__}")
    d_out, d_in = lin.weight.shape
    bias, dtype, device = lin.bias is not None, lin.weight.dtype, lin.weight.device
    if "w_q8" in tree:
        lin = Int8Linear(d_in, d_out, bias, dtype, device)
        _copy_exact(lin.q, pick(tree["w_q8"]["q"]).T)
        _copy_exact(lin.scale, pick(tree["w_q8"]["scale"]))
    elif "w_q4" in tree:
        scale = pick(tree["w_q4"]["scale"]).T
        lin = Int4Linear(d_in, d_out, bias, dtype, device, group=d_in // scale.shape[1])
        _copy_exact(lin.q4, pick(tree["w_q4"]["q4"]).T)
        _copy_exact(lin.scale, scale)
    else:
        _copy(lin.weight, pick(tree["w"]).astype(np.float32).T)
    if bias:
        _copy(lin.bias, pick(tree["b"]).astype(np.float32))
    setattr(parent, role, lin)


def _load_norm(norm: nn.Module, tree: dict, layer: int | None = None) -> None:
    pick = (lambda a: a) if layer is None else (lambda a: a[layer])
    _copy(norm.weight, pick(np.asarray(tree["scale"], np.float32)))
    if "bias" in tree:
        _copy(norm.bias, pick(np.asarray(tree["bias"], np.float32)))


@torch.no_grad()
def params_from_jax(model: Qwen2VLModel, tree: dict) -> Qwen2VLModel:
    """Load the JAX package's parameter tree (leaves as numpy arrays) in place.

    The tree is the token-major layout of ``lmms_owc_tpu.nn.qwen2_vl.init_params``
    / ``convert_hf_weights`` (not the feature-major ``vision_params_to_fm`` one),
    float or quantized by ``lmms_owc_tpu.ops.quant``. Layout rule: a JAX linear
    kernel ``w`` is ``[in, out]`` and becomes the port's ``weight = w.T``
    (``[out, in]``); a ``w_q8`` leaf becomes an ``Int8Linear`` (``q.T``, the
    ``[out]`` scale as is) and a ``w_q4`` leaf an ``Int4Linear`` (``q4.T``,
    ``scale.T``), replacing the float module; biases, norm scales (``scale`` ->
    ``weight``) and the ``[vocab, hidden]`` embedding copy as they are. Stacked
    ``[L, ...]`` leaves are split into the per-layer modules. Float values are
    cast to the model's dtype; quantized leaves are copied exactly. A model with
    a Qwen2.5-VL tower takes the ``init_vision25_params`` vision subtree
    (:func:`~lmms_owc_tpu_torch.nn.qwen2_5_vl.vision25_params_from_jax`); a
    text-only model takes a decoder tree (``init_decoder_params``), with no
    ``vision`` subtree.
    """
    c = model.config
    _copy(model.embed_tokens, np.asarray(tree["embed_tokens"], np.float32))
    lt = tree["layers"]
    for i, layer in enumerate(model.layers):
        _load_norm(layer.input_ln, lt["input_ln"], i)
        _load_norm(layer.post_ln, lt["post_ln"], i)
        for role in ("q", "k", "v", "o"):
            _load_linear(layer, role, lt["attn"][role], i)
        for role in ("gate", "up", "down"):
            _load_linear(layer, role, lt["mlp"][role], i)
    _load_norm(model.final_norm, tree["final_norm"])
    if not c.tie_word_embeddings:
        _load_linear(model, "lm_head", tree["lm_head"])
    if model.vision is None:
        if "vision" in tree:
            raise ValueError("a tree with a vision subtree does not fit this text-only model")
        return model

    vt = tree["vision"]
    tower = model.vision
    if isinstance(tower, Vision25Tower):
        vision25_params_from_jax(tower, vt)
        return model
    if "mlp_gate" in vt["layers"]:
        raise ValueError("a Qwen2.5-VL vision tree does not fit this Qwen2-VL model")
    _load_linear(tower, "patch_embed", vt["patch_embed"])
    vl = vt["layers"]
    for i, blk in enumerate(tower.blocks):
        _load_norm(blk.norm1, vl["norm1"], i)
        _load_norm(blk.norm2, vl["norm2"], i)
        for role in ("qkv", "proj", "fc1", "fc2"):
            _load_linear(blk, role, vl[role], i)
    _load_norm(tower.merger.ln_q, vt["merger"]["ln_q"])
    _load_linear(tower.merger, "fc1", vt["merger"]["fc1"])
    _load_linear(tower.merger, "fc2", vt["merger"]["fc2"])
    return model


def load_hf_weights(model: Qwen2VLModel, state, device=None, after=None) -> Qwen2VLModel:
    """Fill a float model from an HF Qwen2-VL or Qwen2.5-VL checkpoint's tensors
    (``state`` from :func:`~lmms_owc_tpu_torch.nn.loader.load_safetensors_state`),
    cast to the model's dtype, in place: the counterpart of
    ``convert_hf_weights`` / ``convert_hf_decoder_weights`` plus
    ``convert_hf_vision25_weights``, by :meth:`Qwen2VLModel.hf_tensor`'s names.
    The port's ``[out, in]`` layout is the checkpoint's, so nothing is
    transposed; a model with tied embeddings has no ``lm_head`` to fill. A
    model built on ``meta`` comes to ``device`` one module at a time, each
    passed to ``after`` (:func:`~lmms_owc_tpu_torch.nn.loader.load_hf_tensors`)."""
    return load_hf_tensors(model, state, device, after)


# ====================================================================== positions


def vision_rope_cos_sin(grid_thw: list[tuple[int, int, int]], config: Qwen2VLVisionConfig) -> np.ndarray:
    """Host-side 2D rotary table per packed patch, shape [num_patches, head_dim/2] (f32).

    Follows HF rot_pos_emb: h/w position ids are permuted into spatial-merge-window
    order before lookup.
    """
    merge = config.spatial_merge_size
    dim = config.head_dim // 2  # rotary dim (half for h, half for w)
    inv_freq = 1.0 / (10000.0 ** (np.arange(0, dim, 2, dtype=np.float32) / dim))

    pos_list = []
    for t, h, w in grid_thw:
        hpos = np.arange(h)[:, None].repeat(w, axis=1)
        hpos = hpos.reshape(h // merge, merge, w // merge, merge).transpose(0, 2, 1, 3).reshape(-1)
        wpos = np.arange(w)[None, :].repeat(h, axis=0)
        wpos = wpos.reshape(h // merge, merge, w // merge, merge).transpose(0, 2, 1, 3).reshape(-1)
        pos = np.stack([hpos, wpos], axis=-1)
        pos_list.append(np.tile(pos, (t, 1)))
    pos = np.concatenate(pos_list, axis=0)  # [P, 2]

    freqs_h = pos[:, 0:1].astype(np.float32) * inv_freq[None, :]
    freqs_w = pos[:, 1:2].astype(np.float32) * inv_freq[None, :]
    return np.concatenate([freqs_h, freqs_w], axis=-1)  # [P, head_dim/2]


def get_rope_index(
    input_ids: np.ndarray,
    attention_mask: np.ndarray,
    image_grid_thw: list[tuple[int, int, int]],
    config: Qwen2VLConfig,
) -> tuple[np.ndarray, np.ndarray]:
    """Host-side 3D (t/h/w) position ids, shape [3, B, L]; plus per-seq next position.

    Semantics match HF Qwen2VLModel.get_rope_index: text tokens advance all three
    dims together; each image block advances t by timestep and h/w by grid position,
    then text resumes at max+1.
    """
    bsz, seqlen = input_ids.shape
    position_ids = np.ones((3, bsz, seqlen), dtype=np.int64)
    next_pos = np.zeros(bsz, dtype=np.int64)
    merge = config.vision.spatial_merge_size
    image_index = 0

    for i in range(bsz):
        mask = attention_mask[i] == 1
        ids = input_ids[i][mask]
        tokens = ids.tolist()
        pos_chunks = []
        st = 0
        vision_starts = np.where(ids == config.vision_start_token_id)[0]
        n_imgs = int(np.sum(ids[vision_starts + 1] == config.image_token_id)) if len(vision_starts) else 0

        for _ in range(n_imgs):
            ed = tokens.index(config.image_token_id, st)
            t, h, w = image_grid_thw[image_index]
            image_index += 1
            gt, gh, gw = t, h // merge, w // merge
            text_len = ed - st
            st_idx = pos_chunks[-1].max() + 1 if pos_chunks else 0
            pos_chunks.append(np.tile(np.arange(text_len), (3, 1)) + st_idx)
            t_idx = np.repeat(np.arange(gt), gh * gw)
            h_idx = np.tile(np.repeat(np.arange(gh), gw), gt)
            w_idx = np.tile(np.arange(gw), gt * gh)
            pos_chunks.append(np.stack([t_idx, h_idx, w_idx]) + text_len + st_idx)
            st = ed + gt * gh * gw

        if st < len(tokens):
            st_idx = pos_chunks[-1].max() + 1 if pos_chunks else 0
            pos_chunks.append(np.tile(np.arange(len(tokens) - st), (3, 1)) + st_idx)

        positions = np.concatenate(pos_chunks, axis=1)
        position_ids[:, i, mask] = positions
        next_pos[i] = positions.max() + 1
    return position_ids, next_pos


def _llama3_scale_inv_freq(inv_freq: torch.Tensor, scaling: tuple) -> torch.Tensor:
    """HF llama3 rope scaling, in f32 as the JAX package computes it: damp the
    low-frequency components by ``factor`` with a smooth transition band
    (transformers ``_compute_llama3_parameters``)."""
    factor, low_freq_factor, high_freq_factor, old_context_len = scaling
    low_freq_wavelen = old_context_len / low_freq_factor
    high_freq_wavelen = old_context_len / high_freq_factor
    wavelen = 2 * np.pi / inv_freq
    scaled = torch.where(wavelen > low_freq_wavelen, inv_freq / factor, inv_freq)
    smooth = (old_context_len / wavelen - low_freq_factor) / (high_freq_factor - low_freq_factor)
    smoothed = (1 - smooth) / factor * inv_freq + smooth * inv_freq
    is_medium = (wavelen >= high_freq_wavelen) & (wavelen <= low_freq_wavelen)
    return torch.where(is_medium, smoothed, scaled)


def rope_inv_freq(config: Qwen2VLConfig, device: torch.device) -> torch.Tensor:
    """The rotary frequencies [head_dim/2] (f32) on ``device``: ``rope_llama3``
    scales them, ``rope_longrope`` divides them by its factors (a copy from
    the host, so a captured decode step takes them as an input)."""
    hd2 = config.head_dim // 2
    exponent = torch.arange(0, hd2, dtype=torch.float32, device=device) / hd2
    inv_freq = 1.0 / (config.rope_theta ** exponent)
    if config.rope_llama3 is not None:
        inv_freq = _llama3_scale_inv_freq(inv_freq, config.rope_llama3)
    if config.rope_longrope is not None:
        inv_freq = inv_freq / torch.tensor(config.rope_longrope[1], dtype=torch.float32, device=device)
    return inv_freq


def mrope_cos_sin(
    position_ids: torch.Tensor, config: Qwen2VLConfig, inv_freq: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Combine t/h/w rotary tables into [B, L, head_dim/2] cos/sin (f32).

    ``position_ids`` [3, B, L]; the result lives on its device. ``inv_freq``
    is :func:`rope_inv_freq` (computed here where None). A config with
    ``rope_longrope`` multiplies cos and sin by its attention factor, so the
    factor reaches q and k in the prefill and every decode step.
    """
    if inv_freq is None:
        inv_freq = rope_inv_freq(config, position_ids.device)
    freqs = position_ids[..., None].float() * inv_freq  # [3, B, L, hd/2]
    chunks = torch.split(freqs, list(config.mrope_section), dim=-1)
    combined = torch.cat([chunk[i % 3] for i, chunk in enumerate(chunks)], dim=-1)
    cos, sin = torch.cos(combined), torch.sin(combined)
    if config.rope_longrope is not None:  # no extra launches in the other families' decode steps
        attention_factor = config.rope_longrope[0]
        cos, sin = cos * attention_factor, sin * attention_factor
    return cos, sin


# ======================================================================== decoder


def embed_tokens(model: Qwen2VLModel, ids: torch.Tensor) -> torch.Tensor:
    """Token embeddings [..., hidden] of ``ids``. With the vocabulary sharded
    this rank's rows look up the ids in its slice, the others give zeros, and
    the model group sums them (exact: one addend is nonzero). An id outside
    the vocabulary embeds to zeros, sharded or not: a random-init preset's
    pad id can lie past its vocabulary (the flagship dry run's 151643 of
    19456; the JAX lookup reads NaN rows there). Other models take the plain
    lookup."""
    table = model.embed_tokens
    if model.vocab_start is None and model.config.pad_token_id < model.config.vocab_size:
        return embedding(table, ids)
    local = ids - (model.vocab_start or 0)
    inside = (local >= 0) & (local < table.shape[0])
    out = torch.where(inside[..., None], embedding(table, local.clamp(0, table.shape[0] - 1)), 0.0)
    if model.vocab_start is None:
        return out.to(table.dtype)
    return model.tp.all_reduce(out.float().contiguous()).to(table.dtype)


def _qkv(layer: DecoderLayer, x: torch.Tensor, config: Qwen2VLConfig):
    """Rotated-later q [B, H, L, D], k and v [B, KVH, L, D] as views of the
    projections, with this rank's head counts."""
    b, l, _ = x.shape
    nh, kvh, hd = layer.heads, layer.kv_heads, config.head_dim
    q = layer.q(x).view(b, l, nh, hd).transpose(1, 2)
    k = layer.k(x).view(b, l, kvh, hd).transpose(1, 2)
    v = layer.v(x).view(b, l, kvh, hd).transpose(1, 2)
    return q, k, v


def _mm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w.T`` multiplied in the operands' dtype, accumulated and returned in f32."""
    if w.dtype == torch.float32:
        return torch.matmul(x, w.t())
    if w.is_cuda:
        return torch.mm(x, w.t(), out_dtype=torch.float32)
    return torch.matmul(x.float(), w.float().t())


def _head_logits(model: Qwen2VLModel, x: torch.Tensor) -> torch.Tensor:
    """LM head in f32 for [B, H] hidden states; tied heads read the embedding.

    The product multiplies in the stored dtype and accumulates in f32, so a
    bf16 vocab matrix is read at bf16 bytes while the logits stay f32. An int8
    head multiplies bf16 x by its values in bf16 (f32 accumulation), then by the
    channel scale; an int4 head is its ``dense`` on bf16 x (K4 at decode rows),
    as the JAX package. The int8 head's bf16 copy of the vocab matrix is made
    on each call. With the vocabulary sharded, each rank's logits fill their
    columns of a zero [B, vocab] tensor and the model group sums them, so
    every rank holds the full logits (exact: one addend is nonzero).
    """
    return _gather_vocab(model, _local_head_logits(model, x))


def _gather_vocab(model: Qwen2VLModel, logits: torch.Tensor) -> torch.Tensor:
    """This rank's vocabulary columns of the logits -> the full logits on every rank."""
    if getattr(model, "vocab_start", None) is None:
        return logits
    full = logits.new_zeros(*logits.shape[:-1], model.config.vocab_size)
    full[..., model.vocab_start : model.vocab_start + logits.shape[-1]] = logits
    return model.tp.all_reduce(full)


def _local_head_logits(model: Qwen2VLModel, x: torch.Tensor) -> torch.Tensor:
    head = model.lm_head
    if isinstance(head, Int8Linear):
        return _mm_f32(x.to(torch.bfloat16), head.q.to(torch.bfloat16)) * head.scale
    if isinstance(head, Int4Linear):
        return head(x.to(torch.bfloat16)).float()
    w = head.weight if head is not None else model.embed_tokens  # [V, H]
    return _mm_f32(x.to(w.dtype), w)


def _decoder_forward(
    model: Qwen2VLModel,
    input_embeds: torch.Tensor,
    position_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    keep_kv=None,
) -> torch.Tensor:
    """Causal decoder over the full left-padded sequence -> hidden states
    [B, L, hidden] before the final norm (a per-position op the callers apply
    where they need it). ``keep_kv(layer, *tensors)`` receives each layer's
    share of the cache (rotated K and V, [B, KVH, L, D]; a Kimi-VL layer's
    latent, :meth:`~lmms_owc_tpu_torch.nn.kimi_vl.KimiDecoderLayer.prefill_attention`)."""
    cos, sin = model.rope_tables(position_ids)
    x = input_embeds
    for i, layer in enumerate(model.layers):
        keep = None if keep_kv is None else (lambda *kv, i=i: keep_kv(i, *kv))
        x = x + layer.prefill_attention(x, cos, sin, attention_mask, keep, model.config)
        x = x + layer.mlp(x)
    return x


@torch.inference_mode()
def prefill(
    model: Qwen2VLModel,
    input_embeds: torch.Tensor,
    position_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    cache_len: int,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Full forward over the left-padded prompt; returns last logits and the KV cache.

    Args:
        input_embeds: [B, L, hidden] (text embeddings with vision embeds scattered in).
        position_ids: [3, B, L] M-RoPE positions.
        attention_mask: [B, L] 1 = real token (one contiguous run per row).
        cache_len: cache capacity (>= L + max_new_tokens).
    Returns: (logits [B, vocab] f32 at the last position, the cache: (cache_k,
        cache_v), each [num_layers, B, KVH, cache_len, D], or the model's own
        tensors (``model.cache_shapes``), with positions >= L zero).
    """
    b, l, _ = input_embeds.shape
    cache = tuple(torch.zeros(shape, dtype=input_embeds.dtype, device=input_embeds.device)
                  for shape in model.cache_shapes(b, cache_len))

    def keep(i, *kv):
        for dst, src in zip(cache, kv):
            dst[i, :, :, :l] = src

    x = _decoder_forward(model, input_embeds, position_ids, attention_mask, keep)
    x = model.final_norm(x[:, -1])  # left-padded: the last position is the newest token
    return _head_logits(model, x), cache


@torch.inference_mode()
def score_continuation(
    model: Qwen2VLModel,
    input_embeds: torch.Tensor,
    position_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    target_ids: torch.Tensor,
    target_mask: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Loglikelihood scoring: mean cross-entropy over the continuation and greedy match.

    ``target_ids[b, t]`` is the token the model should predict at position t
    (the input shifted left by one); ``target_mask`` [B, L] selects the
    continuation's positions. The decoder runs over the whole padded sequence
    (prefill attention, causal); the final norm and the head run only at the
    selected positions, which gives the same values as the JAX package's head
    over every position without its [B, L, vocab] f32 logits. Returns (loss
    [B] f32, is_greedy [B] bool); a row with no selected position has loss 0
    and is greedy.
    """
    x = _decoder_forward(model, input_embeds, position_ids, attention_mask)
    rows, cols = torch.nonzero(target_mask, as_tuple=True)
    logits = _head_logits(model, model.final_norm(x[rows, cols]))  # [T, vocab] f32
    targets = target_ids[rows, cols]
    nll = -torch.log_softmax(logits, dim=-1).gather(-1, targets[:, None])[:, 0]
    b = x.shape[0]
    zeros = torch.zeros(b, dtype=torch.float32, device=x.device)
    total = zeros.index_add(0, rows, nll)
    count = zeros.index_add(0, rows, torch.ones_like(nll))
    misses = zeros.index_add(0, rows, (logits.argmax(dim=-1) != targets).float())
    return total / count.clamp(min=1.0), misses == 0


def prefill_logits(
    model: Qwen2VLModel,
    input_embeds: torch.Tensor,
    position_ids: torch.Tensor,
    attention_mask: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prefill for the decode pool: last-position logits and the UNPADDED
    cache's tensors (K and V, each [num_layers, B, KVH, L, D]; one latent
    tensor for Kimi-VL); :func:`write_pool_rows` places each."""
    logits, cache = prefill(model, input_embeds, position_ids, attention_mask, input_embeds.shape[1])
    return (logits, *cache)


# ------------------------------------------------------------- int8 cache, pool


def kv_cache_int8_enabled(device: torch.device | str | None = None) -> bool:
    """Gate for the int8 KV cache (``LMMS_OWC_KV_INT8``), read on every call.

    ``force`` enables it anywhere (CPU parity tests); ``1`` on CUDA (the
    ``device`` given, or the default CUDA device when None).
    """
    mode = os.environ.get("LMMS_OWC_KV_INT8", "")
    if mode == "force":
        return True
    if mode != "1":
        return False
    return torch.device(device).type == "cuda" if device is not None else torch.cuda.is_available()


def kv_int8_cache(model, device: torch.device | str | None = None) -> bool:
    """Whether ``model``'s decode cache goes int8: :func:`kv_cache_int8_enabled`
    where the model's cache quantizes (``cache_quantizes``); asked of a cache
    that does not (Kimi-VL's latent cache), a ValueError."""
    if not kv_cache_int8_enabled(device):
        return False
    if not model.cache_quantizes:
        raise ValueError(f"LMMS_OWC_KV_INT8 asks for an int8 KV cache, which {type(model).__name__}'s "
                         "decode cache does not take")
    return True


def _quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-vector symmetric int8 over the trailing head_dim axis: (q int8 [..., D],
    scale f32 [...]) with x ~= q * scale; all-zero vectors get scale 1e-6/127."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1), min=1e-6) / 127.0
    return torch.round(xf / scale[..., None]).to(torch.int8), scale


def quantize_kv_cache(
    ks: torch.Tensor, vs: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """[L, B, KVH, S, D] caches -> (k_q, v_q int8, k_scale, v_scale f32 [L, B, KVH, S])."""
    kq, sk = _quantize_kv(ks)
    vq, sv = _quantize_kv(vs)
    return kq, vq, sk, sv


def write_pool(pool: tuple, chunk: tuple, rows: int, cache_len: int, row_offset: int, front: int) -> tuple:
    """One chunk's prefill cache (:func:`prefill_logits`' tensors of
    left-padded prompts, or their int8 form and scales from
    :func:`quantize_kv_cache`) into the decode pool of ``rows`` rows and
    ``cache_len`` positions IN PLACE, made at the first chunk (``pool``
    empty) in the chunk's dtypes: rows from ``row_offset``, the sequence
    axis FRONT-padded by ``front`` to the pool's common prompt bucket
    (masked off by the caller's kv_mask like ordinary left padding), each
    tensor by :func:`write_pool_rows`. Peak memory is the pool plus one
    chunk. Returns the pool."""
    if not pool:
        pool = tuple(torch.zeros((t.shape[0], rows, t.shape[2], cache_len, *t.shape[4:]), dtype=t.dtype,
                                 device=t.device) for t in chunk)
    for dst, src in zip(pool, chunk):
        write_pool_rows(dst, src, row_offset, front)
    return pool


def write_pool_rows(pool: torch.Tensor, chunk: torch.Tensor, row_offset: int, front: int) -> None:
    """One tensor of :func:`write_pool`: ``chunk`` [L, B_i, heads, L_i, ...]
    into ``pool`` IN PLACE, rows from ``row_offset``, positions from ``front``."""
    b, l = chunk.shape[1], chunk.shape[3]
    pool[:, row_offset : row_offset + b, :, front : front + l] = chunk


# torch's CUDA reduction over the last dim (RMSNorm's mean of squares) sizes
# its thread blocks by the row count below 16 rows, and so sums a row in
# another order (on an H100 a pooled row's norm parted from its unpooled
# one at 8 rows against 4): decode layers whose products keep the batch's
# rows still run on at least this many.
REDUCE_ROWS = 16


def _row_blocks(fn, rows: int | None, *xs: torch.Tensor):
    """``fn`` (a row-wise function of tensors with the same leading rows) over
    blocks of exactly ``rows`` rows, the last block zero-padded, its outputs
    (a tensor or a tuple) concatenated back to the input's rows; with
    ``rows`` None, ``fn(*xs)``. Every product then has the same shape
    whatever the batch, so a row's result does not depend on the rows beside
    it: cuBLAS picks its split of K by the row count (on an H100 the k/v and
    down products of Llama-3.2-3B give other bits at 64 rows than at 128)."""
    if rows is None:
        return fn(*xs)
    b = xs[0].shape[0]
    padded = xs if b % rows == 0 else [torch.nn.functional.pad(x, (0, 0) * (x.dim() - 1) + (0, -b % rows))
                                       for x in xs]
    outs = [fn(*block) for block in zip(*(p.split(rows) for p in padded))]
    if isinstance(outs[0], tuple):
        return tuple((parts[0] if len(parts) == 1 else torch.cat(parts))[:b] for parts in zip(*outs))
    return (outs[0] if len(outs) == 1 else torch.cat(outs))[:b]


def _step_segments(model: Qwen2VLModel, cache: tuple, layer_rows: int | None, head_rows: int | None) -> list:
    """A decode step's work between its attention launches (each layer's
    ``step_attention``), as ``L + 1`` functions of tensors that return
    tuples of tensors. Segment 0 takes
    (token ids [B], positions [3, B, 1], cache position) to (x, cos, sin,
    layer 0's query); segment ``i`` (``0 < i < L``) takes (x, cos, sin, cache
    position, layer ``i - 1``'s attention) to (x, layer ``i``'s query): layer
    ``i - 1``'s post-attention work (``step_post``: the o-projection,
    residual and MLP), then layer ``i``'s query (``step_query``: norm,
    projections, rope, and the cache write); segment ``L`` takes (x, the last
    layer's attention) to (this rank's logits,). Each layer writes its share
    of the cache IN PLACE at the cache position, a one-element device tensor,
    so one capture of a segment serves every step. ``layer_rows`` and
    ``head_rows`` are :func:`_row_blocks`' for the layers' products and for
    the head."""
    layers, c = model.layers, model.config
    inv_freq = model.rope_inv_freq(cache[0].device)

    def first(ids, positions, pos):
        x = embed_tokens(model, ids)[:, None, :]
        cos, sin = model.rope_tables(positions, inv_freq)
        return x, cos, sin, layers[0].step_query(0, x, cos, sin, pos, cache, layer_rows, c)

    def middle(i):
        def segment(x, cos, sin, pos, attn):
            x = layers[i - 1].step_post(x, attn, layer_rows)
            return x, layers[i].step_query(i, x, cos, sin, pos, cache, layer_rows, c)

        return segment

    def last(x, attn):
        x = layers[-1].step_post(x, attn, layer_rows)
        # The vocabulary gather takes the batch's rows only, not a row block's padding.
        return (_row_blocks(lambda t: _local_head_logits(model, model.final_norm(t)), head_rows, x[:, 0]),)

    return [first, *(middle(i) for i in range(1, len(layers))), last]


def _run_segments(run, attend, layers: int, ids, positions, pos) -> torch.Tensor:
    """One step's logits: ``run(k, *inputs)`` gives segment ``k``'s outputs
    (:func:`_step_segments`), ``attend(i, q)`` layer ``i``'s attention."""
    x, cos, sin, q = run(0, ids, positions, pos)
    for i in range(1, layers):
        x, q = run(i, x, cos, sin, pos, attend(i - 1, q))
    (logits,) = run(layers, x, attend(layers - 1, q))
    return logits


def _run_direct(segments: list, attend, ids, positions, cache_pos: int) -> torch.Tensor:
    """:func:`_run_segments` calling each segment, the cache position a new tensor."""
    pos = torch.full((1,), cache_pos, dtype=torch.long, device=ids.device)
    return _run_segments(lambda k, *inputs: segments[k](*inputs), attend, len(segments) - 1, ids, positions, pos)


# A persistent stream per device to capture decode segments on.
_CAPTURE_STREAMS: dict = {}
# Per device, the graph memory pools that no decode pool holds now, each as
# (its handle, one graph captured into it). A decode pool's captures take one
# and give it back when the pool ends, so the next pool's captures reuse its
# blocks: a pool whose graphs are all gone is reclaimed only by
# ``empty_cache``, never during a capture, and PyTorch's allocators refuse a
# capture into it. So a pool comes back with one of its graphs, never
# replayed again, which the next capture into it drops once it has ended.
_FREE_MEMORY: dict = {}
# The fewest decode steps a pool must have left for a capture to pay: on an
# H100 a pool of 7B steps that captures at its first step beats one run
# directly once a single replay follows the capture (PERF.md §6).
GRAPH_MIN_STEPS = 2


def _capture_stream(device: torch.device):
    if device not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
    return _CAPTURE_STREAMS[device]


def _graph_memory(device: torch.device) -> tuple:
    """(a graph memory pool of ``device`` that no decode pool holds, the graph
    that keeps it, or None for a new pool)."""
    free = _FREE_MEMORY.setdefault(device, [])
    return free.pop() if free else (torch.cuda.graph_pool_handle(), None)


class StepGraphs:
    """CUDA graphs of one decode pool's step segments (:func:`_step_segments`),
    captured once and replayed at every later step of the pool; each
    layer's attention (K3, or Kimi-VL's MLA decode) runs between them,
    launched per layer, into a static buffer that the next segment reads.

    A step whose key differs from the step before (the pool's first; a new
    cache or mask tensor, batch or row block; another cache dtype; the W8A8
    switch or the host timers turned) drops the graphs. If this thread has
    not run a step of the key's shapes yet, the step runs its segments
    directly on the capture stream, which warms up that stream's libraries
    and loads the shapes' kernels, and the next step captures; otherwise the
    step captures at once. A capture takes each segment on that stream into
    one memory pool that the segments share (and that the device's next
    decode pool reuses, :func:`_graph_memory`), and replays it at once;
    every later step copies its token ids, positions and cache position
    into the static inputs and replays. With fewer than ``GRAPH_MIN_STEPS`` steps left in the pool's budget a step
    that would capture runs directly instead. The captured segments are kept
    while their graphs live: a graph reads what their closures hold (the
    rope frequencies) at the addresses it was captured with. The counts a
    segment makes while it is captured (W8A8's quantizations, K4's launches)
    are added again at each replay, since a replay runs no Python.
    :meth:`close` drops the graphs, the segments and the buffers, and gives
    the memory pool back.
    """

    def __init__(self, device: torch.device, steps: int | None = None) -> None:
        self.device = device
        self.left = steps  # the pool's decode steps not yet run; None where unbounded
        self.key = self.pool = self.keeper = None
        self.captured = []
        self.close()

    @staticmethod
    def engages(model: Qwen2VLModel, device: torch.device) -> bool:
        """On a CUDA device, with the whole model there (a model group's gloo
        all-reduces cannot be captured), where the model's step reads nothing
        on the host (``capturable``: Kimi-VL's routed product in bf16)."""
        return (device.type == "cuda" and (model.tp is None or model.tp.size == 1)
                and getattr(model, "capturable", True))

    def close(self) -> None:
        keeper = self.captured[-1][0] if self.captured else self.keeper
        self.captured = []  # per segment: (graph, its static outputs, the counts its capture made)
        self.segments = self.inputs = self.attn = None
        if self.pool is not None and keeper is not None:
            _FREE_MEMORY[self.device].append((self.pool, keeper))
        self.pool = self.keeper = None

    def step(self, key, segments, attend, token_ids, position_ids, cache_pos: int, layers: int):
        """(the step's logits, whether they came from graphs captured at an
        earlier step). ``key`` is (the cache's and mask's addresses, the
        step's shapes and switches); ``segments()`` builds the step's
        segments; ``attend(i, q, out=None)`` launches layer ``i``'s attention
        (``step_attention``: K3, or Kimi-VL's MLA decode)."""
        left = self.left
        if left is not None:
            self.left -= 1
        if key != self.key:
            self.close()
            self.key = key
        if not self.captured:
            warm = _warm_shapes()
            if key[1:] not in warm:
                warm.add(key[1:])
                with self._warm_up():
                    return _run_direct(segments(), attend, token_ids, position_ids, cache_pos), False
            if left is not None and left < GRAPH_MIN_STEPS:
                return _run_direct(segments(), attend, token_ids, position_ids, cache_pos), False
        if self.inputs is None:
            self.inputs = (torch.empty_like(token_ids),
                           torch.empty(position_ids.shape, dtype=position_ids.dtype, device=self.device),
                           torch.empty(1, dtype=torch.long, device=self.device))
        ids, positions, pos = self.inputs
        ids.copy_(token_ids)
        positions.copy_(position_ids)
        pos.fill_(cache_pos)
        replay = bool(self.captured)
        if replay:
            run = self._replay
        else:
            _hostprof.count("decode_graph_captures")
            self.segments = segments()
            run = self._capture_and_run
        return _run_segments(run, self._into_static(attend), layers, ids, positions, pos), replay

    def _into_static(self, attend):
        """``attend`` writing into one static buffer that the next segment
        reads: the first call's output, whose shape is the layer's own (an
        MLA output is narrower than its query)."""

        def into(i, q):
            if self.attn is None:
                self.attn = attend(i, q).contiguous()
                return self.attn
            return attend(i, q, out=self.attn)

        return into

    def _capture_and_run(self, k: int, *inputs) -> tuple:
        with _hostprof.tally() as counts:
            graph, outputs = self._capture(self.segments[k], inputs)
        graph.replay()
        self.captured.append((graph, outputs, counts))
        return outputs

    def _replay(self, k: int, *inputs) -> tuple:
        graph, outputs, counts = self.captured[k]
        graph.replay()
        for store, name, n in counts:
            _hostprof.add(store, name, n)
        return outputs

    def _capture(self, fn, inputs):
        """(the graph of ``fn(*inputs)``, its static outputs). The device is
        never synchronized during a capture (``capture_lock``), and other
        threads may launch work meanwhile (``thread_local``)."""
        if self.pool is None:
            self.pool, self.keeper = _graph_memory(self.device)
        graph = torch.cuda.CUDAGraph()
        with capture_lock, torch.cuda.stream(_capture_stream(self.device)):
            graph.capture_begin(self.pool, capture_error_mode="thread_local")
            try:
                outputs = fn(*inputs)
            finally:
                graph.capture_end()
        self.keeper = None  # the new graph keeps the pool now
        return graph, outputs

    @contextmanager
    def _warm_up(self):
        stream, current = _capture_stream(self.device), torch.cuda.current_stream(self.device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            yield
        current.wait_stream(stream)


# The decode pool's graphs of this thread while :func:`_decode_loop` runs,
# and the step shapes this thread has run directly on the capture stream.
_pool = threading.local()


def _warm_shapes() -> set:
    if not hasattr(_pool, "warm"):
        _pool.warm = set()
    return _pool.warm


@contextmanager
def _pool_graphs(model: Qwen2VLModel, device: torch.device, steps: int | None = None):
    """This thread's decode steps inside the block (at most ``steps``, where
    given) run from one :class:`StepGraphs` where they engage (yielded; None
    where not); the graphs are dropped and their memory pool given back as
    the block ends."""
    graphs = StepGraphs(device, steps) if StepGraphs.engages(model, device) else None
    _pool.graphs = graphs
    try:
        yield graphs
    finally:
        _pool.graphs = None
        if graphs is not None:
            graphs.close()


@torch.inference_mode()
def decode_step(
    model: Qwen2VLModel,
    token_ids: torch.Tensor,
    position_ids: torch.Tensor,
    cache: tuple[torch.Tensor, torch.Tensor],
    cache_pos: int,
    kv_mask: torch.Tensor,
    rows: int | None = None,
) -> torch.Tensor:
    """One decode step: token_ids [B], position_ids [3, B, 1] -> logits [B, vocab] f32.

    ``cache`` is (cache_k, cache_v), each [num_layers, B, KVH, S, D], or the
    int8 form (k_q, v_q, k_scale, v_scale) of :func:`quantize_kv_cache`, or
    the model's own (Kimi-VL: one latent tensor [num_layers, B, 1, S, 576]).
    Each layer's share of the new token's cache entry (``step_query``: K and
    V, quantized per vector for an int8 cache, with their scales) is
    point-written IN PLACE at ``cache_pos``; the caller's cache tensors
    hold the update afterwards. ``kv_mask`` [B, S] must already mark
    ``cache_pos`` valid. With ``rows``, a row's logits do not depend on the
    batch: the layers (everything but the attention, which is per row
    already) and the head run on blocks of exactly ``rows`` rows
    (:func:`_row_blocks`) where their products' bits depend on the row count
    (:func:`row_invariant`), and otherwise (W8A8, K4) on at least
    ``REDUCE_ROWS`` rows, for the norms' reductions.

    The step is the segments of :func:`_step_segments` with each layer's
    attention (``step_attention``: K3, or Kimi-VL's MLA decode) launched
    between them. Inside :func:`_decode_loop` on a CUDA device they replay
    the pool's :class:`StepGraphs` (the logits are then a static tensor that
    the next step overwrites); elsewhere, and on the CPU and under tensor
    parallelism always, they run directly.

    With the host timers on (:mod:`~lmms_owc_tpu_torch.utils._hostprof`) it
    counts ``decode_rows``, the batch's rows, ``decode_rows_computed``, the
    rows the decoder layers' products run on after the row blocks' padding
    (the head's rows are not counted), and ``decode_graph_steps``, one where
    the step replayed graphs captured at an earlier step (zero otherwise).
    """
    b = token_ids.shape[0]
    layer0 = model.layers[0]
    layer_rows = head_rows = rows
    if rows is not None:
        head = model.lm_head
        if all(row_invariant(lin, b) for lin in layer0.products()):
            layer_rows = max(b, REDUCE_ROWS)
        # An int8 head multiplies in bf16 (``_head_logits``) even under W8A8.
        if isinstance(head, Int4Linear) and row_invariant(head, b):
            head_rows = max(b, REDUCE_ROWS)
    if _hostprof.ENABLED:
        _hostprof.count("decode_rows", b)
        _hostprof.count("decode_rows_computed", b if layer_rows is None else -(-b // layer_rows) * layer_rows)

    def attend(i, q, **out):
        return model.layers[i].step_attention(i, q, cache, kv_mask, **out)

    def segments():
        return _step_segments(model, cache, layer_rows, head_rows)

    graphs = getattr(_pool, "graphs", None)
    if graphs is None:
        logits, replayed = _run_direct(segments(), attend, token_ids, position_ids, cache_pos), False
    else:
        key = (tuple(t.data_ptr() for t in (*cache, kv_mask)),
               tuple((t.shape, t.dtype) for t in (*cache, kv_mask)), b, rows, model.dtype,
               tuple(type(lin) for lin in layer0.products()), type(model.lm_head), _layers._INT8_ACTIVATIONS,
               _hostprof.ENABLED)
        logits, replayed = graphs.step(key, segments, attend, token_ids, position_ids, cache_pos,
                                       len(model.layers))
    if _hostprof.ENABLED:
        _hostprof.count("decode_graph_steps", int(replayed))
    return _gather_vocab(model, logits)


def _sample_token(
    logits: torch.Tensor,
    generator: torch.Generator | None,
    temperature: float,
    top_p: float,
    do_sample: bool,
) -> torch.Tensor:
    """Greedy argmax, or top-p sampling from ``generator`` (on the logits' device)."""
    if not do_sample:
        return torch.argmax(logits, dim=-1)
    scaled = logits / max(temperature, 1e-6)
    sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
    cumprobs = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    cutoff_idx = torch.sum(cumprobs < top_p, dim=-1, keepdim=True)
    cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
    filtered = torch.where(scaled >= cutoff, scaled, torch.full_like(scaled, float("-inf")))
    probs = torch.softmax(filtered, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.inference_mode()
def _decode_loop(
    model: Qwen2VLModel,
    logits: torch.Tensor,
    cache: tuple[torch.Tensor, torch.Tensor],
    kv_mask: torch.Tensor,
    next_positions: torch.Tensor,
    max_new_tokens: int,
    prompt_len: int,
    eos_ids: torch.Tensor,
    generator: torch.Generator | None,
    do_sample: bool,
    temperature: float,
    top_p: float,
    decode_rows: int | None = None,
) -> torch.Tensor:
    """Decode until every row has emitted EOS or ``max_new_tokens`` are out.

    ``prompt_len`` is the cache position of the first generated token. Tokens
    after a row's EOS are ``pad_token_id``. Returns [B, max_new_tokens] int64.
    The loop stops early once every row is done; the JAX loop then runs one more
    step whose output it discards, so the tokens are the same.

    Host timers (:mod:`~lmms_owc_tpu_torch.utils._hostprof`): each step's
    ``decode_issue`` span holds the host queueing the step (the
    :func:`decode_step` call, the sampling and the token bookkeeping), its
    ``decode_stop_check`` span the host blocked on ``done.all()`` until the
    device has caught up, and ``decode_steps`` counts the steps.

    The steps share one :class:`StepGraphs` where it engages
    (:func:`_pool_graphs`), dropped when the loop ends.
    """
    c = model.config
    b = logits.shape[0]
    tokens = torch.full((b, max_new_tokens), c.pad_token_id, dtype=torch.long, device=logits.device)
    done = torch.zeros(b, dtype=torch.bool, device=logits.device)

    def keep(step, logits, done):
        token = _sample_token(logits, generator, temperature, top_p, do_sample)
        token = torch.where(done, torch.full_like(token, c.pad_token_id), token)
        tokens[:, step] = token
        return token, done | torch.isin(token, eos_ids)

    token, done = keep(0, logits, done)
    with _pool_graphs(model, logits.device, max_new_tokens - 1):
        for step in range(max_new_tokens - 1):
            with hostprof("decode_stop_check"):
                stop = bool(done.all())
            if stop:
                break
            with hostprof("decode_issue"):
                if _hostprof.ENABLED:
                    _hostprof.count("decode_steps")
                pos = (next_positions + step)[None, :, None].expand(3, b, 1)
                kv_mask[:, prompt_len + step] = 1
                logits = decode_step(model, token, pos, cache, prompt_len + step, kv_mask, decode_rows)
                token, done = keep(step + 1, logits, done)
    return tokens


@torch.inference_mode()
def greedy_generate(
    model: Qwen2VLModel,
    input_embeds: torch.Tensor,
    position_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    next_positions: torch.Tensor,
    max_new_tokens: int,
    cache_len: int,
    eos_ids: torch.Tensor,
    generator: torch.Generator | None = None,
    do_sample: bool = False,
    temperature: float = 1.0,
    top_p: float = 1.0,
    phase=None,
    decode_rows: int | None = None,
) -> torch.Tensor:
    """Prefill + decode-until-EOS. Returns generated tokens [B, max_new_tokens]
    (positions after a sequence's EOS hold pad_token_id).

    With ``LMMS_OWC_KV_INT8`` on (:func:`kv_cache_int8_enabled`) the cache is
    quantized after the prefill and the decode runs on the int8 cache.

    Args:
        next_positions: [B] first M-RoPE position of the generated text per row.
        eos_ids: [num_eos] token ids that end a sequence.
        phase: optional ``phase(name)`` context-manager factory wrapped around
            the "prefill" and "decode" halves (the adapter's phase timer).
        decode_rows: run each decode step's products on blocks of this many
            rows (:func:`decode_step`'s ``rows``), so tokens do not depend on the batch.
    """
    phase = phase or (lambda name: nullcontext())
    l = input_embeds.shape[1]
    with phase("prefill"):
        logits, cache = prefill(model, input_embeds, position_ids, attention_mask, cache_len)
        if kv_int8_cache(model, input_embeds.device):
            cache = quantize_kv_cache(*cache)  # the decode-resident cache goes int8
    with phase("decode"):
        kv_mask = torch.zeros(
            (attention_mask.shape[0], cache_len), dtype=torch.int32, device=attention_mask.device
        )
        kv_mask[:, :l] = attention_mask
        return _decode_loop(
            model, logits, cache, kv_mask, next_positions, max_new_tokens, l, eos_ids,
            generator, do_sample, temperature, top_p, decode_rows,
        )


@torch.inference_mode()
def decode_pool(
    model: Qwen2VLModel,
    cache: tuple,
    logits0: torch.Tensor,
    kv_mask: torch.Tensor,
    next_positions: torch.Tensor,
    max_new_tokens: int,
    prompt_len: int,
    eos_ids: torch.Tensor,
    generator: torch.Generator | None = None,
    do_sample: bool = False,
    temperature: float = 1.0,
    top_p: float = 1.0,
    decode_rows: int | None = None,
) -> torch.Tensor:
    """Decode-until-EOS over a pooled cache (``LMMS_OWC_DECODE_POOL`` serving).

    ``cache`` comes from :func:`write_pool` (int8 with its scales for an
    int8 pool) and is updated in place; a float pool is quantized here
    when the int8 cache is on. ``prompt_len`` is the pool's common prompt
    bucket, the cache position of the first generated token; ``kv_mask``
    [B, S] marks the pool's valid prompt positions and is updated in place.
    ``decode_rows`` is :func:`greedy_generate`'s. Returns [B, max_new_tokens] tokens.
    """
    if kv_int8_cache(model, logits0.device) and len(cache) == 2:
        cache = quantize_kv_cache(*cache)
    return _decode_loop(
        model, logits0, cache, kv_mask, next_positions, max_new_tokens, prompt_len, eos_ids,
        generator, do_sample, temperature, top_p, decode_rows,
    )
