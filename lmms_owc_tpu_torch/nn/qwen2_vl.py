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
from contextlib import nullcontext
from dataclasses import dataclass, field
from itertools import chain

import numpy as np
import torch
from torch import nn

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

__all__ = [
    "Qwen2VLConfig",
    "Qwen2VLModel",
    "Qwen2VLVisionConfig",
    "VisionTower",
    "decode_pool",
    "decode_step",
    "embed_tokens",
    "get_rope_index",
    "greedy_generate",
    "init_params",
    "kv_cache_int8_enabled",
    "load_hf_weights",
    "mrope_cos_sin",
    "params_from_jax",
    "prefill",
    "prefill_logits",
    "quantize_kv_cache",
    "score_continuation",
    "vision_rope_cos_sin",
    "write_pool_chunk",
    "write_pool_scales",
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

    def mlp(self, x: torch.Tensor) -> torch.Tensor:
        """Gated MLP on the post-attention norm (``mlp_swiglu`` through the modules,
        so int8/int4 projections take their own dense)."""
        h = self.post_ln(x)
        return self.down(torch.nn.functional.silu(self.gate(h)) * self.up(h))


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


def mrope_cos_sin(position_ids: torch.Tensor, config: Qwen2VLConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Combine t/h/w rotary tables into [B, L, head_dim/2] cos/sin (f32).

    ``position_ids`` [3, B, L]; the result lives on its device. A config with
    ``rope_llama3`` scales the frequencies first; one with ``rope_longrope``
    divides them by its factors and multiplies cos and sin by its attention
    factor, so the factor reaches q and k in the prefill and every decode step.
    """
    hd2 = config.head_dim // 2
    exponent = torch.arange(0, hd2, dtype=torch.float32, device=position_ids.device) / hd2
    inv_freq = 1.0 / (config.rope_theta ** exponent)
    if config.rope_llama3 is not None:
        inv_freq = _llama3_scale_inv_freq(inv_freq, config.rope_llama3)
    if config.rope_longrope is not None:
        attention_factor, ext_factors = config.rope_longrope
        inv_freq = inv_freq / torch.tensor(ext_factors, dtype=torch.float32, device=inv_freq.device)
    freqs = position_ids[..., None].float() * inv_freq  # [3, B, L, hd/2]
    chunks = torch.split(freqs, list(config.mrope_section), dim=-1)
    combined = torch.cat([chunk[i % 3] for i, chunk in enumerate(chunks)], dim=-1)
    cos, sin = torch.cos(combined), torch.sin(combined)
    if config.rope_longrope is not None:  # no extra launches in the other families' decode steps
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
    where they need it). ``keep_kv(layer, k, v)`` receives each layer's
    rotated K and V, [B, KVH, L, D]."""
    c = model.config
    b, l, _ = input_embeds.shape
    cos, sin = mrope_cos_sin(position_ids, c)
    x = input_embeds
    for i, layer in enumerate(model.layers):
        q, k, v = _qkv(layer, layer.input_ln(x), c)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        if keep_kv is not None:
            keep_kv(i, k, v)
        # The padding mask is one contiguous run per row, so the kernel reads
        # it as (start, end) scalars.
        attn = flash_attention(q, k, v, causal=True, kv_mask=attention_mask, kv_mask_contiguous=True)
        x = x + layer.o(attn.transpose(1, 2).reshape(b, l, -1))
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
    Returns: (logits [B, vocab] f32 at the last position, (cache_k, cache_v), each
        [num_layers, B, KVH, cache_len, D] with positions >= L zero).
    """
    c = model.config
    b, l, _ = input_embeds.shape
    shape = (c.num_layers, b, model.kv_heads, cache_len, c.head_dim)
    cache_k = torch.zeros(shape, dtype=input_embeds.dtype, device=input_embeds.device)
    cache_v = torch.zeros_like(cache_k)

    def keep(i, k, v):
        cache_k[i, :, :, :l] = k
        cache_v[i, :, :, :l] = v

    x = _decoder_forward(model, input_embeds, position_ids, attention_mask, keep)
    x = model.final_norm(x[:, -1])  # left-padded: the last position is the newest token
    return _head_logits(model, x), (cache_k, cache_v)


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
    """Prefill for the decode pool: last-position logits and the UNPADDED KV,
    each [num_layers, B, KVH, L, D]; :func:`write_pool_chunk` places it."""
    logits, (ks, vs) = prefill(model, input_embeds, position_ids, attention_mask, input_embeds.shape[1])
    return logits, ks, vs


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


def write_pool_chunk(
    cache_k: torch.Tensor, cache_v: torch.Tensor, ks: torch.Tensor, vs: torch.Tensor,
    row_offset: int, front: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Write one chunk's prefill KV ([L, B_i, KVH, L_i, D], left-padded prompts)
    into the preallocated pool IN PLACE: rows from ``row_offset``, the sequence
    axis FRONT-padded by ``front`` to the pool's common prompt bucket (masked
    off by the caller's kv_mask like ordinary left padding). Peak memory is the
    pool plus one chunk. Returns the pool tensors."""
    b, l = ks.shape[1], ks.shape[3]
    cache_k[:, row_offset : row_offset + b, :, front : front + l] = ks
    cache_v[:, row_offset : row_offset + b, :, front : front + l] = vs
    return cache_k, cache_v


def write_pool_scales(
    scale_k: torch.Tensor, scale_v: torch.Tensor, sk: torch.Tensor, sv: torch.Tensor,
    row_offset: int, front: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Scale-pool companion of :func:`write_pool_chunk` for an int8 pool: one
    chunk's [L, B_i, KVH, S_i] scales, written in place at the same offsets.
    The token axis is axis 3 of the scales as of the cache (the JAX package's
    scales carry a TPU sublane axis before it), so this is the same write."""
    return write_pool_chunk(scale_k, scale_v, sk, sv, row_offset, front)


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
    int8 form (k_q, v_q, k_scale, v_scale) of :func:`quantize_kv_cache`. The new
    token's K and V (quantized per vector for an int8 cache, with their scales)
    are point-written IN PLACE at ``cache_pos``; the caller's cache tensors
    hold the update afterwards. ``kv_mask`` [B, S] must already mark
    ``cache_pos`` valid. With ``rows``, a row's logits do not depend on the
    batch: the layers (everything but the attention, which is per row
    already) and the head run on blocks of exactly ``rows`` rows
    (:func:`_row_blocks`) where their products' bits depend on the row count
    (:func:`row_invariant`), and otherwise (W8A8, K4) on at least
    ``REDUCE_ROWS`` rows, for the norms' reductions.
    """
    c = model.config
    cache_k, cache_v, *scales = cache
    b = token_ids.shape[0]
    layer_rows = head_rows = rows
    if rows is not None:
        layer0, head = model.layers[0], model.lm_head
        if all(row_invariant(lin, b) for lin in (layer0.q, layer0.k, layer0.v, layer0.o,
                                                 layer0.gate, layer0.up, layer0.down)):
            layer_rows = max(b, REDUCE_ROWS)
        # An int8 head multiplies in bf16 (``_head_logits``) even under W8A8.
        if isinstance(head, Int4Linear) and row_invariant(head, b):
            head_rows = max(b, REDUCE_ROWS)
    x = embed_tokens(model, token_ids)[:, None, :]
    cos, sin = mrope_cos_sin(position_ids, c)
    for i, layer in enumerate(model.layers):
        q, k, v = _row_blocks(lambda t: _qkv(layer, layer.input_ln(t), c), layer_rows, x)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        if scales:
            (kq, k_sc), (vq, v_sc) = _quantize_kv(k[:, :, 0]), _quantize_kv(v[:, :, 0])
            cache_k[i, :, :, cache_pos] = kq
            cache_v[i, :, :, cache_pos] = vq
            scales[0][i, :, :, cache_pos] = k_sc
            scales[1][i, :, :, cache_pos] = v_sc
        else:
            cache_k[i, :, :, cache_pos] = k[:, :, 0]
            cache_v[i, :, :, cache_pos] = v[:, :, 0]
        attn = gqa_decode_attention(q[:, :, 0], cache_k, cache_v, i, kv_mask, *scales)

        def post(t, a):
            t = t + layer.o(a)
            return t + layer.mlp(t)

        x = _row_blocks(post, layer_rows, x, attn.reshape(b, 1, -1))
    # The vocabulary gather takes the batch's rows only, not a row block's padding.
    logits = _row_blocks(lambda t: _local_head_logits(model, model.final_norm(t)), head_rows, x[:, 0])
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
    """
    c = model.config
    b = logits.shape[0]
    tokens = torch.full((b, max_new_tokens), c.pad_token_id, dtype=torch.long, device=logits.device)
    done = torch.zeros(b, dtype=torch.bool, device=logits.device)
    token = _sample_token(logits, generator, temperature, top_p, do_sample)
    for step in range(max_new_tokens):
        token = torch.where(done, torch.full_like(token, c.pad_token_id), token)
        tokens[:, step] = token
        done = done | torch.isin(token, eos_ids)
        if step + 1 == max_new_tokens or bool(done.all()):
            break
        pos = (next_positions + step)[None, :, None].expand(3, b, 1)
        kv_mask[:, prompt_len + step] = 1
        logits = decode_step(model, token, pos, cache, prompt_len + step, kv_mask, decode_rows)
        token = _sample_token(logits, generator, temperature, top_p, do_sample)
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
        if kv_cache_int8_enabled(input_embeds.device):
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

    ``cache`` comes from :func:`write_pool_chunk` (and :func:`write_pool_scales`
    for an int8 pool) and is updated in place; a float pool is quantized here
    when the int8 cache is on. ``prompt_len`` is the pool's common prompt
    bucket, the cache position of the first generated token; ``kv_mask``
    [B, S] marks the pool's valid prompt positions and is updated in place.
    ``decode_rows`` is :func:`greedy_generate`'s. Returns [B, max_new_tokens] tokens.
    """
    if kv_cache_int8_enabled(logits0.device) and len(cache) == 2:
        cache = quantize_kv_cache(*cache)
    return _decode_loop(
        model, logits0, cache, kv_mask, next_positions, max_new_tokens, prompt_len, eos_ids,
        generator, do_sample, temperature, top_p, decode_rows,
    )
