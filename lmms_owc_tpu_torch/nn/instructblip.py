"""InstructBLIP in PyTorch: BLIP ViT tower + instruction-aware Q-Former + Llama decoder.

Counterpart of :mod:`lmms_owc_tpu.nn.instructblip`. The learned query tokens
plus the tokenized instruction run through a BERT-style Q-Former with
cross-attention into the frozen vision features; the query outputs are
projected and prepended to the language embeddings.

The tower's attention is :func:`~lmms_owc_tpu_torch.ops.attention.flash_attention`
(K2 on the card; non-causal, no mask) over head-offset views of the fused
qkv projection, at BLIP ViT-g's head_dim 88 (1408 / 16), which K2 lays out
96 columns wide. The Q-Former's attention is plain torch math
(:func:`~lmms_owc_tpu_torch.ops.attention.attention_reference`), as the JAX
package leaves it to XLA (``attention_reference``), not Pallas: no kernel
and no library attention call runs there. The decoder is the port's
Llama/Vicuna decoder (:mod:`lmms_owc_tpu_torch.nn.llama`). The JAX package
stacks the tower's layers for ``lax.scan``; here each layer is its own module.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
from torch import nn

from lmms_owc_tpu_torch.nn.idefics2 import init_modules
from lmms_owc_tpu_torch.nn.layers import LayerNorm, Linear, gelu
from lmms_owc_tpu_torch.nn.llama import LlamaConfig, llama_config_from_hf
from lmms_owc_tpu_torch.nn.loader import find_tensor, load_hf_tensors
from lmms_owc_tpu_torch.nn.qwen2_vl import Qwen2VLModel, _copy, _load_linear, _load_norm, init_params, params_from_jax
from lmms_owc_tpu_torch.ops.attention import attention_reference, flash_attention

__all__ = [
    "BlipVisionConfig",
    "BlipVisionTower",
    "InstructBlipConfig",
    "InstructBlipModel",
    "QFormer",
    "QFormerConfig",
    "blip_vision_forward",
    "convert_hf_instructblip_weights",
    "encode_image_queries",
    "init_instructblip_params",
    "instructblip_config_from_hf",
    "instructblip_params_from_jax",
    "qformer_forward",
]

_PREFIXES = ("", "model.")


@dataclass(frozen=True)
class BlipVisionConfig:
    hidden_size: int = 1408
    num_layers: int = 39
    num_heads: int = 16
    intermediate_size: int = 6144
    image_size: int = 224
    patch_size: int = 14
    layer_norm_eps: float = 1e-6


@dataclass(frozen=True)
class QFormerConfig:
    vocab_size: int = 30523
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    cross_attention_frequency: int = 2
    encoder_hidden_size: int = 1408
    layer_norm_eps: float = 1e-12


@dataclass(frozen=True)
class InstructBlipConfig:
    text: LlamaConfig = field(default_factory=LlamaConfig)
    vision: BlipVisionConfig = field(default_factory=BlipVisionConfig)
    qformer: QFormerConfig = field(default_factory=QFormerConfig)
    num_query_tokens: int = 32


def instructblip_config_from_hf(cfg: dict) -> InstructBlipConfig:
    vis = cfg.get("vision_config", {})
    qf = cfg.get("qformer_config", {})
    return InstructBlipConfig(
        text=llama_config_from_hf(cfg["text_config"]),
        vision=BlipVisionConfig(
            hidden_size=vis.get("hidden_size", 1408),
            num_layers=vis.get("num_hidden_layers", 39),
            num_heads=vis.get("num_attention_heads", 16),
            intermediate_size=vis.get("intermediate_size", 6144),
            image_size=vis.get("image_size", 224),
            patch_size=vis.get("patch_size", 14),
            layer_norm_eps=vis.get("layer_norm_eps", 1e-6),
        ),
        qformer=QFormerConfig(
            vocab_size=qf.get("vocab_size", 30523),
            hidden_size=qf.get("hidden_size", 768),
            num_layers=qf.get("num_hidden_layers", 12),
            num_heads=qf.get("num_attention_heads", 12),
            intermediate_size=qf.get("intermediate_size", 3072),
            max_position_embeddings=qf.get("max_position_embeddings", 512),
            cross_attention_frequency=qf.get("cross_attention_frequency", 2),
            encoder_hidden_size=qf.get("encoder_hidden_size", 1408),
            layer_norm_eps=qf.get("layer_norm_eps", 1e-12),
        ),
        num_query_tokens=cfg.get("num_query_tokens", 32),
    )


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


# ======================================================================= vision


class BlipLayer(nn.Module):
    """Pre-LN block: the fused qkv projection, the output projection and the exact-GELU MLP."""

    def __init__(self, c: BlipVisionConfig, dtype, device) -> None:
        super().__init__()
        e, eps = c.hidden_size, c.layer_norm_eps
        self.ln1 = LayerNorm(e, eps, dtype, device)
        self.ln2 = LayerNorm(e, eps, dtype, device)
        self.qkv = Linear(e, 3 * e, True, dtype, device)
        self.proj = Linear(e, e, True, dtype, device)
        self.fc1 = Linear(e, c.intermediate_size, True, dtype, device)
        self.fc2 = Linear(c.intermediate_size, e, True, dtype, device)


# Port layer roles -> HF InstructBlipEncoderLayer names.
_HF_VISION_ROLES = {"ln1": "layer_norm1", "ln2": "layer_norm2", "qkv": "self_attn.qkv",
                    "proj": "self_attn.projection", "fc1": "mlp.fc1", "fc2": "mlp.fc2"}


class BlipVisionTower(nn.Module):
    """BLIP ViT: the conv patch embedding as a ``Linear`` over flattened
    ``[3 * p * p]`` patches (``patch_embed``, kept in full precision by the
    quantizers), the class embedding, the position table, the encoder layers
    and the post-LN. Parameters are uninitialised until filled."""

    def __init__(self, config: BlipVisionConfig, dtype=torch.float32, device="cpu") -> None:
        super().__init__()
        c, e = config, config.hidden_size
        self.config = config
        self.patch_embed = Linear(3 * c.patch_size**2, e, True, dtype, device)
        self.class_embedding = _param((e,), dtype, device)
        self.position_embedding = _param(((c.image_size // c.patch_size) ** 2 + 1, e), dtype, device)
        self.layers = nn.ModuleList(BlipLayer(c, dtype, device) for _ in range(c.num_layers))
        self.post_ln = LayerNorm(e, c.layer_norm_eps, dtype, device)

    @property
    def dtype(self) -> torch.dtype:
        return self.position_embedding.dtype

    def hf_tensor(self, state, name: str) -> torch.Tensor:
        """The HF ``vision_model.*`` tensor of parameter ``name``."""
        parts = name.split(".")
        base = "vision_model"
        if parts[0] == "layers":
            return find_tensor(state, f"{base}.encoder.layers.{parts[1]}.{_HF_VISION_ROLES[parts[2]]}.{parts[3]}",
                               _PREFIXES)
        if parts[0] == "patch_embed":
            t = find_tensor(state, f"{base}.embeddings.patch_embedding.{parts[1]}", _PREFIXES)
            return t.reshape(t.shape[0], -1) if parts[1] == "weight" else t  # [E, 3, p, p] -> [E, 3*p*p]
        if parts[0] == "post_ln":
            return find_tensor(state, f"{base}.post_layernorm.{parts[1]}", _PREFIXES)
        t = find_tensor(state, f"{base}.embeddings.{parts[0]}", _PREFIXES)  # class / position embedding, [1, N, E]
        return t.reshape(-1) if parts[0] == "class_embedding" else t.reshape(-1, t.shape[-1])


@torch.inference_mode()
def blip_vision_forward(tower: BlipVisionTower, pixel_values: torch.Tensor, config: BlipVisionConfig) -> torch.Tensor:
    """BLIP ViT -> post-LN hidden states [B, 1+P, E]."""
    b = pixel_values.shape[0]
    p, e = config.patch_size, config.hidden_size
    nh = config.num_heads
    hd = e // nh
    gh, gw = pixel_values.shape[2] // p, pixel_values.shape[3] // p
    x = pixel_values.to(tower.dtype).reshape(b, 3, gh, p, gw, p).permute(0, 2, 4, 1, 3, 5).reshape(b, -1, 3 * p * p)
    x = tower.patch_embed(x)
    cls = tower.class_embedding.to(x.dtype)[None, None].expand(b, 1, e)
    x = torch.cat([cls, x], dim=1)
    x = x + tower.position_embedding[None, : x.shape[1]].to(x.dtype)
    for layer in tower.layers:
        l = x.shape[1]
        qkv = layer.qkv(layer.ln1(x)).view(b, l, 3, nh, hd)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # head-offset views, no copies
        attn = flash_attention(q, k, v)
        x = x + layer.proj(attn.transpose(1, 2).reshape(b, l, e))
        x = x + layer.fc2(gelu(layer.fc1(layer.ln2(x))))
    return tower.post_ln(x)


# ====================================================================== qformer


class BertAttention(nn.Module):
    """q/k/v/o projections of one Q-Former attention (k and v read ``kv_dim`` wide sources)."""

    def __init__(self, h: int, kv_dim: int, dtype, device) -> None:
        super().__init__()
        self.q = Linear(h, h, True, dtype, device)
        self.k = Linear(kv_dim, h, True, dtype, device)
        self.v = Linear(kv_dim, h, True, dtype, device)
        self.o = Linear(h, h, True, dtype, device)


class QFormerLayer(nn.Module):
    def __init__(self, qf: QFormerConfig, cross: bool, dtype, device) -> None:
        super().__init__()
        h, inter, eps = qf.hidden_size, qf.intermediate_size, qf.layer_norm_eps
        self.self_attn = BertAttention(h, h, dtype, device)
        self.self_ln = LayerNorm(h, eps, dtype, device)
        if cross:
            self.cross_attn = BertAttention(h, qf.encoder_hidden_size, dtype, device)
            self.cross_ln = LayerNorm(h, eps, dtype, device)
        else:
            self.cross_attn = self.cross_ln = None
        self.intermediate = Linear(h, inter, True, dtype, device)
        self.output = Linear(inter, h, True, dtype, device)
        self.output_ln = LayerNorm(h, eps, dtype, device)
        self.intermediate_query = Linear(h, inter, True, dtype, device)
        self.output_query = Linear(inter, h, True, dtype, device)
        self.output_query_ln = LayerNorm(h, eps, dtype, device)


# Port Q-Former roles -> HF InstructBlipQFormerLayer names.
_HF_QFORMER_ROLES = {
    "self_attn.q": "attention.attention.query", "self_attn.k": "attention.attention.key",
    "self_attn.v": "attention.attention.value", "self_attn.o": "attention.output.dense",
    "self_ln": "attention.output.LayerNorm",
    "cross_attn.q": "crossattention.attention.query", "cross_attn.k": "crossattention.attention.key",
    "cross_attn.v": "crossattention.attention.value", "cross_attn.o": "crossattention.output.dense",
    "cross_ln": "crossattention.output.LayerNorm",
    "intermediate": "intermediate.dense", "output": "output.dense", "output_ln": "output.LayerNorm",
    "intermediate_query": "intermediate_query.dense", "output_query": "output_query.dense",
    "output_query_ln": "output_query.LayerNorm",
}


class QFormer(nn.Module):
    """The Q-Former: word and position embeddings with their LayerNorm, the
    learned query tokens, and the layers (cross-attention every
    ``cross_attention_frequency`` layers, from the first)."""

    def __init__(self, qf: QFormerConfig, num_query_tokens: int, dtype, device) -> None:
        super().__init__()
        h = qf.hidden_size
        self.word_embeddings = _param((qf.vocab_size, h), dtype, device)
        self.position_embeddings = _param((qf.max_position_embeddings, h), dtype, device)
        self.embeddings_ln = LayerNorm(h, qf.layer_norm_eps, dtype, device)
        self.query_tokens = _param((num_query_tokens, h), dtype, device)
        self.layers = nn.ModuleList(
            QFormerLayer(qf, i % qf.cross_attention_frequency == 0, dtype, device) for i in range(qf.num_layers)
        )

    def hf_tensor(self, state, name: str) -> torch.Tensor:
        """The HF ``qformer.*`` (or ``query_tokens``) tensor of parameter ``name``."""
        parts = name.split(".")
        if parts[0] == "layers":
            role = ".".join(parts[2:-1])
            return find_tensor(state, f"qformer.encoder.layer.{parts[1]}.{_HF_QFORMER_ROLES[role]}.{parts[-1]}",
                               _PREFIXES)
        if parts[0] == "query_tokens":
            t = find_tensor(state, "query_tokens", _PREFIXES)  # [1, nq, h]
            return t.reshape(-1, t.shape[-1])
        hf = {"word_embeddings": "word_embeddings.weight", "position_embeddings": "position_embeddings.weight",
              "embeddings_ln": f"layernorm.{parts[-1]}"}[parts[0]]
        return find_tensor(state, f"qformer.embeddings.{hf}", _PREFIXES)


def _bert_attention(attn: BertAttention, hidden: torch.Tensor, kv_source: torch.Tensor, num_heads: int,
                    mask: torch.Tensor | None = None) -> torch.Tensor:
    """BERT-style attention block (before its residual LN), plain torch attention."""
    b, lq, _ = hidden.shape
    lk = kv_source.shape[1]
    q = attn.q(hidden)
    hd = q.shape[-1] // num_heads
    q = q.view(b, lq, num_heads, hd).transpose(1, 2)
    k = attn.k(kv_source).view(b, lk, num_heads, hd).transpose(1, 2)
    v = attn.v(kv_source).view(b, lk, num_heads, hd).transpose(1, 2)
    out = attention_reference(q, k, v, kv_mask=mask)
    return attn.o(out.transpose(1, 2).reshape(b, lq, -1))


@torch.inference_mode()
def qformer_forward(qformer: QFormer, instr_ids: torch.Tensor, instr_mask: torch.Tensor,
                    vision_states: torch.Tensor, config: QFormerConfig, num_query_tokens: int = 32) -> torch.Tensor:
    """Q-Former over [queries; instruction] with cross-attention into the
    vision states: the query positions' outputs [B, num_query_tokens, hidden]."""
    b = instr_ids.shape[0]
    nq = num_query_tokens
    word = qformer.word_embeddings[instr_ids]
    word = word + qformer.position_embeddings[: instr_ids.shape[1]][None]
    queries = qformer.query_tokens[None].expand(b, nq, word.shape[-1]).to(word.dtype)
    x = qformer.embeddings_ln(torch.cat([queries, word], dim=1))
    # Self-attention mask: queries always valid, the instruction right-padded.
    self_mask = torch.cat([torch.ones((b, nq), dtype=instr_mask.dtype, device=instr_mask.device), instr_mask], dim=1)
    for layer in qformer.layers:
        x = layer.self_ln(x + _bert_attention(layer.self_attn, x, x, config.num_heads, mask=self_mask))
        query_part, text_part = x[:, :nq], x[:, nq:]
        if layer.cross_attn is not None:
            cross = _bert_attention(layer.cross_attn, query_part, vision_states, config.num_heads)
            query_part = layer.cross_ln(query_part + cross)
        q_ffn = layer.output_query(gelu(layer.intermediate_query(query_part)))
        query_part = layer.output_query_ln(query_part + q_ffn)
        t_ffn = layer.output(gelu(layer.intermediate(text_part)))
        text_part = layer.output_ln(text_part + t_ffn)
        x = torch.cat([query_part, text_part], dim=1)
    return x[:, :nq]


# ======================================================================== model


class InstructBlipModel(nn.Module):
    """The Vicuna decoder (``text``: a text-only :class:`Qwen2VLModel` without
    attention biases), the BLIP tower (``vision``), the Q-Former and the
    language projection: the JAX adapter's parameter tree as one module tree.
    Parameters are uninitialised until :func:`init_instructblip_params`,
    :func:`convert_hf_instructblip_weights` or
    :func:`instructblip_params_from_jax` fills them."""

    def __init__(self, config: InstructBlipConfig, dtype=torch.bfloat16, device="cpu") -> None:
        super().__init__()
        self.config = config
        self.text = Qwen2VLModel(config.text.to_decoder_config(), dtype, device, text_only=True, attn_bias=False)
        self.vision = BlipVisionTower(config.vision, dtype, device)
        self.qformer = QFormer(config.qformer, config.num_query_tokens, dtype, device)
        self.language_projection = Linear(config.qformer.hidden_size, config.text.hidden_size, True, dtype, device)

    @property
    def dtype(self) -> torch.dtype:
        return self.text.dtype

    def hf_tensor(self, state, name: str) -> torch.Tensor:
        """The HF ``InstructBlipForConditionalGeneration`` tensor of parameter ``name``."""
        head, _, rest = name.partition(".")
        if head == "text":
            return self.text.hf_tensor(state, rest)
        if head in ("vision", "qformer"):
            return getattr(self, head).hf_tensor(state, rest)
        return find_tensor(state, f"language_projection.{rest}", _PREFIXES)


@torch.inference_mode()
def encode_image_queries(model: InstructBlipModel, pixel_values: torch.Tensor, instr_ids: torch.Tensor,
                         instr_mask: torch.Tensor, config: InstructBlipConfig) -> torch.Tensor:
    """Pixels + instruction -> projected language-space query embeddings [B, nq, H]."""
    vision = blip_vision_forward(model.vision, pixel_values, config.vision)
    queries = qformer_forward(model.qformer, instr_ids, instr_mask, vision, config.qformer,
                              num_query_tokens=config.num_query_tokens)
    return model.language_projection(queries)


# ====================================================================== weights


@torch.no_grad()
def init_instructblip_params(config: InstructBlipConfig, generator: torch.Generator,
                             dtype=torch.bfloat16) -> InstructBlipModel:
    """A random-init model on the generator's device, in the JAX
    ``init_instructblip_params`` distribution (the values differ): weights,
    embeddings, the class embedding and the query tokens ~ N(0, 1) * 0.02,
    biases zero, norm scales one."""
    model = InstructBlipModel(config, dtype, generator.device)
    init_params(model.text, generator)
    for part in (model.vision, model.qformer, model.language_projection):
        init_modules(part, generator)
    for t in (model.vision.class_embedding, model.vision.position_embedding, model.qformer.word_embeddings,
              model.qformer.position_embeddings, model.qformer.query_tokens):
        t.copy_((torch.randn(t.shape, generator=generator, device=t.device) * 0.02).to(dtype))
    return model


def convert_hf_instructblip_weights(state, config: InstructBlipConfig, dtype=torch.bfloat16,
                                    device="cpu") -> InstructBlipModel:
    """A model filled from an HF InstructBLIP checkpoint's tensors (``state``
    from :func:`~lmms_owc_tpu_torch.nn.loader.load_safetensors_state`), cast to ``dtype``."""
    return load_hf_tensors(InstructBlipModel(config, dtype, device), state)


def _load_attention(attn: BertAttention, tree: dict) -> None:
    for role in ("q", "k", "v", "o"):
        _load_linear(attn, role, tree[role])


@torch.no_grad()
def instructblip_params_from_jax(tree: dict, config: InstructBlipConfig, dtype=torch.float32,
                                 device="cpu") -> InstructBlipModel:
    """A model filled from the JAX package's InstructBLIP tree
    (``init_instructblip_params`` / ``convert_hf_instructblip_weights``, leaves
    as numpy arrays, float or int8/int4; a quantized leaf replaces its float
    ``Linear``)."""
    model = InstructBlipModel(config, dtype, device)
    params_from_jax(model.text, tree["text"])
    vt, tower = tree["vision"], model.vision
    _load_linear(tower, "patch_embed", vt["patch_embed"])
    _copy(tower.class_embedding, np.asarray(vt["class_embedding"], np.float32))
    _copy(tower.position_embedding, np.asarray(vt["position_embedding"], np.float32))
    lt = vt["layers"]
    for i, layer in enumerate(tower.layers):
        _load_norm(layer.ln1, lt["ln1"], i)
        _load_norm(layer.ln2, lt["ln2"], i)
        for role in ("qkv", "proj", "fc1", "fc2"):
            _load_linear(layer, role, lt[role], i)
    _load_norm(tower.post_ln, vt["post_ln"])
    qt, qformer = tree["qformer"], model.qformer
    for name in ("word_embeddings", "position_embeddings", "query_tokens"):
        _copy(getattr(qformer, name), np.asarray(qt[name], np.float32))
    _load_norm(qformer.embeddings_ln, qt["embeddings_ln"])
    for layer, jt in zip(qformer.layers, qt["layers"], strict=True):
        _load_attention(layer.self_attn, jt["self_attn"])
        if layer.cross_attn is not None:
            _load_attention(layer.cross_attn, jt["cross_attn"])
            _load_norm(layer.cross_ln, jt["cross_ln"])
        for role in ("intermediate", "output", "intermediate_query", "output_query"):
            _load_linear(layer, role, jt[role])
        for norm in ("self_ln", "output_ln", "output_query_ln"):
            _load_norm(getattr(layer, norm), jt[norm])
    _load_linear(model, "language_projection", tree["language_projection"])
    return model
