"""Idefics2 in PyTorch: SigLIP vision tower + perceiver resampler connector + Mistral decoder.

Counterpart of :mod:`lmms_owc_tpu.nn.idefics2`. Vision features are projected
by a SwiGLU modality projection, then compressed to ``n_latents`` tokens by a
perceiver resampler (latents attend to [context; latents]) and spliced into
the Mistral sequence. The SigLIP tower (:class:`SiglipVisionTower`,
:func:`siglip_vision_forward`) also serves LLaVA-OneVision, with plain arange
positions and no connector.

The tower's attention is :func:`~lmms_owc_tpu_torch.ops.attention.flash_attention`
(K2 on the card) at SigLIP's head_dim 72 (1152 / 16), with a padded batch's
``patch_mask`` as its gappy tensor mask. The resampler's attention is plain
torch math (:func:`~lmms_owc_tpu_torch.ops.attention.gqa_attention_reference`:
16 query heads over 4 KV heads of 96), as the JAX package leaves it to XLA
(``attention_reference``), not Pallas. The JAX package stacks the tower's
layers for ``lax.scan``; here each layer is its own module.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lmms_owc_tpu_torch.nn.layers import LayerNorm, Linear, RMSNorm
from lmms_owc_tpu_torch.nn.llama import LlamaConfig, llama_config_from_hf
from lmms_owc_tpu_torch.nn.loader import find_tensor, load_hf_tensors
from lmms_owc_tpu_torch.nn.qwen2_vl import Qwen2VLModel, _copy, _load_linear, _load_norm, init_params, params_from_jax
from lmms_owc_tpu_torch.ops.attention import flash_attention, gqa_attention_reference

__all__ = [
    "Idefics2Config",
    "Idefics2Model",
    "PerceiverConfig",
    "SiglipVisionConfig",
    "SiglipVisionTower",
    "convert_hf_idefics2_weights",
    "encode_images",
    "hf_projection_dim",
    "idefics2_config_from_hf",
    "idefics2_params_from_jax",
    "init_idefics2_params",
    "init_modules",
    "init_siglip_params",
    "siglip_params_from_jax",
    "siglip_vision_forward",
    "variable_patch_layout",
]

# Where HF Idefics2 checkpoints keep the tower and the connector.
_PREFIXES = ("model.", "")


def variable_patch_layout(
    dims: list[tuple[int, int]], grid_hw: tuple[int, int], num_side: int, patch_size: int
):
    """HF variable-aspect layout (modeling_idefics2.Idefics2VisionEmbeddings:136-166).

    For images of pixel dims ``(h, w)`` padded bottom/right into a common grid of
    ``grid_hw`` patches: a patch is valid iff fully covered by real pixels, and
    position ids come from fractional coordinates bucketized over ``num_side``
    boundaries (torch.bucketize(right=True) == np.searchsorted(side='left')).

    Returns (position_ids [N, gh*gw] int64, patch_mask [N, gh*gw] int32).
    """
    gh, gw = grid_hw
    n = len(dims)
    patch_mask = np.zeros((n, gh * gw), np.int32)
    position_ids = np.zeros((n, gh * gw), np.int64)
    boundaries = np.arange(1 / num_side, 1.0, 1 / num_side)
    for i, (h, w) in enumerate(dims):
        nph, npw = h // patch_size, w // patch_size
        grid = np.zeros((gh, gw), bool)
        grid[:nph, :npw] = True
        patch_mask[i] = grid.reshape(-1)
        bh = np.searchsorted(boundaries, np.arange(nph) / nph * (1 - 1e-6), side="left")
        bw = np.searchsorted(boundaries, np.arange(npw) / npw * (1 - 1e-6), side="left")
        position_ids[i][grid.reshape(-1)] = (bh[:, None] * num_side + bw[None, :]).reshape(-1)
    return position_ids, patch_mask


@dataclass(frozen=True)
class SiglipVisionConfig:
    hidden_size: int = 1152
    num_layers: int = 27
    num_heads: int = 16
    intermediate_size: int = 4304
    image_size: int = 980
    patch_size: int = 14
    layer_norm_eps: float = 1e-6

    @property
    def num_positions(self) -> int:
        return (self.image_size // self.patch_size) ** 2


@dataclass(frozen=True)
class PerceiverConfig:
    n_latents: int = 64
    depth: int = 3
    n_heads: int = 16
    head_dim: int = 96
    num_kv_heads: int = 4
    rms_norm_eps: float = 1e-6


@dataclass(frozen=True)
class Idefics2Config:
    text: LlamaConfig = field(default_factory=LlamaConfig)
    vision: SiglipVisionConfig = field(default_factory=SiglipVisionConfig)
    perceiver: PerceiverConfig = field(default_factory=PerceiverConfig)
    image_token_id: int = 32001


def idefics2_config_from_hf(cfg: dict) -> Idefics2Config:
    vis = cfg.get("vision_config", {})
    per = cfg.get("perceiver_config", {})
    text = llama_config_from_hf(cfg["text_config"])
    return Idefics2Config(
        text=text,
        vision=SiglipVisionConfig(
            hidden_size=vis.get("hidden_size", 1152),
            num_layers=vis.get("num_hidden_layers", 27),
            num_heads=vis.get("num_attention_heads", 16),
            intermediate_size=vis.get("intermediate_size", 4304),
            image_size=vis.get("image_size", 980),
            patch_size=vis.get("patch_size", 14),
            layer_norm_eps=vis.get("layer_norm_eps", 1e-6),
        ),
        perceiver=PerceiverConfig(
            n_latents=per.get("resampler_n_latents", 64),
            depth=per.get("resampler_depth", 3),
            n_heads=per.get("resampler_n_heads", 16),
            head_dim=per.get("resampler_head_dim", 96),
            num_kv_heads=per.get("num_key_value_heads", 4),
            rms_norm_eps=per.get("rms_norm_eps", 1e-6),
        ),
        image_token_id=cfg.get("image_token_id", 32001),
    )


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


class SiglipLayer(nn.Module):
    """Pre-LN block: q/k/v/o projections with biases, gelu-tanh MLP."""

    def __init__(self, e: int, inter: int, eps: float, dtype, device) -> None:
        super().__init__()
        self.ln1 = LayerNorm(e, eps, dtype, device)
        self.ln2 = LayerNorm(e, eps, dtype, device)
        self.q = Linear(e, e, True, dtype, device)
        self.k = Linear(e, e, True, dtype, device)
        self.v = Linear(e, e, True, dtype, device)
        self.o = Linear(e, e, True, dtype, device)
        self.fc1 = Linear(e, inter, True, dtype, device)
        self.fc2 = Linear(inter, e, True, dtype, device)


# Port layer roles -> HF SiglipEncoderLayer names.
_HF_LAYER_ROLES = {
    "ln1": "layer_norm1", "ln2": "layer_norm2", "q": "self_attn.q_proj", "k": "self_attn.k_proj",
    "v": "self_attn.v_proj", "o": "self_attn.out_proj", "fc1": "mlp.fc1", "fc2": "mlp.fc2",
}


class SiglipVisionTower(nn.Module):
    """SigLIP ViT (no CLS token): the conv patch embedding as a ``Linear`` with
    bias over flattened ``[3 * p * p]`` patches (named ``patch_embed``, which
    the quantizers leave in full precision), the position table, the encoder
    layers and the post-LN. Parameters are uninitialised until filled."""

    def __init__(self, config: SiglipVisionConfig, dtype=torch.float32, device="cpu") -> None:
        super().__init__()
        c, e = config, config.hidden_size
        self.config = config
        self.patch_embed = Linear(3 * c.patch_size**2, e, True, dtype, device)
        self.position_embedding = _param((c.num_positions, e), dtype, device)
        self.layers = nn.ModuleList(
            SiglipLayer(e, c.intermediate_size, c.layer_norm_eps, dtype, device) for _ in range(c.num_layers)
        )
        self.post_ln = LayerNorm(e, c.layer_norm_eps, dtype, device)

    @property
    def dtype(self) -> torch.dtype:
        return self.position_embedding.dtype

    def hf_tensor(self, state, name: str, prefixes: tuple[str, ...] = _PREFIXES) -> torch.Tensor:
        """The HF ``vision_model.*`` tensor of parameter ``name`` under one of ``prefixes``."""
        parts = name.split(".")
        base = "vision_model"
        if parts[0] == "layers":
            hf = f"{base}.encoder.layers.{parts[1]}.{_HF_LAYER_ROLES[parts[2]]}.{parts[3]}"
        elif parts[0] == "patch_embed":
            t = find_tensor(state, f"{base}.embeddings.patch_embedding.{parts[1]}", prefixes)
            return t.reshape(t.shape[0], -1) if parts[1] == "weight" else t  # [E, 3, p, p] -> [E, 3*p*p]
        else:
            hf = {
                "position_embedding": f"{base}.embeddings.position_embedding.weight",
                "post_ln": f"{base}.post_layernorm.{parts[-1]}",
            }[parts[0]]
        return find_tensor(state, hf, prefixes)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


@torch.inference_mode()
def siglip_vision_forward(
    tower: SiglipVisionTower,
    pixel_values: torch.Tensor,
    config: SiglipVisionConfig,
    bucket_positions: bool = True,
    position_ids: torch.Tensor | None = None,
    patch_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """SigLIP ViT (no CLS token) -> post-LN hidden states [B, P, E].

    Variable-aspect Idefics2 semantics (HF modeling_idefics2.Idefics2VisionEmbeddings):
    pass ``position_ids`` [B, P] (host-computed fractional-coordinate buckets) and
    ``patch_mask`` [B, P] (1 = real patch) for batches padded to a common H x W;
    the mask goes to K2 as its gappy tensor form. Without them,
    ``bucket_positions=True`` reproduces the full-grid special case (position
    id max(i-1, 0) per axis); False uses plain arange positions (the standard
    SigLIP of LLaVA-OneVision).
    """
    b = pixel_values.shape[0]
    p, e = config.patch_size, config.hidden_size
    nh = config.num_heads
    hd = e // nh
    grid_h, grid_w = pixel_values.shape[2] // p, pixel_values.shape[3] // p
    x = pixel_values[:, :, : grid_h * p, : grid_w * p].to(tower.dtype).reshape(b, 3, grid_h, p, grid_w, p)
    x = tower.patch_embed(x.permute(0, 2, 4, 1, 3, 5).reshape(b, -1, 3 * p * p))
    table = tower.position_embedding
    if position_ids is not None:
        x = x + table[position_ids.to(table.device)].to(x.dtype)
    elif bucket_positions:
        num_side = int(round(table.shape[0] ** 0.5))
        h_ids = np.maximum(np.arange(grid_h) - 1, 0)
        w_ids = np.maximum(np.arange(grid_w) - 1, 0)
        pos_ids = torch.from_numpy((h_ids[:, None] * num_side + w_ids[None, :]).reshape(-1)).to(table.device)
        x = x + table[pos_ids][None].to(x.dtype)
    else:
        x = x + table[None, : x.shape[1], :].to(x.dtype)
    mask = patch_mask.to(x.device) if patch_mask is not None else None
    for layer in tower.layers:
        l = x.shape[1]
        normed = layer.ln1(x)
        q = layer.q(normed).view(b, l, nh, hd).transpose(1, 2)
        k = layer.k(normed).view(b, l, nh, hd).transpose(1, 2)
        v = layer.v(normed).view(b, l, nh, hd).transpose(1, 2)
        attn = flash_attention(q, k, v, kv_mask=mask)
        x = x + layer.o(attn.transpose(1, 2).reshape(b, l, e))
        x = x + layer.fc2(_gelu_tanh(layer.fc1(layer.ln2(x))))
    return tower.post_ln(x)


# ------------------------------------------------------------------ connector


class SwiGLU(nn.Module):
    """``down(silu(gate(x)) * up(x))`` over bias-free projections (the JAX ``mlp_swiglu``)."""

    def __init__(self, d_in: int, inter: int, d_out: int, dtype, device) -> None:
        super().__init__()
        self.gate = Linear(d_in, inter, False, dtype, device)
        self.up = Linear(d_in, inter, False, dtype, device)
        self.down = Linear(inter, d_out, False, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(F.silu(self.gate(x)) * self.up(x))


class PerceiverLayer(nn.Module):
    def __init__(self, h: int, per: PerceiverConfig, dtype, device) -> None:
        super().__init__()
        eps = per.rms_norm_eps
        self.input_latents_norm = RMSNorm(h, eps, dtype, device)
        self.input_context_norm = RMSNorm(h, eps, dtype, device)
        self.q = Linear(h, per.n_heads * per.head_dim, False, dtype, device)
        self.k = Linear(h, per.num_kv_heads * per.head_dim, False, dtype, device)
        self.v = Linear(h, per.num_kv_heads * per.head_dim, False, dtype, device)
        self.o = Linear(per.n_heads * per.head_dim, h, False, dtype, device)
        self.post_ln = RMSNorm(h, eps, dtype, device)
        self.mlp = SwiGLU(h, 4 * h, h, dtype, device)


class Perceiver(nn.Module):
    def __init__(self, h: int, per: PerceiverConfig, dtype, device) -> None:
        super().__init__()
        self.latents = _param((per.n_latents, h), dtype, device)
        self.layers = nn.ModuleList(PerceiverLayer(h, per, dtype, device) for _ in range(per.depth))
        self.norm = RMSNorm(h, per.rms_norm_eps, dtype, device)


# Port perceiver roles -> HF Idefics2PerceiverLayer names.
_HF_PERCEIVER_ROLES = {
    "input_latents_norm": "input_latents_norm", "input_context_norm": "input_context_norm",
    "q": "self_attn.q_proj", "k": "self_attn.k_proj", "v": "self_attn.v_proj", "o": "self_attn.o_proj",
    "post_ln": "post_attention_layernorm", "mlp": "mlp",
}


class Idefics2Model(nn.Module):
    """The decoder (``text``: a text-only :class:`Qwen2VLModel` over the Mistral
    config, no attention biases), the SigLIP tower (``vision``), the modality
    projection and the perceiver resampler. Parameters are uninitialised until
    :func:`init_idefics2_params`, :func:`convert_hf_idefics2_weights` or
    :func:`idefics2_params_from_jax` fills them. ``projection_dim`` is the
    modality projection's inner width: the text hidden size by default (the
    JAX ``init_idefics2_params`` shape); a checkpoint's own width
    (:func:`hf_projection_dim`, the text intermediate size in HF's
    ``Idefics2Connector``) when loading one."""

    def __init__(self, config: Idefics2Config, dtype=torch.bfloat16, device="cpu",
                 projection_dim: int | None = None) -> None:
        super().__init__()
        self.config = config
        h, e = config.text.hidden_size, config.vision.hidden_size
        self.text = Qwen2VLModel(config.text.to_decoder_config(), dtype, device, text_only=True, attn_bias=False)
        self.vision = SiglipVisionTower(config.vision, dtype, device)
        self.modality_projection = SwiGLU(e, projection_dim or h, h, dtype, device)
        self.perceiver = Perceiver(h, config.perceiver, dtype, device)

    @property
    def dtype(self) -> torch.dtype:
        return self.text.dtype

    def hf_tensor(self, state, name: str) -> torch.Tensor:
        """The HF ``Idefics2ForConditionalGeneration`` tensor of parameter ``name``."""
        head, _, rest = name.partition(".")
        if head == "text":
            return self.text.hf_tensor(state, rest)
        if head == "vision":
            return self.vision.hf_tensor(state, rest)
        if head == "modality_projection":
            role, _, kind = rest.partition(".")
            return find_tensor(state, f"connector.modality_projection.{role}_proj.{kind}", _PREFIXES)
        base = "connector.perceiver_resampler"
        parts = rest.split(".")
        if parts[0] == "latents":
            return find_tensor(state, f"{base}.latents", _PREFIXES)
        if parts[0] == "norm":
            return find_tensor(state, f"{base}.norm.weight", _PREFIXES)
        role = _HF_PERCEIVER_ROLES[parts[2]]
        if parts[2] == "mlp":
            role = f"mlp.{parts[3]}_proj"
        return find_tensor(state, f"{base}.layers.{parts[1]}.{role}.weight", _PREFIXES)


@torch.inference_mode()
def encode_images(
    model: Idefics2Model,
    pixel_values: torch.Tensor,
    config: Idefics2Config,
    position_ids: torch.Tensor | None = None,
    patch_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Pixels [N, 3, H, W] -> resampled vision tokens [N, n_latents, H_text].

    ``position_ids`` / ``patch_mask`` enable HF-exact variable-aspect batches
    (images padded bottom/right to a common H x W); the tower's attention and
    the perceiver's latents then attend only to real patches.
    """
    per = config.perceiver
    vision = siglip_vision_forward(
        model.vision, pixel_values, config.vision, position_ids=position_ids, patch_mask=patch_mask
    )
    context = model.modality_projection(vision)
    n = context.shape[0]
    latents = model.perceiver.latents[None].expand(n, per.n_latents, context.shape[-1]).to(context.dtype)
    kv_mask = None
    if patch_mask is not None:
        ones = torch.ones((n, per.n_latents), dtype=torch.int32, device=context.device)
        kv_mask = torch.cat([patch_mask.to(device=context.device, dtype=torch.int32), ones], dim=1)
    for layer in model.perceiver.layers:
        residual = latents
        lat_n = layer.input_latents_norm(latents)
        ctx_n = layer.input_context_norm(context)
        kv_src = torch.cat([ctx_n, lat_n], dim=1)
        lk = kv_src.shape[1]
        q = layer.q(lat_n).view(n, per.n_latents, per.n_heads, per.head_dim).transpose(1, 2)
        k = layer.k(kv_src).view(n, lk, per.num_kv_heads, per.head_dim).transpose(1, 2)
        v = layer.v(kv_src).view(n, lk, per.num_kv_heads, per.head_dim).transpose(1, 2)
        out = gqa_attention_reference(q, k, v, kv_mask=kv_mask)
        latents = residual + layer.o(out.transpose(1, 2).reshape(n, per.n_latents, -1))
        latents = latents + layer.mlp(layer.post_ln(latents))
    return model.perceiver.norm(latents)


# ====================================================================== weights


def _draw_fn(generator: torch.Generator):
    def draw(t: torch.Tensor) -> None:
        t.copy_((torch.randn(t.shape, generator=generator, device=t.device) * 0.02).to(t.dtype))

    return draw


@torch.no_grad()
def init_modules(root: nn.Module, generator: torch.Generator) -> None:
    """Linear weights ~ N(0, 1) * 0.02, biases zero, norm scales one."""
    draw = _draw_fn(generator)
    for module in root.modules():
        if isinstance(module, Linear):
            draw(module.weight)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, (LayerNorm, RMSNorm)):
            module.weight.fill_(1.0)
            if isinstance(module, LayerNorm):
                module.bias.zero_()


@torch.no_grad()
def init_siglip_params(tower: SiglipVisionTower, generator: torch.Generator) -> SiglipVisionTower:
    """Random-init ``tower`` in place on the generator's device (the JAX
    ``init_idefics2_params`` vision distribution; the values differ)."""
    init_modules(tower, generator)
    _draw_fn(generator)(tower.position_embedding)
    return tower


@torch.no_grad()
def init_idefics2_params(config: Idefics2Config, generator: torch.Generator, dtype=torch.bfloat16) -> Idefics2Model:
    """A random-init model on the generator's device: weights, the position
    table and the latents ~ N(0, 1) * 0.02, biases zero, norm scales one (the
    JAX ``init_idefics2_params`` distribution; the values differ)."""
    model = Idefics2Model(config, dtype, generator.device)
    init_params(model.text, generator)
    init_siglip_params(model.vision, generator)
    for part in (model.modality_projection, model.perceiver):
        init_modules(part, generator)
    _draw_fn(generator)(model.perceiver.latents)
    return model


def hf_projection_dim(state) -> int:
    """The modality projection's inner width in an HF Idefics2 checkpoint."""
    return int(find_tensor(state, "connector.modality_projection.gate_proj.weight", _PREFIXES).shape[0])


def convert_hf_idefics2_weights(state, config: Idefics2Config, dtype=torch.bfloat16, device="cpu") -> Idefics2Model:
    """A model filled from an HF Idefics2 checkpoint's tensors (``state`` from
    :func:`~lmms_owc_tpu_torch.nn.loader.load_safetensors_state`), cast to
    ``dtype``; every shape is the checkpoint's, as in the JAX converter."""
    return load_hf_tensors(Idefics2Model(config, dtype, device, hf_projection_dim(state)), state)


@torch.no_grad()
def siglip_params_from_jax(tower: SiglipVisionTower, tree: dict) -> SiglipVisionTower:
    """Fill ``tower`` in place from the JAX package's SigLIP tree (stacked
    ``[L, ...]`` leaves as numpy arrays, float or int8/int4; a quantized leaf
    replaces its float ``Linear``)."""
    _load_linear(tower, "patch_embed", tree["patch_embed"])
    _copy(tower.position_embedding, np.asarray(tree["position_embedding"], np.float32))
    lt = tree["layers"]
    for i, layer in enumerate(tower.layers):
        _load_norm(layer.ln1, lt["ln1"], i)
        _load_norm(layer.ln2, lt["ln2"], i)
        for role in ("q", "k", "v", "o"):
            _load_linear(layer, role, lt["attn"][role], i)
        for role in ("fc1", "fc2"):
            _load_linear(layer, role, lt[role], i)
    _load_norm(tower.post_ln, tree["post_ln"])
    return tower


@torch.no_grad()
def idefics2_params_from_jax(tree: dict, config: Idefics2Config, dtype=torch.float32, device="cpu") -> Idefics2Model:
    """A model filled from the JAX package's Idefics2 tree (``init_idefics2_params``
    / ``convert_hf_idefics2_weights``, leaves as numpy arrays, float or int8/int4)."""
    model = Idefics2Model(config, dtype, device, np.shape(tree["modality_projection"]["gate"]["w"])[-1])
    params_from_jax(model.text, tree["text"])
    siglip_params_from_jax(model.vision, tree["vision"])
    for role in ("gate", "up", "down"):
        _load_linear(model.modality_projection, role, tree["modality_projection"][role])
    pt = tree["perceiver"]
    _copy(model.perceiver.latents, np.asarray(pt["latents"], np.float32))
    for layer, lt in zip(model.perceiver.layers, pt["layers"], strict=True):
        for norm in ("input_latents_norm", "input_context_norm", "post_ln"):
            _load_norm(getattr(layer, norm), lt[norm])
        for role in ("q", "k", "v", "o"):
            _load_linear(layer, role, lt["attn"][role])
        for role in ("gate", "up", "down"):
            _load_linear(layer.mlp, role, lt["mlp"][role])
    _load_norm(model.perceiver.norm, pt["norm"])
    return model
