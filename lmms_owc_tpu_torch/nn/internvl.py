"""InternVL (2/2.5/3 "-hf" ports) in PyTorch: InternViT tower + pixel-shuffle projector
+ Qwen2/Llama decoder.

Counterpart of :mod:`lmms_owc_tpu.nn.internvl`. Dynamic aspect-ratio tiling
happens host-side in the adapter (:mod:`lmms_owc_tpu_torch.models.internvl2`);
each 448x448 tile runs through the InternViT encoder (layer-scale residuals,
optional QK RMSNorm over the full embed dim), is pixel-shuffle downsampled
2x2 and projected into the text embedding space.

The tower's attention is :func:`~lmms_owc_tpu_torch.ops.attention.flash_attention`
(K2 on the card; non-causal, no mask) at InternViT-300M's head_dim 64
(1024 / 16), which K2's general instance serves. The decoder is the port's
Llama/Qwen2 decoder (:mod:`lmms_owc_tpu_torch.nn.llama`): a text-only
:class:`~lmms_owc_tpu_torch.nn.qwen2_vl.Qwen2VLModel`. The JAX package stacks
the tower's layers for ``lax.scan``; here each layer is its own module.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
from torch import nn

from lmms_owc_tpu_torch.nn.idefics2 import init_modules
from lmms_owc_tpu_torch.nn.layers import LayerNorm, Linear, RMSNorm, gelu
from lmms_owc_tpu_torch.nn.llama import LlamaConfig, llama_config_from_hf
from lmms_owc_tpu_torch.nn.loader import find_tensor
from lmms_owc_tpu_torch.nn.qwen2_vl import Qwen2VLModel, _copy, _load_linear, _load_norm, init_params, params_from_jax
from lmms_owc_tpu_torch.ops.attention import flash_attention

__all__ = [
    "InternVLConfig",
    "InternVLModel",
    "InternVLVisionConfig",
    "InternViT",
    "encode_tiles",
    "has_final_ln",
    "init_internvl_params",
    "internvit_forward",
    "internvl_config_from_hf",
    "internvl_params_from_jax",
]

# Where HF InternVL ("-hf") checkpoints keep the tower and the projector.
_PREFIXES = ("model.", "")


@dataclass(frozen=True)
class InternVLVisionConfig:
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    image_size: int = 448
    patch_size: int = 14
    layer_norm_eps: float = 1e-6
    use_qk_norm: bool = False
    attention_bias: bool = False

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


@dataclass(frozen=True)
class InternVLConfig:
    text: LlamaConfig = field(default_factory=LlamaConfig)
    vision: InternVLVisionConfig = field(default_factory=InternVLVisionConfig)
    image_token_id: int = 151667
    downsample_ratio: float = 0.5
    vision_feature_select_strategy: str = "default"
    text_attn_bias: bool = True  # Qwen2 backbones carry qkv biases

    @property
    def tokens_per_tile(self) -> int:
        side = self.vision.image_size // self.vision.patch_size
        side = int(side * self.downsample_ratio)
        return side * side


def _first(value, default):
    """An HF size field, which the "-hf" configs may give as [h, w]."""
    value = default if value is None else value
    return value[0] if isinstance(value, list) else value


def internvl_config_from_hf(cfg: dict) -> InternVLConfig:
    text_cfg = cfg["text_config"]
    vis = cfg.get("vision_config", {})
    vision = InternVLVisionConfig(
        hidden_size=vis.get("hidden_size", 1024),
        num_layers=vis.get("num_hidden_layers", 24),
        num_heads=vis.get("num_attention_heads", 16),
        intermediate_size=vis.get("intermediate_size", 4096),
        image_size=_first(vis.get("image_size"), 448),
        patch_size=_first(vis.get("patch_size"), 14),
        layer_norm_eps=vis.get("layer_norm_eps", 1e-6),
        use_qk_norm=vis.get("use_qk_norm", False),
        attention_bias=vis.get("attention_bias", False),
    )
    return InternVLConfig(
        text=llama_config_from_hf(text_cfg),
        vision=vision,
        image_token_id=cfg.get("image_token_id", 151667),
        downsample_ratio=cfg.get("downsample_ratio", 0.5),
        vision_feature_select_strategy=cfg.get("vision_feature_select_strategy", "default"),
        text_attn_bias=text_cfg.get("model_type", "qwen2") == "qwen2",
    )


# ======================================================================= vision


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


class InternViTLayer(nn.Module):
    """Pre-LN block: separate q/k/v (biases with ``attention_bias``), the
    optional full-width QK RMSNorm, the output projection, the exact-GELU MLP
    and the ``lambda_1``/``lambda_2`` layer scales."""

    def __init__(self, c: InternVLVisionConfig, dtype, device) -> None:
        super().__init__()
        e, eps = c.hidden_size, c.layer_norm_eps
        self.ln_before = LayerNorm(e, eps, dtype, device)
        self.ln_after = LayerNorm(e, eps, dtype, device)
        self.q = Linear(e, e, c.attention_bias, dtype, device)
        self.k = Linear(e, e, c.attention_bias, dtype, device)
        self.v = Linear(e, e, c.attention_bias, dtype, device)
        self.o = Linear(e, e, True, dtype, device)
        if c.use_qk_norm:
            self.q_norm = RMSNorm(e, eps, dtype, device)
            self.k_norm = RMSNorm(e, eps, dtype, device)
        self.lambda_1 = _param((e,), dtype, device)
        self.lambda_2 = _param((e,), dtype, device)
        self.fc1 = Linear(e, c.intermediate_size, True, dtype, device)
        self.fc2 = Linear(c.intermediate_size, e, True, dtype, device)


# Port layer roles -> HF InternVLVisionLayer names.
_HF_LAYER_ROLES = {
    "ln_before": "layernorm_before", "ln_after": "layernorm_after", "q": "attention.q_proj",
    "k": "attention.k_proj", "v": "attention.v_proj", "o": "attention.projection_layer",
    "q_norm": "attention.q_norm", "k_norm": "attention.k_norm", "fc1": "mlp.fc1", "fc2": "mlp.fc2",
}


class InternViT(nn.Module):
    """InternViT: the conv patch embedding as a ``Linear`` over flattened
    ``[3 * p * p]`` patches (named ``patch_embed``, which the quantizers leave
    in full precision), the CLS token, the position table, the encoder layers
    and, with ``final_ln`` (the released 300M towers have none), the final
    LayerNorm. Parameters are uninitialised until filled."""

    def __init__(self, config: InternVLVisionConfig, dtype=torch.float32, device="cpu",
                 final_ln: bool = True) -> None:
        super().__init__()
        c, e = config, config.hidden_size
        self.config = config
        self.patch_embed = Linear(3 * c.patch_size**2, e, True, dtype, device)
        self.cls_token = _param((e,), dtype, device)
        self.position_embeddings = _param((c.num_patches + 1, e), dtype, device)
        self.layers = nn.ModuleList(InternViTLayer(c, dtype, device) for _ in range(c.num_layers))
        self.final_ln = LayerNorm(e, c.layer_norm_eps, dtype, device) if final_ln else None

    @property
    def dtype(self) -> torch.dtype:
        return self.position_embeddings.dtype

    def hf_tensor(self, state, name: str, prefixes: tuple[str, ...] = _PREFIXES) -> torch.Tensor:
        """The HF ``vision_tower.*`` tensor of parameter ``name``."""
        parts = name.split(".")
        base = "vision_tower"
        if parts[0] == "layers":
            return find_tensor(state, f"{base}.encoder.layer.{parts[1]}.{_HF_LAYER_ROLES.get(parts[2], parts[2])}"
                               + (f".{parts[3]}" if len(parts) > 3 else ""), prefixes)
        if parts[0] == "patch_embed":
            t = find_tensor(state, f"{base}.embeddings.patch_embeddings.projection.{parts[1]}", prefixes)
            return t.reshape(t.shape[0], -1) if parts[1] == "weight" else t  # [E, 3, p, p] -> [E, 3*p*p]
        if parts[0] == "cls_token":
            return find_tensor(state, f"{base}.embeddings.cls_token", prefixes).reshape(-1)
        if parts[0] == "position_embeddings":  # [1, P + 1, E]
            t = find_tensor(state, f"{base}.embeddings.position_embeddings", prefixes)
            return t.reshape(-1, t.shape[-1])
        return find_tensor(state, f"{base}.layernorm.{parts[1]}", prefixes)  # final_ln


def has_final_ln(state) -> bool:
    """Whether an HF InternVL checkpoint's tower ends in a LayerNorm."""
    return any(prefix + "vision_tower.layernorm.weight" in state for prefix in _PREFIXES)


@torch.inference_mode()
def internvit_forward(tower: InternViT, pixel_values: torch.Tensor, config: InternVLVisionConfig) -> torch.Tensor:
    """InternViT -> last hidden states [B, 1+P, E] (after the final LN when the tower has one)."""
    b = pixel_values.shape[0]
    p, e = config.patch_size, config.hidden_size
    nh = config.num_heads
    hd = e // nh
    gh, gw = pixel_values.shape[2] // p, pixel_values.shape[3] // p
    x = pixel_values.to(tower.dtype).reshape(b, 3, gh, p, gw, p).permute(0, 2, 4, 1, 3, 5).reshape(b, -1, 3 * p * p)
    x = tower.patch_embed(x)
    cls = tower.cls_token.to(x.dtype)[None, None].expand(b, 1, e)
    x = torch.cat([cls, x], dim=1)
    x = x + tower.position_embeddings[None, : x.shape[1]].to(x.dtype)
    for layer in tower.layers:
        l = x.shape[1]
        normed = layer.ln_before(x)
        q, k, v = layer.q(normed), layer.k(normed), layer.v(normed)
        if config.use_qk_norm:  # over the full embed dim, before the head split
            q, k = layer.q_norm(q), layer.k_norm(k)
        q, k, v = (t.view(b, l, nh, hd).transpose(1, 2) for t in (q, k, v))
        attn = flash_attention(q, k, v)
        x = x + layer.lambda_1 * layer.o(attn.transpose(1, 2).reshape(b, l, e))
        x = x + layer.lambda_2 * layer.fc2(gelu(layer.fc1(layer.ln_after(x))))
    return tower.final_ln(x) if tower.final_ln is not None else x


def _pixel_shuffle(x: torch.Tensor, scale_factor: float) -> torch.Tensor:
    """HF InternVL pixel shuffle: [B, W, H, C] -> [B, H*s, W*s, C/s^2] (exact op order)."""
    b, w, h, c = x.shape
    x = x.reshape(b, w, int(h * scale_factor), int(c / scale_factor))
    x = x.permute(0, 2, 1, 3)
    x = x.reshape(b, int(h * scale_factor), int(w * scale_factor), int(c / (scale_factor**2)))
    return x.permute(0, 2, 1, 3)


class Projector(nn.Module):
    """``mlp1``: LayerNorm (eps 1e-5) over the shuffled channels, then fc1 -> GELU -> fc2."""

    def __init__(self, d_in: int, h: int, dtype, device) -> None:
        super().__init__()
        self.ln = LayerNorm(d_in, 1e-5, dtype, device)
        self.fc1 = Linear(d_in, h, True, dtype, device)
        self.fc2 = Linear(h, h, True, dtype, device)


class InternVLModel(nn.Module):
    """The decoder (``text``: a text-only :class:`Qwen2VLModel`, with qkv
    biases for a Qwen2 backbone), the InternViT tower (``vision``) and the
    projector: the JAX adapter's parameter tree as one module tree, so the
    port's quantizers reach the same linear layers. Parameters are
    uninitialised until :func:`init_internvl_params`,
    :func:`~lmms_owc_tpu_torch.nn.loader.load_hf_tensors` or
    :func:`internvl_params_from_jax` fills them."""

    def __init__(self, config: InternVLConfig, dtype=torch.bfloat16, device="cpu", final_ln: bool = True) -> None:
        super().__init__()
        self.config = config
        v = config.vision
        merge_ch = v.hidden_size * int(1 / config.downsample_ratio) ** 2
        self.text = Qwen2VLModel(config.text.to_decoder_config(), dtype, device, text_only=True,
                                 attn_bias=config.text_attn_bias)
        self.vision = InternViT(v, dtype, device, final_ln)
        self.projector = Projector(merge_ch, config.text.hidden_size, dtype, device)

    @property
    def dtype(self) -> torch.dtype:
        return self.text.dtype

    def hf_tensor(self, state, name: str) -> torch.Tensor:
        """The HF ``InternVLForConditionalGeneration`` tensor of parameter ``name``."""
        head, _, rest = name.partition(".")
        if head == "text":
            return self.text.hf_tensor(state, rest)
        if head == "vision":
            return self.vision.hf_tensor(state, rest)
        role, _, kind = rest.partition(".")
        hf = {"ln": "layer_norm", "fc1": "linear_1", "fc2": "linear_2"}[role]
        return find_tensor(state, f"multi_modal_projector.{hf}.{kind}", _PREFIXES)


@torch.inference_mode()
def encode_tiles(model: InternVLModel, pixel_values: torch.Tensor, config: InternVLConfig) -> torch.Tensor:
    """Tiles [N, 3, S, S] -> projected vision tokens [N, tokens_per_tile, H_text]:
    the tower, the CLS token dropped ("default"), the pixel shuffle, the projector."""
    features = internvit_forward(model.vision, pixel_values, config.vision)
    if config.vision_feature_select_strategy == "default":
        features = features[:, 1:, :]
    n, channels = features.shape[0], features.shape[1]
    side = int(channels**0.5)
    features = _pixel_shuffle(features.reshape(n, side, side, -1), config.downsample_ratio)
    features = features.reshape(n, -1, features.shape[-1])
    proj = model.projector
    return proj.fc2(gelu(proj.fc1(proj.ln(features))))


# ====================================================================== weights


@torch.no_grad()
def init_internvl_params(model: InternVLModel, generator: torch.Generator, after=None) -> InternVLModel:
    """Random-init ``model``, built on ``meta``, on the generator's device, in
    the JAX ``init_internvl_params`` distribution (the values differ): weights
    and the position table ~ N(0, 1) * 0.02, biases and the CLS token zero,
    norm scales one, layer scales 0.1. The decoder is drawn first, one module
    at a time (:func:`~lmms_owc_tpu_torch.nn.qwen2_vl.init_params`, whose
    ``after`` is the shard hook of the walk over ``model.text``)."""
    init_params(model.text, generator, after)
    tower = model.vision
    for part in (tower, model.projector):
        part.to_empty(device=generator.device)
        init_modules(part, generator)
    tower.position_embeddings.copy_(
        (torch.randn(tower.position_embeddings.shape, generator=generator, device=generator.device) * 0.02
         ).to(model.dtype))
    tower.cls_token.zero_()
    for layer in tower.layers:
        layer.lambda_1.fill_(0.1)
        layer.lambda_2.fill_(0.1)
    return model


@torch.no_grad()
def internvl_params_from_jax(tree: dict, config: InternVLConfig, dtype=torch.float32, device="cpu") -> InternVLModel:
    """A model filled from the JAX package's InternVL tree (``init_internvl_params``
    / ``convert_hf_internvl_weights``, leaves as numpy arrays, float or
    int8/int4; a quantized leaf replaces its float ``Linear``)."""
    vt = tree["vision"]
    model = InternVLModel(config, dtype, device, "final_ln" in vt)
    params_from_jax(model.text, tree["text"])
    tower = model.vision
    _load_linear(tower, "patch_embed", vt["patch_embed"])
    _copy(tower.cls_token, np.asarray(vt["cls_token"], np.float32))
    _copy(tower.position_embeddings, np.asarray(vt["position_embeddings"], np.float32))
    lt = vt["layers"]
    for i, layer in enumerate(tower.layers):
        _load_norm(layer.ln_before, lt["ln_before"], i)
        _load_norm(layer.ln_after, lt["ln_after"], i)
        _copy(layer.lambda_1, np.asarray(lt["lambda_1"], np.float32)[i])
        _copy(layer.lambda_2, np.asarray(lt["lambda_2"], np.float32)[i])
        for role in ("q", "k", "v", "o"):
            _load_linear(layer, role, lt["attn"][role], i)
        if config.vision.use_qk_norm:
            _load_norm(layer.q_norm, lt["attn"]["q_norm"], i)
            _load_norm(layer.k_norm, lt["attn"]["k_norm"], i)
        for role in ("fc1", "fc2"):
            _load_linear(layer, role, lt["mlp"][role], i)
    if tower.final_ln is not None:
        _load_norm(tower.final_ln, vt["final_ln"])
    pt = tree["projector"]
    _load_norm(model.projector.ln, pt["ln"])
    for role in ("fc1", "fc2"):
        _load_linear(model.projector, role, pt[role])
    return model
