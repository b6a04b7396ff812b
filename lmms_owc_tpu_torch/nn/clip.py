"""CLIP (ViT + text transformer) in PyTorch.

Counterpart of :mod:`lmms_owc_tpu.nn.clip`. Backs two consumers:
  - the image pipeline's ``encode_clip`` scorer (:class:`ClipScorer`: CLIP
    ViT-L/14 image-text logits), and
  - the LLaVA family's vision tower (:mod:`lmms_owc_tpu_torch.nn.llava`:
    CLIP ViT-L/14-336 features from a hidden layer).

The JAX package stacks the encoder layers for ``lax.scan``; here each layer
is its own module and the loop is a Python loop. Attention goes through
:func:`~lmms_owc_tpu_torch.ops.attention.flash_attention` (K2 on the card):
full bidirectional for the vision tower, causal for the text tower. The
scorer reads its checkpoint with the port's safetensors reader, and its
images and texts with the port's ``CLIPImageProcessor``
(:class:`~lmms_owc_tpu_torch.ops.image.ClipImageProcessor`) and CLIP BPE
tokenizer (:class:`~lmms_owc_tpu_torch.tokenizer.Tokenizer`), in place of
``AutoProcessor``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch
from torch import nn

from lmms_owc_tpu_torch._device import get_device
from lmms_owc_tpu_torch.nn.layers import LayerNorm, Linear, quick_gelu
from lmms_owc_tpu_torch.nn.loader import find_tensor, load_config_json, load_safetensors_state
from lmms_owc_tpu_torch.ops.attention import flash_attention
from lmms_owc_tpu_torch.ops.image import ClipImageProcessor
from lmms_owc_tpu_torch.tokenizer import Tokenizer
from lmms_owc_tpu_torch.utils import get_logger

log = get_logger(__name__)

__all__ = [
    "ClipModel",
    "ClipScorer",
    "ClipTextConfig",
    "ClipTextModel",
    "ClipVisionConfig",
    "ClipVisionTower",
    "clip_params_from_jax",
    "clip_text_encode",
    "clip_vision_forward",
    "convert_hf_clip_weights",
    "init_clip_vision_params",
    "resolve_clip_weights",
    "vision_params_from_jax",
]


@dataclass(frozen=True)
class ClipVisionConfig:
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    image_size: int = 224
    patch_size: int = 14
    layer_norm_eps: float = 1e-5
    projection_dim: int = 768

    @property
    def num_positions(self) -> int:
        return (self.image_size // self.patch_size) ** 2 + 1


@dataclass(frozen=True)
class ClipTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    projection_dim: int = 768
    eos_token_id: int = 49407


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


class ClipEncoderLayer(nn.Module):
    """Pre-LN block: separate q/k/v/o projections with biases, quick-GELU MLP."""

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


# Port layer roles -> HF CLIPEncoderLayer names.
_HF_LAYER_ROLES = {
    "ln1": "layer_norm1", "ln2": "layer_norm2", "q": "self_attn.q_proj", "k": "self_attn.k_proj",
    "v": "self_attn.v_proj", "o": "self_attn.out_proj", "fc1": "mlp.fc1", "fc2": "mlp.fc2",
}


def _hf_layer_name(base: str, parts: list[str]) -> str:
    """``layers.<i>.<role>.<weight|bias>`` -> the HF name under ``base``."""
    return f"{base}.encoder.layers.{parts[1]}.{_HF_LAYER_ROLES[parts[2]]}.{parts[3]}"


def _encoder_block(layer: ClipEncoderLayer, x: torch.Tensor, *, num_heads: int, causal: bool) -> torch.Tensor:
    b, l, e = x.shape
    hd = e // num_heads
    normed = layer.ln1(x)
    q = layer.q(normed).view(b, l, num_heads, hd).transpose(1, 2)
    k = layer.k(normed).view(b, l, num_heads, hd).transpose(1, 2)
    v = layer.v(normed).view(b, l, num_heads, hd).transpose(1, 2)
    attn = flash_attention(q, k, v, causal=causal)
    x = x + layer.o(attn.transpose(1, 2).reshape(b, l, e))
    return x + layer.fc2(quick_gelu(layer.fc1(layer.ln2(x))))


class ClipVisionTower(nn.Module):
    """CLIP ViT: the conv patch embedding as a bias-free ``Linear`` over
    flattened ``[3 * p * p]`` patches (named ``patch_embed``, which the
    quantizers leave in full precision, as the JAX package), class and
    position embeddings, pre-LN, the encoder layers, post-LN and (for the
    scorer) the projection. Parameters are uninitialised until
    :func:`init_clip_vision_params`, :func:`convert_hf_clip_weights` or
    :func:`clip_params_from_jax` fills them."""

    def __init__(self, config: ClipVisionConfig, dtype=torch.float32, device="cpu", with_projection: bool = True):
        super().__init__()
        c, e = config, config.hidden_size
        self.config = config
        self.patch_embed = Linear(3 * c.patch_size**2, e, False, dtype, device)
        self.class_embedding = _param((e,), dtype, device)
        self.position_embedding = _param((c.num_positions, e), dtype, device)
        self.pre_ln = LayerNorm(e, c.layer_norm_eps, dtype, device)
        self.layers = nn.ModuleList(
            ClipEncoderLayer(e, c.intermediate_size, c.layer_norm_eps, dtype, device) for _ in range(c.num_layers)
        )
        self.post_ln = LayerNorm(e, c.layer_norm_eps, dtype, device)
        self.visual_projection = Linear(e, c.projection_dim, False, dtype, device) if with_projection else None

    @property
    def dtype(self) -> torch.dtype:
        return self.class_embedding.dtype

    def hf_tensor(self, state, name: str, prefix: str = "") -> torch.Tensor:
        """The HF ``CLIPModel`` / ``CLIPVisionModel`` tensor of parameter
        ``name``, under ``prefix`` (LLaVA's ``model.vision_tower.``) or the
        spellings :func:`convert_hf_clip_weights` probes."""
        parts = name.split(".")
        base = "vision_model"
        if parts[0] == "layers":
            hf = _hf_layer_name(base, parts)
        elif parts[0] == "patch_embed":
            w = find_tensor(state, f"{base}.embeddings.patch_embedding.weight", _prefixes(prefix))
            return w.reshape(w.shape[0], -1)  # [E, 3, p, p] -> [E, 3*p*p], the port's [out, in]
        else:
            hf = {
                "class_embedding": f"{base}.embeddings.class_embedding",
                "position_embedding": f"{base}.embeddings.position_embedding.weight",
                "pre_ln": f"{base}.pre_layrnorm.{parts[-1]}",
                "post_ln": f"{base}.post_layernorm.{parts[-1]}",
                "visual_projection": "visual_projection.weight",
            }[parts[0]]
        return find_tensor(state, hf, _prefixes(prefix))


class ClipTextModel(nn.Module):
    """CLIP text transformer: token and position embeddings, causal encoder
    layers, final LN and the projection."""

    def __init__(self, config: ClipTextConfig, dtype=torch.float32, device="cpu") -> None:
        super().__init__()
        c, e = config, config.hidden_size
        self.config = config
        self.token_embedding = _param((c.vocab_size, e), dtype, device)
        self.position_embedding = _param((c.max_position_embeddings, e), dtype, device)
        self.layers = nn.ModuleList(
            ClipEncoderLayer(e, c.intermediate_size, c.layer_norm_eps, dtype, device) for _ in range(c.num_layers)
        )
        self.final_ln = LayerNorm(e, c.layer_norm_eps, dtype, device)
        self.text_projection = Linear(e, c.projection_dim, False, dtype, device)

    def hf_tensor(self, state, name: str, prefix: str = "") -> torch.Tensor:
        parts = name.split(".")
        base = "text_model"
        if parts[0] == "layers":
            hf = _hf_layer_name(base, parts)
        else:
            hf = {
                "token_embedding": f"{base}.embeddings.token_embedding.weight",
                "position_embedding": f"{base}.embeddings.position_embedding.weight",
                "final_ln": f"{base}.final_layer_norm.{parts[-1]}",
                "text_projection": "text_projection.weight",
            }[parts[0]]
        return find_tensor(state, hf, _prefixes(prefix))


class ClipModel(nn.Module):
    """Both towers and the logit scale (the scorer's model)."""

    def __init__(self, vision: ClipVisionTower, text: ClipTextModel, logit_scale: torch.Tensor) -> None:
        super().__init__()
        self.vision = vision
        self.text = text
        self.logit_scale = nn.Parameter(logit_scale.reshape(()), requires_grad=False)

    def hf_tensor(self, state, name: str) -> torch.Tensor:
        """The HF ``CLIPModel`` tensor of parameter ``name``."""
        head, _, rest = name.partition(".")
        if head == "logit_scale":
            return find_tensor(state, "logit_scale", _prefixes(""))
        return getattr(self, head).hf_tensor(state, rest)


def _prefixes(prefix: str) -> tuple[str, ...]:
    """Transformers has moved embedded towers between ``model.vision_tower.``
    and bare ``vision_tower.`` across versions: probe both spellings."""
    return tuple(dict.fromkeys((prefix, prefix.removeprefix("model."), "model." + prefix, "")))


@torch.inference_mode()
def clip_vision_forward(
    tower: ClipVisionTower,
    pixel_values: torch.Tensor,
    config: ClipVisionConfig,
    feature_layer: int | None = None,
) -> torch.Tensor:
    """CLIP vision tower.

    Args:
        pixel_values: [B, 3, H, W] normalized pixels (cast to the tower's dtype).
        feature_layer: if set (e.g. -2 for LLaVA), return that encoder layer's
            hidden states [B, 1+P, E] (no post-LN); otherwise return the projected
            pooled embedding [B, projection_dim].
    """
    b, _, h, w = pixel_values.shape
    e, p = config.hidden_size, config.patch_size
    x = pixel_values.to(tower.dtype).reshape(b, 3, h // p, p, w // p, p)
    x = tower.patch_embed(x.permute(0, 2, 4, 1, 3, 5).reshape(b, -1, 3 * p * p))
    cls = tower.class_embedding[None, None, :].expand(b, 1, e)
    x = torch.cat([cls, x], dim=1)
    x = x + tower.position_embedding[None, : x.shape[1], :]
    x = tower.pre_ln(x)
    num_layers = config.num_layers if feature_layer is None else config.num_layers + 1 + feature_layer
    for layer in tower.layers[:num_layers]:
        x = _encoder_block(layer, x, num_heads=config.num_heads, causal=False)
    if feature_layer is not None:
        return x
    return tower.visual_projection(tower.post_ln(x[:, 0, :]))


@torch.inference_mode()
def clip_text_encode(text: ClipTextModel, input_ids: torch.Tensor, config: ClipTextConfig) -> torch.Tensor:
    """CLIP text encoder -> projected embedding [B, projection_dim] (causal, pooled
    at the first EOS, as HF ``CLIPTextModel``)."""
    b, l = input_ids.shape
    x = text.token_embedding[input_ids] + text.position_embedding[None, :l, :]
    for layer in text.layers:
        x = _encoder_block(layer, x, num_heads=config.num_heads, causal=True)
    x = text.final_ln(x)
    eos_positions = torch.argmax((input_ids == config.eos_token_id).int(), dim=-1)
    return text.text_projection(x[torch.arange(b, device=x.device), eos_positions])


# ---------------------------------------------------------------------- weights


@torch.no_grad()
def init_clip_vision_params(
    config: ClipVisionConfig, generator: torch.Generator, dtype=torch.float32, with_projection: bool = True
) -> ClipVisionTower:
    """A random-init tower on the generator's device: weights and embeddings
    ~ N(0, 1) * 0.02, biases zero, LayerNorm scales one (the JAX
    ``init_clip_vision_params`` distribution; the values differ)."""
    tower = ClipVisionTower(config, dtype, generator.device, with_projection)

    def draw(t):
        t.copy_((torch.randn(t.shape, generator=generator, device=t.device) * 0.02).to(dtype))

    for module in tower.modules():
        if isinstance(module, LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
        elif isinstance(module, Linear):
            draw(module.weight)
            if module.bias is not None:
                module.bias.zero_()
    draw(tower.class_embedding)
    draw(tower.position_embedding)
    return tower


def convert_hf_clip_weights(
    state, vision_config: ClipVisionConfig, text_config: ClipTextConfig | None = None,
    dtype=torch.float32, prefix: str = "", device="cpu",
) -> dict:
    """Fill the towers from an HF ``CLIPModel`` / ``CLIPVisionModel``
    checkpoint's tensors (``state`` from
    :func:`~lmms_owc_tpu_torch.nn.loader.load_safetensors_state`), cast to
    ``dtype`` on ``device``.

    Returns ``{"vision": ClipVisionTower}`` plus ``"text"`` and
    ``"logit_scale"`` when ``text_config`` is given. ``prefix`` handles
    towers embedded in other checkpoints (LLaVA's ``model.vision_tower.``);
    the tower has its projection when the checkpoint holds one.
    """
    try:
        find_tensor(state, "visual_projection.weight", _prefixes(prefix))
        with_projection = True
    except KeyError:
        with_projection = False
    vision = ClipVisionTower(vision_config, dtype, device, with_projection)
    for name, param in vision.named_parameters():
        param.copy_(vision.hf_tensor(state, name, prefix))
    out: dict = {"vision": vision}
    if text_config is not None:
        text = ClipTextModel(text_config, dtype, device)
        for name, param in text.named_parameters():
            param.copy_(text.hf_tensor(state, name, prefix))
        out["text"] = text
        out["logit_scale"] = find_tensor(state, "logit_scale", _prefixes(prefix)).to(device=device, dtype=dtype)
    return out


def _tower_from_jax(tower: nn.Module, tree: dict, embeddings: dict[str, str]) -> None:
    from lmms_owc_tpu_torch.nn.qwen2_vl import _copy, _load_linear, _load_norm

    for attr, key in embeddings.items():
        _copy(getattr(tower, attr), np.asarray(tree[key], np.float32))
    lt = tree["layers"]
    for i, layer in enumerate(tower.layers):
        _load_norm(layer.ln1, lt["ln1"], i)
        _load_norm(layer.ln2, lt["ln2"], i)
        for role in ("q", "k", "v", "o"):
            _load_linear(layer, role, lt["attn"][role], i)
        for role in ("fc1", "fc2"):
            _load_linear(layer, role, lt["mlp"][role], i)


@torch.no_grad()
def vision_params_from_jax(tower: ClipVisionTower, tree: dict) -> ClipVisionTower:
    """Fill ``tower`` in place from the JAX package's CLIP vision tree (leaves
    as numpy arrays, float or int8/int4; a quantized leaf replaces its float
    ``Linear``)."""
    from lmms_owc_tpu_torch.nn.qwen2_vl import _load_linear, _load_norm

    _tower_from_jax(tower, tree, {"class_embedding": "class_embedding", "position_embedding": "position_embedding"})
    _load_linear(tower, "patch_embed", tree["patch_embed"])
    _load_norm(tower.pre_ln, tree["pre_ln"])
    _load_norm(tower.post_ln, tree["post_ln"])
    if tower.visual_projection is not None:
        _load_linear(tower, "visual_projection", tree["visual_projection"])
    return tower


@torch.no_grad()
def clip_params_from_jax(
    vision_tree: dict | None, vision_config: ClipVisionConfig | None = None,
    text_tree: dict | None = None, text_config: ClipTextConfig | None = None,
    dtype=torch.float32, device="cpu",
) -> dict:
    """Towers filled from the JAX package's CLIP trees (``init_clip_vision_params``
    / ``convert_hf_clip_weights``'s ``"vision"`` and ``"text"``, leaves as
    numpy arrays, float or int8/int4): ``{"vision": ...}`` and/or ``{"text": ...}``.
    A JAX ``[in, out]`` kernel becomes the port's ``[out, in]`` weight; the
    stacked ``[L, ...]`` leaves are split into the layer modules."""
    from lmms_owc_tpu_torch.nn.qwen2_vl import _load_linear, _load_norm

    out: dict = {}
    if vision_tree is not None:
        tower = ClipVisionTower(vision_config, dtype, device, "visual_projection" in vision_tree)
        out["vision"] = vision_params_from_jax(tower, vision_tree)
    if text_tree is not None:
        text = ClipTextModel(text_config, dtype, device)
        _tower_from_jax(text, text_tree, {"token_embedding": "token_embedding",
                                          "position_embedding": "position_embedding"})
        _load_norm(text.final_ln, text_tree["final_ln"])
        _load_linear(text, "text_projection", text_tree["text_projection"])
        out["text"] = text
    return out


def resolve_clip_weights() -> str | None:
    """Locate a local openai/clip-vit-large-patch14 checkpoint directory, or
    None: ``LMMS_OWC_CLIP_PATH``, else the Hugging Face cache (never the network)."""
    env_path = os.environ.get("LMMS_OWC_CLIP_PATH")
    if env_path and Path(env_path).exists():
        return env_path
    try:
        from huggingface_hub import snapshot_download

        return snapshot_download("openai/clip-vit-large-patch14", local_files_only=True)
    except Exception:  # no huggingface_hub, or the model is not in the cache
        return None


def clip_configs_from_hf(cfg: dict) -> tuple[ClipVisionConfig, ClipTextConfig]:
    """(vision, text) configs of an HF ``CLIPModel`` config.json, with the JAX
    scorer's defaults for what it leaves out (the text positions are the
    checkpoint's: the JAX scorer takes the table's rows as they are)."""
    vision_cfg, text_cfg = cfg.get("vision_config", {}), cfg.get("text_config", {})
    vision = ClipVisionConfig(
        hidden_size=vision_cfg.get("hidden_size", 1024),
        num_layers=vision_cfg.get("num_hidden_layers", 24),
        num_heads=vision_cfg.get("num_attention_heads", 16),
        intermediate_size=vision_cfg.get("intermediate_size", 4096),
        image_size=vision_cfg.get("image_size", 224),
        patch_size=vision_cfg.get("patch_size", 14),
        projection_dim=cfg.get("projection_dim", 768),
    )
    text = ClipTextConfig(
        vocab_size=text_cfg.get("vocab_size", 49408),
        hidden_size=text_cfg.get("hidden_size", 768),
        num_layers=text_cfg.get("num_hidden_layers", 12),
        num_heads=text_cfg.get("num_attention_heads", 12),
        intermediate_size=text_cfg.get("intermediate_size", 3072),
        max_position_embeddings=text_cfg.get("max_position_embeddings", 77),
        projection_dim=cfg.get("projection_dim", 768),
        eos_token_id=text_cfg.get("eos_token_id", 49407),
    )
    return vision, text


class ClipScorer:
    """Image-text logits, parity with the reference image pipeline."""

    def __init__(self, model: ClipModel, vision_config: ClipVisionConfig, text_config: ClipTextConfig,
                 processor: ClipImageProcessor, tokenizer: Tokenizer) -> None:
        self.model = model
        self.vision_config = vision_config
        self.text_config = text_config
        self.processor = processor
        self.tokenizer = tokenizer

    @property
    def device(self) -> torch.device:
        return self.model.logit_scale.device

    @classmethod
    def from_pretrained(cls, path: str, dtype=torch.float32, device=None) -> "ClipScorer":
        """Load an HF ``CLIPModel`` checkpoint directory (``config.json``,
        safetensors, ``preprocessor_config.json`` and the tokenizer's
        ``vocab.json`` + ``merges.txt`` or ``tokenizer.json``) onto ``device``
        (default: the card, which raises without CUDA)."""
        device = get_device(device)
        vision_config, text_config = clip_configs_from_hf(load_config_json(path))
        params = convert_hf_clip_weights(load_safetensors_state(path), vision_config, text_config, dtype,
                                         device=device)
        model = ClipModel(params["vision"], params["text"], params["logit_scale"])
        log.info("loaded CLIP from %s on %s", path, device)
        return cls(model, vision_config, text_config, ClipImageProcessor.from_pretrained(path),
                   Tokenizer.from_pretrained(path))

    @torch.inference_mode()
    def score(self, images: list, texts: list[str]) -> np.ndarray:
        """Logits ``(n_images, n_texts)``: the exp(logit_scale)-scaled cosine
        similarities of the projected embeddings, in the model's dtype."""
        dev = self.device
        pixels = torch.from_numpy(self.processor(images)).to(dev)
        ids = torch.from_numpy(self.tokenizer(texts)["input_ids"]).to(dev)
        image_embeds = clip_vision_forward(self.model.vision, pixels, self.vision_config)
        text_embeds = clip_text_encode(self.model.text, ids, self.text_config)
        image_embeds = image_embeds / torch.linalg.vector_norm(image_embeds, dim=-1, keepdim=True)
        text_embeds = text_embeds / torch.linalg.vector_norm(text_embeds, dim=-1, keepdim=True)
        scale = torch.exp(self.model.logit_scale)
        return (scale * image_embeds @ text_embeds.T).float().cpu().numpy()
