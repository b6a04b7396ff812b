"""LLaVA (1.5 / HF-style) in PyTorch: CLIP vision tower + MLP projector + Llama decoder.

Counterpart of :mod:`lmms_owc_tpu.nn.llava`, the model assembly of the
reference's llava-hf family:
  - vision features from CLIP layer ``vision_feature_layer`` (-2), CLS dropped
    ("default" select strategy), through :mod:`lmms_owc_tpu_torch.nn.clip`,
  - 2-layer GELU projector into the text embedding space,
  - the Llama/Vicuna (or Mistral) decoder of :mod:`lmms_owc_tpu_torch.nn.llama`,
    whose prefill, decode and scoring are the port's shared decoder's (K2 for
    the prefill, K3 for each decode step on the card).

A :class:`LlavaModel` is one module tree (``text``, ``vision``,
``projector``, and LLaVA-NeXT's ``image_newline``), so the port's quantizers
(:mod:`lmms_owc_tpu_torch.ops.quant`) reach the same linear layers as the JAX
package's quantize over its llava tree: the decoder's, the tower's and the
projector's, not the patch embedding.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np
import torch
from torch import nn

from lmms_owc_tpu_torch.nn.clip import (
    ClipVisionConfig,
    ClipVisionTower,
    clip_vision_forward,
    vision_params_from_jax,
)
from lmms_owc_tpu_torch.nn.layers import LayerNorm, Linear, RMSNorm, gelu
from lmms_owc_tpu_torch.nn.llama import LlamaConfig, llama_config_from_hf
from lmms_owc_tpu_torch.nn.loader import find_tensor, load_hf_tensors
from lmms_owc_tpu_torch.nn.qwen2_vl import Qwen2VLModel, _copy, _load_linear, params_from_jax

__all__ = [
    "LlavaConfig",
    "LlavaModel",
    "convert_hf_llava_weights",
    "encode_images",
    "init_llava_params",
    "llava_config_from_hf",
    "llava_params_from_jax",
]

# Where HF LLaVA checkpoints keep the tower and the projector.
VISION_PREFIX = "model.vision_tower."
_PROJECTOR_PREFIXES = ("model.", "")


@dataclass(frozen=True)
class LlavaConfig:
    text: LlamaConfig = field(default_factory=LlamaConfig)
    vision: ClipVisionConfig = field(default_factory=lambda: ClipVisionConfig(image_size=336))
    image_token_id: int = 32000
    vision_feature_layer: int = -2
    vision_feature_select_strategy: str = "default"
    pad_token_id: int = 32001

    @property
    def image_seq_length(self) -> int:
        patches = (self.vision.image_size // self.vision.patch_size) ** 2
        return patches if self.vision_feature_select_strategy == "default" else patches + 1

    def decoder_config(self):
        """The decoder's view, with LLaVA's padding id (the JAX adapter's
        ``decoder_config``)."""
        return dataclasses.replace(self.text.to_decoder_config(), pad_token_id=self.pad_token_id)


def llava_config_from_hf(cfg: dict) -> LlavaConfig:
    text = llama_config_from_hf(cfg["text_config"])
    vis = cfg.get("vision_config", {})
    vision = ClipVisionConfig(
        hidden_size=vis.get("hidden_size", 1024),
        num_layers=vis.get("num_hidden_layers", 24),
        num_heads=vis.get("num_attention_heads", 16),
        intermediate_size=vis.get("intermediate_size", 4096),
        image_size=vis.get("image_size", 336),
        patch_size=vis.get("patch_size", 14),
        projection_dim=vis.get("projection_dim", 768),
    )
    return LlavaConfig(
        text=text,
        vision=vision,
        image_token_id=cfg.get("image_token_index", 32000),
        vision_feature_layer=cfg.get("vision_feature_layer", -2),
        vision_feature_select_strategy=cfg.get("vision_feature_select_strategy", "default"),
        pad_token_id=cfg.get("pad_token_id") or 32001,
    )


class Projector(nn.Module):
    def __init__(self, e: int, h: int, dtype, device) -> None:
        super().__init__()
        self.fc1 = Linear(e, h, True, dtype, device)
        self.fc2 = Linear(h, h, True, dtype, device)


class LlavaModel(nn.Module):
    """The decoder (``text``: a text-only :class:`Qwen2VLModel` over
    :meth:`LlavaConfig.decoder_config`), the CLIP tower without its
    projection (``vision``), the projector and, with ``image_newline``,
    LLaVA-NeXT's newline embedding. Parameters are uninitialised until
    :func:`init_llava_params`, :func:`convert_hf_llava_weights` or
    :func:`llava_params_from_jax` fills them."""

    def __init__(self, config: LlavaConfig, dtype=torch.bfloat16, device="cpu", image_newline: bool = False):
        super().__init__()
        self.config = config
        h = config.text.hidden_size
        self.text = Qwen2VLModel(config.decoder_config(), dtype, device, text_only=True,
                                 attn_bias=config.text.attn_bias)
        self.vision = ClipVisionTower(config.vision, dtype, device, with_projection=False)
        self.projector = Projector(config.vision.hidden_size, h, dtype, device)
        self.image_newline = (
            nn.Parameter(torch.empty(h, dtype=dtype, device=device), requires_grad=False) if image_newline else None
        )

    @property
    def dtype(self) -> torch.dtype:
        return self.text.dtype

    def hf_tensor(self, state, name: str) -> torch.Tensor:
        """The HF ``LlavaForConditionalGeneration`` / ``LlavaNext...`` tensor of
        parameter ``name`` (decoder, tower and projector under the prefixes
        of the JAX ``convert_hf_llava_weights``)."""
        head, _, rest = name.partition(".")
        if head == "text":
            return self.text.hf_tensor(state, rest)
        if head == "vision":
            return self.vision.hf_tensor(state, rest, VISION_PREFIX)
        if head == "projector":
            role, _, kind = rest.partition(".")
            linear = {"fc1": "linear_1", "fc2": "linear_2"}[role]
            return find_tensor(state, f"multi_modal_projector.{linear}.{kind}", _PROJECTOR_PREFIXES)
        if head == "image_newline":
            return find_tensor(state, "image_newline", _PROJECTOR_PREFIXES)
        raise KeyError(name)


def has_image_newline(state) -> bool:
    return any(p + "image_newline" in state for p in _PROJECTOR_PREFIXES)


@torch.no_grad()
def init_llava_params(
    config: LlavaConfig, generator: torch.Generator, dtype=torch.bfloat16, image_newline: bool = False
) -> LlavaModel:
    """A random-init model on the generator's device: linear weights, token,
    class and position embeddings ~ N(0, 1) * 0.02, biases zero, norm scales
    one, the newline embedding zero (the JAX ``init_llava_params`` and
    adapter's distribution; the values differ)."""
    model = LlavaModel(config, dtype, generator.device, image_newline)

    def draw(t):
        t.copy_((torch.randn(t.shape, generator=generator, device=t.device) * 0.02).to(dtype))

    for module in model.modules():
        if isinstance(module, Linear):
            draw(module.weight)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, (LayerNorm, RMSNorm)):
            module.weight.fill_(1.0)
            if isinstance(module, LayerNorm):
                module.bias.zero_()
    for t in (model.text.embed_tokens, model.vision.class_embedding, model.vision.position_embedding):
        draw(t)
    if model.image_newline is not None:
        model.image_newline.zero_()
    return model


def convert_hf_llava_weights(state, config: LlavaConfig, dtype=torch.bfloat16, device="cpu") -> LlavaModel:
    """A model filled from an HF LLaVA checkpoint's tensors (``state`` from
    :func:`~lmms_owc_tpu_torch.nn.loader.load_safetensors_state`), cast to
    ``dtype``; with LLaVA-NeXT's ``image_newline`` when the checkpoint has it."""
    return load_hf_tensors(LlavaModel(config, dtype, device, has_image_newline(state)), state)


@torch.no_grad()
def llava_params_from_jax(tree: dict, config: LlavaConfig, dtype=torch.float32, device="cpu") -> LlavaModel:
    """A model filled from the JAX package's llava tree (``init_llava_params``
    / ``convert_hf_llava_weights``, plus the adapter's ``image_newline``;
    leaves as numpy arrays, float or int8/int4)."""
    model = LlavaModel(config, dtype, device, "image_newline" in tree)
    params_from_jax(model.text, tree["text"])
    vision_params_from_jax(model.vision, tree["vision"])
    for role in ("fc1", "fc2"):
        _load_linear(model.projector, role, tree["projector"][role])
    if model.image_newline is not None:
        _copy(model.image_newline, np.asarray(tree["image_newline"], np.float32))
    return model


@torch.inference_mode()
def encode_images(model: LlavaModel, pixel_values: torch.Tensor, config: LlavaConfig) -> torch.Tensor:
    """Pixels [N, 3, S, S] -> projected vision embeddings [N, image_seq_length, H]."""
    features = clip_vision_forward(
        model.vision, pixel_values, config.vision, feature_layer=config.vision_feature_layer
    )
    if config.vision_feature_select_strategy == "default":
        features = features[:, 1:, :]  # drop CLS
    return model.projector.fc2(gelu(model.projector.fc1(features)))
