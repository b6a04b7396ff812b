"""Llama-family causal LM (Llama 3.x) over the port's decoder.

Counterpart of :mod:`lmms_owc_tpu.nn.llama`. A Llama decoder is the
RMSNorm/GQA/SwiGLU block of :mod:`lmms_owc_tpu_torch.nn.qwen2_vl` with
standard 1D RoPE (M-RoPE with three identical position streams), llama3 or
longrope (Phi-3) frequency scaling, no attention biases and no vision tower: a
:class:`~lmms_owc_tpu_torch.nn.qwen2_vl.Qwen2VLModel` built ``text_only`` from
:meth:`LlamaConfig.to_decoder_config`. Prefill, decode and generation are the
decoder's (K2 for the prefill, K3 for each decode step on the card). Used by
the Llama-3.2 judge (:mod:`lmms_owc_tpu_torch.nn.judge`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from lmms_owc_tpu_torch.nn.qwen2_vl import (
    Qwen2VLConfig,
    Qwen2VLModel,
    decode_step,
    greedy_generate,
    init_params,
    load_hf_weights,
    params_from_jax,
    prefill,
    score_continuation,
)

__all__ = [
    "LlamaConfig",
    "build_llama",
    "convert_hf_llama_weights",
    "decode_step",
    "greedy_generate",
    "init_llama_params",
    "llama_config_from_hf",
    "llama_params_from_jax",
    "llama_positions",
    "prefill",
    "score_continuation",
]


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    hidden_size: int = 3072
    num_layers: int = 28
    num_heads: int = 24
    num_kv_heads: int = 8
    intermediate_size: int = 8192
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    # Frozen (key, value) pairs, as in the JAX package.
    rope_scaling: tuple | None = None
    max_position_embeddings: int = 131072
    original_max_position_embeddings: int | None = None
    tie_word_embeddings: bool = True
    eos_token_id: int = 128009
    pad_token_id: int = 128004
    attn_bias: bool = False

    def to_decoder_config(self) -> Qwen2VLConfig:
        """View as a Qwen2VLConfig with uniform mrope sections (== standard RoPE).

        As in the JAX package, llama3 scaling damps the low frequencies, and
        longrope (Phi-3) divides them by its short factors at every length,
        with the attention factor ``sqrt(1 + ln(factor) / ln(original_max))``
        (``factor = max_position_embeddings / original_max``, 1 when that is
        not above 1) on the rope tables; its long factors are never used. A
        scaling of another type (an ``mrope`` text config's sections,
        ``default``, early Phi-3's ``su``) changes nothing: the three position
        streams are identical, so any sections give standard RoPE."""
        hd2 = (self.hidden_size // self.num_heads) // 2
        third = hd2 // 3
        rope_llama3 = None
        rope_longrope = None
        scaling = dict(self.rope_scaling or ())
        rope_type = scaling.get("rope_type", scaling.get("type"))
        if rope_type == "llama3":
            rope_llama3 = (
                scaling["factor"],
                scaling["low_freq_factor"],
                scaling["high_freq_factor"],
                scaling["original_max_position_embeddings"],
            )
        elif rope_type == "longrope":
            original_max = scaling.get(
                "original_max_position_embeddings",
                self.original_max_position_embeddings or self.max_position_embeddings,
            )
            factor = self.max_position_embeddings / original_max
            attention_factor = 1.0 if factor <= 1.0 else math.sqrt(1 + math.log(factor) / math.log(original_max))
            rope_longrope = (attention_factor, tuple(scaling["short_factor"]))
        return Qwen2VLConfig(
            rope_llama3=rope_llama3,
            rope_longrope=rope_longrope,
            vocab_size=self.vocab_size,
            hidden_size=self.hidden_size,
            num_layers=self.num_layers,
            num_heads=self.num_heads,
            num_kv_heads=self.num_kv_heads,
            intermediate_size=self.intermediate_size,
            rms_norm_eps=self.rms_norm_eps,
            rope_theta=self.rope_theta,
            max_position_embeddings=self.max_position_embeddings,
            tie_word_embeddings=self.tie_word_embeddings,
            mrope_section=(third, third, hd2 - 2 * third),
            eos_token_id=self.eos_token_id,
            pad_token_id=self.pad_token_id,
        )


def _freeze_dict(d: dict | None) -> tuple | None:
    """Dict -> hashable (key, value) tuple with list values frozen to tuples."""
    if not d:
        return None
    return tuple((k, tuple(v) if isinstance(v, list) else v) for k, v in sorted(d.items()))


def llama_config_from_hf(cfg: dict) -> LlamaConfig:
    eos = cfg.get("eos_token_id", 128009)
    return LlamaConfig(
        vocab_size=cfg["vocab_size"],
        hidden_size=cfg["hidden_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg.get("num_key_value_heads", cfg["num_attention_heads"]),
        intermediate_size=cfg["intermediate_size"],
        rms_norm_eps=cfg.get("rms_norm_eps", 1e-5),
        rope_theta=cfg.get("rope_theta", 500000.0),
        rope_scaling=_freeze_dict(cfg.get("rope_scaling")),
        max_position_embeddings=cfg.get("max_position_embeddings", 131072),
        original_max_position_embeddings=cfg.get("original_max_position_embeddings"),
        tie_word_embeddings=cfg.get("tie_word_embeddings", False),
        eos_token_id=eos[0] if isinstance(eos, list) else eos,
        pad_token_id=cfg.get("pad_token_id") or 0,
        attn_bias=cfg.get("attention_bias", False),
    )


def build_llama(config: LlamaConfig, dtype=torch.bfloat16, device="cpu") -> Qwen2VLModel:
    """The decoder of ``config``, parameters uninitialised, no vision tower."""
    return Qwen2VLModel(config.to_decoder_config(), dtype, device, text_only=True, attn_bias=config.attn_bias)


def init_llama_params(config: LlamaConfig, generator: torch.Generator, dtype=torch.bfloat16) -> Qwen2VLModel:
    """A random-init decoder on the generator's device (the JAX
    ``init_llama_params`` distribution; the values differ)."""
    return init_params(build_llama(config, dtype, generator.device), generator)


def convert_hf_llama_weights(state, config: LlamaConfig, dtype=torch.bfloat16, device="cpu") -> Qwen2VLModel:
    """A decoder filled from an HF Llama checkpoint's tensors (``state`` from
    :func:`~lmms_owc_tpu_torch.nn.loader.load_safetensors_state`), cast to ``dtype``."""
    return load_hf_weights(build_llama(config, dtype, device), state)


def llama_params_from_jax(tree: dict, config: LlamaConfig, dtype=torch.float32, device="cpu") -> Qwen2VLModel:
    """A decoder filled from the JAX package's Llama tree (``init_llama_params``
    / ``convert_hf_llama_weights``, leaves as numpy arrays, float or int8/int4)."""
    return params_from_jax(build_llama(config, dtype, device), tree)


def llama_positions(attention_mask: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """1D positions broadcast to the [3, B, L] M-RoPE layout, plus next positions."""
    positions_1d = np.maximum(attention_mask.cumsum(axis=-1) - 1, 0)
    position_ids = np.broadcast_to(positions_1d[None], (3, *positions_1d.shape)).copy()
    next_pos = attention_mask.sum(axis=-1)
    return position_ids, next_pos
