"""Sentence encoder (all-MiniLM-L6-v2, BERT-6L-384) in PyTorch.

Counterpart of :mod:`lmms_owc_tpu.nn.sbert`: tokenize on the host
(:class:`~lmms_owc_tpu_torch.tokenizer.WordPieceTokenizer`), run the BERT
encoder, mean-pool over the attention mask and L2-normalize, in f32 by
default. Attention goes through
:func:`~lmms_owc_tpu_torch.nn.layers.multi_head_attention`, that is the
flash kernel (K2) on the card: f32 at head_dim 32, the masks right-padded, so
each row's valid keys are one run that the kernel reads as (start, end).

The JAX package pads every batch to a (batch, length) bucket to bound the
number of XLA programs. The port keeps the length buckets (a padded key is
masked, so a valid row's values do not depend on them) and drops the row
padding: every row it encodes is a sentence.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch
from torch import nn

from lmms_owc_tpu_torch._device import get_device
from lmms_owc_tpu_torch.nn.layers import LayerNorm, Linear, embedding, mlp_gelu, multi_head_attention
from lmms_owc_tpu_torch.nn.loader import find_tensor, load_config_json, load_hf_tensors, load_safetensors_state
from lmms_owc_tpu_torch.tokenizer import WordPieceTokenizer
from lmms_owc_tpu_torch.utils import get_logger

log = get_logger(__name__)

__all__ = [
    "SbertConfig",
    "SbertModel",
    "SentenceEncoder",
    "init_sbert_params",
    "resolve_sbert_weights",
    "sbert_config_from_hf",
    "sbert_encode",
    "sbert_params_from_jax",
]


@dataclass(frozen=True)
class SbertConfig:
    vocab_size: int = 30522
    hidden_size: int = 384
    num_layers: int = 6
    num_heads: int = 12
    intermediate_size: int = 1536
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12


def sbert_config_from_hf(cfg: dict) -> SbertConfig:
    """Build an SbertConfig from an HF BERT config.json dict (defaults: MiniLM-L6)."""
    return SbertConfig(
        vocab_size=cfg.get("vocab_size", 30522),
        hidden_size=cfg.get("hidden_size", 384),
        num_layers=cfg.get("num_hidden_layers", 6),
        num_heads=cfg.get("num_attention_heads", 12),
        intermediate_size=cfg.get("intermediate_size", 1536),
        max_position_embeddings=cfg.get("max_position_embeddings", 512),
        type_vocab_size=cfg.get("type_vocab_size", 2),
        layer_norm_eps=cfg.get("layer_norm_eps", 1e-12),
    )


class SbertLayer(nn.Module):
    def __init__(self, c: SbertConfig, dtype, device) -> None:
        super().__init__()
        h, inter = c.hidden_size, c.intermediate_size
        self.q = Linear(h, h, True, dtype, device)
        self.k = Linear(h, h, True, dtype, device)
        self.v = Linear(h, h, True, dtype, device)
        self.o = Linear(h, h, True, dtype, device)
        self.attn_ln = LayerNorm(h, c.layer_norm_eps, dtype, device)
        self.up = Linear(h, inter, True, dtype, device)
        self.down = Linear(inter, h, True, dtype, device)
        self.mlp_ln = LayerNorm(h, c.layer_norm_eps, dtype, device)


# The port's parameter names -> the HF BERT checkpoint's.
_HF_LAYER_ROLES = {
    "q": "attention.self.query", "k": "attention.self.key", "v": "attention.self.value",
    "o": "attention.output.dense", "attn_ln": "attention.output.LayerNorm",
    "up": "intermediate.dense", "down": "output.dense", "mlp_ln": "output.LayerNorm",
}
_HF_EMBEDDINGS = {
    "word": "embeddings.word_embeddings.weight", "position": "embeddings.position_embeddings.weight",
    "token_type": "embeddings.token_type_embeddings.weight",
}
# sentence-transformers checkpoints may carry a "bert." prefix.
_HF_PREFIXES = ("", "bert.")


class SbertModel(nn.Module):
    """BERT encoder; parameters uninitialised until :func:`init_sbert_params`,
    :func:`sbert_params_from_jax` or a checkpoint fills them."""

    def __init__(self, config: SbertConfig, dtype=torch.float32, device="cpu") -> None:
        super().__init__()
        c = self.config = config

        def table(rows):
            return nn.Parameter(torch.empty(rows, c.hidden_size, dtype=dtype, device=device), requires_grad=False)

        self.word = table(c.vocab_size)
        self.position = table(c.max_position_embeddings)
        self.token_type = table(c.type_vocab_size)
        self.emb_ln = LayerNorm(c.hidden_size, c.layer_norm_eps, dtype, device)
        self.layers = nn.ModuleList(SbertLayer(c, dtype, device) for _ in range(c.num_layers))

    @property
    def device(self) -> torch.device:
        return self.word.device

    def hf_tensor(self, state, name: str) -> torch.Tensor:
        """The HF BERT checkpoint tensor of parameter ``name``."""
        parts = name.split(".")
        if parts[0] == "layers":
            hf = f"encoder.layer.{parts[1]}.{_HF_LAYER_ROLES[parts[2]]}.{parts[3]}"
        elif parts[0] == "emb_ln":
            hf = f"embeddings.LayerNorm.{parts[1]}"
        else:
            hf = _HF_EMBEDDINGS[parts[0]]
        return find_tensor(state, hf, _HF_PREFIXES)


@torch.inference_mode()
def sbert_encode(model: SbertModel, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
    """BERT forward + masked mean-pool + L2-normalize. Returns [B, hidden] f32.

    ``attention_mask`` [B, L] holds one run of ones from position 0 per row
    (right padding). A row with no valid token pools to 0/0; callers never
    pass one.
    """
    c = model.config
    l = input_ids.shape[1]
    x = embedding(model.word, input_ids) + model.position[:l][None] + model.token_type[0][None, None]
    x = model.emb_ln(x)
    for layer in model.layers:
        attn = multi_head_attention(
            x, layer.q, layer.k, layer.v, layer.o, num_heads=c.num_heads,
            kv_mask=attention_mask, kv_mask_contiguous=True,
        )
        x = layer.attn_ln(x + attn)
        x = layer.mlp_ln(x + mlp_gelu(x, layer.up, layer.down))
    mask = attention_mask[:, :, None].float()
    pooled = (x.float() * mask).sum(dim=1) / mask.sum(dim=1).clamp(min=1e-9)
    return pooled / torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)


@torch.no_grad()
def init_sbert_params(model: SbertModel, generator: torch.Generator) -> SbertModel:
    """Random-init in place (the JAX ``init_sbert_params`` distribution: weights
    and tables ~ N(0, 1) * 0.02, biases zero, norm scales one; the values
    differ). ``generator`` lives on the model's device."""
    for table in (model.word, model.position, model.token_type):
        table.normal_(0.0, 0.02, generator=generator)
    for module in model.modules():
        if isinstance(module, Linear):
            module.weight.normal_(0.0, 0.02, generator=generator)
            module.bias.zero_()
        elif isinstance(module, LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
    return model


@torch.no_grad()
def sbert_params_from_jax(model: SbertModel, tree: dict) -> SbertModel:
    """Load the JAX package's SBERT tree (leaves as numpy arrays) in place: a
    linear kernel ``w`` [in, out] becomes ``weight = w.T``, LayerNorm ``scale``
    becomes ``weight``, tables and biases copy as they are."""

    def copy(dst, src, transpose=False):
        a = np.asarray(src, np.float32)
        t = torch.from_numpy(np.ascontiguousarray(a.T if transpose else a))
        if tuple(t.shape) != tuple(dst.shape):
            raise ValueError(f"shape {tuple(t.shape)} does not fit parameter {tuple(dst.shape)}")
        dst.copy_(t.to(dst.dtype))

    def lin(mod, leaf):
        copy(mod.weight, leaf["w"], transpose=True)
        copy(mod.bias, leaf["b"])

    def ln(mod, leaf):
        copy(mod.weight, leaf["scale"])
        copy(mod.bias, leaf["bias"])

    emb = tree["embeddings"]
    copy(model.word, emb["word"])
    copy(model.position, emb["position"])
    copy(model.token_type, emb["token_type"])
    ln(model.emb_ln, emb["ln"])
    for layer, lt in zip(model.layers, tree["layers"], strict=True):
        for role in ("q", "k", "v", "o"):
            lin(getattr(layer, role), lt["attn"][role])
        lin(layer.up, lt["mlp"]["up"])
        lin(layer.down, lt["mlp"]["down"])
        ln(layer.attn_ln, lt["attn_ln"])
        ln(layer.mlp_ln, lt["mlp_ln"])
    return model


def resolve_sbert_weights() -> str | None:
    """Locate a local all-MiniLM-L6-v2 checkpoint directory, or None:
    ``LMMS_OWC_SBERT_PATH``, else the Hugging Face cache (never the network)."""
    env_path = os.environ.get("LMMS_OWC_SBERT_PATH")
    if env_path and Path(env_path).exists():
        return env_path
    try:
        from huggingface_hub import snapshot_download

        return snapshot_download("sentence-transformers/all-MiniLM-L6-v2", local_files_only=True)
    except Exception:  # no huggingface_hub, or the model is not in the cache
        return None


_LENGTH_BUCKETS = (16, 32, 64, 128, 256)


class SentenceEncoder:
    """Tokenize + length-bucket + batched encode on ``model``'s device."""

    def __init__(self, model: SbertModel, tokenizer) -> None:
        self.model = model
        self.config = model.config
        self.tokenizer = tokenizer

    @classmethod
    def from_pretrained(cls, path: str, dtype=torch.float32, device=None) -> "SentenceEncoder":
        """Load an HF BERT checkpoint directory (``config.json``, safetensors,
        ``tokenizer.json`` or ``vocab.txt``) onto ``device`` (default: the card)."""
        device = get_device(device)
        try:
            config = sbert_config_from_hf(load_config_json(path))
        except FileNotFoundError:
            config = SbertConfig()
        model = SbertModel(config, dtype, device)
        load_hf_tensors(model, load_safetensors_state(path))
        log.info("loaded MiniLM sentence encoder from %s on %s", path, device)
        return cls(model, WordPieceTokenizer.from_pretrained(path))

    @classmethod
    def random_init(cls, seed: int = 0, dtype=torch.float32, device=None) -> "SentenceEncoder":
        device = get_device(device)
        config = SbertConfig()
        model = init_sbert_params(SbertModel(config, dtype, device), torch.Generator(device=device).manual_seed(seed))
        return cls(model, _WhitespaceTokenizer(config.vocab_size))

    def _bucket_len(self, length: int) -> int:
        for b in _LENGTH_BUCKETS:
            if length <= b:
                return b
        return self.config.max_position_embeddings

    def encode(self, sentences: list[str], batch_size: int = 1024) -> np.ndarray:
        """[len(sentences), hidden] f32 unit embeddings, ``batch_size`` rows per forward."""
        out = np.zeros((len(sentences), self.config.hidden_size), dtype=np.float32)
        dev = self.model.device
        for start in range(0, len(sentences), batch_size):
            chunk = sentences[start : start + batch_size]
            enc = self.tokenizer(chunk, max_length=self.config.max_position_embeddings)
            ids, mask = enc["input_ids"], enc["attention_mask"]
            pad = self._bucket_len(ids.shape[1]) - ids.shape[1]
            ids, mask = np.pad(ids, ((0, 0), (0, pad))), np.pad(mask, ((0, 0), (0, pad)))
            embeds = sbert_encode(
                self.model, torch.from_numpy(ids.astype(np.int64)).to(dev), torch.from_numpy(mask).to(dev)
            )
            out[start : start + len(chunk)] = embeds.cpu().numpy()
        return out


class _WhitespaceTokenizer:
    """Hash-based tokenizer for random-init benchmarking (not linguistic): the
    JAX package's, ids equal."""

    def __init__(self, vocab_size: int) -> None:
        self.vocab_size = vocab_size
        self._word_ids: dict[str, int] = {}

    def _word_id(self, token: str) -> int:
        cached = self._word_ids.get(token)
        if cached is None:
            cached = 2000 + int.from_bytes(hashlib.md5(token.encode()).digest()[:3], "little") % (self.vocab_size - 3000)
            self._word_ids[token] = cached
        return cached

    def __call__(self, texts: list[str], max_length: int = 512) -> dict[str, np.ndarray]:
        all_ids = [[101] + [self._word_id(t) for t in text.lower().split()[: max_length - 2]] + [102] for text in texts]
        max_len = max(len(i) for i in all_ids)
        input_ids = np.zeros((len(all_ids), max_len), dtype=np.int32)
        mask = np.zeros((len(all_ids), max_len), dtype=np.int32)
        for row, ids in enumerate(all_ids):
            input_ids[row, : len(ids)] = ids
            mask[row, : len(ids)] = 1
        return {"input_ids": input_ids, "attention_mask": mask}
