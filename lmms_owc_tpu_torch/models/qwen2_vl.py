"""Qwen2-VL model adapter of the port: engine requests -> batched GPU generation.

Counterpart of :mod:`lmms_owc_tpu.models.qwen2_vl` (``generate_until``,
``generate_until_multi_round`` and ``loglikelihood``) for the Qwen2-VL and
Qwen2.5-VL presets and checkpoints. The host side is the same: requests
are grouped by generation kwargs, sorted by estimated prompt tokens (text +
vision), packed into token-budget macro batches, LEFT-padded to length buckets
and decoded together. Images are resized on the host, grouped by patch bucket
(Qwen2.5-VL: by grid, in its padded window layout) and run through the vision
tower in batches whose row count is padded to ``VISION_ROW_BUCKETS``. Weights are
bf16/f32, int8 (``load_in_8bit``, with W8A8 under ``int8_activations``) or
int4 (``load_in_4bit``); ``LMMS_OWC_DECODE_POOL`` > 1 decodes several chunks
as one pool, and ``LMMS_OWC_KV_INT8`` keeps the decode cache in int8. A
``pretrained`` checkpoint directory (HF layout: ``config.json``, safetensors
shards, ``tokenizer.json``) is read by the port's own safetensors reader and
byte-level BPE tokenizer (:mod:`lmms_owc_tpu_torch.nn.loader`,
:mod:`lmms_owc_tpu_torch.tokenizer`). Under ``LMMS_OWC_HOST_PROF=1`` the host
stages carry the JAX adapter's timers (:mod:`lmms_owc_tpu_torch.utils._hostprof`),
and a pooled ``generate_until`` prints their table.
"""

from __future__ import annotations

import hashlib
import os
import re
from pathlib import Path

import numpy as np
import torch

from lmms_owc_tpu_torch.models._api import register_model
from lmms_owc_tpu_torch.models._base import Model
from lmms_owc_tpu_torch.nn import qwen2_5_vl as qvl25
from lmms_owc_tpu_torch.nn import qwen2_vl as qvl
from lmms_owc_tpu_torch.nn.layers import Int4Linear, Int8Linear, set_int8_activations
from lmms_owc_tpu_torch.nn.loader import load_config_json, load_safetensors_state
from lmms_owc_tpu_torch.ops import quant
from lmms_owc_tpu_torch.ops.image import (
    patchify_images_batch,
    resize_host_batch,
    smart_resize,
)
from lmms_owc_tpu_torch.parallel.sharding import shard_model
from lmms_owc_tpu_torch.tokenizer import Tokenizer
from lmms_owc_tpu_torch.utils import Collator, get_logger, pad_to_bucket
from lmms_owc_tpu_torch.utils import _hostprof
from lmms_owc_tpu_torch.utils._hostprof import hostprof, hostprof_dump, hostprof_reset

log = get_logger(__name__)

__all__ = ["PRESET_CONFIGS", "Qwen2VL", "plan_decode_pools"]

DEFAULT_MAX_PIXELS = 1024 * 28 * 28
DEFAULT_MIN_PIXELS = 4 * 28 * 28
DEFAULT_MAX_NEW_TOKENS = 128

# Architecture presets (HF config.json form) so random-init runs need no checkpoint.
PRESET_CONFIGS = {
    "qwen2-vl-2b": dict(
        vocab_size=151936, hidden_size=1536, num_hidden_layers=28, num_attention_heads=12,
        num_key_value_heads=2, intermediate_size=8960, tie_word_embeddings=True,
    ),
    "qwen2-vl-7b": dict(
        vocab_size=152064, hidden_size=3584, num_hidden_layers=28, num_attention_heads=28,
        num_key_value_heads=4, intermediate_size=18944, tie_word_embeddings=False,
    ),
    "qwen2.5-vl-3b": dict(
        model_type="qwen2_5_vl",
        vocab_size=151936, hidden_size=2048, num_hidden_layers=36, num_attention_heads=16,
        num_key_value_heads=2, intermediate_size=11008, tie_word_embeddings=True,
        vision_config=dict(
            depth=32, hidden_size=1280, num_heads=16, intermediate_size=3420,
            out_hidden_size=2048, window_size=112, fullatt_block_indexes=[7, 15, 23, 31],
        ),
    ),
    "qwen2.5-vl-7b": dict(
        model_type="qwen2_5_vl",
        vocab_size=152064, hidden_size=3584, num_hidden_layers=28, num_attention_heads=28,
        num_key_value_heads=4, intermediate_size=18944, tie_word_embeddings=False,
        vision_config=dict(
            depth=32, hidden_size=1280, num_heads=16, intermediate_size=3420,
            out_hidden_size=3584, window_size=112, fullatt_block_indexes=[7, 15, 23, 31],
        ),
    ),
    # Flagship-shaped dry-run config: every sharding-relevant width of the 7B
    # (hidden 3584, 28/4 heads, 18944 intermediate, a 1280-wide tower) with
    # the layer counts cut to 2 and a 19456-token vocabulary, for the
    # tensor-parallel dry run (``python -m lmms_owc_tpu_torch.parallel.dryrun``).
    # Not a serving preset.
    "qwen2-vl-flagship-dryrun": dict(
        vocab_size=19456, hidden_size=3584, num_hidden_layers=2, num_attention_heads=28,
        num_key_value_heads=4, intermediate_size=18944, tie_word_embeddings=False,
        image_token_id=5, video_token_id=6, vision_start_token_id=3,
        eos_token_id=2, pad_token_id=0,
        vision_config=dict(depth=2, embed_dim=1280, num_heads=16, mlp_ratio=4.0,
                           hidden_size=3584),
    ),
    # CPU-testable miniature (same special-token space, tiny everything else).
    "qwen2-vl-tiny": dict(
        vocab_size=152064, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, intermediate_size=128, tie_word_embeddings=True,
        rope_scaling={"type": "mrope", "mrope_section": [2, 3, 3]},
        vision_config=dict(depth=2, embed_dim=32, num_heads=4, mlp_ratio=2.0, hidden_size=64),
    ),
    # CPU-testable miniature for the 2.5 tower (window + global attention layers).
    "qwen2.5-vl-tiny": dict(
        model_type="qwen2_5_vl",
        vocab_size=152064, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, intermediate_size=128, tie_word_embeddings=True,
        rope_scaling={"type": "mrope", "mrope_section": [2, 3, 3]},
        vision_config=dict(
            depth=2, hidden_size=32, num_heads=4, intermediate_size=64,
            out_hidden_size=64, window_size=56, fullatt_block_indexes=[1],
        ),
    ),
}

_IM_START = "<|im_start|>"
_IM_END = "<|im_end|>"
_VISION_START = "<|vision_start|>"
_VISION_END = "<|vision_end|>"
_IMAGE_PAD = "<|image_pad|>"

# Qwen2-VL special token ids (tokenizer_config.json of the released checkpoints).
SPECIAL_IDS = {
    "<|endoftext|>": 151643,
    _IM_START: 151644,
    _IM_END: 151645,
    _VISION_START: 151652,
    _VISION_END: 151653,
    _IMAGE_PAD: 151655,
    "<|video_pad|>": 151656,
}

PATCH_BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096)
# Vision-tower batch (row) buckets: ~12.5% granularity bounds the work spent
# on replicated rows while keeping the set of tower shapes small.
VISION_ROW_BUCKETS = (
    1, 2, 3, 4, 6, 8, 10, 12, 16, 20, 24, 28, 32, 40, 48, 56, 64,
    80, 96, 112, 128, 160, 192, 224, 256, 320, 384,
)
GEN_LEN_BUCKETS = (64, 128, 256, 512)
# On the card each decode step's float products run on blocks of this many
# rows (the JAX bench's pool of 2 x batch 48 = 96 rows fits one block, so the
# weights are read once per step), pooled and unpooled alike: cuBLAS picks its
# split of K by the row count, and a row's tokens must not depend on its batch.
# Layers of W8A8 or K4 products keep the batch's rows, at least
# ``REDUCE_ROWS`` (``decode_step``).
DECODE_ROWS = 128


def plan_decode_pools(
    chunks: list, pool_n: int, batch_size: int, bucket_fn=None, device=None
) -> list[list]:
    """Group consecutive same-gen-kwargs chunks into decode pools (the JAX rule).

    Up to ``pool_n`` chunks always pool. A pool then extends past ``pool_n``
    while its rows are below ``pool_n x batch_size`` and its estimated KV
    footprint, rows x (prompt bucket + gen bucket), stays within
    ``LMMS_OWC_POOL_KV_CAP_X`` (default 1.5) times the uniform pool's
    (``pool_n x batch_size x (320 + 64)``); an int8 KV cache (on ``device``,
    see :func:`~lmms_owc_tpu_torch.nn.qwen2_vl.kv_cache_int8_enabled`) admits
    1.6x the row-tokens. ``bucket_fn(chunk)`` estimates a chunk's prompt
    bucket (320 without it).
    """
    pools: list[list] = []
    cur_key = None
    rows = bucket = 0
    cap_x = float(os.environ.get("LMMS_OWC_POOL_KV_CAP_X", "1.5"))
    kv_cap = int(cap_x * pool_n * batch_size * (320 + 64))
    if qvl.kv_cache_int8_enabled(device):
        kv_cap = int(kv_cap * 1.6)  # 128 B values + 32 B scales per token vs 256 B bf16
    for chunk in chunks:
        key = repr(chunk[0][1])
        n_rows = len(chunk)
        c_bucket = bucket_fn(chunk) if bucket_fn is not None else 320
        gk = dict(chunk[0][1] or {})
        gen_bucket = pad_to_bucket(int(gk.get("max_new_tokens", DEFAULT_MAX_NEW_TOKENS)), GEN_LEN_BUCKETS)
        if (
            pools
            and key == cur_key
            and (
                len(pools[-1]) < pool_n
                or (
                    rows < pool_n * batch_size
                    and (rows + n_rows) * (max(bucket, c_bucket) + gen_bucket) <= kv_cap
                )
            )
        ):
            pools[-1].append(chunk)
            rows += n_rows
            bucket = max(bucket, c_bucket)
        else:
            pools.append([chunk])
            cur_key = key
            rows = n_rows
            bucket = c_bucket
    return pools


def _assemble_embeds(
    decoder: qvl.Qwen2VLModel,
    input_ids: torch.Tensor,
    vision_flat: torch.Tensor | None,
    index_map: torch.Tensor | None,
) -> torch.Tensor:
    """The decoder's token embeddings (:func:`~lmms_owc_tpu_torch.nn.qwen2_vl.embed_tokens`,
    so a sharded vocabulary too) with vision tokens gathered in where ``index_map >= 0``."""
    tok = qvl.embed_tokens(decoder, input_ids)
    if vision_flat is None:
        return tok
    gathered = vision_flat[index_map.clamp(min=0)].to(tok.dtype)
    return torch.where((index_map >= 0)[..., None], gathered, tok)


class _FallbackTokenizer:
    """Deterministic hash tokenizer for random-init runs (no checkpoint).

    Same ids as the JAX package's fallback tokenizer: the Qwen special tokens
    exactly, plain words hashed to stable ids below the first special id. The
    config (source of truth for special ids and vocab size) keeps ids in range.
    """

    def __init__(self, config=None) -> None:
        self.special_ids = dict(SPECIAL_IDS)
        vocab = 152064
        if config is not None:
            vocab = config.vocab_size
            self.special_ids.update({
                _IM_END: config.eos_token_id,
                "<|endoftext|>": config.pad_token_id,
                _VISION_START: config.vision_start_token_id,
                _IMAGE_PAD: config.image_token_id,
                "<|video_pad|>": config.video_token_id,
                # Not in the config; released checkpoints place them adjacent.
                _IM_START: max(config.eos_token_id - 1, 1),
                _VISION_END: config.vision_start_token_id + 1,
            })
        self.eos_token_id = self.special_ids[_IM_END]
        self.pad_token_id = self.special_ids["<|endoftext|>"]
        self._plain_span = max(1000, min(vocab, min(self.special_ids.values())) - 1001)
        self._pattern = re.compile("|".join(re.escape(s) for s in self.special_ids))
        self._inverse = {v: k for k, v in self.special_ids.items()}

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        pos = 0
        for match in self._pattern.finditer(text):
            ids.extend(self._encode_plain(text[pos : match.start()]))
            ids.append(self.special_ids[match.group()])
            pos = match.end()
        ids.extend(self._encode_plain(text[pos:]))
        return ids

    def _encode_plain(self, text: str) -> list[int]:
        return [
            1000 + int.from_bytes(hashlib.md5(w.encode()).digest()[:3], "little") % self._plain_span
            for w in text.split()
        ]

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        words = []
        for i in ids:
            i = int(i)
            if i in self._inverse:
                if not skip_special_tokens:
                    words.append(self._inverse[i])
            else:
                words.append(f"tok{i}")
        return " ".join(words)


class Qwen2VL(Model):
    """Qwen2-VL on the PyTorch/CUDA stack."""

    supports_mesh = True
    presets = PRESET_CONFIGS

    def __init__(
        self,
        pretrained: str | None = None,
        preset: str = "qwen2-vl-2b",
        max_pixels: int = DEFAULT_MAX_PIXELS,
        min_pixels: int = DEFAULT_MIN_PIXELS,
        random_init: bool = False,
        system_prompt: str = "You are a helpful assistant.",
        jax_params: dict | None = None,
        time_phases: bool = False,
        int8_activations: bool = False,
        **kwargs,
    ) -> None:
        """Weights come from the ``pretrained`` checkpoint directory (its
        ``config.json`` gives the architecture; with ``load_in_8bit`` /
        ``load_in_4bit`` each layer is quantized on the device as it loads),
        from ``jax_params`` (the JAX package's parameter tree as numpy arrays,
        float or quantized, see
        :func:`lmms_owc_tpu_torch.nn.qwen2_vl.params_from_jax`), or are drawn
        on the device from ``torch_random_seed`` (the CLI's third ``--seed``
        value; ``random_init``, implied when there is no
        ``pretrained``; quantized runs draw and quantize one layer at a time).
        A ``pretrained`` directory that does not exist raises
        ``FileNotFoundError`` unless ``random_init`` is set, as in the JAX
        adapter. ``int8_activations`` turns on W8A8 for the process, as the JAX adapter
        does. ``time_phases`` synchronizes the device around the vision,
        prefill and decode phases and sums their wall seconds into
        :attr:`phase_seconds` (with several chunks the next chunk's vision runs
        beside the current decode, so the phases then overlap). With
        ``model_parallel`` > 1 (:class:`~lmms_owc_tpu_torch.models._base.Model`)
        the decoder and the Qwen2-VL tower are sharded over the model group as
        each module is drawn or loaded (:mod:`lmms_owc_tpu_torch.parallel.sharding`;
        the Qwen2.5-VL tower stays whole)."""
        if preset not in self.presets:
            raise ValueError(f"unknown preset {preset!r}; available: {sorted(self.presets)}")
        self.preset = preset
        self.pretrained = pretrained
        self.random_init = random_init or pretrained is None
        self.max_pixels = int(max_pixels)
        self.min_pixels = int(min_pixels)
        self.system_prompt = system_prompt
        self._jax_params = jax_params
        self.time_phases = bool(time_phases)
        if int8_activations:
            set_int8_activations(True)
        super().__init__(model_id=preset, **kwargs)

    # ------------------------------------------------------------------- load

    def load_model(self) -> None:
        checkpoint = self.pretrained is not None and Path(self.pretrained).exists()
        if self.pretrained is not None and not checkpoint and not self.random_init:
            raise FileNotFoundError(f"checkpoint not found: {self.pretrained}")
        hf = load_config_json(self.pretrained) if checkpoint else PRESET_CONFIGS[self.preset]
        self.config = qvl.Qwen2VLConfig.from_hf_dict(hf)
        self.is_v25 = hf.get("model_type") == "qwen2_5_vl"
        self.vision25_config = (
            qvl25.Qwen25VisionConfig.from_hf_dict(hf.get("vision_config", {})) if self.is_v25 else None
        )
        bits = 4 if self.load_in_4bit else (8 if self.load_in_8bit else None)
        gen = torch.Generator(device=self.device).manual_seed(self.torch_random_seed)

        def build(device):
            return qvl.Qwen2VLModel(self.config, self.torch_dtype, device, vision25=self.vision25_config)

        if checkpoint:
            self.tokenizer = Tokenizer.from_pretrained(self.pretrained)
            self._check_vocabulary()
            state = load_safetensors_state(self.pretrained)
            # Modules are built on meta, then each weight is read (quantized
            # and dropped), and under tensor parallelism sliced, in turn.
            self.model = build("meta")
            shard = self._shard_hook(self.model, bits)
            if bits is not None:
                quant.load_quantized_on_device(self.model, state, bits=bits, dtype=self.torch_dtype, device=self.device,
                                               after=shard)
            else:
                qvl.load_hf_weights(self.model, state, self.device, shard)
            del state
            log.info("loaded %s from %s (%s)", self.preset, self.pretrained, f"int{bits}" if bits else self.dtype)
        elif self._jax_params is not None:
            self.model = build(self.device)
            qvl.params_from_jax(self.model, self._jax_params)
            self._jax_params = None
            quantized = any(isinstance(m, (Int8Linear, Int4Linear)) for m in self.model.modules())
            if bits is not None and not quantized:  # a float tree, served quantized
                (quant.quantize_params_int8 if bits == 8 else quant.quantize_params_int4)(self.model)
            if self.model_group is not None:
                shard_model(self.model, self.model_group)
            log.info("loaded %s from a JAX parameter tree", self.preset)
        else:
            # The full-precision tree never exists: modules are built on the
            # meta device, then each weight is drawn (and quantized), and under
            # tensor parallelism sliced, in turn.
            self.model = build("meta")
            shard = self._shard_hook(self.model, bits)
            if bits is not None:
                quant.init_quantized_on_device(self.model, gen, bits=bits, dtype=self.torch_dtype, after=shard)
            else:
                qvl.init_params(self.model, gen, shard)
            log.warning("random-init %s%s on %s (no checkpoint)", f"int{bits} " if bits else "", self.preset,
                        self.device)
        if not checkpoint:
            self.tokenizer = _FallbackTokenizer(self.config)
        self.generator = torch.Generator(device=self.device).manual_seed(self.torch_random_seed)
        # The CPU path keeps the JAX package's shapes, which its parity tests compare.
        self.decode_rows = DECODE_ROWS if self.device.type == "cuda" else None

    def _check_vocabulary(self) -> None:
        """Every token id the adapter feeds to the embedding or stops on must be
        inside the checkpoint's vocabulary. (The JAX adapter's ``jnp.take``
        fills an out-of-range row with NaN and then decodes empty strings; the
        port's embedding would raise at the first prompt instead.)"""
        c = self.config
        ids = {
            "pad_token_id": c.pad_token_id, "eos_token_id": c.eos_token_id,
            "image_token_id": c.image_token_id, "vision_start_token_id": c.vision_start_token_id,
            "the tokenizer's eos_token_id": self.tokenizer.eos_token_id,
            "the tokenizer's pad_token_id": self.tokenizer.pad_token_id,
        }
        for name, value in ids.items():
            if value is not None and not 0 <= int(value) < c.vocab_size:
                raise ValueError(
                    f"{self.pretrained}: {name} {value} lies outside the checkpoint's vocabulary "
                    f"of {c.vocab_size} tokens"
                )

    @property
    def eos_token_ids(self) -> list[int]:
        ids = {int(self.config.eos_token_id), int(self.config.pad_token_id)}
        eos = getattr(self.tokenizer, "eos_token_id", None)
        if eos is not None:
            ids.add(int(eos))
        return sorted(ids)

    # -------------------------------------------------------------- prompting

    def _build_prompt(self, context: str, num_images: int) -> str:
        """Chat-formatted prompt with one vision block per image (Qwen2-VL template)."""
        vision = f"{_VISION_START}{_IMAGE_PAD}{_VISION_END}" * num_images
        return (
            f"{_IM_START}system\n{self.system_prompt}{_IM_END}\n"
            f"{_IM_START}user\n{vision}{context}{_IM_END}\n"
            f"{_IM_START}assistant\n"
        )

    def apply_chat_template(self, messages: list[dict]) -> str:
        parts = [f"{_IM_START}{msg['role']}\n{msg['content']}{_IM_END}\n" for msg in messages]
        parts.append(f"{_IM_START}assistant\n")
        return "".join(parts)

    @property
    def chat_template(self) -> str:
        return "qwen2-vl"

    @property
    def tokenizer_name(self) -> str:
        return f"qwen2_vl_{self.preset}"

    def _tokenize_with_images(self, prompt: str, image_token_counts: list[int]) -> list[int]:
        """Tokenize, expanding each single <|image_pad|> to its merged token count."""
        image_pad = self.config.image_token_id
        out: list[int] = []
        img_idx = 0
        for tok in self.tokenizer.encode(prompt):
            if tok == image_pad:
                out.extend([image_pad] * image_token_counts[img_idx])
                img_idx += 1
            else:
                out.append(tok)
        return out

    # ----------------------------------------------------------------- vision

    @torch.inference_mode()
    def _encode_images_flat(self, all_visuals: list):
        """Encode every image of a macro batch.

        Host resize -> group by resized size (patchify needs a common H, W) ->
        group sizes by patch bucket -> one tower call per bucket segment, rows
        padded to a ``VISION_ROW_BUCKETS`` count by replicating the last row
        (real data, so no all-masked softmax rows).

        Returns (vision_flat [K, hidden] on the device or None, per-image
        (flat_offset, token_count), grids).
        """
        if not all_visuals:
            return None, [], []
        if self.is_v25:
            return self._encode_images_flat_v25(all_visuals)
        v = self.config.vision
        merge_sq = v.spatial_merge_size**2
        factor = v.patch_size * v.spatial_merge_size
        dtype = self.model.dtype
        dev = self.device

        with hostprof("prep_resize"):
            resized = resize_host_batch(all_visuals, self.min_pixels, self.max_pixels, factor)
        grids = [(1, hw[0] // v.patch_size, hw[1] // v.patch_size) for _, hw in resized]

        by_size: dict[tuple[int, int], list[int]] = {}
        for idx, (_, hw) in enumerate(resized):
            by_size.setdefault(hw, []).append(idx)

        by_bucket: dict[int, list[tuple[list[int], int, torch.Tensor]]] = {}
        for hw, indices in by_size.items():
            with hostprof("prep_stack"):
                stacked = np.stack([resized[i][0] for i in indices])  # [n, C, H, W]
            num_patches = (hw[0] // v.patch_size) * (hw[1] // v.patch_size)
            bucket = pad_to_bucket(num_patches, PATCH_BUCKETS)
            with hostprof("prep_upload"):
                stacked_dev = torch.from_numpy(stacked).to(dev)
            with hostprof("prep_patchify"):
                patches = patchify_images_batch(
                    stacked_dev, v.patch_size, v.temporal_patch_size, v.spatial_merge_size, dtype
                )
                patches = torch.nn.functional.pad(patches, (0, 0, 0, bucket - num_patches))
            by_bucket.setdefault(bucket, []).append((indices, num_patches, patches))

        group_outputs: list[torch.Tensor] = []
        spans: dict[int, tuple[int, int]] = {}  # image idx -> (flat offset, merged count)
        flat_offset = 0
        for bucket, entries in by_bucket.items():
            patches = torch.cat([e[2] for e in entries]) if len(entries) > 1 else entries[0][2]
            n = patches.shape[0]
            freq_table = np.zeros((len(entries), bucket, v.head_dim // 2), np.float32)
            mask_table = np.zeros((len(entries), bucket), np.int32)
            gids: list[int] = []
            row_info: list[tuple[int, int]] = []  # (image idx, merged count) per row
            all_full = True
            for g, (indices, num_patches, _) in enumerate(entries):
                freq_table[g, :num_patches] = qvl.vision_rope_cos_sin([grids[indices[0]]], v)
                mask_table[g, :num_patches] = 1
                all_full = all_full and num_patches == bucket
                for idx in indices:
                    gids.append(g)
                    row_info.append((idx, num_patches // merge_sq))
            gids_np = np.asarray(gids, np.int64)
            freq_table_dev = torch.from_numpy(freq_table).to(dev)
            mask_table_dev = None if all_full else torch.from_numpy(mask_table).to(dev)
            merged_bucket = bucket // merge_sq
            # Cap each tower call at batch_size x 1024 patch tokens.
            cap = max(1, (self.batch_size * 1024) // bucket)
            for s in range(0, n, cap):
                seg_patches = patches[s : s + cap]
                m = seg_patches.shape[0]
                seg_gids = gids_np[s : s + cap]
                m_rows = pad_to_bucket(m, VISION_ROW_BUCKETS)
                if m_rows > m:
                    seg_patches = torch.cat(
                        [seg_patches, seg_patches[-1:].expand(m_rows - m, *seg_patches.shape[1:])]
                    )
                    seg_gids = np.concatenate([seg_gids, np.repeat(seg_gids[-1:], m_rows - m)])
                gids_dev = torch.from_numpy(seg_gids).to(dev)
                freqs = freq_table_dev[gids_dev]
                patch_mask = None if all_full else mask_table_dev[gids_dev]
                with hostprof("prep_tower"):
                    out = self.model.vision(seg_patches, freqs, patch_mask)  # [m_rows, merged, hidden]
                group_outputs.append(out.reshape(m_rows * merged_bucket, -1))
                for row, (idx, merged_count) in enumerate(row_info[s : s + cap]):
                    spans[idx] = (flat_offset + row * merged_bucket, merged_count)
                flat_offset += m_rows * merged_bucket

        vision_flat = torch.cat(group_outputs) if len(group_outputs) > 1 else group_outputs[0]
        return vision_flat, [spans[i] for i in range(len(all_visuals))], grids

    @torch.inference_mode()
    def _encode_images_flat_v25(self, all_visuals: list):
        """Qwen2.5-VL vision: images grouped by grid, each group in its uniform
        padded window layout.

        Per grid: patchify, rows padded to a ``VISION_ROW_BUCKETS`` count by
        replicating the last image, tokens gathered into the [W, S] window
        layout (padding slots zeroed), rope freqs and the validity mask in slot
        order (no mask when every slot is real), one tower call, and a second
        gather that restores the merge units' original order. Returns as
        :meth:`_encode_images_flat`.
        """
        v25 = self.vision25_config
        mu = v25.spatial_merge_size**2
        factor = v25.patch_size * v25.spatial_merge_size
        dtype = self.model.dtype
        dev = self.device

        with hostprof("prep_resize"):
            resized = resize_host_batch(all_visuals, self.min_pixels, self.max_pixels, factor)
        grids = [(1, hw[0] // v25.patch_size, hw[1] // v25.patch_size) for _, hw in resized]
        by_size: dict[tuple[int, int, int], list[int]] = {}
        for idx, grid in enumerate(grids):
            by_size.setdefault(grid, []).append(idx)

        group_outputs: list[torch.Tensor] = []
        spans: dict[int, tuple[int, int]] = {}
        flat_offset = 0
        for grid, indices in by_size.items():
            stacked = torch.from_numpy(np.stack([resized[i][0] for i in indices])).to(dev)
            patches = patchify_images_batch(
                stacked, v25.patch_size, v25.temporal_patch_size, v25.spatial_merge_size, dtype
            )  # [n, P, patch_dim], merge units contiguous
            n = pad_to_bucket(len(indices), VISION_ROW_BUCKETS)
            if n > len(indices):
                patches = torch.cat([patches, patches[-1:].expand(n - len(indices), *patches.shape[1:])])
            n_units = patches.shape[1] // mu

            slot_src, num_windows, s_tokens = qvl25.get_window_layout(grid, v25)
            valid_units = slot_src >= 0
            tok_idx = (np.where(valid_units, slot_src, 0)[:, None] * mu + np.arange(mu)).reshape(-1)
            valid = np.repeat(valid_units, mu).astype(np.int32)  # [W*S]
            valid_dev = torch.from_numpy(valid).to(dev)
            gathered = patches[:, torch.from_numpy(tok_idx).to(dev)] * valid_dev[None, :, None].to(dtype)
            freqs = (qvl25.vision25_rope_freqs(grid, v25)[tok_idx] * valid[:, None]).astype(np.float32)
            freqs_dev = torch.from_numpy(freqs).to(dev).view(1, num_windows, s_tokens, -1)
            mask = None if valid.all() else valid_dev.view(1, num_windows, s_tokens).expand(n, -1, -1)
            out = self.model.vision(
                gathered.view(n, num_windows, s_tokens, -1),
                freqs_dev.expand(n, -1, -1, -1),
                mask,
            )  # [n, W*S/mu, out_hidden] in slot order
            pos_of = np.zeros(n_units, np.int64)  # slot of each source merge unit
            pos_of[slot_src[valid_units]] = np.nonzero(valid_units)[0]
            restored = out[:, torch.from_numpy(pos_of).to(dev)]  # [n, n_units, hidden]
            group_outputs.append(restored.reshape(n * n_units, -1))
            for row, idx in enumerate(indices):
                spans[idx] = (flat_offset + row * n_units, n_units)
            flat_offset += n * n_units

        vision_flat = torch.cat(group_outputs) if len(group_outputs) > 1 else group_outputs[0]
        return vision_flat, [spans[i] for i in range(len(all_visuals))], grids

    # ------------------------------------------------------------- generation

    @torch.inference_mode()
    def _build_batch_inputs(self, batch: list[tuple], vision_flat=None):
        """Inputs for one macro batch of (token_ids, vision_spans, grids):
        left-padded ids and mask, M-RoPE positions, and the token embeddings
        with vision embeddings gathered in.

        Returns (embeds [B, L, hidden] on the device, position_ids [3, B, L] np,
        attention_mask [B, L] np, next_pos [B] np, bucket_len).
        """
        bsz = len(batch)
        bucket_len = pad_to_bucket(max(len(ids) for ids, _, _ in batch))
        input_ids = np.full((bsz, bucket_len), self.config.pad_token_id, np.int64)
        attention_mask = np.zeros((bsz, bucket_len), np.int64)
        index_map = np.full((bsz, bucket_len), -1, np.int64)
        for row, (ids, spans, _) in enumerate(batch):
            offset = bucket_len - len(ids)
            input_ids[row, offset:] = ids
            attention_mask[row, offset:] = 1
            positions = np.where(np.asarray(ids) == self.config.image_token_id)[0]
            cursor = 0
            for span_off, span_count in spans:
                span_positions = positions[cursor : cursor + span_count]
                index_map[row, offset + span_positions] = span_off + np.arange(span_count)
                cursor += span_count

        all_grids = [g for _, _, grids in batch for g in grids]
        position_ids, next_pos = qvl.get_rope_index(input_ids, attention_mask, all_grids, self.config)
        dev = self.device
        embeds = _assemble_embeds(
            self.model,
            torch.from_numpy(input_ids).to(dev),
            vision_flat,
            torch.from_numpy(index_map).to(dev) if vision_flat is not None else None,
        )
        return embeds, position_ids, attention_mask, next_pos, bucket_len

    def _run_batch(self, batch: list[tuple], gen_kwargs: dict, vision_flat=None) -> list[str]:
        """Generate for one macro batch of (token_ids, vision_spans, grids)."""
        max_new_tokens = int(gen_kwargs.get("max_new_tokens", DEFAULT_MAX_NEW_TOKENS))
        embeds, position_ids, attention_mask, next_pos, bucket_len = self._build_batch_inputs(
            batch, vision_flat
        )
        dev = self.device
        cache_len = bucket_len + pad_to_bucket(max_new_tokens, GEN_LEN_BUCKETS)
        tokens = qvl.greedy_generate(
            self.model,
            embeds,
            torch.from_numpy(position_ids).to(dev),
            torch.from_numpy(attention_mask.astype(np.int32)).to(dev),
            torch.from_numpy(next_pos).to(dev),
            max_new_tokens=max_new_tokens,
            cache_len=cache_len,
            eos_ids=torch.tensor(self.eos_token_ids, dtype=torch.long, device=dev),
            generator=self.generator,
            do_sample=bool(gen_kwargs.get("do_sample", False)),
            temperature=float(gen_kwargs.get("temperature") or 1.0),
            top_p=float(gen_kwargs.get("top_p") or 1.0),
            phase=self._phase,
            decode_rows=self.decode_rows,
        )
        return self._detokenize(tokens.cpu().numpy())

    @staticmethod
    def _trim_until(text: str, until: list[str] | None) -> str:
        for stop in until or []:
            if stop and stop in text:
                text = text.split(stop)[0]
        return text

    def _fetch_visuals(self, args: tuple) -> list:
        return self._request_visuals(*args[2:6])

    def _prepare_requests_batch(self, chunk: list[tuple]) -> tuple[list[tuple], object]:
        """One batched vision pass over every image of the chunk, then
        per-request tokenization. Returns (rows, vision_flat); each row is
        (token_ids, vision_spans, grids)."""
        all_visuals: list = []
        counts: list[int] = []
        with hostprof("prep_fetch"):
            for args in chunk:
                visuals = self._fetch_visuals(args)
                counts.append(len(visuals))
                all_visuals.extend(visuals)

        with self._phase("vision"), hostprof("prep_vision"):
            vision_flat, spans, flat_grids = self._encode_images_flat(all_visuals)

        merge_sq = self.config.vision.spatial_merge_size**2
        rows = []
        offset = 0
        for args, n_images in zip(chunk, counts):
            row_spans = spans[offset : offset + n_images]
            grids = flat_grids[offset : offset + n_images]
            offset += n_images
            token_counts = [(g[0] * g[1] * g[2]) // merge_sq for g in grids]
            ids = self._tokenize_with_images(self._build_prompt(args[0], n_images), token_counts)
            rows.append((ids, row_spans, grids))
        return rows, vision_flat

    def _estimate_prompt_tokens(self, args: tuple) -> int:
        """Collator sort key: estimated prompt tokens (text + vision, from the
        smart-resize arithmetic on ``img.size``), so like-size images share a
        chunk and short prompts stay in short buckets."""
        est = len(args[0]) // 4
        try:
            visuals = self._fetch_visuals(args)
        except Exception:
            return est
        v = self.config.vision
        merge_sq = v.spatial_merge_size**2
        factor = v.patch_size * v.spatial_merge_size
        for img in visuals:
            try:
                width, height = img.size
                rh, rw = smart_resize(
                    height, width, factor=factor, min_pixels=self.min_pixels,
                    max_pixels=self.max_pixels,
                )
                est += (rh // v.patch_size) * (rw // v.patch_size) // merge_sq
            except Exception:
                continue
        return est

    def _collate(self, args_list: list) -> tuple[Collator, list, object]:
        """(collator, chunks, pool_bucket_fn) for generation requests, as the
        JAX adapter batches them: grouped by gen_kwargs and, at batch sizes
        above 1 (unless ``LMMS_OWC_SORT_BY_VISION=0``), sorted by estimated
        prompt tokens (text + vision) into token-budget chunks; otherwise
        sorted by context length into chunks of ``batch_size``."""
        batch_fn = None
        pool_bucket_fn = None
        if self.batch_size > 1 and bool(int(os.environ.get("LMMS_OWC_SORT_BY_VISION", "1"))):
            est_cache: dict[int, int] = {}

            def _est(args) -> int:
                key = id(args)
                if key not in est_cache:
                    est_cache[key] = self._estimate_prompt_tokens(args)
                return est_cache[key]

            sort_fn = lambda args: -_est(args)  # noqa: E731
            # Token-budget chunking: each batch's row count is set by its
            # leader (the longest item) so rows x prompt_bucket stays near
            # batch_size x 320, the uniform-448 chunk's token footprint.
            budget = self.batch_size * 320
            state = {"flushed": -1, "cap": self.batch_size}

            def batch_fn(n_flushed, args):
                if n_flushed != state["flushed"]:  # first item of a new batch
                    state["flushed"] = n_flushed
                    bucket = pad_to_bucket(_est(args) + 48)
                    state["cap"] = max(8, min(2 * self.batch_size, budget // bucket))
                return state["cap"]

            def pool_bucket_fn(chunk):
                return pad_to_bucket(_est(chunk[0]) + 48)
        else:
            sort_fn = lambda args: -len(args[0])  # noqa: E731
        collator = Collator(args_list, sort_fn=sort_fn, group_fn=lambda args: repr(args[1]), group_by="gen_kwargs")
        return collator, list(collator.get_batched(n=self.batch_size, batch_fn=batch_fn)), pool_bucket_fn

    def generate_until(self, requests) -> list[str]:
        collator, chunks, pool_bucket_fn = self._collate([req.args for req in requests])

        pool_n = int(os.environ.get("LMMS_OWC_DECODE_POOL", "1"))
        if pool_n > 1:
            hostprof_reset()
            out = collator.get_original(self._generate_pooled(chunks, pool_n, pool_bucket_fn))
            hostprof_dump(f"generate_until n={len(requests)}")
            return out

        def run(chunk, prepared):
            rows, vision_flat = prepared
            gen_kwargs = dict(chunk[0][1] or {})
            until = gen_kwargs.get("until") or []
            if isinstance(until, str):
                until = [until]
            texts = self._run_batch(rows, gen_kwargs, vision_flat)
            return [self._trim_until(t, until).strip() for t in texts]

        # Host prep and the vision encode of the next chunks overlap the decode
        # of the current one (a worker thread; the kernels queue on one stream).
        results = self._foreach_chunk_pipelined(chunks, self._prepare_requests_batch, run)
        return collator.get_original(results)

    def _generate_pooled(self, chunks: list, pool_n: int, bucket_fn=None) -> list[str]:
        """Decode-pool scheduling: consecutive chunks that share gen_kwargs pool
        (:func:`plan_decode_pools`); each chunk prefills at its own shape and the
        pool decodes as one batch (:meth:`_run_pooled`). The host-prep and
        vision pipeline runs at pool granularity."""
        pools = plan_decode_pools(chunks, pool_n, self.batch_size, bucket_fn, self.device)

        def prepare(pool):
            return [self._prepare_requests_batch(c) for c in pool]

        def run(pool, prepared):
            gen_kwargs = dict(pool[0][0][1] or {})
            until = gen_kwargs.get("until") or []
            if isinstance(until, str):
                until = [until]
            texts = self._run_pooled(prepared, gen_kwargs)
            return [self._trim_until(t, until).strip() for t in texts]

        return self._foreach_chunk_pipelined(pools, prepare, run)

    @torch.inference_mode()
    def _run_pooled(self, prepared_list: list, gen_kwargs: dict) -> list[str]:
        """Prefill each chunk of a pool at its own (batch, bucket) shape, write
        its KV into one preallocated pool cache (front-padded to the pool's
        longest prompt bucket, int8 before the write when the int8 cache is on,
        so a bf16 pool never exists), then decode every row together. Peak
        memory is the pool plus one chunk. Returns the texts in chunk order.
        With the host timers on, each chunk counts ``prefill_tokens`` (its
        prompts' tokens, text and merged image tokens) and ``prefill_slots``
        (its rows times its bucket)."""
        max_new_tokens = int(gen_kwargs.get("max_new_tokens", DEFAULT_MAX_NEW_TOKENS))
        dev = self.device
        bucket_lens = [pad_to_bucket(max(len(ids) for ids, _, _ in rows)) for rows, _ in prepared_list]
        l_max = max(bucket_lens)
        cache_len = l_max + pad_to_bucket(max_new_tokens, GEN_LEN_BUCKETS)
        total_rows = sum(len(rows) for rows, _ in prepared_list)
        kv_mask = torch.zeros((total_rows, cache_len), dtype=torch.int32, device=dev)
        cache: tuple = ()
        logits_all, next_all = [], []
        row_offset = 0
        for (rows, vision_flat), bucket_len in zip(prepared_list, bucket_lens):
            if _hostprof.ENABLED:
                _hostprof.count("prefill_tokens", sum(len(ids) for ids, _, _ in rows))
                _hostprof.count("prefill_slots", len(rows) * bucket_len)
            with self._phase("prefill"):
                with hostprof("build_inputs"):
                    embeds, position_ids, attention_mask, next_pos, _ = self._build_batch_inputs(rows, vision_flat)
                    mask = torch.from_numpy(attention_mask.astype(np.int32)).to(dev)
                with hostprof("prefill_dispatch"):
                    logits, *kv = qvl.prefill_logits(
                        self.model, embeds, torch.from_numpy(position_ids).to(dev), mask
                    )
                if qvl.kv_int8_cache(self.model, dev):
                    kv = qvl.quantize_kv_cache(*kv)
                front = l_max - bucket_len
                cache = qvl.write_pool(cache, kv, total_rows, cache_len, row_offset, front)
                del kv
                kv_mask[row_offset : row_offset + len(rows), front : front + bucket_len] = mask
                logits_all.append(logits)
                next_all.append(next_pos)
                row_offset += len(rows)

        with self._phase("decode"), hostprof("decode_dispatch"):
            tokens = qvl.decode_pool(
                self.model,
                cache,
                torch.cat(logits_all),
                kv_mask,
                torch.from_numpy(np.concatenate(next_all)).to(dev),
                max_new_tokens=max_new_tokens,
                prompt_len=l_max,
                eos_ids=torch.tensor(self.eos_token_ids, dtype=torch.long, device=dev),
                generator=self.generator,
                do_sample=bool(gen_kwargs.get("do_sample", False)),
                temperature=float(gen_kwargs.get("temperature") or 1.0),
                top_p=float(gen_kwargs.get("top_p") or 1.0),
                decode_rows=self.decode_rows,
            )
        with hostprof("fetch"):
            tokens_np = tokens.cpu().numpy()
        with hostprof("detok"):
            return self._detokenize(tokens_np)

    def generate_until_multi_round(self, requests) -> list[list[str]]:
        """Staged conversation until the task's ``doc_to_text`` signals the end.

        Round 0 uses the prebuilt context; later rounds call
        ``doc_to_text(doc, round_idx=r, previous_round_results=...,
        last_round_info=...)``, which returns ``(visual, text, terminal,
        previous_round_results, last_round_info)``. Requests are chunked as
        :meth:`generate_until` chunks them, and each round runs every
        still-active request of a chunk as one batched decode; round r of every
        chunk runs before round r + 1 of any, so under ``LMMS_OWC_DECODE_POOL``
        > 1 a round's sub-chunks pool (:meth:`_generate_pooled`). At most 17
        rounds. Request args: (ctx, gen_kwargs, doc_to_visual, doc_to_text,
        doc_id, task, split).
        """
        collator, chunks, _ = self._collate([req.args for req in requests])
        states = []
        for chunk in chunks:
            until = dict(chunk[0][1] or {}).get("until") or []
            states.append({
                "chunk": chunk,
                "docs": [self._doc(args[5], args[6], args[4]) for args in chunk],
                "gen_kwargs": dict(chunk[0][1] or {}),
                "until": [until] if isinstance(until, str) else until,
                "rounds": [[] for _ in chunk],
                "infos": [None] * len(chunk),
                "prompts": [args[0] for args in chunk],
                "active": list(range(len(chunk))),
            })

        pool_n = int(os.environ.get("LMMS_OWC_DECODE_POOL", "1"))
        for round_idx in range(17):
            live: list[tuple[dict, list]] = []  # (state, this round's sub-chunk)
            for st in states:
                if round_idx and st["active"]:
                    still_active = []
                    for i in st["active"]:
                        _vis, text, terminal, _prev, st["infos"][i] = st["chunk"][i][3](
                            st["docs"][i], round_idx=round_idx, previous_round_results=list(st["rounds"][i]),
                            last_round_info=st["infos"][i],
                        )
                        if not terminal:
                            st["prompts"][i] = text
                            still_active.append(i)
                    st["active"] = still_active
                if st["active"]:
                    # (ctx, gen_kwargs, doc_to_visual, doc_id, task, split) rows.
                    live.append((st, [(st["prompts"][i], *st["chunk"][i][1:3], *st["chunk"][i][4:7])
                                      for i in st["active"]]))
            if not live:
                break
            if pool_n > 1 and len(live) > 1:
                texts = self._generate_pooled([sc for _, sc in live], pool_n)
            else:
                texts = self._foreach_chunk_pipelined(
                    live,
                    lambda item: self._prepare_requests_batch(item[1]),
                    lambda item, prepared: self._run_batch(prepared[0], dict(item[0]["gen_kwargs"]), prepared[1]),
                )
            offset = 0
            for st, sc in live:
                for i, text in zip(st["active"], texts[offset : offset + len(sc)]):
                    st["rounds"][i].append(self._trim_until(text, st["until"]).strip())
                offset += len(sc)
        return collator.get_original([rounds for st in states for rounds in st["rounds"]])

    def loglikelihood(self, requests) -> list[tuple[float, bool]]:
        """(ctx, doc_to_target, doc_to_visual, doc_id, task, split), or (ctx,
        continuation), -> (loss, is_greedy): the mean cross-entropy over the
        continuation's tokens with the context masked, and whether greedy
        decoding would produce the continuation. Requests run in order in
        batches of ``batch_size``; each row is the chat prompt followed by the
        continuation encoded on its own, left-padded to a length bucket."""
        merge_sq = self.config.vision.spatial_merge_size**2
        dev = self.device
        results: list[tuple[float, bool]] = []
        for start in range(0, len(requests), self.batch_size):
            batch = requests[start : start + self.batch_size]
            metas, counts, all_visuals = [], [], []
            for req in batch:
                ctx, continuation, visuals = self._resolve_loglikelihood_request(req)
                metas.append((ctx, continuation))
                counts.append(len(visuals))
                all_visuals.extend(visuals)
            with self._phase("vision"):
                vision_flat, spans_flat, flat_grids = self._encode_images_flat(all_visuals)

            rows, n_conts = [], []
            img_off = 0
            for (ctx, continuation), n_images in zip(metas, counts):
                spans = spans_flat[img_off : img_off + n_images]
                grids = flat_grids[img_off : img_off + n_images]
                img_off += n_images
                token_counts = [(g[0] * g[1] * g[2]) // merge_sq for g in grids]
                ids = self._tokenize_with_images(self._build_prompt(ctx, n_images), token_counts)
                cont_ids = self._encode_continuation(continuation)
                rows.append((list(ids) + cont_ids, spans, grids))
                n_conts.append(len(cont_ids))

            with self._phase("score"):
                embeds, position_ids, mask, _, bucket = self._build_batch_inputs(rows, vision_flat)
                target_ids = np.zeros((len(rows), bucket), np.int64)
                target_mask = np.zeros((len(rows), bucket), np.int64)
                for row, ((ids, _, _), n_cont) in enumerate(zip(rows, n_conts)):
                    # Position t predicts token t + 1: the continuation's
                    # targets take the last n_cont prediction slots.
                    target_ids[row, bucket - len(ids) : bucket - 1] = ids[1:]
                    target_mask[row, bucket - 1 - n_cont : bucket - 1] = 1
                loss, is_greedy = qvl.score_continuation(
                    self.model, embeds, torch.from_numpy(position_ids).to(dev),
                    torch.from_numpy(mask.astype(np.int32)).to(dev),
                    torch.from_numpy(target_ids).to(dev), torch.from_numpy(target_mask).to(dev),
                )
            results.extend(zip(loss.tolist(), is_greedy.tolist()))
        return results


@register_model("qwen2-vl-7b")
def qwen2_vl_7b(**kwargs) -> Qwen2VL:
    """Qwen2-VL-7B-Instruct architecture."""
    kwargs.setdefault("preset", "qwen2-vl-7b")
    return Qwen2VL(**kwargs)


@register_model("qwen2-vl-2b")
def qwen2_vl_2b(**kwargs) -> Qwen2VL:
    """Qwen2-VL-2B-Instruct architecture."""
    kwargs.setdefault("preset", "qwen2-vl-2b")
    return Qwen2VL(**kwargs)


@register_model("qwen2-vl-tiny")
def qwen2_vl_tiny(**kwargs) -> Qwen2VL:
    """Miniature Qwen2-VL for CPU tests."""
    kwargs.setdefault("preset", "qwen2-vl-tiny")
    return Qwen2VL(**kwargs)


@register_model("qwen2.5-vl-7b")
def qwen2_5_vl_7b(**kwargs) -> Qwen2VL:
    """Qwen2.5-VL-7B-Instruct architecture."""
    kwargs.setdefault("preset", "qwen2.5-vl-7b")
    return Qwen2VL(**kwargs)


@register_model("qwen2.5-vl-3b")
def qwen2_5_vl_3b(**kwargs) -> Qwen2VL:
    """Qwen2.5-VL-3B-Instruct architecture."""
    kwargs.setdefault("preset", "qwen2.5-vl-3b")
    return Qwen2VL(**kwargs)


@register_model("qwen2.5-vl-tiny")
def qwen2_5_vl_tiny(**kwargs) -> Qwen2VL:
    """Miniature Qwen2.5-VL for CPU tests."""
    kwargs.setdefault("preset", "qwen2.5-vl-tiny")
    return Qwen2VL(**kwargs)
