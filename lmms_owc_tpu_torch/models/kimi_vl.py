"""Kimi-VL model adapter of the port: MoonViT + the MLA/MoE decoder behind Qwen2-VL's pipeline.

Kimi-VL-A3B-Instruct (:mod:`lmms_owc_tpu_torch.nn.kimi_vl`) is served by the
Qwen2-VL adapter's pipeline (:class:`~lmms_owc_tpu_torch.models.qwen2_vl.Qwen2VL`):
requests grouped by generation kwargs and sorted by estimated prompt tokens
into token-budget chunks, the host prep and the tower in the chunk
pipeline's worker, prompts LEFT-padded to length buckets, and
``LMMS_OWC_DECODE_POOL`` > 1 decoding several chunks as one pool over one
latent cache (``plan_decode_pools``, ``_run_pooled``, the decode loop and
its CUDA graphs in ``nn/qwen2_vl.py``). What differs is the family's own:
images are resized to multiples of 28 px under the published processor's
token limit (the Qwen2-VL sizing rule with factor 28: 4096 patches, the
``max_pixels`` default), normalised with mean and std 0.5, cut into 14-px
patches in merge-window order and run through MoonViT in batches of one
patch bucket; the chat template is Kimi-VL's; text positions are plain
(one rope position per token). Weights come from a ``pretrained``
checkpoint directory (the released layout: ``language_model.`` and
``vision_tower.`` names, per-expert tensors stacked into grouped weights as
they load) or are drawn on the device from ``torch_random_seed``. bf16/f32
weights only; no int8 KV cache (the latent cache stays in the compute dtype)
and no tensor parallelism.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import torch

from lmms_owc_tpu_torch.models._api import register_model
from lmms_owc_tpu_torch.models.qwen2_vl import (
    DECODE_ROWS,
    PATCH_BUCKETS,
    VISION_ROW_BUCKETS,
    Qwen2VL,
    _assemble_embeds,
    _FallbackTokenizer,
)
from lmms_owc_tpu_torch.nn import kimi_vl as kvl
from lmms_owc_tpu_torch.nn.loader import load_config_json, load_safetensors_state
from lmms_owc_tpu_torch.ops.image import resize_host_batch
from lmms_owc_tpu_torch.tokenizer import Tokenizer
from lmms_owc_tpu_torch.utils import get_logger, pad_to_bucket
from lmms_owc_tpu_torch.utils._hostprof import hostprof

log = get_logger(__name__)

__all__ = ["KIMI_SPECIAL_IDS", "PRESET_CONFIGS", "KimiVL", "load_safetensors_state"]

DEFAULT_SYSTEM_PROMPT = "You are a helpful assistant"

# Kimi-VL's special tokens (tokenizer_config.json of the released checkpoint).
KIMI_SPECIAL_IDS = {
    "[BOS]": 163584, "[EOS]": 163585, "<|im_end|>": 163586, "<|im_user|>": 163587,
    "<|im_assistant|>": 163588, "<|im_system|>": 163594, "<|im_middle|>": 163601,
    "<|media_start|>": 163602, "<|media_content|>": 163603, "<|media_end|>": 163604,
    "<|media_pad|>": 163605, "[PAD]": 163839,
}

_TEXT = dict(
    vocab_size=163840, max_position_embeddings=131072, hidden_size=2048, intermediate_size=11264,
    moe_intermediate_size=1408, num_hidden_layers=27, num_attention_heads=16, n_shared_experts=2,
    n_routed_experts=64, ep_size=1, routed_scaling_factor=2.446, kv_lora_rank=512, q_lora_rank=None,
    qk_rope_head_dim=64, v_head_dim=128, qk_nope_head_dim=128, topk_method="noaux_tc", n_group=1, topk_group=1,
    num_experts_per_tok=6, moe_layer_freq=1, first_k_dense_replace=1, norm_topk_prob=True,
    scoring_func="sigmoid", num_key_value_heads=16, hidden_act="silu", rms_norm_eps=1e-5, rope_theta=800000,
    rope_scaling=None, attention_bias=False, tie_word_embeddings=False,
    bos_token_id=163584, eos_token_id=163586, pad_token_id=163839,
)
_VISION = dict(
    model_type="moonvit", patch_size=14, num_attention_heads=16, num_hidden_layers=27, hidden_size=1152,
    intermediate_size=4304, init_pos_emb_height=64, init_pos_emb_width=64, merge_kernel_size=[2, 2],
)

# Architecture presets (the released config.json's layout) so random-init runs need no checkpoint.
PRESET_CONFIGS = {
    "kimi-vl-a3b": dict(model_type="kimi_vl", media_placeholder_token_id=163605, text_config=_TEXT,
                        vision_config=_VISION),
    # CPU-testable miniature: every mechanism (MLA, a dense layer then MoE
    # layers with shared experts, MoonViT with an interpolated grid) at tiny widths.
    "kimi-vl-tiny": dict(
        model_type="kimi_vl", media_placeholder_token_id=163605,
        text_config={**_TEXT, "hidden_size": 64, "intermediate_size": 96, "moe_intermediate_size": 32,
                     "num_hidden_layers": 3, "num_attention_heads": 4, "n_routed_experts": 8,
                     "num_experts_per_tok": 3, "n_shared_experts": 1, "kv_lora_rank": 32,
                     "qk_rope_head_dim": 16, "qk_nope_head_dim": 16, "v_head_dim": 16},
        vision_config={**_VISION, "num_attention_heads": 4, "num_hidden_layers": 2, "hidden_size": 32,
                       "intermediate_size": 64, "init_pos_emb_height": 8, "init_pos_emb_width": 8},
    ),
}


class _FallbackKimiTokenizer(_FallbackTokenizer):
    """The hash tokenizer of random-init runs with Kimi-VL's special tokens."""

    def __init__(self, config: kvl.KimiVLConfig) -> None:
        self.special_ids = dict(KIMI_SPECIAL_IDS)
        self.special_ids.update({"<|im_end|>": config.eos_token_id, "[PAD]": config.pad_token_id,
                                 "<|media_pad|>": config.image_token_id,
                                 "<|media_start|>": config.vision_start_token_id})
        self.eos_token_id = self.special_ids["<|im_end|>"]
        self.pad_token_id = self.special_ids["[PAD]"]
        self._plain_span = max(1000, min(config.vocab_size, min(self.special_ids.values())) - 1001)
        self._pattern = re.compile("|".join(re.escape(s) for s in self.special_ids))
        self._inverse = {v: k for k, v in self.special_ids.items()}


def _patchify(pixels_u8: torch.Tensor, patch: int, merge: int, dtype) -> torch.Tensor:
    """uint8 [N, 3, H, W] -> [N, h * w, 3 * patch * patch], (x / 255 - 0.5) / 0.5,
    each patch channel-major (the Conv2d kernel's layout), patches in
    merge-window order."""
    n, c, hh, ww = pixels_u8.shape
    x = (pixels_u8.float() / 255.0 - 0.5) / 0.5
    gh, gw = hh // patch, ww // patch
    x = x.reshape(n, c, gh // merge, merge, patch, gw // merge, merge, patch)
    return x.permute(0, 2, 5, 3, 6, 1, 4, 7).reshape(n, gh * gw, c * patch * patch).to(dtype)


class KimiVL(Qwen2VL):
    """Kimi-VL on the PyTorch/CUDA stack."""

    supports_mesh = False
    presets = PRESET_CONFIGS

    def __init__(self, pretrained: str | None = None, preset: str = "kimi-vl-a3b",
                 system_prompt: str = DEFAULT_SYSTEM_PROMPT, **kwargs) -> None:
        if kwargs.get("load_in_8bit") or kwargs.get("load_in_4bit") or kwargs.get("int8_activations"):
            raise ValueError("Kimi-VL is served in bf16 or f32 weights only")
        super().__init__(pretrained=pretrained, preset=preset, system_prompt=system_prompt, **kwargs)

    # ------------------------------------------------------------------- load

    def load_model(self) -> None:
        checkpoint = self.pretrained is not None and Path(self.pretrained).exists()
        if self.pretrained is not None and not checkpoint and not self.random_init:
            raise FileNotFoundError(f"checkpoint not found: {self.pretrained}")
        hf = load_config_json(self.pretrained) if checkpoint else PRESET_CONFIGS[self.preset]
        self.config = kvl.KimiVLConfig.from_hf_dict(hf)
        self.is_v25 = False
        self.model = kvl.KimiVLModel(self.config, self.torch_dtype, "meta")
        if checkpoint:
            self.tokenizer = Tokenizer.from_pretrained(self.pretrained)
            self._check_vocabulary()
            state = load_safetensors_state(self.pretrained)
            kvl.load_hf_weights(self.model, state, self.device)
            del state
            log.info("loaded %s from %s (%s)", self.preset, self.pretrained, self.dtype)
        else:
            kvl.init_params(self.model, torch.Generator(device=self.device).manual_seed(self.torch_random_seed))
            self.tokenizer = _FallbackKimiTokenizer(self.config)
            log.warning("random-init %s on %s (no checkpoint)", self.preset, self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(self.torch_random_seed)
        # The CPU path keeps the plain shapes; the card's decode runs 128-row blocks, as Qwen2-VL's.
        self.decode_rows = DECODE_ROWS if self.device.type == "cuda" else None

    # -------------------------------------------------------------- prompting

    def _build_prompt(self, context: str, num_images: int) -> str:
        """Kimi-VL's chat template: a system turn, then the user turn with one
        media block per image before the text, then the assistant's opening."""
        media = "<|media_start|>image<|media_content|><|media_pad|><|media_end|>" * num_images
        return (f"<|im_system|>system<|im_middle|>{self.system_prompt}<|im_end|>"
                f"<|im_user|>user<|im_middle|>{media}{context}<|im_end|>"
                f"<|im_assistant|>assistant<|im_middle|>")

    def apply_chat_template(self, messages: list[dict]) -> str:
        opening = {"system": "<|im_system|>", "user": "<|im_user|>", "assistant": "<|im_assistant|>"}
        parts = [f"{opening.get(m['role'], '')}{m['role']}<|im_middle|>{m['content']}<|im_end|>" for m in messages]
        return "".join(parts) + "<|im_assistant|>assistant<|im_middle|>"

    @property
    def chat_template(self) -> str:
        return "kimi-vl"

    @property
    def tokenizer_name(self) -> str:
        return f"kimi_vl_{self.preset}"

    # ----------------------------------------------------------------- vision

    @torch.inference_mode()
    def _encode_images_flat(self, all_visuals: list):
        """Every image of a macro batch through MoonViT: host resize, images
        grouped by size (patchify needs one H, W) and the sizes by patch
        bucket; per bucket, each image's position grid and rope angles, rows
        padded to a ``VISION_ROW_BUCKETS`` count by repeating the last, one
        tower call per at most ``batch_size`` x 1024 patches. Returns as
        :meth:`Qwen2VL._encode_images_flat`."""
        if not all_visuals:
            return None, [], []
        v = self.config.vision
        m2 = v.spatial_merge_size**2
        dev, dtype = self.device, self.model.dtype
        tower = self.model.vision
        with hostprof("prep_resize"):
            resized = resize_host_batch(all_visuals, self.min_pixels, self.max_pixels, v.patch_size * v.spatial_merge_size)
        grids = [(1, hw[0] // v.patch_size, hw[1] // v.patch_size) for _, hw in resized]
        by_size: dict[tuple[int, int], list[int]] = {}
        for idx, (_, hw) in enumerate(resized):
            by_size.setdefault(hw, []).append(idx)

        by_bucket: dict[int, list] = {}
        for hw, indices in by_size.items():
            grid = (hw[0] // v.patch_size, hw[1] // v.patch_size)
            p = grid[0] * grid[1]
            bucket = pad_to_bucket(p, PATCH_BUCKETS)
            with hostprof("prep_upload"):
                stacked = torch.from_numpy(np.stack([resized[i][0] for i in indices])).to(dev)
            with hostprof("prep_patchify"):
                patches = _patchify(stacked, v.patch_size, v.spatial_merge_size, dtype)
                pos = kvl.position_embedding(tower.pos_emb, grid, v.spatial_merge_size).to(dtype)
                angles = torch.from_numpy(kvl.vision_rope_angles(grid, v)).to(dev)
            by_bucket.setdefault(bucket, []).append((indices, p, patches, pos, angles))

        outputs: list[torch.Tensor] = []
        spans: dict[int, tuple[int, int]] = {}
        flat_offset = 0
        for bucket, entries in by_bucket.items():
            rows = []  # (image idx, real patches, patches, pos, angles) per image, padded to the bucket
            for indices, p, patches, pos, angles in entries:
                pad = (0, 0, 0, bucket - p)
                pos_pad, ang_pad = torch.nn.functional.pad(pos, pad), torch.nn.functional.pad(angles, pad)
                for j, idx in enumerate(indices):
                    rows.append((idx, p, torch.nn.functional.pad(patches[j], pad), pos_pad, ang_pad))
            all_full = all(p == bucket for _, p, *_ in rows)
            cap = max(1, (self.batch_size * 1024) // bucket)
            for s in range(0, len(rows), cap):
                seg = rows[s : s + cap]
                n_rows = pad_to_bucket(len(seg), VISION_ROW_BUCKETS)
                seg_padded = seg + [seg[-1]] * (n_rows - len(seg))
                patches = torch.stack([r[2] for r in seg_padded])
                pos = torch.stack([r[3] for r in seg_padded])
                angles = torch.stack([r[4] for r in seg_padded])
                mask = None
                if not all_full:
                    real = torch.tensor([r[1] for r in seg_padded], device=dev)
                    mask = (torch.arange(bucket, device=dev)[None] < real[:, None]).to(torch.int32)
                with hostprof("prep_tower"):
                    out = tower(patches, pos, angles, mask)  # [n_rows, bucket / 4, hidden]
                merged = bucket // m2
                outputs.append(out.reshape(n_rows * merged, -1))
                for row, (idx, p, *_) in enumerate(seg):
                    spans[idx] = (flat_offset + row * merged, p // m2)
                flat_offset += n_rows * merged
        vision_flat = torch.cat(outputs) if len(outputs) > 1 else outputs[0]
        return vision_flat, [spans[i] for i in range(len(all_visuals))], grids

    # ------------------------------------------------------------- generation

    @torch.inference_mode()
    def _build_batch_inputs(self, batch: list[tuple], vision_flat=None):
        """As :meth:`Qwen2VL._build_batch_inputs`, with plain text positions:
        each row's tokens at 0, 1, ... from its first real token (the three
        rows of the [3, B, L] layout equal)."""
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
                index_map[row, offset + positions[cursor : cursor + span_count]] = span_off + np.arange(span_count)
                cursor += span_count
        position_ids = np.broadcast_to(np.clip(np.cumsum(attention_mask, 1) - 1, 0, None)[None], (3, bsz, bucket_len))
        next_pos = attention_mask.sum(1)
        dev = self.device
        embeds = _assemble_embeds(
            self.model,
            torch.from_numpy(input_ids).to(dev),
            vision_flat,
            torch.from_numpy(index_map).to(dev) if vision_flat is not None else None,
        )
        return embeds, np.ascontiguousarray(position_ids), attention_mask, next_pos, bucket_len


@register_model("kimi-vl-a3b")
def kimi_vl_a3b(**kwargs) -> KimiVL:
    """Kimi-VL-A3B-Instruct architecture."""
    kwargs.setdefault("preset", "kimi-vl-a3b")
    return KimiVL(**kwargs)


@register_model("kimi-vl-tiny")
def kimi_vl_tiny(**kwargs) -> KimiVL:
    """Miniature Kimi-VL for CPU tests."""
    kwargs.setdefault("preset", "kimi-vl-tiny")
    return KimiVL(**kwargs)
