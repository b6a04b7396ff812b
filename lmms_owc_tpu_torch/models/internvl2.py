"""InternVL2/2.5 model adapter of the port: dynamic tiling + InternViT + Qwen2/Llama decoder.

Counterpart of :mod:`lmms_owc_tpu.models.internvl2` (the reference's
``src/models/_internvl2.py``: dynamic aspect-ratio preprocessing into at most
``max_tiles`` 448px tiles plus a thumbnail, ImageNet normalisation,
chat-style generation), on the PyTorch/CUDA stack: every tile of a chunk
goes through the InternViT tower of :mod:`lmms_owc_tpu_torch.nn.internvl` in
one call (K2 at head_dim 64 on the card), is pixel-shuffled and projected,
and its tokens are scattered into the ``<IMG_CONTEXT>`` slots; the Qwen2
decoder of the port then runs the prefill (K2) and the decode (K3). Host
preprocessing and the tower run in the chunk pipeline's preparation,
overlapped with the previous chunk's decode. Weights come from a
``pretrained`` HF ("-hf") checkpoint (the port's safetensors reader and BPE
tokenizer, which reads ``<img>``, ``</img>`` and ``<IMG_CONTEXT>`` as added
tokens), from a JAX parameter tree, or are drawn on the device from a seed;
``load_in_8bit`` / ``load_in_4bit`` quantize the decoder's, the tower's and
the projector's linear layers. As in the JAX adapter there is no decode pool
here. The JAX adapter's tensor-parallel mesh (``use_mesh``) is not ported.
"""

from __future__ import annotations

import hashlib
import re
from pathlib import Path

import numpy as np
import torch

from lmms_owc_tpu_torch.models._api import register_model
from lmms_owc_tpu_torch.models._base import Model
from lmms_owc_tpu_torch.models.qwen2_vl import _assemble_embeds
from lmms_owc_tpu_torch.nn import internvl as iv
from lmms_owc_tpu_torch.nn import qwen2_vl as qvl
from lmms_owc_tpu_torch.nn.layers import Int4Linear, Int8Linear
from lmms_owc_tpu_torch.nn.llama import llama_positions
from lmms_owc_tpu_torch.nn.loader import load_config_json, load_hf_tensors, load_safetensors_state
from lmms_owc_tpu_torch.ops import quant
from lmms_owc_tpu_torch.parallel.sharding import shard_model
from lmms_owc_tpu_torch.tokenizer import Tokenizer
from lmms_owc_tpu_torch.utils import Collator, get_logger, pad_to_bucket

log = get_logger(__name__)

__all__ = ["PRESET_CONFIGS", "InternVL2", "dynamic_preprocess", "find_closest_aspect_ratio"]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
DEFAULT_MAX_NEW_TOKENS = 128
GEN_LEN_BUCKETS = (64, 128, 256, 512)

PRESET_CONFIGS = {
    # Qwen2-1.5B backbone (InternVL2-2B-class).
    "internvl2-2b": dict(
        text_config=dict(
            model_type="qwen2", vocab_size=151674, hidden_size=1536, intermediate_size=8960,
            num_hidden_layers=28, num_attention_heads=12, num_key_value_heads=2,
            rope_theta=1000000.0, rms_norm_eps=1e-6, tie_word_embeddings=True,
        ),
        vision_config=dict(
            hidden_size=1024, num_hidden_layers=24, num_attention_heads=16,
            intermediate_size=4096, image_size=448, patch_size=14,
        ),
        image_token_id=151667,
    ),
    "internvl2-tiny": dict(
        text_config=dict(
            model_type="qwen2", vocab_size=151674, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            rope_theta=1000000.0, rms_norm_eps=1e-6, tie_word_embeddings=True,
            rope_scaling={"type": "mrope", "mrope_section": [2, 3, 3]},
        ),
        vision_config=dict(
            hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, image_size=28, patch_size=14,
        ),
        image_token_id=151667,
    ),
}

_IM_START = "<|im_start|>"
_IM_END = "<|im_end|>"
_IMG_START = "<img>"
_IMG_END = "</img>"
_IMG_CONTEXT = "<IMG_CONTEXT>"


def find_closest_aspect_ratio(aspect_ratio, target_ratios, width, height, image_size):
    """Pick the tiling grid whose aspect ratio best matches the image (ties broken by area)."""
    best_diff = float("inf")
    best = (1, 1)
    area = width * height
    for ratio in target_ratios:
        target = ratio[0] / ratio[1]
        diff = abs(aspect_ratio - target)
        if diff < best_diff:
            best_diff = diff
            best = ratio
        elif diff == best_diff and area > 0.5 * image_size * image_size * ratio[0] * ratio[1]:
            best = ratio
    return best


def dynamic_preprocess(image, min_num=1, max_num=6, image_size=448, use_thumbnail=True):
    """Split an image into <= max_num equally-sized square tiles (+ optional thumbnail)."""
    width, height = image.size
    aspect_ratio = width / height
    target_ratios = sorted(
        {
            (i, j)
            for n in range(min_num, max_num + 1)
            for i in range(1, n + 1)
            for j in range(1, n + 1)
            if min_num <= i * j <= max_num
        },
        key=lambda x: x[0] * x[1],
    )
    ratio = find_closest_aspect_ratio(aspect_ratio, target_ratios, width, height, image_size)
    target_w, target_h = image_size * ratio[0], image_size * ratio[1]
    blocks = ratio[0] * ratio[1]
    resized = image.resize((target_w, target_h))
    cols = target_w // image_size
    tiles = []
    for i in range(blocks):
        box = (
            (i % cols) * image_size,
            (i // cols) * image_size,
            ((i % cols) + 1) * image_size,
            ((i // cols) + 1) * image_size,
        )
        tiles.append(resized.crop(box))
    if use_thumbnail and len(tiles) != 1:
        tiles.append(image.resize((image_size, image_size)))
    return tiles


class _FallbackInternVLTokenizer:
    """Hash tokenizer for random-init runs (the JAX adapter's, id for id)."""

    eos_token_id = 151645
    pad_token_id = 151643

    def __init__(self, image_token_id: int) -> None:
        self.image_token_id = image_token_id
        self._special = {
            _IM_START: 151644, _IM_END: 151645, _IMG_START: 151665,
            _IMG_END: 151666, _IMG_CONTEXT: image_token_id,
        }

    @staticmethod
    def _word(word: str) -> int:
        return 1000 + int.from_bytes(hashlib.md5(word.encode()).digest()[:3], "little") % 150000

    def encode(self, text: str, add_special_tokens: bool = True) -> list[int]:
        ids: list[int] = []
        pattern = "|".join(re.escape(s) for s in self._special)
        pos = 0
        for match in re.finditer(pattern, text):
            ids.extend(self._word(w) for w in text[pos : match.start()].split())
            ids.append(self._special[match.group()])
            pos = match.end()
        ids.extend(self._word(w) for w in text[pos:].split())
        return ids

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        return " ".join(f"tok{int(i)}" for i in ids)


class InternVL2(Model):
    """InternVL2 family on the PyTorch/CUDA stack. With ``model_parallel`` > 1
    the decoder is sharded over the model group, as in the JAX adapter (the
    tower stays whole)."""

    supports_mesh = True

    def __init__(
        self,
        pretrained: str | None = None,
        preset: str = "internvl2-2b",
        max_tiles: int = 6,
        random_init: bool = False,
        jax_params: dict | None = None,
        time_phases: bool = False,
        **kwargs,
    ) -> None:
        """Weights come from the ``pretrained`` checkpoint directory (its
        ``config.json`` gives the architecture), from ``jax_params`` (the JAX
        adapter's ``params`` tree as numpy arrays), or are drawn on the device
        from ``torch_random_seed`` (``random_init``, implied when there is no
        ``pretrained``; an unknown preset draws ``internvl2-2b``'s widths, as
        in the JAX adapter). ``time_phases`` sums the vision, prefill and
        decode phases' wall seconds into :attr:`phase_seconds`."""
        self.pretrained = pretrained
        self.preset = preset
        self.max_tiles = int(max_tiles)
        self.random_init = random_init or pretrained is None
        self._jax_params = jax_params
        self.time_phases = bool(time_phases)
        super().__init__(model_id=preset, **kwargs)

    # ------------------------------------------------------------------- load

    def load_model(self) -> None:
        checkpoint = self.pretrained is not None and Path(self.pretrained).exists()
        if self.pretrained is not None and not checkpoint and not self.random_init:
            raise FileNotFoundError(f"checkpoint not found: {self.pretrained}")
        hf = load_config_json(self.pretrained) if checkpoint else PRESET_CONFIGS.get(
            self.preset, PRESET_CONFIGS["internvl2-2b"])
        self.config = iv.internvl_config_from_hf(dict(hf))
        self.decoder_config = self.config.text.to_decoder_config()
        bits = 4 if self.load_in_4bit else (8 if self.load_in_8bit else None)
        dtype, dev = self.torch_dtype, self.device
        if checkpoint:
            self.tokenizer = Tokenizer.from_pretrained(self.pretrained)
            self._check_vocabulary()
            state = load_safetensors_state(self.pretrained)
            # Modules are built on meta, then each weight is read (quantized
            # and dropped), and under tensor parallelism sliced, in turn.
            self.model = iv.InternVLModel(self.config, dtype, "meta", iv.has_final_ln(state))
            shard = self._shard_hook(self.model.text, bits, "text.")
            if bits is not None:
                quant.load_quantized_on_device(self.model, state, bits=bits, dtype=dtype, device=dev, after=shard)
            else:
                load_hf_tensors(self.model, state, dev, shard)
            del state
            log.info("loaded %s from %s (%s)", self.preset, self.pretrained, f"int{bits}" if bits else self.dtype)
        elif self._jax_params is not None:
            self.model = iv.internvl_params_from_jax(self._jax_params, self.config, dtype, dev)
            self._jax_params = None
            quantized = any(isinstance(m, (Int8Linear, Int4Linear)) for m in self.model.modules())
            if bits is not None and not quantized:
                (quant.quantize_params_int8 if bits == 8 else quant.quantize_params_int4)(self.model)
            if self.model_group is not None:
                shard_model(self.model.text, self.model_group)
            log.info("loaded %s from a JAX parameter tree", self.preset)
        else:
            # Drawn one module at a time from meta, as a checkpoint is read.
            gen = torch.Generator(device=dev).manual_seed(self.torch_random_seed)
            self.model = iv.InternVLModel(self.config, dtype, "meta")
            if bits is not None:
                quant.init_quantized_on_device(self.model, gen, bits=bits, dtype=dtype,
                                               after=self._shard_hook(self.model.text, bits, "text."))
            else:  # the decoder's walk is rooted at the decoder
                iv.init_internvl_params(self.model, gen, self._shard_hook(self.model.text))
            log.warning("random-init %s on %s (no checkpoint)", self.preset, dev)
        if not checkpoint:
            self.tokenizer = _FallbackInternVLTokenizer(self.config.image_token_id)
        self.generator = torch.Generator(device=dev).manual_seed(self.torch_random_seed)

    def _check_vocabulary(self) -> None:
        """Every token id the adapter feeds to the embedding (the pad, the
        image token, ``<img>``, ``</img>`` and the tokenizer's EOS) must lie
        inside the checkpoint's vocabulary (the JAX package's embedding lookup
        reads NaN rows past it; the port refuses the load instead)."""
        vocab = self.config.text.vocab_size
        ids = {"pad_token_id": self.decoder_config.pad_token_id, "image_token_id": self.config.image_token_id,
               "the tokenizer's eos_token_id": self.tokenizer.eos_token_id}
        for token in (_IMG_START, _IMG_END):
            encoded = self.tokenizer.encode(token, add_special_tokens=False)
            ids[token] = encoded[0] if len(encoded) == 1 else None
        for name, value in ids.items():
            if value is not None and not 0 <= int(value) < vocab:
                raise ValueError(f"{self.pretrained}: {name} {value} lies outside the checkpoint's vocabulary "
                                 f"of {vocab} tokens")

    @property
    def pad_token_id(self) -> int:
        return self.decoder_config.pad_token_id

    @property
    def eos_token_ids(self) -> list[int]:
        eos = getattr(self.tokenizer, "eos_token_id", 151645)
        return sorted({int(eos if eos is not None else 151645), 151645})

    @property
    def tokenizer_name(self) -> str:
        return f"internvl_{self.preset}"

    @property
    def chat_template(self) -> str:
        return "internvl2"

    def apply_chat_template(self, messages: list[dict]) -> str:
        parts = [f"{_IM_START}system\n你是书生·万象, 一个多模态大模型。{_IM_END}\n"]
        for msg in messages:
            parts.append(f"{_IM_START}{msg['role']}\n{msg['content']}{_IM_END}\n")
        parts.append(f"{_IM_START}assistant\n")
        return "".join(parts)

    def _build_prompt(self, context: str, tile_counts: list[int]) -> str:
        tokens_per_tile = self.config.tokens_per_tile
        image_blocks = "".join(
            f"{_IMG_START}{_IMG_CONTEXT * (tokens_per_tile * n)}{_IMG_END}\n" for n in tile_counts
        )
        return (
            f"{_IM_START}system\nYou are a helpful assistant.{_IM_END}\n"
            f"{_IM_START}user\n{image_blocks}{context}{_IM_END}\n"
            f"{_IM_START}assistant\n"
        )

    # ------------------------------------------------------------ preprocessing

    def _tile_images(self, visuals: list) -> tuple[np.ndarray | None, list[int]]:
        """All images -> stacked normalized tiles [N_tiles, 3, S, S] + tiles per image
        (the JAX adapter's float64 arithmetic)."""
        if not visuals:
            return None, []
        size = self.config.vision.image_size
        tile_counts = []
        arrays = []
        for image in visuals:
            tiles = dynamic_preprocess(image.convert("RGB"), max_num=self.max_tiles, image_size=size,
                                       use_thumbnail=True)
            tile_counts.append(len(tiles))
            for tile in tiles:
                arr = np.asarray(tile.resize((size, size))).astype(np.float32) / 255.0
                arr = (arr - np.asarray(IMAGENET_MEAN)) / np.asarray(IMAGENET_STD)
                arrays.append(arr.transpose(2, 0, 1))
        return np.stack(arrays), tile_counts

    @torch.inference_mode()
    def _encode(self, all_tiles: list[np.ndarray]) -> torch.Tensor | None:
        """Every tile of a batch through the tower and the projector in one
        call: vision tokens [N_tiles * tokens_per_tile, H] on the device, or None."""
        if not all_tiles:
            return None
        with self._phase("vision"):
            pixels = torch.from_numpy(np.concatenate(all_tiles)).to(self.device, self.model.dtype)
            vision = iv.encode_tiles(self.model, pixels, self.config)
            return vision.reshape(-1, vision.shape[-1])

    def _embed(self, input_ids: np.ndarray, tile_offsets: list[int], vision_flat) -> torch.Tensor:
        """Token embeddings with each row's tile tokens in its ``<IMG_CONTEXT>`` slots."""
        tokens_per_tile = self.config.tokens_per_tile
        index_map = np.full(input_ids.shape, -1, np.int64)
        for row, tile_off in enumerate(tile_offsets):
            positions = np.where(input_ids[row] == self.config.image_token_id)[0]
            index_map[row, positions] = tile_off * tokens_per_tile + np.arange(len(positions))
        dev = self.device
        return _assemble_embeds(
            self.model.text,
            torch.from_numpy(input_ids).to(dev),
            vision_flat,
            torch.from_numpy(index_map).to(dev) if vision_flat is not None else None,
        )

    def _prepare_rows(self, items) -> tuple[list, list[int], torch.Tensor | None]:
        """``items`` of (prompt context, visuals, continuation ids): (token rows,
        each row's first tile, the encoded tiles)."""
        rows, offsets, all_tiles, cursor = [], [], [], 0
        for ctx, visuals, cont_ids in items:
            tiles, tile_counts = self._tile_images(visuals)
            rows.append(self.tokenizer.encode(self._build_prompt(ctx, tile_counts)) + cont_ids)
            offsets.append(cursor)
            cursor += sum(tile_counts)
            if tiles is not None:
                all_tiles.append(tiles)
        return rows, offsets, self._encode(all_tiles)

    def _prepare_chunk(self, chunk: list) -> tuple:
        """Host preprocessing and the tower for a chunk of request args
        (overlapped with the previous chunk's decode): the embeddings,
        positions, mask, next positions and prompt bucket."""
        rows, offsets, vision_flat = self._prepare_rows(
            [(args[0], self._request_visuals(*args[2:6]), []) for args in chunk])
        input_ids, mask = self._left_pad(rows)
        embeds = self._embed(input_ids, offsets, vision_flat)
        position_ids, next_pos = llama_positions(mask)
        return embeds, position_ids, mask, next_pos, input_ids.shape[1]

    # -------------------------------------------------------------- generation

    def generate_until(self, requests) -> list[str]:
        collator = Collator(
            [req.args for req in requests],
            sort_fn=lambda args: -len(args[0]),
            group_fn=lambda args: repr(args[1]),
            group_by="gen_kwargs",
        )
        dev = self.device

        @torch.inference_mode()
        def run(chunk, prepared):
            embeds, position_ids, mask, next_pos, bucket = prepared
            gen_kwargs = dict(chunk[0][1] or {})
            until = gen_kwargs.get("until") or []
            if isinstance(until, str):
                until = [until]
            max_new = int(gen_kwargs.get("max_new_tokens", DEFAULT_MAX_NEW_TOKENS))
            tokens = qvl.greedy_generate(
                self.model.text,
                embeds,
                torch.from_numpy(position_ids).to(dev),
                torch.from_numpy(mask.astype(np.int32)).to(dev),
                torch.from_numpy(next_pos).to(dev),
                max_new_tokens=max_new,
                cache_len=bucket + pad_to_bucket(max_new, GEN_LEN_BUCKETS),
                eos_ids=torch.tensor(self.eos_token_ids, dtype=torch.long, device=dev),
                generator=self.generator,
                do_sample=bool(gen_kwargs.get("do_sample", False)),
                temperature=float(gen_kwargs.get("temperature") or 1.0),
                top_p=float(gen_kwargs.get("top_p") or 1.0),
                phase=self._phase,
            )
            out = []
            for text in self._detokenize(tokens.cpu().numpy()):
                for stop_str in until:
                    if stop_str and stop_str in text:
                        text = text.split(stop_str)[0]
                out.append(text.strip())
            return out

        chunks = list(collator.get_batched(n=self.batch_size))
        results = self._foreach_chunk_pipelined(chunks, self._prepare_chunk, run)
        return collator.get_original(results)

    @torch.inference_mode()
    def loglikelihood(self, requests) -> list[tuple[float, bool]]:
        """(ctx, doc_to_target, doc_to_visual, doc_id, task, split), or (ctx,
        continuation), -> (loss, is_greedy): the mean continuation
        cross-entropy and whether greedy decoding reproduces it. A capability
        beyond the reference's InternVL2 adapter, with the contract of its
        llava adapter, as in the JAX package."""
        dev = self.device
        results: list[tuple[float, bool]] = []
        for start in range(0, len(requests), self.batch_size):
            items, cont_lens = [], []
            for req in requests[start : start + self.batch_size]:
                ctx, continuation, visuals = self._resolve_loglikelihood_request(req)
                cont_ids = self._encode_continuation(continuation)
                items.append((ctx, visuals, cont_ids))
                cont_lens.append(len(cont_ids))
            rows, offsets, vision_flat = self._prepare_rows(items)
            input_ids, mask = self._left_pad(rows)
            bucket = input_ids.shape[1]
            target_ids = np.zeros((len(rows), bucket), np.int64)
            target_mask = np.zeros((len(rows), bucket), np.int64)
            for row, ids in enumerate(rows):
                target_ids[row, bucket - len(ids) : bucket - 1] = ids[1:]
                target_mask[row, bucket - 1 - cont_lens[row] : bucket - 1] = 1
            embeds = self._embed(input_ids, offsets, vision_flat)
            position_ids, _ = llama_positions(mask)
            with self._phase("score"):
                loss, is_greedy = qvl.score_continuation(
                    self.model.text, embeds, torch.from_numpy(position_ids).to(dev),
                    torch.from_numpy(mask.astype(np.int32)).to(dev),
                    torch.from_numpy(target_ids).to(dev), torch.from_numpy(target_mask).to(dev),
                )
            results.extend(zip(loss.tolist(), is_greedy.tolist()))
        return results


@register_model("internvl2-1b")
def internvl2_1b(**kwargs) -> InternVL2:
    """InternVL2-1B (Qwen2-0.5B backbone). Reference: src/models/_internvl2.py:579-674."""
    kwargs.setdefault("preset", "internvl2-2b")
    return InternVL2(**kwargs)


@register_model("internvl2-2b")
def internvl2_2b(**kwargs) -> InternVL2:
    """InternVL2-2B (Qwen2-1.5B backbone)."""
    kwargs.setdefault("preset", "internvl2-2b")
    return InternVL2(**kwargs)


@register_model("internvl2-4b", "internvl2-8b", "internvl2-26b", "internvl2-40b")
def internvl2_large(**kwargs) -> InternVL2:
    """Larger InternVL2 variants; architecture resolved from the checkpoint config."""
    kwargs.setdefault("preset", "internvl2-2b")
    return InternVL2(**kwargs)


@register_model(
    "internvl2.5-1b", "internvl2.5-2b", "internvl2.5-4b", "internvl2.5-8b",
    "internvl2.5-26b", "internvl2.5-38b",
)
def internvl25(**kwargs) -> InternVL2:
    """InternVL2.5 variants (HF "-hf" ports); architecture from the checkpoint config."""
    kwargs.setdefault("preset", "internvl2-2b")
    return InternVL2(**kwargs)


@register_model("internvl2-tiny")
def internvl2_tiny(**kwargs) -> InternVL2:
    """Miniature InternVL2 for CPU tests."""
    kwargs.setdefault("preset", "internvl2-tiny")
    return InternVL2(**kwargs)
