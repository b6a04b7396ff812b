"""InstructBLIP model adapter of the port (instructblip-vicuna-7b/13b).

Counterpart of :mod:`lmms_owc_tpu.models.instructblip` (the reference's
``src/models/_instructblip.py``: registered IDs, multi-image handling by
drawing order labels and concatenating the images into one canvas), on the
PyTorch/CUDA stack: BLIP 224x224 preprocessing, the BLIP ViT-g tower of
:mod:`lmms_owc_tpu_torch.nn.instructblip` (K2 at head_dim 88 on the card,
one call per chunk), the instruction-aware Q-Former (plain torch attention,
as the JAX package), and the Vicuna decoder of the port (K2 for the
prefill, K3 for each decode step). Host preprocessing, the tower and the
Q-Former run in the chunk pipeline's preparation, overlapped with the
previous chunk's decode. Weights come from a ``pretrained`` HF checkpoint
(the port's safetensors reader, its ``byte_fallback`` BPE tokenizer, and the
released ``qformer_tokenizer/`` directory read by its WordPiece tokenizer),
from a JAX parameter tree, or are drawn on the device from a seed.
"""

from __future__ import annotations

import hashlib
from pathlib import Path

import numpy as np
import torch

from lmms_owc_tpu_torch.models._api import register_model
from lmms_owc_tpu_torch.models._base import Model
from lmms_owc_tpu_torch.models.qwen2_vl import _assemble_embeds
from lmms_owc_tpu_torch.nn import instructblip as ib
from lmms_owc_tpu_torch.nn import qwen2_vl as qvl
from lmms_owc_tpu_torch.nn.layers import Int4Linear, Int8Linear
from lmms_owc_tpu_torch.nn.llama import llama_positions
from lmms_owc_tpu_torch.nn.loader import load_config_json, load_safetensors_state
from lmms_owc_tpu_torch.ops import quant
from lmms_owc_tpu_torch.ops.image import OPENAI_CLIP_MEAN, OPENAI_CLIP_STD
from lmms_owc_tpu_torch.tokenizer import Tokenizer, WordPieceTokenizer
from lmms_owc_tpu_torch.utils import Collator, get_logger, pad_to_bucket

log = get_logger(__name__)

__all__ = ["PRESET_CONFIGS", "InstructBlip", "concatenate_images_with_labels"]

DEFAULT_MAX_NEW_TOKENS = 128
GEN_LEN_BUCKETS = (64, 128, 256, 512)
QFORMER_BUCKETS = (16, 32, 64, 128, 256)
QFORMER_MAX_LENGTH = 512

PRESET_CONFIGS = {
    "instructblip-vicuna-7b": dict(
        vision_config=dict(
            hidden_size=1408, num_hidden_layers=39, num_attention_heads=16,
            intermediate_size=6144, image_size=224, patch_size=14,
        ),
        qformer_config=dict(
            vocab_size=30523, hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
            intermediate_size=3072, cross_attention_frequency=2, encoder_hidden_size=1408,
        ),
        text_config=dict(
            model_type="llama", vocab_size=32001, hidden_size=4096, intermediate_size=11008,
            num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=32,
            rope_theta=10000.0, rms_norm_eps=1e-6, tie_word_embeddings=False,
        ),
        num_query_tokens=32,
    ),
    "instructblip-tiny": dict(
        vision_config=dict(
            hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, image_size=28, patch_size=14,
        ),
        qformer_config=dict(
            vocab_size=64, hidden_size=24, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=48, cross_attention_frequency=1, encoder_hidden_size=32,
        ),
        text_config=dict(
            model_type="llama", vocab_size=32001, hidden_size=48, intermediate_size=96,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            rope_theta=10000.0, rms_norm_eps=1e-6, tie_word_embeddings=True,
        ),
        num_query_tokens=4,
    ),
}


def concatenate_images_with_labels(images: list, gap: int = 8):
    """Combine multiple images into one labeled canvas (reference multi-image trick)."""
    from PIL import Image, ImageDraw

    images = [img.convert("RGB") for img in images]
    height = max(img.height for img in images)
    total_w = sum(img.width for img in images) + gap * (len(images) - 1)
    canvas = Image.new("RGB", (total_w, height), (255, 255, 255))
    x = 0
    draw = ImageDraw.Draw(canvas)
    for i, img in enumerate(images):
        canvas.paste(img, (x, 0))
        draw.text((x + 4, 4), f"({i + 1})", fill=(255, 0, 0))
        x += img.width + gap
    return canvas


def _hashed(word: str) -> int:
    return int.from_bytes(hashlib.md5(word.encode()).digest()[:3], "little")


class _FallbackBlipTokenizer:
    """Hash tokenizer for random-init runs (the JAX adapter's, id for id)."""

    eos_token_id = 2
    pad_token_id = 0

    def __init__(self, vocab_size: int = 32000) -> None:
        self.vocab_size = vocab_size

    def encode(self, text: str, add_special_tokens: bool = True) -> list[int]:
        ids = [1] if add_special_tokens else []
        return ids + [100 + _hashed(w) % (self.vocab_size - 200) for w in text.split()]

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        return " ".join(f"tok{int(i)}" for i in ids if int(i) > 2)


class InstructBlip(Model):
    """InstructBLIP on the PyTorch/CUDA stack."""

    def __init__(
        self,
        pretrained: str | None = None,
        preset: str = "instructblip-vicuna-7b",
        random_init: bool = False,
        jax_params: dict | None = None,
        time_phases: bool = False,
        **kwargs,
    ) -> None:
        """Weights come from the ``pretrained`` checkpoint directory, from
        ``jax_params`` (the JAX adapter's ``params`` tree as numpy arrays), or
        are drawn on the device from ``torch_random_seed`` (``random_init``,
        implied when there is no ``pretrained``; an unknown preset draws
        ``instructblip-vicuna-7b``'s widths, as in the JAX adapter).
        ``time_phases`` sums the vision, prefill and decode phases' wall
        seconds into :attr:`phase_seconds`."""
        self.pretrained = pretrained
        self.preset = preset
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
            self.preset, PRESET_CONFIGS["instructblip-vicuna-7b"])
        self.config = ib.instructblip_config_from_hf(dict(hf))
        self.decoder_config = self.config.text.to_decoder_config()
        bits = 4 if self.load_in_4bit else (8 if self.load_in_8bit else None)
        dtype, dev = self.torch_dtype, self.device
        self.qformer_tokenizer = None
        if checkpoint:
            self.tokenizer = Tokenizer.from_pretrained(self.pretrained)
            qdir = Path(self.pretrained) / "qformer_tokenizer"
            if (qdir / "vocab.txt").exists() or (qdir / "tokenizer.json").exists():
                self.qformer_tokenizer = WordPieceTokenizer.from_pretrained(qdir)
            self._check_vocabulary()
            state = load_safetensors_state(self.pretrained)
            if bits is not None:  # the full-precision tree never exists on the device
                meta = ib.InstructBlipModel(self.config, dtype, "meta")
                self.model = quant.load_quantized_on_device(meta, state, bits=bits, dtype=dtype, device=dev)
            else:
                self.model = ib.convert_hf_instructblip_weights(state, self.config, dtype, dev)
            del state
            log.info("loaded %s from %s (%s)", self.preset, self.pretrained, f"int{bits}" if bits else self.dtype)
        elif self._jax_params is not None:
            self.model = ib.instructblip_params_from_jax(self._jax_params, self.config, dtype, dev)
            self._jax_params = None
            quantized = any(isinstance(m, (Int8Linear, Int4Linear)) for m in self.model.modules())
            if bits is not None and not quantized:
                (quant.quantize_params_int8 if bits == 8 else quant.quantize_params_int4)(self.model)
            log.info("loaded %s from a JAX parameter tree", self.preset)
        else:
            gen = torch.Generator(device=dev).manual_seed(self.torch_random_seed)
            if bits is not None:
                self.model = quant.init_quantized_on_device(
                    ib.InstructBlipModel(self.config, dtype, "meta"), gen, bits=bits, dtype=dtype)
            else:
                self.model = ib.init_instructblip_params(self.config, gen, dtype)
            log.warning("random-init %s on %s (no checkpoint)", self.preset, dev)
        if not checkpoint:
            self.tokenizer = _FallbackBlipTokenizer()
        self.generator = torch.Generator(device=dev).manual_seed(self.torch_random_seed)

    def _check_vocabulary(self) -> None:
        """Every token id the adapter feeds to the decoder's embedding (the pad
        and the tokenizer's EOS) must lie inside the checkpoint's vocabulary
        (the JAX package's lookup reads NaN rows past it; the port refuses
        the load instead)."""
        vocab = self.config.text.vocab_size
        ids = {"pad_token_id": self.decoder_config.pad_token_id,
               "the tokenizer's eos_token_id": self.tokenizer.eos_token_id}
        for name, value in ids.items():
            if value is not None and not 0 <= int(value) < vocab:
                raise ValueError(f"{self.pretrained}: {name} {value} lies outside the checkpoint's vocabulary "
                                 f"of {vocab} tokens")

    @property
    def pad_token_id(self) -> int:
        return self.decoder_config.pad_token_id

    @property
    def eos_token_ids(self) -> list[int]:
        eos = getattr(self.tokenizer, "eos_token_id", 2)
        return [int(eos)] if eos is not None else [2]

    @property
    def tokenizer_name(self) -> str:
        return f"instructblip_{self.preset}"

    def apply_chat_template(self, messages: list[dict]) -> str:
        return " ".join(msg["content"] for msg in messages)

    # ------------------------------------------------------------ preprocessing

    def _qformer_encode(self, text: str) -> list[int]:
        """The Q-Former's instruction ids: the released ``qformer_tokenizer/``
        (truncated to 512 ids), else the JAX adapter's vocabulary-safe hash."""
        if self.qformer_tokenizer is not None:
            return self.qformer_tokenizer.encode(text, max_length=QFORMER_MAX_LENGTH)
        vocab = self.config.qformer.vocab_size
        lo = 1000 if vocab > 1200 else 4
        span = max(1, vocab - lo - 2)
        cls_id, sep_id = min(101, vocab - 2), min(102, vocab - 1)
        return [cls_id] + [lo + _hashed(w) % span for w in text.split()] + [sep_id]

    def _preprocess(self, visuals: list) -> np.ndarray | None:
        """BLIP preprocessing: several images become one labeled canvas, then a
        bicubic resize to (S, S) and CLIP normalization -> [1, 3, S, S]."""
        if not visuals:
            return None
        from PIL import Image

        if len(visuals) > 1:
            visuals = [concatenate_images_with_labels(visuals)]
        size = self.config.vision.image_size
        img = visuals[0].convert("RGB").resize((size, size), Image.BICUBIC)
        arr = np.asarray(img).astype(np.float32) / 255.0
        arr = (arr - np.asarray(OPENAI_CLIP_MEAN)) / np.asarray(OPENAI_CLIP_STD)
        return arr.transpose(2, 0, 1)[None]

    @torch.inference_mode()
    def _query_embeds(self, pixel_rows: list, qf_rows: list[list[int]]) -> torch.Tensor:
        """Every row through the tower (a row without an image takes zeros) and
        the Q-Former in one call each: [B, nq, H] on the device."""
        size = self.config.vision.image_size
        pixels = np.concatenate(
            [p if p is not None else np.zeros((1, 3, size, size), np.float32) for p in pixel_rows])
        qf_len = pad_to_bucket(max(len(q) for q in qf_rows), QFORMER_BUCKETS)
        qf_ids = np.zeros((len(qf_rows), qf_len), np.int64)
        qf_mask = np.zeros((len(qf_rows), qf_len), np.int64)
        for row, ids in enumerate(qf_rows):
            qf_ids[row, : len(ids)] = ids
            qf_mask[row, : len(ids)] = 1
        dev = self.device
        with self._phase("vision"):
            return ib.encode_image_queries(
                self.model, torch.from_numpy(pixels).to(dev, self.model.dtype), torch.from_numpy(qf_ids).to(dev),
                torch.from_numpy(qf_mask).to(dev), self.config)

    def _layout(self, text_rows: list[list[int]], has_image: list[bool]):
        """Left-padded [queries; text] rows: (input_ids, mask, index_map, the
        first query position of each row). A row without an image masks its
        query slots out, as the JAX adapter."""
        nq = self.config.num_query_tokens
        bsz = len(text_rows)
        bucket = pad_to_bucket(nq + max(len(t) for t in text_rows))
        input_ids = np.full((bsz, bucket), self.pad_token_id, np.int64)
        mask = np.zeros((bsz, bucket), np.int64)
        index_map = np.full((bsz, bucket), -1, np.int64)
        offsets = []
        for row, ids in enumerate(text_rows):
            offset = bucket - (nq + len(ids))
            offsets.append(offset)
            input_ids[row, offset + nq :] = ids
            mask[row, offset:] = 1
            if has_image[row]:
                index_map[row, offset : offset + nq] = row * nq + np.arange(nq)
            else:
                mask[row, offset : offset + nq] = 0
        return input_ids, mask, index_map, offsets

    def _embed(self, input_ids: np.ndarray, index_map: np.ndarray, query_embeds: torch.Tensor) -> torch.Tensor:
        dev = self.device
        return _assemble_embeds(self.model.text.embed_tokens, torch.from_numpy(input_ids).to(dev),
                                query_embeds.reshape(-1, query_embeds.shape[-1]), torch.from_numpy(index_map).to(dev))

    def _prepare_chunk(self, chunk: list) -> tuple:
        """Host preprocessing, the tower and the Q-Former for a chunk of
        request args (overlapped with the previous chunk's decode): the
        embeddings, positions, mask, next positions and prompt bucket."""
        pixel_rows, qf_rows, text_rows = [], [], []
        for args in chunk:
            pixel_rows.append(self._preprocess(self._request_visuals(*args[2:6])))
            qf_rows.append(self._qformer_encode(args[0]))
            text_rows.append(self.tokenizer.encode(args[0]))
        query_embeds = self._query_embeds(pixel_rows, qf_rows)
        input_ids, mask, index_map, _ = self._layout(text_rows, [p is not None for p in pixel_rows])
        embeds = self._embed(input_ids, index_map, query_embeds)
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
        beyond the reference's InstructBLIP adapter, with the contract of its
        llava adapter, as in the JAX package."""
        dev = self.device
        nq = self.config.num_query_tokens
        results: list[tuple[float, bool]] = []
        for start in range(0, len(requests), self.batch_size):
            pixel_rows, qf_rows, text_rows, cont_lens = [], [], [], []
            for req in requests[start : start + self.batch_size]:
                ctx, continuation, visuals = self._resolve_loglikelihood_request(req)
                pixel_rows.append(self._preprocess(visuals))
                qf_rows.append(self._qformer_encode(ctx))
                cont_ids = self._encode_continuation(continuation)
                text_rows.append(self.tokenizer.encode(ctx) + cont_ids)
                cont_lens.append(len(cont_ids))
            query_embeds = self._query_embeds(pixel_rows, qf_rows)
            input_ids, mask, index_map, offsets = self._layout(text_rows, [p is not None for p in pixel_rows])
            bucket = input_ids.shape[1]
            target_ids = np.zeros(input_ids.shape, np.int64)
            target_mask = np.zeros(input_ids.shape, np.int64)
            for row, ids in enumerate(text_rows):
                # Position t predicts token t + 1: the last query slot predicts the first text token.
                target_ids[row, offsets[row] + nq - 1 : bucket - 1] = ids
                target_mask[row, bucket - 1 - cont_lens[row] : bucket - 1] = 1
            embeds = self._embed(input_ids, index_map, query_embeds)
            position_ids, _ = llama_positions(mask)
            with self._phase("score"):
                loss, is_greedy = qvl.score_continuation(
                    self.model.text, embeds, torch.from_numpy(position_ids).to(dev),
                    torch.from_numpy(mask.astype(np.int32)).to(dev),
                    torch.from_numpy(target_ids).to(dev), torch.from_numpy(target_mask).to(dev),
                )
            results.extend(zip(loss.tolist(), is_greedy.tolist()))
        return results


@register_model("instructblip-vicuna-7b")
def instructblip_vicuna_7b(**kwargs) -> InstructBlip:
    """Salesforce/instructblip-vicuna-7b (reference: src/models/_instructblip.py:608-622)."""
    kwargs.setdefault("preset", "instructblip-vicuna-7b")
    return InstructBlip(**kwargs)


@register_model("instructblip-vicuna-13b")
def instructblip_vicuna_13b(**kwargs) -> InstructBlip:
    """Salesforce/instructblip-vicuna-13b."""
    kwargs.setdefault("preset", "instructblip-vicuna-7b")
    return InstructBlip(**kwargs)


@register_model("instructblip-tiny")
def instructblip_tiny(**kwargs) -> InstructBlip:
    """Miniature InstructBLIP for CPU tests."""
    kwargs.setdefault("preset", "instructblip-tiny")
    return InstructBlip(**kwargs)
