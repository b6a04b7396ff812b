"""LLaVA (HF-style) model adapter of the port: llava-1.5 and llava-next with
generate_until + loglikelihood.

Counterpart of :mod:`lmms_owc_tpu.models.llava_hf` (the reference's
``src/models/_llava_hf.py``: registered IDs, generate flow, the Vicuna chat
format, loglikelihood via context/continuation masking), on the PyTorch/CUDA
stack: CLIP-ViT tower + projector + Llama decoder
(:mod:`lmms_owc_tpu_torch.nn.llava`), batched left-padded generation through
the port's decoder (K2 prefill, K3 decode on the card) and fused
loglikelihood scoring. llava-1.5 images take the JAX adapter's own PIL recipe
and one tower call per chunk; llava-next images are tiled by anyres
(:mod:`lmms_owc_tpu_torch.nn.anyres`) and packed with the newline embedding
on the card. Weights come from a ``pretrained`` HF checkpoint (the port's
safetensors reader and ``byte_fallback`` BPE tokenizer), from a JAX
parameter tree, or are drawn on the device from a seed; ``load_in_8bit`` /
``load_in_4bit`` quantize the decoder's, the tower's and the projector's
linear layers, as the JAX package. As in the JAX adapter there is no decode
pool here, and its mesh path is not ported.
"""

from __future__ import annotations

import hashlib
from pathlib import Path

import numpy as np
import torch

from lmms_owc_tpu_torch.models._api import register_model
from lmms_owc_tpu_torch.models._base import Model
from lmms_owc_tpu_torch.models.qwen2_vl import _assemble_embeds
from lmms_owc_tpu_torch.nn import anyres
from lmms_owc_tpu_torch.nn import llava as lv
from lmms_owc_tpu_torch.nn import qwen2_vl as qvl
from lmms_owc_tpu_torch.nn.layers import Int4Linear, Int8Linear
from lmms_owc_tpu_torch.nn.llama import llama_positions
from lmms_owc_tpu_torch.nn.loader import load_config_json, load_safetensors_state
from lmms_owc_tpu_torch.ops import quant
from lmms_owc_tpu_torch.ops.image import OPENAI_CLIP_MEAN, OPENAI_CLIP_STD
from lmms_owc_tpu_torch.tokenizer import Tokenizer
from lmms_owc_tpu_torch.utils import Collator, get_logger, pad_to_bucket

log = get_logger(__name__)

__all__ = ["PRESET_CONFIGS", "LlavaHf"]

DEFAULT_MAX_NEW_TOKENS = 128
GEN_LEN_BUCKETS = (64, 128, 256, 512)

# Vicuna v1 conversation format used by llava-1.5 (reference src/models/_llava_hf.py:23).
VICUNA_SYSTEM = (
    "A chat between a curious human and an artificial intelligence assistant. "
    "The assistant gives helpful, detailed, and polite answers to the human's questions."
)

PRESET_CONFIGS = {
    "llava-1.5-7b": dict(
        text_config=dict(
            model_type="llama", vocab_size=32064, hidden_size=4096, intermediate_size=11008,
            num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=32,
            rope_theta=10000.0, rms_norm_eps=1e-5, tie_word_embeddings=False,
        ),
        vision_config=dict(
            hidden_size=1024, num_hidden_layers=24, num_attention_heads=16,
            intermediate_size=4096, image_size=336, patch_size=14,
        ),
        image_token_index=32000,
    ),
    "llava-1.5-13b": dict(
        text_config=dict(
            model_type="llama", vocab_size=32064, hidden_size=5120, intermediate_size=13824,
            num_hidden_layers=40, num_attention_heads=40, num_key_value_heads=40,
            rope_theta=10000.0, rms_norm_eps=1e-5, tie_word_embeddings=False,
        ),
        vision_config=dict(
            hidden_size=1024, num_hidden_layers=24, num_attention_heads=16,
            intermediate_size=4096, image_size=336, patch_size=14,
        ),
        image_token_index=32000,
    ),
    "llava-next-vicuna-7b": dict(
        model_type="llava_next",
        text_config=dict(
            model_type="llama", vocab_size=32064, hidden_size=4096, intermediate_size=11008,
            num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=32,
            rope_theta=10000.0, rms_norm_eps=1e-5, tie_word_embeddings=False,
        ),
        vision_config=dict(
            hidden_size=1024, num_hidden_layers=24, num_attention_heads=16,
            intermediate_size=4096, image_size=336, patch_size=14,
        ),
        image_token_index=32000,
        image_grid_pinpoints=[[336, 672], [672, 336], [672, 672], [1008, 336], [336, 1008]],
    ),
    "llava-next-mistral-7b": dict(
        model_type="llava_next",
        text_config=dict(
            model_type="mistral", vocab_size=32064, hidden_size=4096, intermediate_size=14336,
            num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
            rope_theta=1000000.0, rms_norm_eps=1e-5, tie_word_embeddings=False,
        ),
        vision_config=dict(
            hidden_size=1024, num_hidden_layers=24, num_attention_heads=16,
            intermediate_size=4096, image_size=336, patch_size=14,
        ),
        image_token_index=32000,
        image_grid_pinpoints=[[336, 672], [672, 336], [672, 672], [1008, 336], [336, 1008]],
    ),
    "llava-tiny": dict(
        text_config=dict(
            model_type="llama", vocab_size=32064, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            rope_theta=10000.0, rms_norm_eps=1e-5, tie_word_embeddings=True,
        ),
        vision_config=dict(
            hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, image_size=28, patch_size=14,
        ),
        image_token_index=32000,
    ),
}


class _FallbackLlavaTokenizer:
    """Hash tokenizer for random-init benchmarking; handles <image> and </s>
    (the JAX adapter's, id for id)."""

    eos_token_id = 2
    pad_token_id = 0

    def __init__(self, image_token_id: int, vocab_size: int = 32000) -> None:
        self.image_token_id = image_token_id
        self.vocab_size = vocab_size

    def encode(self, text: str, add_special_tokens: bool = True) -> list[int]:
        ids = [1] if add_special_tokens else []
        for piece in text.replace("<image>", " <image> ").split():
            if piece == "<image>":
                ids.append(self.image_token_id)
            else:
                ids.append(
                    100 + int.from_bytes(hashlib.md5(piece.encode()).digest()[:3], "little")
                    % (self.vocab_size - 200)
                )
        return ids

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        return " ".join(f"tok{int(i)}" for i in ids if int(i) > 2)


class LlavaHf(Model):
    """LLaVA-1.5 / LLaVA-NeXT on the PyTorch/CUDA stack."""

    def __init__(
        self,
        pretrained: str | None = None,
        preset: str = "llava-1.5-7b",
        random_init: bool = False,
        jax_params: dict | None = None,
        time_phases: bool = False,
        **kwargs,
    ) -> None:
        """Weights come from the ``pretrained`` checkpoint directory (its
        ``config.json`` gives the architecture; with ``load_in_8bit`` /
        ``load_in_4bit`` each layer is quantized on the device as it loads),
        from ``jax_params`` (the JAX package's llava tree as numpy arrays,
        float or quantized, see :func:`~lmms_owc_tpu_torch.nn.llava.llava_params_from_jax`),
        or are drawn on the device from ``torch_random_seed`` (``random_init``,
        implied when there is no ``pretrained``). ``time_phases`` sums the
        vision, prefill and decode phases' wall seconds into
        :attr:`phase_seconds`."""
        if preset not in PRESET_CONFIGS:
            raise ValueError(f"unknown preset {preset!r}; available: {sorted(PRESET_CONFIGS)}")
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
        hf = load_config_json(self.pretrained) if checkpoint else PRESET_CONFIGS[self.preset]
        self.is_next = hf.get("model_type") == "llava_next"
        self.grid_pinpoints = hf.get("image_grid_pinpoints")
        self.config = lv.llava_config_from_hf(hf)
        bits = 4 if self.load_in_4bit else (8 if self.load_in_8bit else None)
        dtype, dev = self.torch_dtype, self.device
        if checkpoint:
            self.tokenizer = Tokenizer.from_pretrained(self.pretrained)
            self._check_vocabulary()
            state = load_safetensors_state(self.pretrained)
            newline = self.is_next and lv.has_image_newline(state)
            if bits is not None:
                # The full-precision tree never exists on the device.
                self.model = lv.LlavaModel(self.config, dtype, "meta", newline)
                quant.load_quantized_on_device(self.model, state, bits=bits, dtype=dtype, device=dev)
            else:
                self.model = lv.convert_hf_llava_weights(state, self.config, dtype, dev)
            del state
            log.info("loaded %s from %s (%s)", self.preset, self.pretrained, f"int{bits}" if bits else self.dtype)
        elif self._jax_params is not None:
            self.model = lv.llava_params_from_jax(self._jax_params, self.config, dtype, dev)
            self._jax_params = None
            quantized = any(isinstance(m, (Int8Linear, Int4Linear)) for m in self.model.modules())
            if bits is not None and not quantized:  # a float tree, served quantized
                (quant.quantize_params_int8 if bits == 8 else quant.quantize_params_int4)(self.model)
            log.info("loaded %s from a JAX parameter tree", self.preset)
        else:
            gen = torch.Generator(device=dev).manual_seed(self.torch_random_seed)
            if bits is not None:
                self.model = lv.LlavaModel(self.config, dtype, "meta", self.is_next)
                quant.init_quantized_on_device(self.model, gen, bits=bits, dtype=dtype)
                if self.model.image_newline is not None:
                    self.model.image_newline.data.zero_()
            else:
                self.model = lv.init_llava_params(self.config, gen, dtype, self.is_next)
            log.warning("random-init %s on %s (no checkpoint)", self.preset, dev)
        if not checkpoint:
            self.tokenizer = _FallbackLlavaTokenizer(self.config.image_token_id)
        self.generator = torch.Generator(device=dev).manual_seed(self.torch_random_seed)

    def _check_vocabulary(self) -> None:
        """Every token id the adapter feeds to the embedding or stops on must lie
        inside the checkpoint's vocabulary. (A ``pad_token_id`` of 0 in the
        config becomes 32001, as in the JAX package, whose embedding lookup
        then reads NaN rows past a smaller vocabulary; the port refuses the
        load instead.)"""
        c = self.config
        ids = {"pad_token_id": c.pad_token_id, "image_token_index": c.image_token_id,
               "the tokenizer's eos_token_id": self.tokenizer.eos_token_id}
        for name, value in ids.items():
            if value is not None and not 0 <= int(value) < c.text.vocab_size:
                raise ValueError(f"{self.pretrained}: {name} {value} lies outside the checkpoint's vocabulary "
                                 f"of {c.text.vocab_size} tokens")

    @property
    def eos_token_ids(self) -> list[int]:
        eos = getattr(self.tokenizer, "eos_token_id", 2)
        return [int(eos)] if eos is not None else [2]

    @property
    def chat_template(self) -> str:
        return "vicuna_v1"

    @property
    def tokenizer_name(self) -> str:
        return f"llava_{self.preset}"

    def apply_chat_template(self, messages: list[dict]) -> str:
        parts = [VICUNA_SYSTEM, " "]
        for msg in messages:
            role = "USER" if msg["role"] == "user" else "ASSISTANT"
            parts.append(f"{role}: {msg['content']} ")
        parts.append("ASSISTANT:")
        return "".join(parts)

    def _build_prompt(self, context: str, num_images: int) -> str:
        image_tokens = "<image>\n" * num_images
        if "mistral" in self.preset:
            return f"[INST] {image_tokens}{context} [/INST]"
        return f"USER: {image_tokens}{context} ASSISTANT:"

    # ------------------------------------------------------------ preprocessing

    @staticmethod
    def _normalize(image) -> np.ndarray:
        """uint8 RGB -> [3, H, W] CLIP-normalized (the JAX adapter's float64 arithmetic)."""
        arr = np.asarray(image).astype(np.float32) / 255.0
        arr = (arr - np.asarray(OPENAI_CLIP_MEAN)) / np.asarray(OPENAI_CLIP_STD)
        return arr.transpose(2, 0, 1)

    def _preprocess_images(self, visuals: list) -> np.ndarray | None:
        """CLIP preprocessing (the JAX adapter's recipe, not HF's): resize the
        shortest side to the tower's size (``round``, at least the size),
        centre crop at ``(w - size) // 2``, normalize."""
        if not visuals:
            return None
        from PIL import Image

        size = self.config.vision.image_size
        arrays = []
        for image in visuals:
            image = image.convert("RGB")
            w, h = image.size
            scale = size / min(w, h)
            image = image.resize((max(size, round(w * scale)), max(size, round(h * scale))), Image.BICUBIC)
            w, h = image.size
            left, top = (w - size) // 2, (h - size) // 2
            image = image.crop((left, top, left + size, top + size))
            arrays.append(self._normalize(image))
        return np.stack(arrays)

    def _pixels(self, arrays: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arrays).to(device=self.device, dtype=self.model.dtype)

    @torch.inference_mode()
    def _embed_sequence(self, input_ids: np.ndarray, payloads: list) -> torch.Tensor:
        """Token embeddings with vision features gathered into the <image> slots.

        ``payloads[row]`` is a pixel array [N, 3, S, S] (llava-1.5: a fixed
        ``image_seq_length`` per image; every row's pixels go through the
        tower in one call), a ("features", [tokens, H]) tuple (llava-next
        anyres packing, already encoded), or None.
        """
        pixel_rows = [p for p in payloads if isinstance(p, np.ndarray)]
        encoded = None
        if pixel_rows:
            with self._phase("vision"):
                vision = lv.encode_images(self.model, self._pixels(np.concatenate(pixel_rows)), self.config)
                encoded = vision.reshape(-1, vision.shape[-1])
        feature_rows: list[torch.Tensor] = []
        bsz, bucket = input_ids.shape
        index_map = np.full((bsz, bucket), -1, np.int64)
        cursor = pix_cursor = 0
        for row, payload in enumerate(payloads):
            if payload is None:
                continue
            if isinstance(payload, tuple):
                feats = payload[1]
            else:
                n = payload.shape[0] * self.config.image_seq_length
                feats = encoded[pix_cursor : pix_cursor + n]
                pix_cursor += n
            if feats is None:
                continue
            positions = np.where(input_ids[row] == self.config.image_token_id)[0]
            index_map[row, positions] = cursor + np.arange(len(positions))
            cursor += feats.shape[0]
            feature_rows.append(feats)
        dev = self.device
        vision_flat = torch.cat(feature_rows) if feature_rows else None
        return _assemble_embeds(
            self.model.text.embed_tokens,
            torch.from_numpy(input_ids).to(dev),
            vision_flat,
            torch.from_numpy(index_map).to(dev) if vision_flat is not None else None,
        )

    @torch.inference_mode()
    def _encode_anyres_image(self, image) -> torch.Tensor:
        """LLaVA-NeXT path: anyres tiles -> CLIP -> projector -> packed [tokens, H] on the device."""
        from PIL import Image

        image = image.convert("RGB")
        size = self.config.vision.image_size
        orig_w, orig_h = image.size
        pinpoints = self.grid_pinpoints or anyres.default_grid_pinpoints(size, 3)
        best = anyres.select_best_resolution((orig_h, orig_w), pinpoints)
        padded = anyres.resize_and_pad(image, best)
        tiles = [image.resize((size, size), Image.BICUBIC)] + anyres.divide_to_patches(padded, size)
        pixels = np.stack([self._normalize(tile) for tile in tiles])
        with self._phase("vision"):
            feats = lv.encode_images(self.model, self._pixels(pixels), self.config)
            return anyres.pack_anyres_features(
                feats, (orig_h, orig_w), pinpoints, size, self.config.vision.patch_size,
                self.model.image_newline, max_patches=None,  # llava-next does not downscale
            )

    def _prepare_request(self, ctx, doc_to_visual, doc_id, task_name, split):
        task = self.task_dict.get(task_name)
        if isinstance(task, tuple):
            task = task[1]
        visuals = []
        if task is not None and doc_to_visual is not None:
            doc = task.dataset[split][doc_id]
            visuals = doc_to_visual(doc) or []
        prompt = self._build_prompt(ctx, len(visuals))
        ids = self.tokenizer.encode(prompt)

        if self.is_next and visuals:
            features = [self._encode_anyres_image(img) for img in visuals]
            expanded: list[int] = []
            img_idx = 0
            for tok in ids:
                if tok == self.config.image_token_id:
                    expanded.extend([tok] * features[img_idx].shape[0])
                    img_idx += 1
                else:
                    expanded.append(tok)
            return expanded, ("features", torch.cat(features))

        # Expand each single <image> token to image_seq_length positions.
        expanded = []
        for tok in ids:
            if tok == self.config.image_token_id:
                expanded.extend([tok] * self.config.image_seq_length)
            else:
                expanded.append(tok)
        return expanded, self._preprocess_images(visuals)

    # ------------------------------------------------------------- generation

    def _detokenize(self, tokens: np.ndarray) -> list[str]:
        """Trim each row at the first EOS/pad token and decode to text."""
        stop = set(self.eos_token_ids) | {self.config.pad_token_id}
        texts = []
        for row in range(tokens.shape[0]):
            ids = []
            for tok in tokens[row]:
                if int(tok) in stop:
                    break
                ids.append(int(tok))
            texts.append(self.tokenizer.decode(ids, skip_special_tokens=True))
        return texts

    def _left_pad(self, rows: list[list[int]]) -> tuple[np.ndarray, np.ndarray]:
        """(input_ids, mask) [B, bucket]: rows left-padded with the pad id."""
        bucket = pad_to_bucket(max(len(ids) for ids in rows))
        input_ids = np.full((len(rows), bucket), self.config.pad_token_id, np.int64)
        mask = np.zeros((len(rows), bucket), np.int64)
        for row, ids in enumerate(rows):
            input_ids[row, bucket - len(ids) :] = ids
            mask[row, bucket - len(ids) :] = 1
        return input_ids, mask

    def generate_until(self, requests) -> list[str]:
        collator = Collator(
            [req.args for req in requests],
            sort_fn=lambda args: -len(args[0]),
            group_fn=lambda args: repr(args[1]),
            group_by="gen_kwargs",
        )
        chunks = list(collator.get_batched(n=self.batch_size))
        dev = self.device

        def _prepare_chunk(chunk):
            return [self._prepare_request(args[0], args[2], args[3], args[4], args[5]) for args in chunk]

        @torch.inference_mode()
        def _run_chunk(chunk, prepared):
            gen_kwargs = dict(chunk[0][1] or {})
            until = gen_kwargs.get("until") or []
            if isinstance(until, str):
                until = [until]
            max_new = int(gen_kwargs.get("max_new_tokens", DEFAULT_MAX_NEW_TOKENS))
            input_ids, mask = self._left_pad([ids for ids, _ in prepared])
            embeds = self._embed_sequence(input_ids, [payload for _, payload in prepared])
            position_ids, next_pos = llama_positions(mask)
            tokens = qvl.greedy_generate(
                self.model.text,
                embeds,
                torch.from_numpy(position_ids).to(dev),
                torch.from_numpy(mask.astype(np.int32)).to(dev),
                torch.from_numpy(next_pos).to(dev),
                max_new_tokens=max_new,
                cache_len=input_ids.shape[1] + pad_to_bucket(max_new, GEN_LEN_BUCKETS),
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

        results = self._foreach_chunk_pipelined(chunks, _prepare_chunk, _run_chunk)
        return collator.get_original(results)

    @torch.inference_mode()
    def loglikelihood(self, requests) -> list[tuple[float, bool]]:
        """(ctx, doc_to_target, doc_to_visual, doc_id, task, split), or (ctx,
        continuation), -> (loss, is_greedy): labels are the full ids with the
        context masked; returns the mean cross-entropy over the continuation
        and whether greedy decoding reproduces it (the reference's contract).
        Requests run in order in batches of ``batch_size``."""
        dev = self.device
        results: list[tuple[float, bool]] = []
        for start in range(0, len(requests), self.batch_size):
            rows = []
            for req in requests[start : start + self.batch_size]:
                ctx, continuation, _ = self._resolve_loglikelihood_request(req)
                task_built = len(req.args) >= 6
                expanded_ctx, payload = self._prepare_request(
                    ctx, req.args[2] if task_built else None, req.args[3] if task_built else 0,
                    req.args[4] if task_built else "", req.args[5] if task_built else "",
                )
                cont_ids = self._encode_continuation(continuation)
                rows.append((expanded_ctx + cont_ids, len(cont_ids), payload))

            input_ids, mask = self._left_pad([ids for ids, _, _ in rows])
            bucket = input_ids.shape[1]
            target_ids = np.zeros((len(rows), bucket), np.int64)
            target_mask = np.zeros((len(rows), bucket), np.int64)
            for row, (ids, n_cont, _) in enumerate(rows):
                # Position t predicts token t+1: continuation targets live at the
                # last n_cont prediction slots.
                target_ids[row, bucket - len(ids) : bucket - 1] = ids[1:]
                target_mask[row, bucket - 1 - n_cont : bucket - 1] = 1
            embeds = self._embed_sequence(input_ids, [payload for _, _, payload in rows])
            position_ids, _ = llama_positions(mask)
            with self._phase("score"):
                loss, is_greedy = qvl.score_continuation(
                    self.model.text, embeds, torch.from_numpy(position_ids).to(dev),
                    torch.from_numpy(mask.astype(np.int32)).to(dev),
                    torch.from_numpy(target_ids).to(dev), torch.from_numpy(target_mask).to(dev),
                )
            results.extend(zip(loss.tolist(), is_greedy.tolist()))
        return results


@register_model("llava-1.5-7b")
def llava_15_7b(**kwargs) -> LlavaHf:
    """llava-hf/llava-1.5-7b-hf (reference registration: src/models/_llava_hf.py:586-595)."""
    kwargs.setdefault("preset", "llava-1.5-7b")
    return LlavaHf(**kwargs)


@register_model("llava-1.5-13b")
def llava_15_13b(**kwargs) -> LlavaHf:
    """llava-hf/llava-1.5-13b-hf."""
    kwargs.setdefault("preset", "llava-1.5-13b")
    return LlavaHf(**kwargs)


@register_model("llava-next-vicuna-7b")
def llava_next_vicuna_7b(**kwargs) -> LlavaHf:
    """llava-hf/llava-v1.6-vicuna-7b-hf (anyres tiling)."""
    kwargs.setdefault("preset", "llava-next-vicuna-7b")
    return LlavaHf(**kwargs)


@register_model("llava-next-mistral-7b")
def llava_next_mistral_7b(**kwargs) -> LlavaHf:
    """llava-hf/llava-v1.6-mistral-7b-hf (anyres tiling, [INST] prompt format)."""
    kwargs.setdefault("preset", "llava-next-mistral-7b")
    return LlavaHf(**kwargs)


@register_model("llava-tiny")
def llava_tiny(**kwargs) -> LlavaHf:
    """Miniature LLaVA for CPU tests."""
    kwargs.setdefault("preset", "llava-tiny")
    return LlavaHf(**kwargs)
