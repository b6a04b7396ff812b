"""Idefics2 model adapter of the port (idefics2-8b).

Counterpart of :mod:`lmms_owc_tpu.models.idefics2` (the reference's
``src/models/_idefics2.py``, registered at :407, messages-format prompting),
on the PyTorch/CUDA stack: the SigLIP tower (K2 at head_dim 72 on the card,
its tensor-mask form over a padded batch's patch masks), the modality
projection and perceiver resampler of :mod:`lmms_owc_tpu_torch.nn.idefics2`,
and the Mistral decoder of the port (K2 for the prefill, K3 for each decode
step). By default images take the HF processor's variable-aspect
preprocessing (``hf_preprocess``: resize within the edge budget, pad the
batch bottom/right to one H x W, patch masks and bucketized position ids);
``image_size=N`` forces the fixed-square path. The HF 4-crop splitting is
off by default (``do_image_splitting=False``). Host preprocessing, the tower
and the perceiver run in the chunk pipeline's preparation, overlapped with
the previous chunk's decode. Weights come from a ``pretrained`` HF
checkpoint (the port's safetensors reader and ``byte_fallback`` BPE
tokenizer), from a JAX parameter tree, or are drawn on the device from a
seed. As in the JAX adapter there is no decode pool here.
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
from lmms_owc_tpu_torch.nn import idefics2 as idf
from lmms_owc_tpu_torch.nn import qwen2_vl as qvl
from lmms_owc_tpu_torch.nn.layers import Int4Linear, Int8Linear
from lmms_owc_tpu_torch.nn.llama import llama_positions
from lmms_owc_tpu_torch.nn.loader import load_config_json, load_safetensors_state
from lmms_owc_tpu_torch.ops import quant
from lmms_owc_tpu_torch.tokenizer import Tokenizer
from lmms_owc_tpu_torch.utils import Collator, get_logger, pad_to_bucket

log = get_logger(__name__)

__all__ = ["PRESET_CONFIGS", "Idefics2"]

DEFAULT_MAX_NEW_TOKENS = 128
GEN_LEN_BUCKETS = (64, 128, 256, 512)
IDEFICS_MEAN = (0.5, 0.5, 0.5)
IDEFICS_STD = (0.5, 0.5, 0.5)

_FAKE = "<fake_token_around_image>"
_IMAGE = "<image>"
_EOU = "<end_of_utterance>"

PRESET_CONFIGS = {
    "idefics2-8b": dict(
        vision_config=dict(
            hidden_size=1152, num_hidden_layers=27, num_attention_heads=16,
            intermediate_size=4304, image_size=980, patch_size=14,
        ),
        perceiver_config=dict(
            resampler_n_latents=64, resampler_depth=3, resampler_n_heads=16,
            resampler_head_dim=96, num_key_value_heads=4,
        ),
        text_config=dict(
            model_type="mistral", vocab_size=32003, hidden_size=4096, intermediate_size=14336,
            num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
            rope_theta=10000.0, rms_norm_eps=1e-5, tie_word_embeddings=False,
        ),
        image_token_id=32001,
    ),
    "idefics2-tiny": dict(
        vision_config=dict(
            hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, image_size=28, patch_size=14,
        ),
        perceiver_config=dict(
            resampler_n_latents=4, resampler_depth=1, resampler_n_heads=4,
            resampler_head_dim=8, num_key_value_heads=2,
        ),
        text_config=dict(
            model_type="mistral", vocab_size=32003, hidden_size=48, intermediate_size=96,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            rope_theta=10000.0, rms_norm_eps=1e-5, tie_word_embeddings=True,
        ),
        image_token_id=32001,
    ),
}


class _FallbackIdeficsTokenizer:
    """Hash tokenizer for random-init runs (the JAX adapter's, id for id)."""

    eos_token_id = 2
    pad_token_id = 0

    def __init__(self, image_token_id: int) -> None:
        self._special = {_FAKE: 32000, _IMAGE: image_token_id, _EOU: 32002}

    @staticmethod
    def _word(word: str) -> int:
        return 100 + int.from_bytes(hashlib.md5(word.encode()).digest()[:3], "little") % 31000

    def encode(self, text: str, add_special_tokens: bool = True) -> list[int]:
        ids = [1] if add_special_tokens else []
        pattern = "|".join(re.escape(s) for s in self._special)
        pos = 0
        for match in re.finditer(pattern, text):
            ids.extend(self._word(w) for w in text[pos : match.start()].split())
            ids.append(self._special[match.group()])
            pos = match.end()
        ids.extend(self._word(w) for w in text[pos:].split())
        return ids

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        return " ".join(f"tok{int(i)}" for i in ids if int(i) > 2)


class Idefics2(Model):
    """Idefics2 on the PyTorch/CUDA stack."""

    def __init__(
        self,
        pretrained: str | None = None,
        preset: str = "idefics2-8b",
        image_size: int | None = None,
        do_image_splitting: bool = False,
        hf_preprocess: bool = True,
        random_init: bool = False,
        jax_params: dict | None = None,
        time_phases: bool = False,
        **kwargs,
    ) -> None:
        """Weights come from the ``pretrained`` checkpoint directory, from
        ``jax_params`` (the JAX adapter's ``params`` tree as numpy arrays), or
        are drawn on the device from ``torch_random_seed``. ``image_size=N``
        forces the fixed-square preprocessing (and turns ``hf_preprocess``
        off); ``time_phases`` sums the vision, prefill and decode phases' wall
        seconds into :attr:`phase_seconds`."""
        if preset not in PRESET_CONFIGS:
            raise ValueError(f"unknown preset {preset!r}; available: {sorted(PRESET_CONFIGS)}")
        self.pretrained = pretrained
        self.preset = preset
        self.image_size_override = image_size
        self.do_image_splitting = do_image_splitting
        self.hf_preprocess = bool(hf_preprocess) and image_size is None
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
        self.config = idf.idefics2_config_from_hf(hf)
        self.decoder_config = self.config.text.to_decoder_config()
        bits = 4 if self.load_in_4bit else (8 if self.load_in_8bit else None)
        dtype, dev = self.torch_dtype, self.device
        if checkpoint:
            self.tokenizer = Tokenizer.from_pretrained(self.pretrained)
            self._check_vocabulary()
            state = load_safetensors_state(self.pretrained)
            if bits is not None:  # the full-precision tree never exists on the device
                meta = idf.Idefics2Model(self.config, dtype, "meta", idf.hf_projection_dim(state))
                self.model = quant.load_quantized_on_device(meta, state, bits=bits, dtype=dtype, device=dev)
            else:
                self.model = idf.convert_hf_idefics2_weights(state, self.config, dtype, dev)
            del state
            log.info("loaded %s from %s (%s)", self.preset, self.pretrained, f"int{bits}" if bits else self.dtype)
        elif self._jax_params is not None:
            self.model = idf.idefics2_params_from_jax(self._jax_params, self.config, dtype, dev)
            self._jax_params = None
            quantized = any(isinstance(m, (Int8Linear, Int4Linear)) for m in self.model.modules())
            if bits is not None and not quantized:
                (quant.quantize_params_int8 if bits == 8 else quant.quantize_params_int4)(self.model)
            log.info("loaded %s from a JAX parameter tree", self.preset)
        else:
            gen = torch.Generator(device=dev).manual_seed(self.torch_random_seed)
            if bits is not None:
                self.model = quant.init_quantized_on_device(
                    idf.Idefics2Model(self.config, dtype, "meta"), gen, bits=bits, dtype=dtype)
            else:
                self.model = idf.init_idefics2_params(self.config, gen, dtype)
            log.warning("random-init %s on %s (no checkpoint)", self.preset, dev)
        if not checkpoint:
            self.tokenizer = _FallbackIdeficsTokenizer(self.config.image_token_id)
        # 980px SigLIP is expensive; the fixed-square path takes at most 448.
        self.image_size = self.image_size_override or min(self.config.vision.image_size, 448)
        self.generator = torch.Generator(device=dev).manual_seed(self.torch_random_seed)

    def _check_vocabulary(self) -> None:
        """Every token id the adapter feeds to the embedding (the pad, the
        image token, ``<fake_token_around_image>`` and the tokenizer's EOS)
        must lie inside the checkpoint's vocabulary."""
        vocab = self.config.text.vocab_size
        ids = {"pad_token_id": self.decoder_config.pad_token_id, "image_token_id": self.config.image_token_id,
               "the tokenizer's eos_token_id": self.tokenizer.eos_token_id}
        for token in (_FAKE, _EOU):
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
        ids = {2, 32002}  # </s> and <end_of_utterance>
        eos = getattr(self.tokenizer, "eos_token_id", None)
        if eos is not None:
            ids.add(int(eos))
        return sorted(ids)

    @property
    def tokenizer_name(self) -> str:
        return f"idefics2_{self.preset}"

    @property
    def chat_template(self) -> str:
        return "idefics2"

    def apply_chat_template(self, messages: list[dict]) -> str:
        parts = []
        for msg in messages:
            role = "User" if msg["role"] == "user" else "Assistant"
            parts.append(f"{role}: {msg['content']}{_EOU}\n")
        parts.append("Assistant:")
        return "".join(parts)

    def _build_prompt(self, context: str, num_images: int) -> str:
        n_latents = self.config.perceiver.n_latents
        image_block = (_FAKE + _IMAGE * n_latents) * num_images + (_FAKE if num_images else "")
        return f"User:{image_block}{context}{_EOU}\nAssistant:"

    # ------------------------------------------------------------ preprocessing

    def _expand_visuals(self, visuals: list) -> list:
        """Optional HF-style image splitting: 4 quadrant crops + the full image."""
        if not self.do_image_splitting:
            return list(visuals)
        out = []
        for image in visuals:
            image = image.convert("RGB")
            w, h = image.size
            mid_w, mid_h = w // 2, h // 2
            out.extend([
                image.crop((0, 0, mid_w, mid_h)),
                image.crop((mid_w, 0, w, mid_h)),
                image.crop((0, mid_h, mid_w, h)),
                image.crop((mid_w, mid_h, w, h)),
                image,
            ])
        return out

    @staticmethod
    def _normalize(image) -> np.ndarray:
        """uint8 RGB -> [3, H, W] normalized (the JAX adapter's float64 arithmetic)."""
        arr = np.asarray(image).astype(np.float32) / 255.0
        arr = (arr - np.asarray(IDEFICS_MEAN)) / np.asarray(IDEFICS_STD)
        return arr.transpose(2, 0, 1)

    def _preprocess(self, visuals: list) -> np.ndarray | None:
        """The fixed-square path: bicubic resize to ``image_size``, normalize."""
        if not visuals:
            return None
        from PIL import Image

        size = self.image_size
        return np.stack([self._normalize(image.convert("RGB").resize((size, size), Image.BICUBIC))
                         for image in visuals])

    @staticmethod
    def _hf_resize_dims(width: int, height: int, shortest: int, longest: int) -> tuple[int, int]:
        """HF Idefics2ImageProcessor.get_resize_output_image_size, exactly
        (image_processing_idefics2.py:49-78): cap the longest edge, int-truncate
        the other, then clamp both to the shortest-edge minimum."""
        aspect_ratio = width / height
        if width >= height and width > longest:
            width = longest
            height = int(width / aspect_ratio)
        elif height > width and height > longest:
            height = longest
            width = int(height * aspect_ratio)
        height = max(height, shortest)
        width = max(width, shortest)
        return width, height

    def _preprocess_hf(self, visuals: list):
        """HF-exact variable-aspect preprocessing for a list of images.

        Returns (pixels [N, 3, Hmax, Wmax] normalized + zero-padded bottom/right,
        position_ids [N, P], patch_mask [N, P]) with Hmax/Wmax bucketed to
        8-patch multiples (extra slots are masked out).
        """
        from PIL import Image

        p = self.config.vision.patch_size
        longest = self.config.vision.image_size
        shortest = max(p, round(longest * 378 / 980))
        num_side = longest // p
        resized, dims = [], []
        for image in visuals:
            img = image.convert("RGB")
            w, h = self._hf_resize_dims(*img.size, shortest, longest)
            resized.append(self._normalize(img.resize((w, h), Image.BILINEAR)))  # HF default resample
            dims.append((h, w))
        step = 8 * p
        max_h = min(-(-max(h for h, _ in dims) // step) * step, longest)
        max_w = min(-(-max(w for _, w in dims) // step) * step, longest)
        max_h = max(max_h, max(h for h, _ in dims))
        max_w = max(max_w, max(w for _, w in dims))
        pixels = np.zeros((len(visuals), 3, max_h, max_w), np.float32)
        for i, ((h, w), arr) in enumerate(zip(dims, resized)):
            pixels[i, :, :h, :w] = arr
        position_ids, patch_mask = idf.variable_patch_layout(dims, (max_h // p, max_w // p), num_side, p)
        return pixels, position_ids, patch_mask

    @torch.inference_mode()
    def _encode_visuals(self, images: list) -> torch.Tensor | None:
        """Every image of a batch through the tower and the perceiver in one
        call: resampled tokens [N * n_latents, H] on the device, or None."""
        if not images:
            return None
        dev, dtype = self.device, self.model.dtype
        with self._phase("vision"):
            if self.hf_preprocess:
                pixels, pos_ids, patch_mask = self._preprocess_hf(images)
                vision = idf.encode_images(
                    self.model, torch.from_numpy(pixels).to(dev, dtype), self.config,
                    torch.from_numpy(pos_ids).to(dev), torch.from_numpy(patch_mask).to(dev),
                )
            else:
                pixels = torch.from_numpy(self._preprocess(images)).to(dev, dtype)
                vision = idf.encode_images(self.model, pixels, self.config)
            return vision.reshape(-1, vision.shape[-1])

    def _visuals(self, args) -> list:
        return self._expand_visuals(self._request_visuals(*args[2:6]))

    # -------------------------------------------------------------- sequences

    def _embed(self, input_ids: np.ndarray, image_counts: list[int], vision_flat) -> torch.Tensor:
        """Token embeddings with each row's resampled image tokens in its <image> slots."""
        n_latents = self.config.perceiver.n_latents
        index_map = np.full(input_ids.shape, -1, np.int64)
        image_cursor = 0
        for row in range(input_ids.shape[0]):
            positions = np.where(input_ids[row] == self.config.image_token_id)[0]
            index_map[row, positions] = image_cursor * n_latents + np.arange(len(positions))
            image_cursor += image_counts[row]
        dev = self.device
        return _assemble_embeds(
            self.model.text.embed_tokens,
            torch.from_numpy(input_ids).to(dev),
            vision_flat,
            torch.from_numpy(index_map).to(dev) if vision_flat is not None else None,
        )

    def _prepare_chunk(self, chunk: list) -> tuple:
        """Host preprocessing, the tower and the perceiver for a chunk of
        request args (overlapped with the previous chunk's decode): the
        embeddings, positions, mask, next positions and prompt bucket."""
        rows, all_images, image_counts = [], [], []
        for args in chunk:
            visuals = self._visuals(args)
            all_images.extend(visuals)
            image_counts.append(len(visuals))
            rows.append(self.tokenizer.encode(self._build_prompt(args[0], len(visuals))))
        vision_flat = self._encode_visuals(all_images)
        input_ids, mask = self._left_pad(rows)
        embeds = self._embed(input_ids, image_counts, vision_flat)
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
        beyond the reference's Idefics2 adapter, with the contract of its
        llava adapter, as in the JAX package."""
        dev = self.device
        results: list[tuple[float, bool]] = []
        for start in range(0, len(requests), self.batch_size):
            rows, all_images, image_counts, cont_lens = [], [], [], []
            for req in requests[start : start + self.batch_size]:
                ctx, continuation, visuals = self._resolve_loglikelihood_request(req)
                visuals = self._expand_visuals(visuals)
                all_images.extend(visuals)
                image_counts.append(len(visuals))
                cont_ids = self._encode_continuation(continuation)
                rows.append(self.tokenizer.encode(self._build_prompt(ctx, len(visuals))) + cont_ids)
                cont_lens.append(len(cont_ids))
            vision_flat = self._encode_visuals(all_images)
            input_ids, mask = self._left_pad(rows)
            bucket = input_ids.shape[1]
            target_ids = np.zeros((len(rows), bucket), np.int64)
            target_mask = np.zeros((len(rows), bucket), np.int64)
            for row, ids in enumerate(rows):
                target_ids[row, bucket - len(ids) : bucket - 1] = ids[1:]
                target_mask[row, bucket - 1 - cont_lens[row] : bucket - 1] = 1
            embeds = self._embed(input_ids, image_counts, vision_flat)
            position_ids, _ = llama_positions(mask)
            with self._phase("score"):
                loss, is_greedy = qvl.score_continuation(
                    self.model.text, embeds, torch.from_numpy(position_ids).to(dev),
                    torch.from_numpy(mask.astype(np.int32)).to(dev),
                    torch.from_numpy(target_ids).to(dev), torch.from_numpy(target_mask).to(dev),
                )
            results.extend(zip(loss.tolist(), is_greedy.tolist()))
        return results


@register_model("idefics2-8b")
def idefics2_8b(**kwargs) -> Idefics2:
    """HuggingFaceM4/idefics2-8b (reference: src/models/_idefics2.py:407)."""
    kwargs.setdefault("preset", "idefics2-8b")
    return Idefics2(**kwargs)


@register_model("idefics2-tiny")
def idefics2_tiny(**kwargs) -> Idefics2:
    """Miniature Idefics2 for CPU tests."""
    kwargs.setdefault("preset", "idefics2-tiny")
    return Idefics2(**kwargs)
