"""LLaVA-OneVision model adapter of the port (llava-onevision-qwen2-{7b,0.5b}-{ov,si}).

Counterpart of :mod:`lmms_owc_tpu.models.llava_onevision` (the reference's
``src/models/_llava_onevision.py``: registered IDs, anyres image handling,
loglikelihood), on the PyTorch/CUDA stack: the SigLIP-SO400M tower of
:mod:`lmms_owc_tpu_torch.nn.idefics2` over anyres tiles (K2 at head_dim 72 on
the card), the 2-layer GELU projector, grid reassembly, unpadding, the
``anyres_max_9`` downscale and newline packing
(:mod:`lmms_owc_tpu_torch.nn.anyres`), and the Qwen2 decoder of the port
(K2 for the prefill, K3 for each decode step). One tower call per image, in
the chunk pipeline's preparation, as the JAX adapter; the packing runs in f32
on the features' device, as the JAX adapter's host numpy. Weights come from a
``pretrained`` HF checkpoint (the port's safetensors reader and BPE
tokenizer), from a JAX parameter tree, or are drawn on the device from a
seed; ``load_in_8bit`` / ``load_in_4bit`` quantize the decoder's, the
tower's and the projector's linear layers. As in the JAX adapter there is no
decode pool here.
"""

from __future__ import annotations

import hashlib
import re
from pathlib import Path

import numpy as np
import torch
from torch import nn

from lmms_owc_tpu_torch.models._api import register_model
from lmms_owc_tpu_torch.models._base import Model
from lmms_owc_tpu_torch.models.qwen2_vl import _assemble_embeds
from lmms_owc_tpu_torch.nn import anyres
from lmms_owc_tpu_torch.nn import idefics2 as idf
from lmms_owc_tpu_torch.nn import qwen2_vl as qvl
from lmms_owc_tpu_torch.nn.layers import Int4Linear, Int8Linear, gelu
from lmms_owc_tpu_torch.nn.llama import llama_config_from_hf, llama_positions
from lmms_owc_tpu_torch.nn.llava import Projector
from lmms_owc_tpu_torch.nn.loader import find_tensor, load_config_json, load_hf_tensors, load_safetensors_state
from lmms_owc_tpu_torch.ops import quant
from lmms_owc_tpu_torch.tokenizer import Tokenizer
from lmms_owc_tpu_torch.utils import Collator, get_logger, pad_to_bucket

log = get_logger(__name__)

__all__ = ["PRESET_CONFIGS", "LlavaOnevision", "OnevisionModel"]

DEFAULT_MAX_NEW_TOKENS = 128
GEN_LEN_BUCKETS = (64, 128, 256, 512)
SIGLIP_MEAN = (0.5, 0.5, 0.5)
SIGLIP_STD = (0.5, 0.5, 0.5)

_IM_START = "<|im_start|>"
_IM_END = "<|im_end|>"
_IMAGE = "<image>"

PRESET_CONFIGS = {
    "llava-onevision-qwen2-7b-ov": dict(
        vision_config=dict(
            hidden_size=1152, num_hidden_layers=26, num_attention_heads=16,
            intermediate_size=4304, image_size=384, patch_size=14,
        ),
        text_config=dict(
            model_type="qwen2", vocab_size=152128, hidden_size=3584, intermediate_size=18944,
            num_hidden_layers=28, num_attention_heads=28, num_key_value_heads=4,
            rope_theta=1000000.0, rms_norm_eps=1e-6, tie_word_embeddings=False,
        ),
        image_token_index=151646,
        vision_aspect_ratio="anyres_max_9",
    ),
    "llava-onevision-qwen2-0.5b-ov": dict(
        vision_config=dict(
            hidden_size=1152, num_hidden_layers=26, num_attention_heads=16,
            intermediate_size=4304, image_size=384, patch_size=14,
        ),
        text_config=dict(
            model_type="qwen2", vocab_size=151936, hidden_size=896, intermediate_size=4864,
            num_hidden_layers=24, num_attention_heads=14, num_key_value_heads=2,
            rope_theta=1000000.0, rms_norm_eps=1e-6, tie_word_embeddings=True,
        ),
        image_token_index=151646,
        vision_aspect_ratio="anyres_max_9",
    ),
    "llava-onevision-tiny": dict(
        vision_config=dict(
            hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, image_size=28, patch_size=14,
        ),
        text_config=dict(
            model_type="qwen2", vocab_size=152128, hidden_size=48, intermediate_size=96,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            rope_theta=1000000.0, rms_norm_eps=1e-6, tie_word_embeddings=True,
        ),
        image_token_index=151646,
        vision_aspect_ratio="anyres_max_9",
    ),
}

# Where HF LLaVA-OneVision checkpoints keep the tower (new transformers, then older exports).
_VISION_PREFIXES = ("model.vision_tower.", "vision_tower.")
_PROJECTOR_PREFIXES = ("model.", "")


class _FallbackOVTokenizer:
    """Hash tokenizer for random-init runs (the JAX adapter's, id for id)."""

    eos_token_id = 151645
    pad_token_id = 151643

    def __init__(self, image_token_id: int) -> None:
        self._special = {_IM_START: 151644, _IM_END: 151645, _IMAGE: image_token_id}

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


class OnevisionModel(nn.Module):
    """The Qwen2 decoder (``text``: a text-only :class:`~lmms_owc_tpu_torch.nn.qwen2_vl.Qwen2VLModel`),
    the SigLIP tower (``vision``), the projector and the newline embedding:
    the JAX adapter's parameter tree as one module tree, so the port's
    quantizers reach the same linear layers."""

    def __init__(self, decoder_config, vision_config: idf.SiglipVisionConfig, attn_bias: bool,
                 dtype=torch.bfloat16, device="cpu") -> None:
        super().__init__()
        h = decoder_config.hidden_size
        self.text = qvl.Qwen2VLModel(decoder_config, dtype, device, text_only=True, attn_bias=attn_bias)
        self.vision = idf.SiglipVisionTower(vision_config, dtype, device)
        self.projector = Projector(vision_config.hidden_size, h, dtype, device)
        self.image_newline = nn.Parameter(torch.empty(h, dtype=dtype, device=device), requires_grad=False)

    @property
    def dtype(self) -> torch.dtype:
        return self.text.dtype

    def hf_tensor(self, state, name: str) -> torch.Tensor:
        """The HF ``LlavaOnevisionForConditionalGeneration`` tensor of parameter ``name``."""
        head, _, rest = name.partition(".")
        if head == "text":
            return self.text.hf_tensor(state, rest)
        if head == "vision":
            return self.vision.hf_tensor(state, rest, _VISION_PREFIXES)
        if head == "projector":
            role, _, kind = rest.partition(".")
            linear = {"fc1": "linear_1", "fc2": "linear_2"}[role]
            return find_tensor(state, f"multi_modal_projector.{linear}.{kind}", _PROJECTOR_PREFIXES)
        if head == "image_newline":
            return find_tensor(state, "image_newline", _PROJECTOR_PREFIXES)
        raise KeyError(name)


class LlavaOnevision(Model):
    """LLaVA-OneVision on the PyTorch/CUDA stack."""

    def __init__(
        self,
        pretrained: str | None = None,
        preset: str = "llava-onevision-qwen2-7b-ov",
        max_anyres_tiles: int = 6,
        random_init: bool = False,
        jax_params: dict | None = None,
        time_phases: bool = False,
        **kwargs,
    ) -> None:
        """Weights come from the ``pretrained`` checkpoint directory, from
        ``jax_params`` (the JAX adapter's ``params`` tree as numpy arrays), or
        are drawn on the device from ``torch_random_seed`` (``random_init``,
        implied when there is no ``pretrained``). ``time_phases`` sums the
        vision, prefill and decode phases' wall seconds into :attr:`phase_seconds`."""
        if preset not in PRESET_CONFIGS:
            raise ValueError(f"unknown preset {preset!r}; available: {sorted(PRESET_CONFIGS)}")
        self.pretrained = pretrained
        self.preset = preset
        self.max_anyres_tiles = max_anyres_tiles
        self.random_init = random_init or pretrained is None
        self._jax_params = jax_params
        self.time_phases = bool(time_phases)
        super().__init__(model_id=preset, **kwargs)

    # ------------------------------------------------------------------- load

    def load_model(self) -> None:
        checkpoint = self.pretrained is not None and Path(self.pretrained).exists()
        if self.pretrained is not None and not checkpoint and not self.random_init:
            raise FileNotFoundError(f"checkpoint not found: {self.pretrained}")
        cfg = load_config_json(self.pretrained) if checkpoint else PRESET_CONFIGS[self.preset]
        vis = cfg.get("vision_config", {})
        self.vision_config = idf.SiglipVisionConfig(
            hidden_size=vis.get("hidden_size", 1152),
            num_layers=vis.get("num_hidden_layers", 26),
            num_heads=vis.get("num_attention_heads", 16),
            intermediate_size=vis.get("intermediate_size", 4304),
            image_size=vis.get("image_size", 384),
            patch_size=vis.get("patch_size", 14),
        )
        self.text_config = llama_config_from_hf(cfg["text_config"])
        self.text_attn_bias = cfg["text_config"].get("model_type", "qwen2") == "qwen2"
        self.image_token_id = cfg.get("image_token_index", 151646)
        aspect = cfg.get("vision_aspect_ratio", "anyres_max_9")
        self.max_patches = int(aspect.replace("anyres_max_", "")) if "anyres_max" in aspect else None
        self.grid_pinpoints = cfg.get(
            "image_grid_pinpoints",
            anyres.default_grid_pinpoints(self.vision_config.image_size, self.max_anyres_tiles),
        )
        self.decoder_config = self.text_config.to_decoder_config()
        bits = 4 if self.load_in_4bit else (8 if self.load_in_8bit else None)
        dtype, dev = self.torch_dtype, self.device

        def build(device):
            return OnevisionModel(self.decoder_config, self.vision_config, self.text_attn_bias, dtype, device)

        if checkpoint:
            self.tokenizer = Tokenizer.from_pretrained(self.pretrained)
            self._check_vocabulary()
            state = load_safetensors_state(self.pretrained)
            if bits is not None:  # the full-precision tree never exists on the device
                self.model = quant.load_quantized_on_device(build("meta"), state, bits=bits, dtype=dtype, device=dev)
            else:
                self.model = load_hf_tensors(build(dev), state)
            del state
            log.info("loaded %s from %s (%s)", self.preset, self.pretrained, f"int{bits}" if bits else self.dtype)
        elif self._jax_params is not None:
            self.model = self._from_jax(self._jax_params, build(dev))
            self._jax_params = None
            quantized = any(isinstance(m, (Int8Linear, Int4Linear)) for m in self.model.modules())
            if bits is not None and not quantized:
                (quant.quantize_params_int8 if bits == 8 else quant.quantize_params_int4)(self.model)
            log.info("loaded %s from a JAX parameter tree", self.preset)
        else:
            gen = torch.Generator(device=dev).manual_seed(self.torch_random_seed)
            if bits is not None:
                self.model = quant.init_quantized_on_device(build("meta"), gen, bits=bits, dtype=dtype)
            else:
                self.model = build(dev)
                qvl.init_params(self.model.text, gen)
                idf.init_siglip_params(self.model.vision, gen)
                idf.init_modules(self.model.projector, gen)
            with torch.no_grad():
                self.model.image_newline.zero_()
            log.warning("random-init %s on %s (no checkpoint)", self.preset, dev)
        if not checkpoint:
            self.tokenizer = _FallbackOVTokenizer(self.image_token_id)
        self.generator = torch.Generator(device=dev).manual_seed(self.torch_random_seed)

    @staticmethod
    @torch.no_grad()
    def _from_jax(tree: dict, model: OnevisionModel) -> OnevisionModel:
        """Fill ``model`` from the JAX adapter's tree (``text``, ``vision``,
        ``projector``, ``image_newline``; numpy leaves, float or int8/int4)."""
        qvl.params_from_jax(model.text, tree["text"])
        idf.siglip_params_from_jax(model.vision, tree["vision"])
        for role in ("fc1", "fc2"):
            qvl._load_linear(model.projector, role, tree["projector"][role])
        qvl._copy(model.image_newline, np.asarray(tree["image_newline"], np.float32))
        return model

    def _check_vocabulary(self) -> None:
        """Every token id the adapter feeds to the embedding must lie inside the
        checkpoint's vocabulary (the JAX package's embedding lookup reads NaN
        rows past it; the port refuses the load instead)."""
        ids = {"pad_token_id": self.decoder_config.pad_token_id, "image_token_index": self.image_token_id,
               "the tokenizer's eos_token_id": self.tokenizer.eos_token_id}
        for name, value in ids.items():
            if value is not None and not 0 <= int(value) < self.text_config.vocab_size:
                raise ValueError(f"{self.pretrained}: {name} {value} lies outside the checkpoint's vocabulary "
                                 f"of {self.text_config.vocab_size} tokens")

    @property
    def pad_token_id(self) -> int:
        return self.decoder_config.pad_token_id

    @property
    def eos_token_ids(self) -> list[int]:
        eos = getattr(self.tokenizer, "eos_token_id", 151645)
        return sorted({int(eos if eos is not None else 151645), 151645})

    @property
    def tokenizer_name(self) -> str:
        return f"llava_onevision_{self.preset}"

    @property
    def chat_template(self) -> str:
        return "qwen_ov"

    def apply_chat_template(self, messages: list[dict]) -> str:
        parts = [f"{_IM_START}{m['role']}\n{m['content']}{_IM_END}\n" for m in messages]
        parts.append(f"{_IM_START}assistant\n")
        return "".join(parts)

    def _build_prompt(self, context: str, num_images: int) -> str:
        images = (_IMAGE + "\n") * num_images
        return f"{_IM_START}user\n{images}{context}{_IM_END}\n{_IM_START}assistant\n"

    # ------------------------------------------------------------------ vision

    @staticmethod
    def _normalize(tile) -> np.ndarray:
        """uint8 RGB -> [3, H, W] SigLIP-normalized (the JAX adapter's float64 arithmetic)."""
        arr = np.asarray(tile).astype(np.float32) / 255.0
        arr = (arr - np.asarray(SIGLIP_MEAN)) / np.asarray(SIGLIP_STD)
        return arr.transpose(2, 0, 1)

    @torch.inference_mode()
    def _encode_one_image(self, image) -> torch.Tensor:
        """Anyres tiles -> SigLIP -> projector -> packed features [tokens, H] (f32, on the device)."""
        from PIL import Image

        image = image.convert("RGB")
        size = self.vision_config.image_size
        orig_w, orig_h = image.size
        best = anyres.select_best_resolution((orig_h, orig_w), self.grid_pinpoints)
        padded = anyres.resize_and_pad(image, best)
        tiles = [image.resize((size, size), Image.BICUBIC)] + anyres.divide_to_patches(padded, size)
        pixels = torch.from_numpy(np.stack([self._normalize(t) for t in tiles])).to(self.device, self.model.dtype)
        with self._phase("vision"):
            feats = idf.siglip_vision_forward(self.model.vision, pixels, self.vision_config, bucket_positions=False)
            proj = self.model.projector.fc2(gelu(self.model.projector.fc1(feats)))
            return anyres.pack_anyres_features(
                proj.float(), (orig_h, orig_w), self.grid_pinpoints, size, self.vision_config.patch_size,
                self.model.image_newline.float(), max_patches=self.max_patches,
            )

    def _prepare(self, ctx, doc_to_visual, doc_id, task_name, split):
        """(expanded ids, packed features of each image) for one request."""
        visuals = self._request_visuals(doc_to_visual, doc_id, task_name, split)
        features = [self._encode_one_image(img) for img in visuals]
        ids = self.tokenizer.encode(self._build_prompt(ctx, len(visuals)))
        expanded: list[int] = []
        img_idx = 0
        for tok in ids:
            if tok == self.image_token_id:
                expanded.extend([tok] * features[img_idx].shape[0])
                img_idx += 1
            else:
                expanded.append(tok)
        return expanded, features

    # -------------------------------------------------------------- sequences

    @torch.inference_mode()
    def _embed_sequence(self, input_ids: np.ndarray, features: list[list[torch.Tensor]]) -> torch.Tensor:
        """Token embeddings with each row's packed image features gathered into its <image> slots."""
        bsz, bucket = input_ids.shape
        index_map = np.full((bsz, bucket), -1, np.int64)
        flat: list[torch.Tensor] = []
        cursor = 0
        for row, feats in enumerate(features):
            positions = np.where(input_ids[row] == self.image_token_id)[0]
            if len(positions):
                index_map[row, positions] = cursor + np.arange(len(positions))
                cursor += len(positions)
                flat.extend(feats)
        dev = self.device
        vision_flat = torch.cat(flat).to(self.model.dtype) if flat else None
        return _assemble_embeds(
            self.model.text,
            torch.from_numpy(input_ids).to(dev),
            vision_flat,
            torch.from_numpy(index_map).to(dev) if vision_flat is not None else None,
        )

    # -------------------------------------------------------------- generation

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
            return [self._prepare(args[0], args[2], args[3], args[4], args[5]) for args in chunk]

        @torch.inference_mode()
        def _run_chunk(chunk, prepared):
            gen_kwargs = dict(chunk[0][1] or {})
            until = gen_kwargs.get("until") or []
            if isinstance(until, str):
                until = [until]
            max_new = int(gen_kwargs.get("max_new_tokens", DEFAULT_MAX_NEW_TOKENS))
            input_ids, mask = self._left_pad([ids for ids, _ in prepared])
            embeds = self._embed_sequence(input_ids, [feats for _, feats in prepared])
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
        """Mean continuation cross-entropy and whether greedy decoding
        reproduces the continuation (the reference's contract); requests run in
        order in batches of ``batch_size``."""
        dev = self.device
        results: list[tuple[float, bool]] = []
        for start in range(0, len(requests), self.batch_size):
            rows = []
            for req in requests[start : start + self.batch_size]:
                ctx, continuation, _ = self._resolve_loglikelihood_request(req)
                task_built = len(req.args) >= 6
                expanded_ctx, features = self._prepare(
                    ctx, req.args[2] if task_built else None, req.args[3] if task_built else 0,
                    req.args[4] if task_built else "", req.args[5] if task_built else "",
                )
                cont_ids = self._encode_continuation(continuation)
                rows.append((expanded_ctx + cont_ids, len(cont_ids), features))
            input_ids, mask = self._left_pad([ids for ids, _, _ in rows])
            bucket = input_ids.shape[1]
            target_ids = np.zeros((len(rows), bucket), np.int64)
            target_mask = np.zeros((len(rows), bucket), np.int64)
            for row, (ids, n_cont, _) in enumerate(rows):
                target_ids[row, bucket - len(ids) : bucket - 1] = ids[1:]
                target_mask[row, bucket - 1 - n_cont : bucket - 1] = 1
            embeds = self._embed_sequence(input_ids, [feats for _, _, feats in rows])
            position_ids, _ = llama_positions(mask)
            with self._phase("score"):
                loss, is_greedy = qvl.score_continuation(
                    self.model.text, embeds, torch.from_numpy(position_ids).to(dev),
                    torch.from_numpy(mask.astype(np.int32)).to(dev),
                    torch.from_numpy(target_ids).to(dev), torch.from_numpy(target_mask).to(dev),
                )
            results.extend(zip(loss.tolist(), is_greedy.tolist()))
        return results


@register_model("llava-onevision-qwen2-7b-ov", "llava-onevision-qwen2-7b-si")
def llava_onevision_7b(**kwargs) -> LlavaOnevision:
    """lmms-lab/llava-onevision-qwen2-7b-{ov,si} (reference: src/models/_llava_onevision.py:805-838)."""
    kwargs.setdefault("preset", "llava-onevision-qwen2-7b-ov")
    return LlavaOnevision(**kwargs)


@register_model("llava-onevision-qwen2-0.5b-ov", "llava-onevision-qwen2-0.5b-si")
def llava_onevision_05b(**kwargs) -> LlavaOnevision:
    """lmms-lab/llava-onevision-qwen2-0.5b-{ov,si}."""
    kwargs.setdefault("preset", "llava-onevision-qwen2-0.5b-ov")
    return LlavaOnevision(**kwargs)


@register_model("llava-onevision-tiny")
def llava_onevision_tiny(**kwargs) -> LlavaOnevision:
    """Miniature LLaVA-OneVision for CPU tests."""
    kwargs.setdefault("preset", "llava-onevision-tiny")
    return LlavaOnevision(**kwargs)
