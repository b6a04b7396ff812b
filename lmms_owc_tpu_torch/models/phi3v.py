"""Phi-3-Vision model adapter of the port (phi3v).

Counterpart of :mod:`lmms_owc_tpu.models.phi3v` (the reference's
``src/models/_phi3v.py``, registered at :470, with its ``<|image_1|>``
placeholder chat format) on the PyTorch/CUDA stack: the CLIP ViT-L/14-336
tower of :mod:`lmms_owc_tpu_torch.nn.clip` (features of its second-to-last
layer, K2 at head_dim 64 on the card), the 2x2 feature concat with the
``sub_GN`` / ``glb_GN`` row separators, the GELU projector, and the
Phi-3-mini decoder: the port's shared decoder over a Llama view of the config
with its longrope scaling (:meth:`~lmms_owc_tpu_torch.nn.llama.LlamaConfig.to_decoder_config`),
whose prefill runs K2 and each decode step K3 at head_dim 96.

Images take the published HD transform (transpose if portrait, scale to the
largest ``num_crops``-bounded multiple of 336, white-pad the height to a
multiple, tile into 336 px crops plus a global view bicubic-resized from the
normalised tensor), on the host with numpy and PIL, each image in one tower
call, as the JAX adapter. ``num_crops=0`` keeps the global view alone.
Weights come from a ``pretrained`` checkpoint in the released layout (fused
``qkv_proj`` / ``gate_up_proj`` split at load, the tower under
``model.vision_embed_tokens.img_processor.``, read by the port's safetensors
reader, with the port's ``byte_fallback`` BPE tokenizer), from a JAX
parameter tree, or are drawn on the device from a seed; ``load_in_8bit`` /
``load_in_4bit`` quantize the linear layers that the JAX base class's generic
path quantizes (``DEFAULT_EXCLUDE``; int4 skips an odd contraction axis), one
layer at a time on the device as the other families do. As in the JAX adapter
there is no decode pool and no mesh path.
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
from lmms_owc_tpu_torch.nn import clip as nnclip
from lmms_owc_tpu_torch.nn import qwen2_vl as qvl
from lmms_owc_tpu_torch.nn.clip import ClipVisionConfig, ClipVisionTower, vision_params_from_jax
from lmms_owc_tpu_torch.nn.layers import Int4Linear, Int8Linear, LayerNorm, Linear, RMSNorm, gelu
from lmms_owc_tpu_torch.nn.llama import LlamaConfig, llama_config_from_hf, llama_positions
from lmms_owc_tpu_torch.nn.llava import Projector
from lmms_owc_tpu_torch.nn.loader import load_config_json, load_hf_tensors, load_safetensors_state
from lmms_owc_tpu_torch.nn.qwen2_vl import Qwen2VLModel, _copy, _load_linear, params_from_jax
from lmms_owc_tpu_torch.ops import quant
from lmms_owc_tpu_torch.ops.image import OPENAI_CLIP_MEAN, OPENAI_CLIP_STD
from lmms_owc_tpu_torch.tokenizer import Tokenizer
from lmms_owc_tpu_torch.utils import Collator, get_logger, pad_to_bucket
from lmms_owc_tpu_torch.utils._hostprof import hostprof

log = get_logger(__name__)

__all__ = [
    "IMAGE_TOKEN_ID",
    "PRESET_CONFIGS",
    "Phi3v",
    "Phi3vModel",
    "init_phi3v_params",
    "phi3v_params_from_jax",
    "split_phi3_fused_weights",
]

DEFAULT_MAX_NEW_TOKENS = 128
GEN_LEN_BUCKETS = (64, 128, 256, 512)
IMAGE_TOKEN_ID = 32044  # <|image_1|> placeholder id space starts at 32044 in phi3v

PRESET_CONFIGS = {
    "phi3v": dict(
        text_config=dict(
            model_type="phi3", vocab_size=32064, hidden_size=3072, intermediate_size=8192,
            num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=32,
            rope_theta=10000.0, rms_norm_eps=1e-5, tie_word_embeddings=False,
            max_position_embeddings=131072, original_max_position_embeddings=4096,
        ),
        vision_config=dict(
            hidden_size=1024, num_hidden_layers=24, num_attention_heads=16,
            intermediate_size=4096, image_size=336, patch_size=14,
        ),
    ),
    "phi3v-tiny": dict(
        text_config=dict(
            model_type="phi3", vocab_size=32064, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
            rope_theta=10000.0, rms_norm_eps=1e-5, tie_word_embeddings=True,
        ),
        vision_config=dict(
            hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, image_size=28, patch_size=14,
        ),
    ),
}

# Released Phi-3-vision checkpoints keep the CLIP tower's config in remote
# code, not config.json: CLIP ViT-L/14-336.
DEFAULT_VISION_CONFIG = PRESET_CONFIGS["phi3v"]["vision_config"]
# Where the released checkpoints keep the tower, the projector and the separators.
VISION_PREFIX = "model.vision_embed_tokens."
CLIP_PREFIX = VISION_PREFIX + "img_processor."
_PROJECTOR_LAYERS = {"fc1": "img_projection.0", "fc2": "img_projection.2"}
_SEPARATORS = {"sub_gn": "sub_GN", "glb_gn": "glb_GN"}
# The chat specials the adapter's prompts carry.
_SPECIAL_TOKENS = ("<|user|>", "<|assistant|>", "<|end|>")


def split_phi3_fused_weights(state) -> dict:
    """Split Phi-3's fused qkv_proj / gate_up_proj tensors into q/k/v and
    gate/up (torch tensors are sliced as views, anything else as numpy)."""
    out = dict(state)
    for name in list(state):
        if name.endswith("self_attn.qkv_proj.weight"):
            w = state[name] if isinstance(state[name], torch.Tensor) else np.asarray(state[name])
            n = w.shape[0] // 3
            base = name.replace("qkv_proj", "{}")
            out[base.format("q_proj")] = w[:n]
            out[base.format("k_proj")] = w[n : 2 * n]
            out[base.format("v_proj")] = w[2 * n :]
            del out[name]
        elif name.endswith("mlp.gate_up_proj.weight"):
            w = state[name] if isinstance(state[name], torch.Tensor) else np.asarray(state[name])
            n = w.shape[0] // 2
            base = name.replace("gate_up_proj", "{}")
            out[base.format("gate_proj")] = w[:n]
            out[base.format("up_proj")] = w[n:]
            del out[name]
    return out


def clip_config(vis: dict) -> ClipVisionConfig:
    return ClipVisionConfig(
        hidden_size=vis["hidden_size"],
        num_layers=vis["num_hidden_layers"],
        num_heads=vis["num_attention_heads"],
        intermediate_size=vis["intermediate_size"],
        image_size=vis["image_size"],
        patch_size=vis["patch_size"],
    )


class _FallbackPhi3Tokenizer:
    """Hash tokenizer for random-init runs (the JAX adapter's, id for id)."""

    eos_token_id = 32000  # <|end|>
    pad_token_id = 32000

    @staticmethod
    def _word(word: str) -> int:
        return 100 + int.from_bytes(hashlib.md5(word.encode()).digest()[:3], "little") % 31000

    def encode(self, text: str, add_special_tokens: bool = True) -> list[int]:
        ids = [1] if add_special_tokens else []
        pos = 0
        for match in re.finditer(r"<\|image_\d+\|>|<\|user\|>|<\|assistant\|>|<\|end\|>", text):
            ids.extend(self._word(w) for w in text[pos : match.start()].split())
            tok = match.group()
            if tok.startswith("<|image_"):
                ids.append(IMAGE_TOKEN_ID)
            elif tok == "<|user|>":
                ids.append(32010)
            elif tok == "<|assistant|>":
                ids.append(32001)
            else:
                ids.append(32000)
            pos = match.end()
        ids.extend(self._word(w) for w in text[pos:].split())
        return ids

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        return " ".join(f"tok{int(i)}" for i in ids if int(i) < 32000)


class Phi3vModel(nn.Module):
    """The decoder (``text``: a text-only :class:`Qwen2VLModel` without
    attention biases over the Llama view of the Phi-3 config), the CLIP tower
    without its projection (``vision``), the projector (``fc1`` from the 2x2
    concat's 4E columns, ``fc2``) and the ``sub_gn`` / ``glb_gn`` separator
    rows [4E]. Parameters are uninitialised until :func:`init_phi3v_params`,
    a checkpoint load or :func:`phi3v_params_from_jax` fills them."""

    def __init__(self, text: LlamaConfig, vision: ClipVisionConfig, dtype=torch.bfloat16, device="cpu"):
        super().__init__()
        merge_dim = 4 * vision.hidden_size
        self.text = Qwen2VLModel(text.to_decoder_config(), dtype, device, text_only=True, attn_bias=False)
        self.vision = ClipVisionTower(vision, dtype, device, with_projection=False)
        self.projector = Projector(merge_dim, text.hidden_size, dtype, device)
        self.sub_gn = nn.Parameter(torch.empty(merge_dim, dtype=dtype, device=device), requires_grad=False)
        self.glb_gn = nn.Parameter(torch.empty(merge_dim, dtype=dtype, device=device), requires_grad=False)

    @property
    def dtype(self) -> torch.dtype:
        return self.text.dtype

    def hf_tensor(self, state, name: str) -> torch.Tensor:
        """The released checkpoint's tensor of parameter ``name``, with the
        decoder's fused projections already split
        (:func:`split_phi3_fused_weights`): the decoder under ``model.``, the
        CLIP tower's names under :data:`CLIP_PREFIX` (the lookups of
        ``convert_hf_clip_weights`` with that prefix), the projector's
        ``img_projection.0`` / ``.2`` and the separators flattened."""
        head, _, rest = name.partition(".")
        if head == "text":
            return self.text.hf_tensor(state, rest)
        if head == "vision":
            return self.vision.hf_tensor(state, rest, CLIP_PREFIX)
        if head == "projector":
            role, _, kind = rest.partition(".")
            return state[f"{VISION_PREFIX}{_PROJECTOR_LAYERS[role]}.{kind}"]
        return state[VISION_PREFIX + _SEPARATORS[head]].reshape(-1)


@torch.no_grad()
def init_phi3v_params(text: LlamaConfig, vision: ClipVisionConfig, generator: torch.Generator,
                      dtype=torch.bfloat16) -> Phi3vModel:
    """A random-init model on the generator's device: linear weights, token,
    class and position embeddings ~ N(0, 1) * 0.02, biases zero, norm scales
    one, the separators zero (the JAX adapter's distribution; the values
    differ)."""
    model = Phi3vModel(text, vision, dtype, generator.device)

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
    model.sub_gn.zero_()
    model.glb_gn.zero_()
    return model


@torch.no_grad()
def phi3v_params_from_jax(tree: dict, text: LlamaConfig, vision: ClipVisionConfig, dtype=torch.float32,
                          device="cpu") -> Phi3vModel:
    """A model filled from the JAX adapter's ``params`` tree (``text`` a
    decoder tree, ``vision`` a CLIP tower tree, ``projector``, ``sub_gn``,
    ``glb_gn``; leaves as numpy arrays)."""
    model = Phi3vModel(text, vision, dtype, device)
    params_from_jax(model.text, tree["text"])
    vision_params_from_jax(model.vision, tree["vision"])
    for role in ("fc1", "fc2"):
        _load_linear(model.projector, role, tree["projector"][role])
    _copy(model.sub_gn, np.asarray(tree["sub_gn"], np.float32))
    _copy(model.glb_gn, np.asarray(tree["glb_gn"], np.float32))
    return model


class Phi3v(Model):
    """Phi-3-Vision on the PyTorch/CUDA stack."""

    def __init__(
        self,
        pretrained: str | None = None,
        preset: str = "phi3v",
        num_crops: int = 16,
        random_init: bool = False,
        jax_params: dict | None = None,
        time_phases: bool = False,
        **kwargs,
    ) -> None:
        """Weights come from the ``pretrained`` checkpoint directory (its
        ``config.json`` gives the decoder, and its ``vision_config``, or
        CLIP-L/336 when it has none, the tower), from ``jax_params`` (the JAX
        adapter's ``params`` tree as numpy arrays), or are drawn on the device
        from ``torch_random_seed`` (``random_init``, implied when there is no
        ``pretrained``; an unknown preset draws ``phi3v``'s widths, as in the
        JAX adapter). ``time_phases`` sums the vision, prefill and decode
        phases' wall seconds into :attr:`phase_seconds`."""
        self.pretrained = pretrained
        self.preset = preset
        self.num_crops = int(num_crops)
        self.random_init = random_init or pretrained is None
        self._jax_params = jax_params
        self.time_phases = bool(time_phases)
        super().__init__(model_id=preset, **kwargs)

    # ------------------------------------------------------------------- load

    def load_model(self) -> None:
        checkpoint = self.pretrained is not None and Path(self.pretrained).exists()
        if checkpoint:
            cfg = load_config_json(self.pretrained)
            text_cfg = cfg if "hidden_size" in cfg else cfg.get("text_config", cfg)
            vis = cfg.get("vision_config") or DEFAULT_VISION_CONFIG
        else:
            if not self.random_init:
                raise FileNotFoundError(f"checkpoint not found: {self.pretrained}")
            preset = PRESET_CONFIGS.get(self.preset, PRESET_CONFIGS["phi3v"])
            text_cfg, vis = preset["text_config"], preset["vision_config"]
        self.text_config = llama_config_from_hf(text_cfg)
        self.vision_config = clip_config(vis)
        self.decoder_config = self.text_config.to_decoder_config()
        dtype, dev = self.torch_dtype, self.device
        bits = 4 if self.load_in_4bit else (8 if self.load_in_8bit else None)
        if checkpoint:
            self.tokenizer = Tokenizer.from_pretrained(self.pretrained)
            self._check_vocabulary()
            state = split_phi3_fused_weights(load_safetensors_state(self.pretrained))
            if bits is not None:  # the full-precision tree never exists on the device
                meta = Phi3vModel(self.text_config, self.vision_config, dtype, "meta")
                self.model = quant.load_quantized_on_device(meta, state, bits=bits, dtype=dtype, device=dev)
            else:
                self.model = load_hf_tensors(Phi3vModel(self.text_config, self.vision_config, dtype, dev), state)
            del state
            log.info("loaded %s from %s (%s)", self.preset, self.pretrained, f"int{bits}" if bits else self.dtype)
        else:
            if self._jax_params is not None:
                self.model = phi3v_params_from_jax(self._jax_params, self.text_config, self.vision_config,
                                                   dtype, dev)
                self._jax_params = None
                quantized = any(isinstance(m, (Int8Linear, Int4Linear)) for m in self.model.modules())
                if bits is not None and not quantized:  # a float tree, served quantized
                    (quant.quantize_params_int8 if bits == 8 else quant.quantize_params_int4)(self.model)
                log.info("loaded %s from a JAX parameter tree", self.preset)
            elif bits is not None:
                gen = torch.Generator(device=dev).manual_seed(self.torch_random_seed)
                self.model = quant.init_quantized_on_device(
                    Phi3vModel(self.text_config, self.vision_config, dtype, "meta"), gen, bits=bits, dtype=dtype)
                self.model.sub_gn.zero_()
                self.model.glb_gn.zero_()
                log.warning("random-init int%d %s on %s (no checkpoint)", bits, self.preset, dev)
            else:
                gen = torch.Generator(device=dev).manual_seed(self.torch_random_seed)
                self.model = init_phi3v_params(self.text_config, self.vision_config, gen, dtype)
                log.warning("random-init %s on %s (no checkpoint)", self.preset, dev)
            self.tokenizer = _FallbackPhi3Tokenizer()
        self.generator = torch.Generator(device=dev).manual_seed(self.torch_random_seed)

    def _check_vocabulary(self) -> None:
        """Every token id the adapter feeds to the embedding or stops on (the
        pad, the image placeholder, the EOS ids and the chat specials as the
        tokenizer encodes them) must lie inside the checkpoint's vocabulary
        (the JAX package's embedding lookup reads NaN rows past it; the port
        refuses the load instead)."""
        vocab = self.text_config.vocab_size
        ids = {"pad_token_id": self.decoder_config.pad_token_id, "<|image_1|>": IMAGE_TOKEN_ID,
               **{f"eos id {i}": i for i in self.eos_token_ids}}
        for token in _SPECIAL_TOKENS:
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
        ids = {32000, 32007}  # <|end|>, <|endoftext|>-adjacent specials
        eos = getattr(self.tokenizer, "eos_token_id", None)
        if eos is not None:
            ids.add(int(eos))
        return sorted(ids)

    @property
    def tokenizer_name(self) -> str:
        return f"phi3v_{self.preset}"

    @property
    def chat_template(self) -> str:
        return "phi3"

    def apply_chat_template(self, messages: list[dict]) -> str:
        parts = [f"<|{m['role']}|>\n{m['content']}<|end|>\n" for m in messages]
        parts.append("<|assistant|>\n")
        return "".join(parts)

    def _build_prompt(self, context: str, num_images: int) -> str:
        images = "".join(f"<|image_{i + 1}|>\n" for i in range(num_images))
        return f"<|user|>\n{images}{context}<|end|>\n<|assistant|>\n"

    # ------------------------------------------------------------ preprocessing

    @staticmethod
    def _to_chw_normalized(img) -> np.ndarray:
        arr = np.asarray(img).astype(np.float32) / 255.0
        arr = (arr - np.asarray(OPENAI_CLIP_MEAN)) / np.asarray(OPENAI_CLIP_STD)
        return arr.transpose(2, 0, 1)

    @staticmethod
    def _bicubic_resize_tensor(arr: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
        """torch ``F.interpolate(mode="bicubic", align_corners=False)`` on [C, H, W].

        The published Phi-3-vision processor builds the global view by bicubic-
        interpolating the NORMALIZED TENSOR of the padded HD image (torch
        semantics: cubic convolution a=-0.75, half-pixel centers, border
        replication, no antialias), not by PIL-resizing the image; in numpy,
        as the JAX adapter computes it.
        """
        a = -0.75

        def axis_weights(in_size: int, out_size: int):
            scale = in_size / out_size
            x = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
            x0 = np.floor(x).astype(np.int64)
            offsets = np.arange(-1, 3)
            idx = x0[None, :] + offsets[:, None]  # [4, out]
            d = np.abs(idx - x[None, :])
            w = np.where(
                d <= 1,
                ((a + 2) * d - (a + 3)) * d * d + 1,
                np.where(d < 2, (((d - 5) * d + 8) * d - 4) * a, 0.0),
            )
            return np.clip(idx, 0, in_size - 1), w.astype(np.float32)

        c, h, w = arr.shape
        idx_h, w_h = axis_weights(h, out_h)
        idx_w, w_w = axis_weights(w, out_w)
        # rows: [C, H, W] -> [C, out_h, W]; then cols -> [C, out_h, out_w].
        rows = np.einsum("kchw,kh->chw", arr[:, idx_h, :].transpose(1, 0, 2, 3), w_h)
        out = np.einsum("kchw,kw->chw", rows[:, :, idx_w].transpose(2, 0, 1, 3), w_w)
        return out.astype(np.float32)

    def _hd_transform(self, image, hd_num: int):
        """Published Phi-3-vision HD transform (processing_phi3_v.py algorithm):
        transpose portrait images, scale width to the largest hd_num-bounded
        multiple of the crop size, white-pad height (centered) to a multiple,
        transpose back."""
        from PIL import Image

        size = self.vision_config.image_size
        img = image.convert("RGB")
        w, h = img.size
        trans = False
        if w < h:
            img = img.transpose(Image.TRANSPOSE)
            trans = True
            w, h = img.size
        ratio = w / h
        scale = 1
        while scale * np.ceil(scale / ratio) <= hd_num:
            scale += 1
        scale -= 1
        new_w = max(int(scale * size), size)
        new_h = max(int(new_w / ratio), 1)
        img = img.resize((new_w, new_h), Image.BICUBIC)
        target_h = int(np.ceil(new_h / size) * size)
        top = (target_h - new_h) // 2
        canvas = Image.new("RGB", (new_w, target_h), (255, 255, 255))
        canvas.paste(img, (0, top))
        if trans:
            canvas = canvas.transpose(Image.TRANSPOSE)
        return canvas

    def _pixels(self, image) -> tuple[np.ndarray, int, int]:
        """The tower's input for one image, [1 + crops, 3, S, S] (the global
        view first), and the crop grid's rows and columns (0, 0 with
        ``num_crops=0``: the global view alone, a PIL resize)."""
        from PIL import Image

        size = self.vision_config.image_size
        if self.num_crops <= 0:
            return self._to_chw_normalized(image.convert("RGB").resize((size, size), Image.BICUBIC))[None], 0, 0
        hd = self._hd_transform(image, self.num_crops)
        w_px, h_px = hd.size
        w_crop, h_crop = w_px // size, h_px // size
        hd_arr = self._to_chw_normalized(hd)
        crops = (
            hd_arr.reshape(3, h_crop, size, w_crop, size)
            .transpose(1, 3, 0, 2, 4)
            .reshape(h_crop * w_crop, 3, size, size)
        )
        # Global view: torch-convention bicubic of the normalized tensor
        # (published processing_phi3_v.py order), NOT a PIL resize of the image.
        glb = self._bicubic_resize_tensor(hd_arr, size, size)
        return np.concatenate([glb[None], crops]), h_crop, w_crop

    def _units_2x2(self, feats: torch.Tensor) -> torch.Tensor:
        """[N, side^2, D] CLIP features -> [N, side/2, side/2, 4D] merged units."""
        side = self.vision_config.image_size // self.vision_config.patch_size
        half = side // 2
        d = feats.shape[-1]
        f = feats.reshape(-1, half, 2, half, 2, d).permute(0, 1, 3, 2, 4, 5)
        return f.reshape(-1, half, half, 4 * d)

    @torch.inference_mode()
    def _encode_one_image(self, image) -> torch.Tensor:
        """HD crops + global view -> CLIP(-2) -> 2x2 concat -> separator layout
        -> projector: the image's embedding rows [tokens, H] on the device.

        Sequence layout (reference remote-code semantics): sub-image unit rows
        with a sub_GN at each row end, then glb_GN, then global unit rows with
        sub_GN per row: (h_crop*w_crop)*half^2 + h_crop*half + 1 +
        half*(half+1) rows. ``num_crops=0``: [global rows + sub_GN, glb_GN].
        """
        half = (self.vision_config.image_size // self.vision_config.patch_size) // 2
        with hostprof("prep_resize"):
            pixels, h_crop, w_crop = self._pixels(image)
        with self._phase("vision"), hostprof("prep_tower"):
            x = torch.from_numpy(pixels).to(self.device, self.model.dtype)
            feats = nnclip.clip_vision_forward(self.model.vision, x, self.vision_config, feature_layer=-2)[:, 1:, :]  # drop CLS
            units = self._units_2x2(feats)
            d4 = units.shape[-1]

            def with_row_separators(grid):  # [R, C, 4D] -> [(R*(C+1)), 4D]
                rows = torch.cat([grid, self.model.sub_gn.expand(grid.shape[0], 1, d4)], dim=1)
                return rows.reshape(-1, d4)

            glb_flat = with_row_separators(units[0])
            if self.num_crops <= 0:
                flat = torch.cat([glb_flat, self.model.glb_gn[None]])
            else:
                sub_grid = (
                    units[1:]
                    .reshape(h_crop, w_crop, half, half, d4)
                    .permute(0, 2, 1, 3, 4)
                    .reshape(h_crop * half, w_crop * half, d4)
                )
                flat = torch.cat([with_row_separators(sub_grid), self.model.glb_gn[None], glb_flat])
            proj = self.model.projector
            return proj.fc2(gelu(proj.fc1(flat)))

    def _prepare_rows(self, items) -> tuple[list, list]:
        """``items`` of (prompt context, visuals, continuation ids): (token
        rows with each ``<|image_1|>`` expanded to its image's rows, each
        row's image features)."""
        rows = []
        for ctx, visuals, cont_ids in items:
            features = [self._encode_one_image(img) for img in visuals]
            ids = self.tokenizer.encode(self._build_prompt(ctx, len(visuals)))
            expanded: list[int] = []
            img_idx = 0
            for tok in ids:
                if tok == IMAGE_TOKEN_ID and img_idx < len(features):
                    expanded.extend([tok] * features[img_idx].shape[0])
                    img_idx += 1
                else:
                    expanded.append(tok)
            rows.append((expanded + cont_ids, features))
        return rows

    @torch.inference_mode()
    def _embed(self, rows: list) -> tuple[torch.Tensor, np.ndarray, np.ndarray]:
        """(embeddings [B, bucket, H] on the device with the image rows in the
        placeholder slots, input ids, mask) of left-padded token rows; a row's
        features fill its placeholder slots in order, as the JAX adapter
        indexes them."""
        input_ids, mask = self._left_pad([ids for ids, _ in rows])
        bucket = input_ids.shape[1]
        index_map = np.full(input_ids.shape, -1, np.int64)
        all_features: list[torch.Tensor] = []
        cursor = 0
        for row, (ids, features) in enumerate(rows):
            positions = np.where(np.asarray(ids) == IMAGE_TOKEN_ID)[0]
            if len(positions):
                index_map[row, bucket - len(ids) + positions] = cursor + np.arange(len(positions))
                cursor += len(positions)
                all_features.extend(features)
        dev = self.device
        vision_flat = torch.cat(all_features) if all_features else None
        embeds = _assemble_embeds(
            self.model.text,
            torch.from_numpy(input_ids).to(dev),
            vision_flat,
            torch.from_numpy(index_map).to(dev) if vision_flat is not None else None,
        )
        return embeds, input_ids, mask

    def _prepare_chunk(self, chunk: list) -> tuple:
        """Host preprocessing and the tower for a chunk of request args
        (overlapped with the previous chunk's decode): the embeddings,
        positions, mask, next positions and prompt bucket."""
        rows = self._prepare_rows([(args[0], self._request_visuals(*args[2:6]), []) for args in chunk])
        with hostprof("build_inputs"):
            embeds, input_ids, mask = self._embed(rows)
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
            with hostprof("fetch"):
                tokens_np = tokens.cpu().numpy()
            with hostprof("detok"):
                texts = self._detokenize(tokens_np)
            out = []
            for text in texts:
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
        beyond the reference's Phi3v adapter, with the contract of its llava
        adapter, as in the JAX package. Requests run in order in batches of
        ``batch_size``."""
        dev = self.device
        results: list[tuple[float, bool]] = []
        for start in range(0, len(requests), self.batch_size):
            items, cont_lens = [], []
            for req in requests[start : start + self.batch_size]:
                ctx, continuation, visuals = self._resolve_loglikelihood_request(req)
                cont_ids = self._encode_continuation(continuation)
                items.append((ctx, visuals, cont_ids))
                cont_lens.append(len(cont_ids))
            rows = self._prepare_rows(items)
            embeds, input_ids, mask = self._embed(rows)
            bucket = input_ids.shape[1]
            target_ids = np.zeros((len(rows), bucket), np.int64)
            target_mask = np.zeros((len(rows), bucket), np.int64)
            for row, (ids, _) in enumerate(rows):
                target_ids[row, bucket - len(ids) : bucket - 1] = ids[1:]
                target_mask[row, bucket - 1 - cont_lens[row] : bucket - 1] = 1
            position_ids, _ = llama_positions(mask)
            with self._phase("score"):
                loss, is_greedy = qvl.score_continuation(
                    self.model.text, embeds, torch.from_numpy(position_ids).to(dev),
                    torch.from_numpy(mask.astype(np.int32)).to(dev),
                    torch.from_numpy(target_ids).to(dev), torch.from_numpy(target_mask).to(dev),
                )
            results.extend(zip(loss.tolist(), is_greedy.tolist()))
        return results


@register_model("phi3v")
def phi3v(**kwargs) -> Phi3v:
    """microsoft/Phi-3-vision-128k-instruct (reference: src/models/_phi3v.py:470)."""
    kwargs.setdefault("preset", "phi3v")
    return Phi3v(**kwargs)


@register_model("phi3v-tiny")
def phi3v_tiny(**kwargs) -> Phi3v:
    """Miniature Phi3v for CPU tests."""
    kwargs.setdefault("preset", "phi3v-tiny")
    return Phi3v(**kwargs)
