"""Llama-3.2 judge model on the port's decoder.

Counterpart of :mod:`lmms_owc_tpu.nn.judge`: greedy decoding, 16 new tokens,
the chat template applied per prompt. Prompts are batched and LEFT-padded to
length buckets; each chunk prefills through the flash kernel (K2) and decodes
through the decode kernel (K3, or its int8-cache form under
``LMMS_OWC_KV_INT8``) on the card. ``LMMS_OWC_JUDGE_DECODE_POOL`` = N > 1
prefills each chunk at its own shape and decodes N chunks' rows as one batch.
On the card every decode step's products run on blocks of ``DECODE_ROWS``
rows, so a row's answer does not depend on the rows decoded beside it (pooled
answers equal unpooled ones, as in the JAX package). With ``data_parallel``
and a process group of more than one rank, the judge is the JAX package's
row-sharded data mesh in torch's form: every rank holds the whole model and
calls the judge on the same prompts, each padded chunk's rows (padded to a
multiple of the rank count with the last row, as in JAX) are split over the
ranks, and an all-reduce gathers the answers; the decode pool is then off,
as in JAX.
"""

from __future__ import annotations

import hashlib
import os
from pathlib import Path

import numpy as np
import torch

from lmms_owc_tpu_torch._device import get_device
from lmms_owc_tpu_torch.nn import qwen2_vl as qvl
from lmms_owc_tpu_torch.nn.layers import embedding
from lmms_owc_tpu_torch.nn.llama import (
    build_llama,
    init_llama_params,
    llama_config_from_hf,
    llama_positions,
)
from lmms_owc_tpu_torch.nn.loader import load_config_json, load_hf_tensors, load_safetensors_state
from lmms_owc_tpu_torch.ops import quant
from lmms_owc_tpu_torch.tokenizer import Tokenizer
from lmms_owc_tpu_torch.utils import foreach_chunk_pipelined, get_logger, pad_to_bucket

log = get_logger(__name__)

__all__ = ["LLAMA32_3B_CONFIG", "MAX_NEW_TOKENS", "JudgeModel", "resolve_judge_weights"]

JUDGE_MODEL_ID = "meta-llama/Llama-3.2-3B-Instruct"
MAX_NEW_TOKENS = 16
# On the card each decode step's products run on blocks of this many rows
# (the default batch of 64 times a pool of 2), so that pooled decoding gives
# the unpooled tokens: cuBLAS picks its split of K by the row count.
DECODE_ROWS = 128

# Architecture of the released judge checkpoint (config.json of Llama-3.2-3B).
LLAMA32_3B_CONFIG = dict(
    vocab_size=128256, hidden_size=3072, num_hidden_layers=28, num_attention_heads=24,
    num_key_value_heads=8, intermediate_size=8192, rope_theta=500000.0,
    rms_norm_eps=1e-5, max_position_embeddings=131072, tie_word_embeddings=True,
    eos_token_id=128009, pad_token_id=128004,
    rope_scaling={"rope_type": "llama3", "factor": 32.0, "low_freq_factor": 1.0,
                  "high_freq_factor": 4.0, "original_max_position_embeddings": 8192},
)


class _FallbackJudgeTokenizer:
    """Hash tokenizer + trivial chat template for random-init benchmarking (the
    JAX package's, ids equal)."""

    eos_token_id = 128009
    pad_token_id = 128004

    def apply_chat_template(self, messages, tokenize=False, add_generation_prompt=True):
        text = "".join(f"<|{m['role']}|>\n{m['content']}\n" for m in messages)
        return text + ("<|assistant|>\n" if add_generation_prompt else "")

    def convert_tokens_to_ids(self, token):
        return None

    def encode(self, text: str, add_special_tokens: bool = True) -> list[int]:
        return [
            100 + int.from_bytes(hashlib.md5(w.encode()).digest()[:3], "little") % 128000
            for w in text.split()
        ]

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        return " ".join(f"tok{int(i)}" for i in ids)


def resolve_judge_weights() -> str | None:
    """``LMMS_OWC_JUDGE_PATH``, else the Hugging Face cache (never the network), else None."""
    env_path = os.environ.get("LMMS_OWC_JUDGE_PATH")
    if env_path and Path(env_path).exists():
        return env_path
    try:
        from huggingface_hub import snapshot_download

        return snapshot_download(JUDGE_MODEL_ID, local_files_only=True)
    except Exception:  # no huggingface_hub, or the model is not in the cache
        return None


class JudgeModel:
    """Batched greedy scorer over (prompt -> short verdict) pairs, on one device,
    or data-parallel over the ranks of the default process group with
    ``data_parallel``."""

    def __init__(self, model: qvl.Qwen2VLModel, tokenizer, batch_size: int = 64, data_parallel: bool = False) -> None:
        self.model = model
        self.config = model.config  # the decoder view (Qwen2VLConfig)
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        dist = torch.distributed
        # The row split's rank count and this rank's index (1 and 0 on one rank).
        self.ranks = dist.get_world_size() if data_parallel and dist.is_available() and dist.is_initialized() else 1
        self.rank = dist.get_rank() if self.ranks > 1 else 0
        # The CPU path keeps the JAX package's shapes, which its parity tests compare.
        self.decode_rows = DECODE_ROWS if model.device.type == "cuda" else None

    @property
    def device(self) -> torch.device:
        return self.model.device

    @classmethod
    def from_pretrained(
        cls, path: str, dtype=None, load_in_8bit: bool = False, device=None, data_parallel: bool = False
    ) -> "JudgeModel":
        """Load a judge checkpoint onto ``device`` (default: the card) in
        ``dtype`` (default bf16); ``load_in_8bit`` quantizes each linear
        weight on the device as it loads (the int8 leaves of the weight cast
        to ``dtype``), so the full-precision tree never exists there.
        ``data_parallel`` is the constructor's."""
        device = get_device(device)
        dtype = dtype or torch.bfloat16
        config = llama_config_from_hf(load_config_json(path))
        state = load_safetensors_state(path)
        if load_in_8bit:
            model = quant.load_quantized_on_device(build_llama(config, dtype, "meta"), state, bits=8,
                                                   dtype=dtype, device=device)
        else:
            model = load_hf_tensors(build_llama(config, dtype, device), state)
        del state
        log.info("loaded judge model from %s on %s%s", path, device, " (int8)" if load_in_8bit else "")
        return cls(model, Tokenizer.from_pretrained(path), data_parallel=data_parallel)

    @classmethod
    def random_init(cls, seed: int = 0, dtype=None, load_in_8bit: bool = False, device=None,
                    data_parallel: bool = False) -> "JudgeModel":
        """Judge-architecture model with random weights drawn on ``device``
        (benchmarking without checkpoints: the real judge's FLOPs and memory
        traffic). int8 draws and quantizes one layer at a time."""
        device = get_device(device)
        dtype = dtype or torch.bfloat16
        config = llama_config_from_hf(dict(LLAMA32_3B_CONFIG))
        gen = torch.Generator(device=device).manual_seed(seed)
        if load_in_8bit:
            model = quant.init_quantized_on_device(build_llama(config, dtype, "meta"), gen, bits=8, dtype=dtype)
        else:
            model = init_llama_params(config, gen, dtype)
        return cls(model, _FallbackJudgeTokenizer(), data_parallel=data_parallel)

    def _prepare_chunk(self, chunk: list[str]) -> tuple:
        """Host side of one scoring chunk: chat-template render, tokenize,
        left-pad to a length bucket. Returns (bucket, input_ids, position_ids,
        mask, next_pos) as numpy."""
        rendered = [
            self.tokenizer.apply_chat_template(
                [{"role": "user", "content": prompt}], tokenize=False, add_generation_prompt=True
            )
            for prompt in chunk
        ]
        encoded = [self.tokenizer.encode(text, add_special_tokens=False) for text in rendered]
        bucket = pad_to_bucket(max(len(ids) for ids in encoded))
        n_rows = len(chunk)
        n_rows += -n_rows % self.ranks  # a multiple of the ranks, the last row repeated
        input_ids = np.full((n_rows, bucket), self.config.pad_token_id, np.int64)
        mask = np.zeros((n_rows, bucket), np.int64)
        for row in range(n_rows):
            ids = encoded[min(row, len(chunk) - 1)]
            input_ids[row, bucket - len(ids) :] = ids
            mask[row, bucket - len(ids) :] = 1
        position_ids, next_pos = llama_positions(mask)
        return bucket, input_ids, position_ids, mask, next_pos

    def _inputs(self, prepared: tuple) -> tuple:
        """One chunk's device tensors: (embeds, position_ids, mask int32, next_pos)."""
        _, input_ids, position_ids, mask, next_pos = prepared
        dev = self.device
        embeds = embedding(self.model.embed_tokens, torch.from_numpy(input_ids).to(dev))
        return (embeds, torch.from_numpy(position_ids).to(dev),
                torch.from_numpy(mask.astype(np.int32)).to(dev), torch.from_numpy(next_pos).to(dev))

    def _eos_and_stop(self) -> tuple[list[int], set[int]]:
        eos_ids = [self.tokenizer.eos_token_id]
        for tok in ("<|eot_id|>",):
            tok_id = self.tokenizer.convert_tokens_to_ids(tok)
            if tok_id is not None and tok_id >= 0:
                eos_ids.append(tok_id)
        eos_ids = sorted(set(int(e) for e in eos_ids if e is not None))
        return eos_ids, set(eos_ids) | {self.config.pad_token_id}

    def _decode_rows(self, tokens: np.ndarray, n_rows: int, stop: set[int]) -> list[str]:
        outputs = []
        for row in range(n_rows):
            ids = []
            for tok in tokens[row]:
                if int(tok) in stop:
                    break
                ids.append(int(tok))
            outputs.append(self.tokenizer.decode(ids, skip_special_tokens=True).strip())
        return outputs

    def _eos_tensor(self, eos_ids: list[int]) -> torch.Tensor:
        return torch.tensor(eos_ids, dtype=torch.long, device=self.device)

    @torch.inference_mode()
    def _generate_pooled(self, prompts: list[str], pool_n: int) -> list[str]:
        """Decode-pool judge serving: prefill each chunk at its own (batch,
        bucket) shape, write its KV into one preallocated pool cache
        (front-padded to the pool's longest bucket, int8 before the write when
        the int8 cache is on), then decode ``pool_n`` chunks' rows as ONE
        batch. Peak memory is the pool plus one chunk. The cache holds
        ``l_max + MAX_NEW_TOKENS`` positions rounded up to 32, as in the JAX
        package."""
        eos_ids, stop = self._eos_and_stop()
        chunks = [prompts[start : start + self.batch_size] for start in range(0, len(prompts), self.batch_size)]
        pools = [chunks[i : i + pool_n] for i in range(0, len(chunks), pool_n)]
        dev = self.device

        def prepare(pool: list[list[str]]) -> list[tuple]:
            return [self._prepare_chunk(c) for c in pool]

        def run(pool: list[list[str]], prepared: list[tuple]) -> list[str]:
            l_max = max(p[0] for p in prepared)
            cache_len = l_max + MAX_NEW_TOKENS
            cache_len += (-cache_len) % 32
            kv_int8 = qvl.kv_int8_cache(self.model, dev)
            total_rows = sum(p[1].shape[0] for p in prepared)
            kv_mask = torch.zeros((total_rows, cache_len), dtype=torch.int32, device=dev)
            cache: tuple = ()
            logits_all, next_all = [], []
            row_offset = 0
            for p in prepared:
                bucket = p[0]
                embeds, position_ids, mask, next_pos = self._inputs(p)
                logits, *kv = qvl.prefill_logits(self.model, embeds, position_ids, mask)
                if kv_int8:
                    # Quantize BEFORE the pool write: the bf16 pool never exists.
                    kv = qvl.quantize_kv_cache(*kv)
                front = l_max - bucket
                cache = qvl.write_pool(cache, kv, total_rows, cache_len, row_offset, front)
                del kv
                n_rows = mask.shape[0]
                kv_mask[row_offset : row_offset + n_rows, front : front + bucket] = mask
                logits_all.append(logits)
                next_all.append(next_pos)
                row_offset += n_rows
            tokens = qvl.decode_pool(
                self.model, cache, torch.cat(logits_all), kv_mask, torch.cat(next_all),
                max_new_tokens=MAX_NEW_TOKENS, prompt_len=l_max, eos_ids=self._eos_tensor(eos_ids),
                decode_rows=self.decode_rows,
            ).cpu().numpy()
            outputs: list[str] = []
            row_offset = 0
            for chunk in pool:
                outputs.extend(self._decode_rows(tokens[row_offset:], len(chunk), stop))
                row_offset += len(chunk)
            return outputs

        return foreach_chunk_pipelined(pools, prepare, run)

    @torch.inference_mode()
    def _generate(self, prompts: list[str]) -> list[str]:
        pool_n = int(os.environ.get("LMMS_OWC_JUDGE_DECODE_POOL", "0") or 0)
        if pool_n > 1 and self.ranks == 1:
            return self._generate_pooled(prompts, pool_n)
        eos_ids, stop = self._eos_and_stop()

        def run(chunk: list[str], prepared: tuple) -> list[str]:
            if self.ranks > 1:
                prepared = self._own_rows(prepared)
            embeds, position_ids, mask, next_pos = self._inputs(prepared)
            tokens = qvl.greedy_generate(
                self.model, embeds, position_ids, mask, next_pos,
                max_new_tokens=MAX_NEW_TOKENS, cache_len=prepared[0] + 64, eos_ids=self._eos_tensor(eos_ids),
                decode_rows=self.decode_rows,
            )
            if self.ranks > 1:
                tokens = self._gather_rows(tokens)
            return self._decode_rows(tokens.cpu().numpy(), len(chunk), stop)

        chunks = [prompts[start : start + self.batch_size] for start in range(0, len(prompts), self.batch_size)]
        return foreach_chunk_pipelined(chunks, self._prepare_chunk, run)

    def _own_rows(self, prepared: tuple) -> tuple:
        """This rank's contiguous share of a padded chunk's rows (the bucket is the chunk's)."""
        bucket, input_ids, position_ids, mask, next_pos = prepared
        per = input_ids.shape[0] // self.ranks
        rows = slice(self.rank * per, (self.rank + 1) * per)
        return bucket, input_ids[rows], position_ids[:, rows], mask[rows], next_pos[rows]

    def _gather_rows(self, tokens: torch.Tensor) -> torch.Tensor:
        """Every rank's tokens in row order: each fills its rows of a zero
        tensor and an all-reduce sums them."""
        per = tokens.shape[0]
        full = tokens.new_zeros(per * self.ranks, tokens.shape[1])
        full[self.rank * per : (self.rank + 1) * per] = tokens
        torch.distributed.all_reduce(full)
        return full

    def score_pairs(self, prompts: list[str], predictions, references) -> list[str]:
        return self._generate(prompts)

    def score_triplets(self, prompts: list[str], a, b, references) -> list[str]:
        return self._generate(prompts)
