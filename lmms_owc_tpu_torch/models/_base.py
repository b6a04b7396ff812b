"""Model adapter base class of the port (counterpart of :mod:`lmms_owc_tpu.models._base`).

It keeps the JAX base's contract: the constructor (batch size, dtype,
device, the ``load_in_8bit``/``load_in_4bit`` flags, the ``--use_cache``
response cache and the seed), ``rank`` and ``world_size``, the request
handlers (with the generic multi-round protocol and the loglikelihood request
helpers), the chat template and the chunk pipeline. Each adapter's
``load_model`` applies the quantization flags. An adapter that sets
``time_phases`` times its phases with :meth:`Model._phase`.

``model_parallel`` / ``use_mesh`` build the ("data", "model") mesh of
:mod:`lmms_owc_tpu_torch.parallel.mesh` over the process group before the
model loads: ``model_parallel`` consecutive ranks hold one model's shards
(:attr:`Model.model_group`), and ``rank`` / ``world_size`` become the data
coordinate and the data size, so the evaluator shards requests by data group.
Only the adapters that set ``supports_mesh`` (Qwen2-VL, LLaVA, InternVL2, as
in the JAX package) take them; the others raise.
"""

from __future__ import annotations

import abc
import hashlib
import json
import os
import time
from collections import defaultdict
from contextlib import contextmanager

import numpy as np
import torch

from lmms_owc_tpu_torch._device import get_device
from lmms_owc_tpu_torch.parallel.mesh import DATA_AXIS, local_mesh, model_group
from lmms_owc_tpu_torch.utils import foreach_chunk_pipelined, pad_to_bucket

__all__ = ["CacheHook", "Model"]


class CacheHook:
    """sha256(request) -> response cache, persisted as JSON lines
    (``--use_cache DIR``); the JAX package's ``CacheHook``."""

    def __init__(self, cache_dir: str | None = None) -> None:
        self.cache_dir = cache_dir
        self._store: dict[str, object] = {}
        if cache_dir is not None:
            os.makedirs(cache_dir, exist_ok=True)
            self._path = os.path.join(cache_dir, "responses.jsonl")
            if os.path.exists(self._path):
                with open(self._path, encoding="utf-8") as f:
                    for line in f:
                        try:
                            record = json.loads(line)
                            self._store[record["key"]] = record["value"]
                        except (json.JSONDecodeError, KeyError):
                            continue

    @staticmethod
    def hash_args(attr: str, args: tuple) -> str:
        payload = json.dumps([attr, *[str(a) for a in args]], ensure_ascii=False)
        return hashlib.sha256(payload.encode("utf-8")).hexdigest()

    def get(self, attr: str, args: tuple):
        return self._store.get(self.hash_args(attr, args))

    def add_partial(self, attr: str, args: tuple, value) -> None:
        key = self.hash_args(attr, args)
        self._store[key] = value
        if self.cache_dir is not None:
            with open(self._path, "a", encoding="utf-8") as f:
                f.write(json.dumps({"key": key, "value": value}, ensure_ascii=False) + "\n")

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class Model(abc.ABC):
    """Base class for the port's model adapters.

    ``device`` defaults to :attr:`default_device` (``"cuda"``, which raises
    when CUDA is absent); pass ``device="cpu"`` to run the plain PyTorch
    versions of the kernels.
    ``torch_random_seed`` seeds the adapter's ``torch.Generator`` (random
    weights and sampling; the CLI's third ``--seed`` value).
    """

    default_device = "cuda"
    time_phases = False
    supports_mesh = False

    def __init__(
        self,
        model_id: str | None = None,
        batch_size: int = 8,
        dtype: str = "bfloat16",
        device: str | None = None,
        use_cache: str | None = None,
        load_in_8bit: bool = False,
        load_in_4bit: bool = False,
        torch_random_seed: int = 1234,
        model_parallel: int = 1,
        use_mesh: bool = False,
        **kwargs,
    ) -> None:
        # Weight-only int8/int4 (the bitsandbytes load_in_8bit/load_in_4bit
        # equivalents of the JAX package, lmms_owc_tpu_torch.ops.quant).
        self.load_in_8bit = bool(load_in_8bit)
        self.load_in_4bit = bool(load_in_4bit)
        if self.load_in_8bit and self.load_in_4bit:
            raise ValueError("load_in_8bit and load_in_4bit are mutually exclusive")
        if dtype not in _DTYPES:
            raise ValueError(f"dtype {dtype!r} not supported; choose from {sorted(_DTYPES)}")
        self.model_id = model_id
        self.batch_size = int(batch_size)
        self.dtype = dtype
        self.torch_dtype = _DTYPES[dtype]
        self.device = get_device(device or self.default_device)
        self.torch_random_seed = int(torch_random_seed)
        self.model_parallel = int(model_parallel)
        if (use_mesh or self.model_parallel > 1) and not self.supports_mesh:
            raise ValueError(f"{type(self).__name__} has no tensor-parallel path: model_parallel and use_mesh "
                             "are for the Qwen2-VL, LLaVA and InternVL2 adapters")
        # Every rank builds the mesh together, before any weight exists.
        self.mesh = local_mesh(self.model_parallel, self.device.type) if use_mesh or self.model_parallel > 1 else None
        self.model_group = model_group(self.mesh)
        self._extra_kwargs = kwargs
        self.cache_hook = CacheHook(use_cache)
        self.task_dict: dict = {}
        self.phase_seconds: dict[str, float] = defaultdict(float)
        self.load_model()

    @property
    def rank(self) -> int:
        """The data coordinate under a mesh; else the ``torch.distributed`` rank
        when it is initialised, else 0."""
        if self.mesh is not None:
            return self.mesh.get_local_rank(DATA_AXIS)
        dist = torch.distributed
        return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0

    @property
    def world_size(self) -> int:
        """The data size under a mesh; else the ``torch.distributed`` world size, else 1."""
        if self.mesh is not None:
            return self.mesh.size(0)
        dist = torch.distributed
        return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1

    @property
    def data_group(self):
        """The process group of the evaluator's collectives: this rank's data
        group under a mesh, else None (the default group)."""
        return None if self.mesh is None else self.mesh.get_group(DATA_AXIS)

    @property
    def model_rank(self) -> int:
        """This rank's place in its model group (0 without tensor parallelism)."""
        return 0 if self.model_group is None else self.model_group.rank

    def _shard_hook(self, decoder, bits: int | None = None, prefix: str = ""):
        """Under tensor parallelism, the shard hook of the module walks for
        ``decoder`` (:class:`~lmms_owc_tpu_torch.parallel.sharding.Sharder`; its
        path in the walked model is ``prefix``); else None."""
        if self.model_group is None:
            return None
        from lmms_owc_tpu_torch.parallel.sharding import Sharder

        return Sharder(decoder, self.model_group, int4=bits == 4, prefix=prefix)

    @abc.abstractmethod
    def load_model(self) -> None:
        """Build the modules and load or generate the weights."""

    @abc.abstractmethod
    def loglikelihood(self, requests) -> list[tuple[float, bool]]:
        """Return (loss, is_greedy) per request; loss is the continuation NLL."""

    @abc.abstractmethod
    def generate_until(self, requests) -> list[str]:
        """Generate free-text responses for each request."""

    def generate_until_multi_round(self, requests) -> list[list[str]]:
        """Multi-round conversation protocol, generic over any adapter (the JAX
        base's): round 0 uses the prebuilt context; later rounds call
        ``doc_to_text(doc, round_idx=r, previous_round_results=[...],
        last_round_info=...)``, which returns ``(visual, text, terminal,
        previous_round_results, last_round_info)``. Each round hands every
        still-active request to :meth:`generate_until`. Request args: (ctx,
        gen_kwargs, doc_to_visual, doc_to_text, doc_id, task, split).
        """

        class _PseudoReq:
            __slots__ = ("args",)

            def __init__(self, args):
                self.args = args

        docs = [self._doc(req.args[5], req.args[6], req.args[4]) for req in requests]
        n = len(requests)
        rounds: list[list[str]] = [[] for _ in range(n)]
        infos: list = [None] * n
        prompts: list = [req.args[0] for req in requests]
        active = list(range(n))
        round_idx = 0
        while active and round_idx <= 16:
            if round_idx != 0:
                still_active = []
                for i in active:
                    _vis, text, terminal, _prev, infos[i] = requests[i].args[3](
                        docs[i], round_idx=round_idx, previous_round_results=list(rounds[i]),
                        last_round_info=infos[i],
                    )
                    if not terminal:
                        prompts[i] = text
                        still_active.append(i)
                active = still_active
                if not active:
                    break
            sub_reqs = [
                _PseudoReq((prompts[i], *requests[i].args[1:3], *requests[i].args[4:7])) for i in active
            ]
            for i, text in zip(active, self.generate_until(sub_reqs)):
                rounds[i].append(text)
            round_idx += 1
        return rounds

    def _doc(self, task_name: str, split: str, doc_id):
        task = self.task_dict.get(task_name)
        if isinstance(task, tuple):
            task = task[1]
        return task.dataset[split][doc_id]

    def _request_visuals(self, doc_to_visual, doc_id, task_name: str, split: str) -> list:
        """The visuals of a generate_until request's document: none when the
        task is unknown or the request has no ``doc_to_visual``."""
        task = self.task_dict.get(task_name)
        if isinstance(task, tuple):
            task = task[1]
        if task is None or doc_to_visual is None:
            return []
        return doc_to_visual(task.dataset[split][doc_id]) or []

    def _resolve_loglikelihood_request(self, req) -> tuple[str, str, list]:
        """(context, continuation_text, visuals) for a loglikelihood request.

        Task-built requests carry (ctx, doc_to_target, doc_to_visual, doc_id,
        task, split); ``acc_mutual_info``'s unconditional P(choice) requests
        carry just (ctx, choice).
        """
        args = req.args
        ctx = args[0]
        if len(args) < 6:
            return ctx, str(args[1]), []
        _, doc_to_target, doc_to_visual, doc_id, task_name, split = args[:6]
        doc = self._doc(task_name, split, doc_id)
        continuation = doc_to_target(doc) if callable(doc_to_target) else doc_to_target
        if isinstance(continuation, list):
            continuation = continuation[0]
        visuals = (doc_to_visual(doc) if doc_to_visual else []) or []
        return ctx, str(continuation), visuals

    def _encode_continuation(self, continuation: str) -> list[int]:
        """Token ids of a loglikelihood continuation, encoded on its own with no
        special tokens. The task layer already put any word-boundary delimiter
        in the continuation, so the scored text is ``prompt + continuation``;
        encoding the continuation alone is the same for every prompt, where
        slicing ``encode(prompt + continuation)`` would drift when BPE merges
        across the boundary."""
        tok = self.tokenizer
        try:
            return list(tok.encode(continuation, add_special_tokens=False))
        except TypeError:
            return list(tok.encode(continuation))

    @contextmanager
    def _phase(self, name: str):
        """Wall seconds of one phase, device work included, summed into
        :attr:`phase_seconds` (only when the adapter's ``time_phases`` is set:
        the device is synchronized around the phase)."""
        if not self.time_phases:
            yield
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.phase_seconds[name] += time.perf_counter() - t0

    @property
    def pad_token_id(self) -> int:
        """The id that left-pads prompts (and, with the EOS ids, ends a
        generated row): the decoder config's."""
        return self.config.pad_token_id

    def _left_pad(self, rows: list[list[int]]) -> tuple[np.ndarray, np.ndarray]:
        """(input_ids, mask) [B, bucket]: rows left-padded with the pad id to
        the length bucket of the longest."""
        bucket = pad_to_bucket(max(len(ids) for ids in rows))
        input_ids = np.full((len(rows), bucket), self.pad_token_id, np.int64)
        mask = np.zeros((len(rows), bucket), np.int64)
        for row, ids in enumerate(rows):
            input_ids[row, bucket - len(ids) :] = ids
            mask[row, bucket - len(ids) :] = 1
        return input_ids, mask

    def _detokenize(self, tokens: np.ndarray) -> list[str]:
        """Trim each row at the first EOS/pad token and decode to text."""
        stop = set(self.eos_token_ids) | {self.pad_token_id}
        texts = []
        for row in range(tokens.shape[0]):
            ids = []
            for tok in tokens[row]:
                if int(tok) in stop:
                    break
                ids.append(int(tok))
            texts.append(self.tokenizer.decode(ids, skip_special_tokens=True))
        return texts

    def _foreach_chunk_pipelined(self, chunks: list, prepare, run, depth: int = 2, finish=None) -> list:
        """Process chunks with up to ``depth`` chunks' preparation in flight.

        ``prepare(chunk)`` does host preprocessing and the vision encode in a
        worker thread; ``run(chunk, prepared)`` decodes. See
        :func:`lmms_owc_tpu_torch.utils.foreach_chunk_pipelined`. Under tensor
        parallelism the chunks run one after another in this thread: the
        model group's collectives must come in one sequence on every rank.
        """
        if self.model_group is not None:
            depth = 0
        return foreach_chunk_pipelined(chunks, prepare, run, depth=depth, finish=finish)

    def apply_chat_template(self, messages: list[dict]) -> str:
        rendered = "".join(f"{m['role']}: {m['content']}\n" for m in messages)
        return rendered + "assistant:"

    @property
    def chat_template(self) -> str:
        return type(self).__name__

    @property
    def tokenizer_name(self) -> str:
        """Part of the request-cache key under ``--apply_chat_template``."""
        return ""
