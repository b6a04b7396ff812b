"""Host helpers of the port: request collation, logging and the chunk pipeline.

The port keeps its own copies of the JAX package's host helpers that it uses
(:mod:`lmms_owc_tpu.utils`: ``_collation``, ``_logging``, ``_core``), so that
importing it never imports that package. Behaviour is the same: the adapter's
chunk order and length buckets, on which token identity with the JAX adapter
depends, come from :class:`Collator` and :func:`pad_to_bucket` as they are
there. :func:`foreach_chunk_pipelined` leaves out the reference's host-profile
spans.
"""

from __future__ import annotations

import functools
import logging
import os
import sys
from collections import deque
from collections.abc import Callable, Iterator
from concurrent.futures import ThreadPoolExecutor
from typing import Any

__all__ = [
    "DEFAULT_LENGTH_BUCKETS",
    "Collator",
    "foreach_chunk_pipelined",
    "get_logger",
    "pad_to_bucket",
]

# Sequence-length buckets, multiples of 64 below 512 and coarser above, as in
# the JAX package (each bucket there is one compiled program; here they bound
# padding and keep prompt shapes, and so tokens, identical to the reference).
DEFAULT_LENGTH_BUCKETS = (
    128, 192, 256, 288, 320, 352, 384, 448, 512, 640, 768,
    1024, 1536, 2048, 3072, 4096, 6144, 8192,
)


def pad_to_bucket(length: int, buckets: tuple[int, ...] = DEFAULT_LENGTH_BUCKETS) -> int:
    """Smallest bucket >= length (last bucket if none fits)."""
    for b in buckets:
        if length <= b:
            return b
    return buckets[-1]


class Collator:
    """Sort, group, and batch requests; restore original order afterwards.

    Args:
        arr: list of request payloads.
        sort_fn: key for length-descending sort (e.g. ``lambda x: -len(toks(x))``).
        group_fn: key for grouping (e.g. generation kwargs repr); requests are only
            batched within a group.
        group_by: "gen_kwargs", "contexts", or None.
    """

    def __init__(
        self,
        arr: list,
        sort_fn: Callable[[Any], Any] = lambda x: 0,
        group_fn: Callable[[Any], Any] = lambda x: x[1],
        group_by: str | None = None,
    ) -> None:
        self._group_by = group_by
        self._arr_with_indices: list[tuple[int, Any]] = list(enumerate(arr))
        self._sort_fn = lambda item: sort_fn(item[1])
        self._group_fn = lambda item: group_fn(item[1])
        self._reorder_indices: list[int] = []
        self._size = len(arr)

    def __len__(self) -> int:
        return self._size

    def _grouped(self) -> dict[Any, list[tuple[int, Any]]]:
        if self._group_by is None:
            return {None: self._arr_with_indices}
        groups: dict[Any, list[tuple[int, Any]]] = {}
        for item in self._arr_with_indices:
            key = self._group_fn(item)
            try:
                hash(key)
            except TypeError:
                key = repr(key)
            groups.setdefault(key, []).append(item)
        return groups

    def get_batched(self, n: int = 1, batch_fn: Callable[[int, Any], int] | None = None) -> Iterator[list]:
        """Yield batches of at most ``n`` requests (0 = single batch per group),
        sorted within each group, recording order for :meth:`get_original`."""
        for _, group in self._grouped().items():
            ordered = sorted(group, key=self._sort_fn)
            batch: list[tuple[int, Any]] = []
            for item in ordered:
                max_n = batch_fn(len(self._reorder_indices), item[1]) if batch_fn else n
                batch.append(item)
                if max_n and len(batch) >= max_n:
                    self._reorder_indices.extend(idx for idx, _ in batch)
                    yield [payload for _, payload in batch]
                    batch = []
            if batch:
                self._reorder_indices.extend(idx for idx, _ in batch)
                yield [payload for _, payload in batch]

    def get_original(self, newarr: list) -> list:
        """Undo the sort/group permutation over the processed results."""
        res = [None] * self._size
        covered = [False] * self._size
        for idx, value in zip(self._reorder_indices, newarr):
            res[idx] = value
            covered[idx] = True
        assert all(covered), "some requests were not processed"
        return res


def foreach_chunk_pipelined(chunks: list, prepare, run, depth: int = 2, finish=None) -> list:
    """Process chunks with up to ``depth`` chunks' preparation in flight.

    ``prepare(chunk)`` does host preprocessing and runs in one worker thread;
    ``run(chunk, prepared)`` does the serial device step and returns a list of
    outputs. With ``finish`` the loop is a three-stage pipeline: ``run`` only
    dispatches device work and returns a handle, and ``finish(chunk, handle)``
    for chunk k runs after chunk k+1's dispatch and returns the outputs.
    """
    results: list = []
    if not chunks:
        return results
    depth = max(1, int(depth))
    with ThreadPoolExecutor(max_workers=1) as pool:
        pending: deque = deque(pool.submit(prepare, chunk) for chunk in chunks[:depth])
        inflight = None  # (chunk, handle) awaiting finish
        for i, chunk in enumerate(chunks):
            prepared = pending.popleft().result()
            if i + depth < len(chunks):
                pending.append(pool.submit(prepare, chunks[i + depth]))
            out = run(chunk, prepared)
            if finish is None:
                results.extend(out)
                continue
            if inflight is not None:
                results.extend(finish(*inflight))
            inflight = (chunk, out)
        if finish is not None and inflight is not None:
            results.extend(finish(*inflight))
    return results


_FORMAT = "%(asctime)s | %(levelname)-8s | %(name)s | %(message)s"


def _process_index() -> int:
    """Process index from the JAX_PROCESS_INDEX / RANK / LOCAL_RANK variables, else 0."""
    for var in ("JAX_PROCESS_INDEX", "RANK", "LOCAL_RANK"):
        val = os.environ.get(var)
        if val is not None and val.lstrip("-").isdigit():
            return int(val)
    return 0


class _ProcessPrefixFilter(logging.Filter):
    def filter(self, record: logging.LogRecord) -> bool:
        idx = _process_index()
        if idx != 0 and not record.msg.startswith(f"[proc {idx}]"):
            record.msg = f"[proc {idx}] {record.msg}"
        return True


@functools.lru_cache(maxsize=None)
def get_logger(name: str, rank_zero_only: bool = True) -> logging.Logger:
    """Return a configured logger (stderr; ``LMMS_OWC_TPU_LOG_LEVEL``, default INFO).

    Args:
        name: logger name (usually ``__name__``).
        rank_zero_only: if True, non-zero processes log only WARNING+.
    """
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT))
        handler.addFilter(_ProcessPrefixFilter())
        logger.addHandler(handler)
        level = os.environ.get("LMMS_OWC_TPU_LOG_LEVEL", "INFO").upper()
        if rank_zero_only and _process_index() != 0:
            level = "WARNING"
        logger.setLevel(level)
        logger.propagate = False
    return logger
