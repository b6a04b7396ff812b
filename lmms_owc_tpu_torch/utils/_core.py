"""Core host-side utilities of the port (the JAX package's ``utils._core``):
sharded iteration, arg parsing, hashing, sanitizers and the chunk pipeline.

One departure: :func:`foreach_chunk_pipelined` leaves out the reference's
host-profile spans.
"""

from __future__ import annotations

import datetime
import fnmatch
import hashlib
import json
import re
import subprocess
from collections import deque
from collections.abc import Iterable, Iterator
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any

from tqdm import tqdm

from lmms_owc_tpu_torch.utils._hostprof import hostprof

__all__ = [
    "create_iterator",
    "parse_string_args",
    "pattern_match",
    "hash_string",
    "sanitize_model_name",
    "sanitize_task_name",
    "sanitize_long_string",
    "get_datetime_str",
    "get_git_commit_hash",
    "get_progress_bar",
    "convert_non_serializable",
    "positional_deprecated",
    "simple_parse_args_string",
    "foreach_chunk_pipelined",
]


def foreach_chunk_pipelined(chunks: list, prepare, run, depth: int = 2, finish=None) -> list:
    """Process chunks with up to ``depth`` chunks' preparation in flight.

    ``prepare(chunk)`` does host preprocessing and runs in one worker thread;
    ``run(chunk, prepared)`` does the serial device step and returns a list of
    outputs. With ``finish`` the loop is a three-stage pipeline: ``run`` only
    dispatches device work and returns a handle, and ``finish(chunk, handle)``
    for chunk k runs after chunk k+1's dispatch and returns the outputs.
    Under ``LMMS_OWC_HOST_PROF`` the waits for a prepared chunk and the
    ``run`` and ``finish`` calls are timed (``prep_wait``, ``run_total``,
    ``finish_total``; :mod:`lmms_owc_tpu_torch.utils._hostprof`). ``depth`` 0
    prepares each chunk in the calling thread just before its ``run``.
    """
    results: list = []
    if not chunks:
        return results
    if int(depth) == 0:
        for chunk in chunks:
            out = run(chunk, prepare(chunk))
            results.extend(out if finish is None else finish(chunk, out))
        return results
    depth = max(1, int(depth))
    with ThreadPoolExecutor(max_workers=1) as pool:
        pending: deque = deque(pool.submit(prepare, chunk) for chunk in chunks[:depth])
        inflight = None  # (chunk, handle) awaiting finish
        for i, chunk in enumerate(chunks):
            with hostprof("prep_wait"):
                prepared = pending.popleft().result()
            if i + depth < len(chunks):
                pending.append(pool.submit(prepare, chunks[i + depth]))
            with hostprof("run_total"):
                out = run(chunk, prepared)
            if finish is None:
                results.extend(out)
                continue
            if inflight is not None:
                with hostprof("finish_total"):
                    results.extend(finish(*inflight))
            inflight = (chunk, out)
        if finish is not None and inflight is not None:
            with hostprof("finish_total"):
                results.extend(finish(*inflight))
    return results


TQDM_BAR_FORMAT = (
    "{desc}: {percentage:3.0f}%|{bar}| {n_fmt}/{total_fmt} "
    "[{elapsed}<{remaining}, {rate_fmt}{postfix}]"
)


def create_iterator(
    raw_iterator: Iterable,
    rank: int = 0,
    world_size: int = 1,
    limit: int | None = None,
) -> Iterator:
    """Shard an iterator over data-parallel workers.

    The data-parallel sharding primitive (reference: src/utils/_core_utils.py:53-69):
    worker ``rank`` of ``world_size`` sees elements ``rank, rank+world_size, ...`` up
    to ``limit``: the documents of a task are sharded over the ``torch.distributed``
    ranks.
    """
    from itertools import islice

    return islice(raw_iterator, rank, limit, world_size)


def parse_string_args(args_string: str | None) -> dict[str, Any]:
    """Parse ``k1=v1,k2=v2`` CLI strings into a dict with literal-eval'd values.

    (reference: src/utils/_core_utils.py:181-194)
    """
    if not args_string:
        return {}
    args_string = args_string.strip()
    if not args_string:
        return {}
    out: dict[str, Any] = {}
    for piece in args_string.split(","):
        if not piece:
            continue
        key, _, value = piece.partition("=")
        out[key.strip()] = _coerce(value.strip())
    return out


# Alias used by some call-sites for familiarity with the lm-eval lineage.
simple_parse_args_string = parse_string_args


def _coerce(value: str) -> Any:
    low = value.lower()
    if low == "true":
        return True
    if low == "false":
        return False
    if low in ("none", "null"):
        return None
    try:
        return int(value)
    except ValueError:
        pass
    try:
        return float(value)
    except ValueError:
        pass
    return value


def pattern_match(patterns: str | list[str], source_list: Iterable[str]) -> list[str]:
    """fnmatch wildcard matching of task name patterns (reference: src/utils/_core_utils.py:197-217)."""
    if isinstance(patterns, str):
        patterns = [patterns]
    matched: list[str] = []
    seen: set[str] = set()
    for pattern in patterns:
        hits = sorted(fnmatch.filter(source_list, pattern))
        if not hits and pattern in source_list:
            hits = [pattern]
        for hit in hits:
            if hit not in seen:
                seen.add(hit)
                matched.append(hit)
    return matched


def hash_string(string: str) -> str:
    """sha256 hex digest of a string — used for doc/prompt/target reproducibility hashes."""
    return hashlib.sha256(string.encode("utf-8")).hexdigest()


def sanitize_model_name(model_name: str) -> str:
    """Sanitize a model arg string into a filesystem-safe directory name."""
    return re.sub(r"[\"<>:/\|\\?\*\[\]]+", "__", model_name)


def sanitize_task_name(task_name: str) -> str:
    return re.sub(r"\W", "_", task_name)


def sanitize_long_string(string: str, max_length: int = 40) -> str:
    if len(string) > max_length:
        return string[: max_length // 2] + "..." + string[-max_length // 2 :]
    return string


def get_datetime_str(timezone: str = "Europe/Rome") -> str:
    """Timezone-aware datetime string used in output filenames."""
    try:
        from zoneinfo import ZoneInfo

        tz = ZoneInfo(timezone)
    except Exception:
        tz = datetime.timezone.utc
    now = datetime.datetime.now(tz)
    return now.strftime("%Y%m%d_%H%M%S")


def get_git_commit_hash() -> str | None:
    """Current git commit hash, embedded in results for reproducibility."""
    try:
        return (
            subprocess.check_output(
                ["git", "rev-parse", "HEAD"], stderr=subprocess.DEVNULL,
                cwd=Path(__file__).resolve().parent,
            )
            .decode("ascii")
            .strip()
        )
    except Exception:
        return None


def get_progress_bar(**kwargs) -> tqdm:
    kwargs.setdefault("bar_format", TQDM_BAR_FORMAT)
    return tqdm(**kwargs)


def convert_non_serializable(obj: Any) -> str:
    """json.dumps ``default=`` hook for non-serializable values."""
    try:
        import numpy as np

        if isinstance(obj, np.generic):
            return obj.item()
        if isinstance(obj, np.ndarray):
            return obj.tolist()
    except Exception:
        pass
    if isinstance(obj, (set, frozenset)):
        return list(obj)
    return str(obj)


def positional_deprecated(fn):
    """Warn on positional use of keyword-intended args (reference: src/utils/_decorators.py:8-39)."""
    import functools
    import warnings

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if len(args) > 1:
            warnings.warn(
                f"{fn.__name__} should be called with keyword arguments",
                DeprecationWarning,
                stacklevel=2,
            )
        return fn(*args, **kwargs)

    return wrapped


def json_dumps_deterministic(obj: Any) -> str:
    """Stable JSON serialization used for hashing docs."""
    return json.dumps(obj, indent=2, default=convert_non_serializable, ensure_ascii=False)
