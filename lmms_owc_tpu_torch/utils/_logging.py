"""Process-aware logging (the JAX package's ``utils._logging``): only process 0
emits rank-zero-only records, and every record of another process is prefixed
with its index, read from ``JAX_PROCESS_INDEX`` / ``RANK`` / ``LOCAL_RANK``."""

from __future__ import annotations

import functools
import logging
import os
import sys
from typing import Callable

__all__ = ["deprecated_positional", "get_logger", "rank_zero_only"]

_FORMAT = "%(asctime)s | %(levelname)-8s | %(name)s | %(message)s"


def _process_index() -> int:
    """Process index from the JAX_PROCESS_INDEX / RANK / LOCAL_RANK variables, else 0."""
    for var in ("JAX_PROCESS_INDEX", "RANK", "LOCAL_RANK"):
        val = os.environ.get(var)
        if val is not None and val.lstrip("-").isdigit():
            return int(val)
    return 0


def rank_zero_only(fn: Callable) -> Callable:
    """Decorator that runs ``fn`` only on process 0 (reference: src/utils/_decorators.py:42-62)."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if _process_index() == 0:
            return fn(*args, **kwargs)
        return None

    return wrapped


def deprecated_positional(fn: Callable) -> Callable:
    """Warn when a function is called with positional arguments beyond ``self``.

    Reference parity: src/utils/_decorators.py:8-39 — used to migrate public APIs
    toward keyword-only calls without breaking existing callers.
    """
    import inspect
    import warnings

    params = list(inspect.signature(fn).parameters)
    allowed = 2 if params and params[0] in ("self", "cls") else 1

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if len(args) > allowed:
            warnings.warn(
                f"{fn.__qualname__}: positional arguments beyond the first are deprecated; "
                "pass them as keywords",
                DeprecationWarning,
                stacklevel=2,
            )
        return fn(*args, **kwargs)

    return wrapped


class _ProcessPrefixFilter(logging.Filter):
    def filter(self, record: logging.LogRecord) -> bool:
        idx = _process_index()
        if idx != 0 and not record.msg.startswith(f"[proc {idx}]"):
            record.msg = f"[proc {idx}] {record.msg}"
        return True


@functools.lru_cache(maxsize=None)
def get_logger(name: str, rank_zero_only: bool = True) -> logging.Logger:
    """Return a configured logger.

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
