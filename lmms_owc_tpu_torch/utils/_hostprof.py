"""Host-side stage timers for the serving adapters (LMMS_OWC_HOST_PROF=1).

A copy of :mod:`lmms_owc_tpu.utils._hostprof`. The accumulators attribute
the host's share of a serving run to its stages: preparation that the chunk
pipeline failed to hide (``prep_wait``), input assembly, the dispatch of the
prefill and of the decode steps, the token fetch and detokenization. On the
card they time the host alone: a kernel launch or a PyTorch call on a CUDA
tensor returns before the device has finished, so a ``*_dispatch`` span is
the time to queue the work, and the wait for the device lands in the first
span that reads a result back (``fetch``). No span synchronizes the device.
Zero overhead unless ``LMMS_OWC_HOST_PROF`` is set (checked once at import).

Usage::

    with hostprof("detok"):
        ...
    hostprof_reset(); ...; hostprof_dump("label")
"""

from __future__ import annotations

import os
import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext

ENABLED = bool(int(os.environ.get("LMMS_OWC_HOST_PROF", "0")))

_acc: dict[str, float] = defaultdict(float)
_counts: dict[str, int] = defaultdict(int)


@contextmanager
def _timed(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _acc[name] += time.perf_counter() - t0
        _counts[name] += 1


def hostprof(name: str):
    """Context manager timing one host stage; no-op when disabled."""
    if not ENABLED:
        return nullcontext()
    return _timed(name)


def hostprof_reset() -> None:
    _acc.clear()
    _counts.clear()


def hostprof_dump(label: str = "") -> None:
    if not ENABLED or not _acc:
        return
    total = sum(_acc.values())
    rows = sorted(_acc.items(), key=lambda kv: -kv[1])
    print(f"[hostprof {label}] total attributed {total * 1e3:.0f} ms")
    for name, secs in rows:
        print(f"  {name:<18} {secs * 1e3:>8.0f} ms  x{_counts[name]}")
