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

Beside the spans, a store of event counters (``counters``, added to by
:func:`count` while ``ENABLED``): decode steps and their rows, prompt tokens
against prefill slots, W8A8 activation quantizations. ``hostprof_reset``
leaves the counters alone (``counters_reset`` clears them), so a caller that
resets the spans after every call and enables the timers for a window only
reads that window's counts. Call sites in hot loops test ``ENABLED`` first.
(``launch_counts`` in ``ops/attention.py`` and ``ops/int4_matmul.py`` is
not tracing: always on, it tells the tests and the smoke which kernels a path
launched.)

Both stores take their adds through :func:`add`, which also notes each add in
the adding thread's open :func:`tally`: a CUDA graph runs no Python when it
replays, so the decode step records the counts its capture made and adds
them again on every replay (``nn/qwen2_vl.py StepGraphs``).

Usage::

    with hostprof("detok"):
        ...
    hostprof_reset(); ...; hostprof_dump("label")
    if ENABLED:
        count("decode_steps")
"""

from __future__ import annotations

import os
import threading
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


counters: dict[str, int] = defaultdict(int)
_counter_lock = threading.Lock()
_tallies = threading.local()


def add(store: dict[str, int], name: str, n: int = 1) -> None:
    """Add ``n`` to ``store[name]`` and note the add in this thread's open
    :func:`tally`, if any. The adapters' prep worker counts beside the main
    thread, so the add holds a lock."""
    with _counter_lock:
        store[name] += n
    log = getattr(_tallies, "log", None)
    if log is not None:
        log.append((store, name, n))


@contextmanager
def tally():
    """Yields the list of ``(store, name, n)`` that :func:`add` makes on this
    thread inside the block (another thread's adds are not in it)."""
    _tallies.log = log = []
    try:
        yield log
    finally:
        _tallies.log = None


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``; no-op when disabled."""
    if ENABLED:
        add(counters, name, n)


def counters_reset() -> None:
    with _counter_lock:
        counters.clear()
