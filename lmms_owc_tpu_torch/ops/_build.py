"""Build and load the port's CUDA kernels (``lmms_owc_tpu_torch/csrc/*.cu``).

The sources are compiled at first use with ``nvcc`` for ``sm_90a``, one
``nvcc`` per source, all started together, and linked into one shared library
with a plain C interface, loaded with :mod:`ctypes`. The library
lands in ``build/kernels/`` at the repository root, named by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one loads as
is. Nothing outside the repository and the CUDA toolkit is included. A missing
``nvcc`` or a failed build raises :class:`KernelBuildError`; there is no
fallback.

Each C entry takes a pointer to an argument struct (mirrored below as a
``ctypes.Structure``) and the CUDA stream, and returns ``cudaGetLastError()``.
``owc_flash_plan(heads, kv_heads, lq, head_dim, int out[2])`` writes the flash kernel's
Hopper plan (warpgroups per CTA, CTAs per KV head) and launches nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = [
    "BUILD_DIR",
    "DecodeArgs",
    "FlashArgs",
    "Int4MatmulArgs",
    "KernelBuildError",
    "build",
    "load_library",
    "ptxas_report",
]

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)
# Where nvcc is looked for when it is not on PATH.
NVCC_CANDIDATES = ("/usr/local/cuda/bin/nvcc",)

_LIBRARY: ctypes.CDLL | None = None
_LOAD_LOCK = threading.Lock()


class KernelBuildError(RuntimeError):
    """The CUDA kernels could not be built or loaded."""


class FlashArgs(ctypes.Structure):
    """Mirror of ``FlashArgs`` in csrc/flash_attn.cu (field order and types)."""

    _fields_ = [
        ("q", ctypes.c_void_p), ("k", ctypes.c_void_p), ("v", ctypes.c_void_p),
        ("o", ctypes.c_void_p),
        ("q_sb", ctypes.c_longlong), ("q_sh", ctypes.c_longlong), ("q_sl", ctypes.c_longlong),
        ("k_sb", ctypes.c_longlong), ("k_sh", ctypes.c_longlong), ("k_sl", ctypes.c_longlong),
        ("v_sb", ctypes.c_longlong), ("v_sh", ctypes.c_longlong), ("v_sl", ctypes.c_longlong),
        ("o_sb", ctypes.c_longlong), ("o_sh", ctypes.c_longlong), ("o_sl", ctypes.c_longlong),
        ("mask_run", ctypes.c_void_p), ("mask", ctypes.c_void_p),
        ("cos", ctypes.c_void_p), ("sin", ctypes.c_void_p),
        ("rope_sb", ctypes.c_longlong),
        ("batch", ctypes.c_int), ("heads", ctypes.c_int), ("kv_heads", ctypes.c_int),
        ("lq", ctypes.c_int), ("lk", ctypes.c_int), ("head_dim", ctypes.c_int),
        ("causal", ctypes.c_int), ("dtype", ctypes.c_int),
        ("scale_log2", ctypes.c_float),
        ("k_rot", ctypes.c_void_p),
        ("warpgroups", ctypes.c_int),
    ]


class DecodeArgs(ctypes.Structure):
    """Mirror of ``DecodeArgs`` in csrc/decode_attn.cu (field order and types)."""

    _fields_ = [
        ("q", ctypes.c_void_p), ("k_cache", ctypes.c_void_p), ("v_cache", ctypes.c_void_p),
        ("mask", ctypes.c_void_p), ("o", ctypes.c_void_p),
        ("k_scale", ctypes.c_void_p), ("v_scale", ctypes.c_void_p),
        ("layers", ctypes.c_int), ("batch", ctypes.c_int), ("heads", ctypes.c_int),
        ("kv_heads", ctypes.c_int), ("seq", ctypes.c_int), ("head_dim", ctypes.c_int),
        ("layer", ctypes.c_int), ("dtype", ctypes.c_int), ("cache_int8", ctypes.c_int),
        ("scale", ctypes.c_float),
        ("splits", ctypes.c_int), ("split_keys", ctypes.c_int),
        ("workspace", ctypes.c_void_p),
    ]


class Int4MatmulArgs(ctypes.Structure):
    """Mirror of ``Int4MatmulArgs`` in csrc/int4_matmul.cu (field order and types)."""

    _fields_ = [
        ("x", ctypes.c_void_p), ("q4", ctypes.c_void_p), ("scale", ctypes.c_void_p),
        ("out", ctypes.c_void_p), ("workspace", ctypes.c_void_p),
        ("m", ctypes.c_int), ("n", ctypes.c_int), ("k", ctypes.c_int),
        ("groups", ctypes.c_int), ("dtype", ctypes.c_int),
        ("splits", ctypes.c_int), ("split_bytes", ctypes.c_int), ("block_n", ctypes.c_int),
    ]


# (C entry, its argument struct): each takes (const Args*, cudaStream_t) -> int.
_ENTRIES = (
    ("owc_flash_attention", FlashArgs),
    ("owc_gqa_decode_attention", DecodeArgs),
    ("owc_int4_matmul", Int4MatmulArgs),
)


def _sources() -> list[Path]:
    return sorted(
        p for pattern in ("*.cu", "*.cuh", "*.h") for p in CSRC_DIR.glob(pattern)
    )


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for candidate in NVCC_CANDIDATES:
        if Path(candidate).exists():
            return candidate
    raise KernelBuildError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libowc_kernels_{digest.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Run the commands side by side; raise with the first failure's output,
    else return each command's standard error."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for cmd in cmds]
    errors = [proc.communicate()[1] for proc in procs]  # waits for every process
    for cmd, proc, err in zip(cmds, procs, errors):
        if proc.returncode != 0:
            raise KernelBuildError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{err[-4000:]}")
    return errors


def ptxas_report(path: Path | None = None) -> str:
    """What ``ptxas -v`` said about each kernel of the library at ``path`` (the
    current one by default): registers, shared memory, spills. Written by
    :func:`build`; empty when the library was built elsewhere."""
    report = (path or library_path()).with_suffix(".ptxas.txt")
    return report.read_text() if report.exists() else ""


def build() -> Path:
    """Compile the sources unless the library for them exists; returns its path."""
    path = library_path()
    if path.exists():
        return path
    nvcc = _nvcc()
    units = [p for p in _sources() if p.suffix == ".cu"]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objects = [str(Path(tmpdir) / f"{p.stem}.o") for p in units]
        reports = _run_all([
            [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-I", str(CSRC_DIR), "-c", str(src), "-o", obj]
            for src, obj in zip(units, objects)
        ])
        tmp = str(Path(tmpdir) / "lib.so")
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objects]])
        path.with_suffix(".ptxas.txt").write_text("".join(reports))
        os.replace(tmp, path)  # atomic: concurrent builders never load a partial file
    return path


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library; raises if that fails."""
    global _LIBRARY
    if _LIBRARY is not None:
        return _LIBRARY
    with _LOAD_LOCK:  # the vision encode may first run in a pipeline worker thread
        if _LIBRARY is not None:
            return _LIBRARY
        lib = ctypes.CDLL(str(build()))
        for name, args in _ENTRIES:
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.POINTER(args), ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.owc_flash_plan.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
        lib.owc_flash_plan.restype = None
        _LIBRARY = lib
        return _LIBRARY
