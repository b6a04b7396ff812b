"""The port's native host image code, built with g++ and bound with ctypes.

``owc_resize.cpp`` is the antialiased bicubic resize; ``owc_jpeg.cpp`` (the
JPEG half of the JAX package's ``owc_loader.cpp``) decodes JPEG bytes with
libjpeg and resizes them with the same arithmetic. Each library is compiled
at first use into ``build/native/`` at the repository root, named by a hash
of its sources and flags, never into a package directory. Calls release the
GIL, so :func:`lmms_owc_tpu_torch.ops.image.resize_host_batch` and
:meth:`NativeImageLoader.decode_resize_batch` overlap them in threads. When
g++ is missing or a build fails (no ``jpeglib.h`` for the JPEG library),
:func:`native_resizer` returns None and the caller resizes with PIL, and
:func:`native_loader_available` is False, as the JAX package reports it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from lmms_owc_tpu_torch.utils import get_logger

log = get_logger(__name__)

__all__ = [
    "NativeImageLoader",
    "NativeResizer",
    "build_native_loader",
    "build_native_resizer",
    "native_loader_available",
    "native_resizer",
]

SOURCE = Path(__file__).resolve().parent / "owc_resize.cpp"
JPEG_SOURCE = Path(__file__).resolve().parent / "owc_jpeg.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")  # the JAX package's flags, so the pixels match

_LOCK = threading.Lock()
_RESIZER: NativeResizer | None = None
_BUILD_FAILED = False
_JPEG_LIB: ctypes.CDLL | None = None
_JPEG_FAILED = False


def _build(stem: str, source: Path, libs: tuple[str, ...] = ()) -> Path | None:
    """Compile ``source`` unless its library exists; its path, or None if the build fails."""
    key = " ".join(CXX_FLAGS + libs).encode() + source.read_bytes() + SOURCE.read_bytes()
    path = BUILD_DIR / f"{stem}_{hashlib.sha256(key).hexdigest()[:16]}.so"
    if path.exists():
        return path
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
            tmp = Path(tmpdir) / path.name
            subprocess.run(["g++", *CXX_FLAGS, str(source), "-o", str(tmp), *libs],
                           check=True, capture_output=True, timeout=300)
            os.replace(tmp, path)  # atomic: concurrent builders never load a partial file
    except (OSError, subprocess.CalledProcessError, subprocess.TimeoutExpired) as err:
        stderr = getattr(err, "stderr", b"") or b""
        log.warning("native %s build failed: %s %s", stem, err, stderr[:500])
        return None
    log.info("built %s at %s", stem, path)
    return path


def build_native_resizer() -> Path | None:
    """Compile the resize library unless it exists; its path, or None if the build fails."""
    return _build("libowcresize", SOURCE)


def build_native_loader() -> Path | None:
    """Compile the JPEG library (``-ljpeg``) unless it exists; its path, or None
    if the build fails."""
    return _build("libowcjpeg", JPEG_SOURCE, ("-ljpeg",))


class NativeResizer:
    """Bicubic resize (PIL's convention) over the native library."""

    def __init__(self, path: Path) -> None:
        lib = ctypes.CDLL(str(path))
        lib.owc_resize_u8.restype = ctypes.c_int
        lib.owc_resize_u8.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
        ]
        self._lib = lib

    def resize_u8(self, hwc: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
        """uint8 HWC -> uint8 CHW bicubic resize (PIL convention)."""
        hwc = np.ascontiguousarray(hwc, dtype=np.uint8)
        in_h, in_w, channels = hwc.shape
        out = np.empty((channels, out_h, out_w), dtype=np.uint8)
        rc = self._lib.owc_resize_u8(
            hwc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), in_h, in_w, channels,
            out_h, out_w, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        if rc != 0:
            raise ValueError("resize failed")
        return out


def native_resizer() -> NativeResizer | None:
    """The resizer, built at first use; None when it cannot be built."""
    global _RESIZER, _BUILD_FAILED
    with _LOCK:  # resize_host_batch calls this from several threads
        if _RESIZER is None and not _BUILD_FAILED:
            path = build_native_resizer()
            if path is None:
                _BUILD_FAILED = True
            else:
                _RESIZER = NativeResizer(path)
        return _RESIZER


def _jpeg_lib() -> ctypes.CDLL | None:
    global _JPEG_LIB, _JPEG_FAILED
    with _LOCK:
        if _JPEG_LIB is None and not _JPEG_FAILED:
            path = build_native_loader()
            try:
                lib = ctypes.CDLL(str(path)) if path is not None else None
            except OSError as err:  # built elsewhere, and this machine lacks libjpeg's shared library
                log.warning("native JPEG loader does not load: %s", err)
                lib = None
            if lib is None:
                _JPEG_FAILED = True
            else:
                lib.owc_jpeg_dims.restype = ctypes.c_int
                lib.owc_jpeg_dims.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                              ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
                lib.owc_decode_resize_jpeg.restype = ctypes.c_int
                lib.owc_decode_resize_jpeg.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
                                                       ctypes.POINTER(ctypes.c_uint8)]
                _JPEG_LIB = lib
        return _JPEG_LIB


def native_loader_available() -> bool:
    """Whether the JPEG library builds (g++ and libjpeg present) and loads."""
    return _jpeg_lib() is not None


class NativeImageLoader(NativeResizer):
    """JPEG decode + resize over the native libraries, with a thread pool for
    batches (the JAX package's ``NativeImageLoader``)."""

    def __init__(self, num_workers: int = 4) -> None:
        lib, resize = _jpeg_lib(), build_native_resizer()
        if lib is None or resize is None:
            raise RuntimeError("native loader unavailable (build failed)")
        super().__init__(resize)
        self._jpeg = lib
        self._pool = ThreadPoolExecutor(max_workers=num_workers)

    def jpeg_dims(self, data: bytes) -> tuple[int, int]:
        """(height, width) of a JPEG; ``ValueError`` if it does not decode."""
        h, w = ctypes.c_int(), ctypes.c_int()
        if self._jpeg.owc_jpeg_dims(data, len(data), ctypes.byref(h), ctypes.byref(w)) != 0:
            raise ValueError("not a decodable JPEG")
        return h.value, w.value

    def decode_resize(self, data: bytes, out_h: int, out_w: int) -> np.ndarray:
        """JPEG bytes -> uint8 [3, out_h, out_w]."""
        out = np.empty((3, out_h, out_w), dtype=np.uint8)
        rc = self._jpeg.owc_decode_resize_jpeg(data, len(data), out_h, out_w,
                                               out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        if rc != 0:
            raise ValueError("JPEG decode failed")
        return out

    def decode_resize_batch(self, jobs: list[tuple[bytes, int, int]]) -> list[np.ndarray]:
        """Decode + resize many JPEGs concurrently (the GIL is released inside each call)."""
        futures = [self._pool.submit(self.decode_resize, d, h, w) for d, h, w in jobs]
        return [f.result() for f in futures]
