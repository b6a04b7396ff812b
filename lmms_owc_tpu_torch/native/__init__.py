"""The port's native host resizer: ``owc_resize.cpp`` built with g++ and bound with ctypes.

The library is compiled at first use into ``build/native/`` at the repository
root, named by a hash of the source, never into a package directory. Calls
release the GIL, so :func:`lmms_owc_tpu_torch.ops.image.resize_host_batch`
overlaps them in threads. When g++ is missing or the build fails,
:func:`native_resizer` returns None and the caller resizes with PIL, as the
JAX package does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

from lmms_owc_tpu_torch.utils import get_logger

log = get_logger(__name__)

__all__ = ["NativeResizer", "build_native_resizer", "native_resizer"]

SOURCE = Path(__file__).resolve().parent / "owc_resize.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")  # the JAX package's flags, so the pixels match

_LOCK = threading.Lock()
_RESIZER: NativeResizer | None = None
_BUILD_FAILED = False


def build_native_resizer() -> Path | None:
    """Compile the library unless it exists; its path, or None if the build fails."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes()).hexdigest()[:16]
    path = BUILD_DIR / f"libowcresize_{digest}.so"
    if path.exists():
        return path
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
            tmp = Path(tmpdir) / path.name
            subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                           check=True, capture_output=True, timeout=300)
            os.replace(tmp, path)  # atomic: concurrent builders never load a partial file
    except (OSError, subprocess.CalledProcessError, subprocess.TimeoutExpired) as err:
        stderr = getattr(err, "stderr", b"") or b""
        log.warning("native resizer build failed: %s %s", err, stderr[:500])
        return None
    log.info("built native resizer at %s", path)
    return path


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
