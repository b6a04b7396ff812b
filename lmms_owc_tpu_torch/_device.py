"""Device selection and float32 matmul precision for the port."""

from __future__ import annotations

import threading

import torch

__all__ = ["capture_lock", "get_device", "no_tf32", "synchronize"]

# Held while a stream of this process captures a CUDA graph (the decode step's
# segments, ``nn/qwen2_vl.py StepGraphs``): synchronizing the device while a
# stream captures is invalid and ends the capture, so :func:`synchronize`
# waits for the capture to end. Another thread's kernels may run meanwhile.
capture_lock = threading.Lock()


def synchronize(device: torch.device) -> None:
    """``torch.cuda.synchronize(device)``, never during a graph capture."""
    with capture_lock:
        torch.cuda.synchronize(device)


def get_device(device: str | torch.device | None = None) -> torch.device:
    """Resolve ``device`` (default ``"cuda"``) to a ``torch.device``.

    Raises ``RuntimeError`` when a CUDA device is asked for and none is usable:
    nothing silently carries on on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not available")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {dev} requested but only {torch.cuda.device_count()} CUDA devices exist"
            )
    return dev


def no_tf32() -> None:
    """Run float32 matmuls and convolutions in full float32, never TF32.

    The JAX reference runs its float32 parity at "highest" precision; TF32 keeps
    about three decimal digits, which would make float32 tolerances meaningless.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
