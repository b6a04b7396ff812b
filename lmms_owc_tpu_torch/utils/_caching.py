"""Request-construction cache (the JAX package's ``utils._caching``).

Built ``TaskInstance`` lists are dill-pickled under ``lmms_owc_tpu_torch/.cache/requests``, keyed by
task + shots + rank + world-size + chat-template/system-prompt hash, so re-runs skip
document iteration and prompt construction.
"""

from __future__ import annotations

import os
import tempfile
from pathlib import Path

import dill

from lmms_owc_tpu_torch.utils._logging import get_logger

log = get_logger(__name__)

__all__ = ["load_from_cache", "save_to_cache", "delete_cache", "request_cache_dir"]

_OVERRIDE_PATH = os.environ.get("LMMS_OWC_TPU_DATASET_CACHE")
FILE_SUFFIX = ".pickle"


def request_cache_dir() -> Path:
    if _OVERRIDE_PATH:
        return Path(_OVERRIDE_PATH)
    return Path(__file__).resolve().parent.parent / ".cache" / "requests"


def _path_for(file_name: str) -> Path:
    return request_cache_dir() / f"{file_name}{FILE_SUFFIX}"


def load_from_cache(file_name: str):
    path = _path_for(file_name)
    if not path.exists():
        return None
    try:
        with open(path, "rb") as f:
            return dill.load(f)
    except Exception as err:  # corrupt cache — treat as miss
        log.warning("failed to load request cache %s: %s", path, err)
        return None


def save_to_cache(file_name: str, obj) -> None:
    """Write ``obj`` under ``file_name``. The ranks of one model group share
    a key and may write it at once: each writes a file of its own and renames
    it into place, so a reader never sees a torn file."""
    path = _path_for(file_name)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=path.name, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            dill.dump(obj, f)
        os.replace(tmp, path)
    except BaseException:
        Path(tmp).unlink(missing_ok=True)
        raise
    log.debug("saved request cache to %s", path)


def delete_cache(key: str = "") -> None:
    directory = request_cache_dir()
    if not directory.exists():
        return
    for path in directory.iterdir():
        if path.name.startswith(key) and path.suffix == FILE_SUFFIX:
            path.unlink()
