"""Dataset download / extraction / conversion helpers.

Contract parity with reference src/utils/_data_utils.py:122-187 (download_data /
extract_data with zip+tar path-traversal checks) and :251-288
(load_image_folder_as_hf_dataset). Used by each benchmark's ``download()`` asset util.

The JAX package's ``utils/_data.py``; ``requests`` and ``gdown`` are imported
only inside the functions, so importing the port never needs them.
"""

from __future__ import annotations

import tarfile
import zipfile
from pathlib import Path

from lmms_owc_tpu_torch.utils._logging import get_logger

log = get_logger(__name__)

__all__ = ["download_data", "extract_data", "load_image_folder_as_hf_dataset", "write_jsonl"]


def download_data(url: str, target: str | Path, from_gdrive: bool = False) -> Path:
    """Download ``url`` to ``target`` (requests stream, or gdown for Google Drive)."""
    target = Path(target)
    if target.exists():
        log.info("download target %s already exists, skipping", target)
        return target
    target.parent.mkdir(parents=True, exist_ok=True)
    if from_gdrive:
        try:
            import gdown  # optional dependency

            gdown.download(url, str(target), quiet=False)
            return target
        except ImportError as err:
            raise RuntimeError("gdown is required for Google Drive downloads") from err
    import requests

    with requests.get(url, stream=True, timeout=600) as r:
        r.raise_for_status()
        with open(target, "wb") as f:
            for chunk in r.iter_content(chunk_size=1 << 20):
                f.write(chunk)
    return target


def _is_within(base: Path, target: Path) -> bool:
    try:
        target.resolve().relative_to(base.resolve())
        return True
    except ValueError:
        return False


def extract_data(archive: str | Path, target_dir: str | Path) -> Path:
    """Extract a zip/tar archive with path-traversal protection."""
    archive = Path(archive)
    target_dir = Path(target_dir)
    target_dir.mkdir(parents=True, exist_ok=True)
    if zipfile.is_zipfile(archive):
        with zipfile.ZipFile(archive) as zf:
            for member in zf.namelist():
                if not _is_within(target_dir, target_dir / member):
                    raise ValueError(f"unsafe path in zip archive: {member}")
            zf.extractall(target_dir)
    elif tarfile.is_tarfile(archive):
        with tarfile.open(archive) as tf:
            for member in tf.getmembers():
                if not _is_within(target_dir, target_dir / member.name):
                    raise ValueError(f"unsafe path in tar archive: {member.name}")
            tf.extractall(target_dir)
    else:
        raise ValueError(f"unsupported archive format: {archive}")
    return target_dir


def load_image_folder_as_hf_dataset(
    image_dir: str | Path,
    metadata: "object | None" = None,
    split: str | None = None,
    num_proc: int | None = None,
):
    """Build an HF ``datasets.Dataset`` from an image folder plus a metadata table.

    ``metadata`` is a pandas DataFrame with at least ``image_path`` (relative to
    ``image_dir``) plus arbitrary label columns (class_name, split, ...).
    """
    import datasets

    image_dir = Path(image_dir)
    if metadata is None:
        return datasets.load_dataset("imagefolder", data_dir=str(image_dir), split=split)

    records = metadata.to_dict(orient="list")
    paths = [str(image_dir / p) for p in records.pop("image_path")]
    ds = datasets.Dataset.from_dict({"image": paths, **records})
    ds = ds.cast_column("image", datasets.Image())
    if split is not None and "split" in ds.column_names:
        ds = ds.filter(lambda ex: ex["split"] == split, num_proc=num_proc)
    return ds


def write_jsonl(path: str | Path, rows: list[dict]) -> None:
    import json

    from lmms_owc_tpu_torch.utils._core import convert_non_serializable

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        for row in rows:
            f.write(json.dumps(row, default=convert_non_serializable, ensure_ascii=False))
            f.write("\n")
