"""Asset utils for the stanford_cars open-world classification benchmark.

Content parity with reference src/data/tasks/_classification/stanford_cars/assets/: same
doc hooks (columns ``visual`` = image path, ``target`` = class name) and the same
download -> HF-dataset-on-disk flow. Split/metadata resolution order:
  1. ``$LMMS_OWC_ASSETS_DIR/stanford_cars/metadata.csv`` + ``split_coop.csv`` (the
     reference's packaged CoOp splits; exact parity when provided),
  2. the dataset's official split files inside the archive (when it ships any),
  3. a seeded CoOp-style random split (documented divergence).
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

_COMMON = Path(__file__).resolve().parents[2] / "_assets_common.py"
_spec = importlib.util.spec_from_file_location("lmms_owc_tpu_torch_classification_common", _COMMON)
_common = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_common)

__all__ = ["doc_to_text", "doc_to_text_multi_round", "doc_to_visual", "doc_to_target", "download"]

doc_to_text = _common.doc_to_text
doc_to_text_multi_round = _common.doc_to_text_multi_round
doc_to_visual = _common.doc_to_visual
doc_to_target = _common.doc_to_target


def download(output_dir: str = "data", cache_dir: str = ".cache") -> None:
    _common.download_benchmark("stanford_cars", output_dir=output_dir, cache_dir=cache_dir)
