"""Shared asset logic for the 10 classification benchmarks.

Behavior parity with the reference's per-dataset asset utils (e.g.
src/data/tasks/_classification/caltech101/assets/_caltech101_utils.py): doc hooks over
``visual`` (image path) / ``target`` (class name) columns, and a ``download()`` that
fetches the raw archive, resolves train/val/test splits, and saves an HF DatasetDict
under ``data/<name>``.

Split/metadata resolution (per benchmark):
  1. ``$LMMS_OWC_ASSETS_DIR/<name>/{metadata.csv,split_coop.csv}`` — operator
     override.
  2. The CoOp split tables VENDORED in-tree under ``<name>/assets/`` (copied
     verbatim from the reference's packaged CSVs) — the DEFAULT: a fresh offline
     checkout reproduces the paper's exact train/val/test splits. Covers all
     benchmarks except fgvc_aircraft (the reference ships no tables for it and
     uses the archive's official variant splits, as do we).
  3. ``split_zhou_*.json`` CoOp split artifacts, if present.
  4. Official split files shipped inside the archive (dtd, fgvc_aircraft, food101,
     oxford_pets, sun397 partitions).
  5. Seeded CoOp-style random split (50/20/30) — functional fallback, documented
     divergence from the reference's packaged splits.
"""

from __future__ import annotations

import os
import random
from pathlib import Path

from PIL import Image

__all__ = [
    "doc_to_text",
    "doc_to_text_multi_round",
    "doc_to_visual",
    "doc_to_target",
    "download_benchmark",
]


# ------------------------------------------------------------------- doc hooks


def doc_to_text(doc: dict, model_specific_kwargs: dict) -> str:
    pre = model_specific_kwargs.get("pre_prompt", "")
    prompt = model_specific_kwargs.get("prompt", "What's in the image?")
    post = model_specific_kwargs.get("post_prompt", "")
    return pre + prompt + post


def doc_to_text_multi_round(
    doc: dict,
    model_specific_kwargs: dict,
    round_idx: int | None = None,
    previous_round_results: list | None = None,
    last_round_info: dict | None = None,
):
    """Multi-round protocol: round 0 returns the first prompt string; later rounds
    return (visual, text, terminal, previous_round_results, last_round_info)."""
    if previous_round_results is None:
        previous_round_results = []

    pre = model_specific_kwargs.get("pre_prompt", "")
    post = model_specific_kwargs.get("post_prompt", "")
    prompts = model_specific_kwargs.get("prompts")
    if not isinstance(prompts, list) or len(prompts) < 2:
        raise ValueError("multi_round expects at least two prompts")

    if round_idx is None:
        return pre + prompts[0] + post
    if round_idx < len(prompts):
        return None, pre + prompts[round_idx] + post, False, previous_round_results, last_round_info
    return None, None, True, previous_round_results, last_round_info


def doc_to_visual(doc: dict) -> list:
    return [Image.open(doc["visual"]).convert("RGB")]


def doc_to_target(doc: dict) -> str:
    return doc["target"].replace("_", " ")


# ------------------------------------------------------------------- downloads

ARCHIVES: dict[str, list[dict]] = {
    "caltech101": [
        dict(url="https://data.caltech.edu/records/mzrjq-6wc02/files/caltech-101.zip"),
    ],
    "dtd": [dict(url="https://www.robots.ox.ac.uk/~vgg/data/dtd/download/dtd-r1.0.1.tar.gz")],
    "eurosat": [dict(url="http://madm.dfki.de/files/sentinel/EuroSAT.zip")],
    "fgvc_aircraft": [
        dict(url="https://www.robots.ox.ac.uk/~vgg/data/fgvc-aircraft/archives/fgvc-aircraft-2013b.tar.gz")
    ],
    "flowers102": [
        dict(url="https://www.robots.ox.ac.uk/~vgg/data/flowers/102/102flowers.tgz"),
        dict(url="https://www.robots.ox.ac.uk/~vgg/data/flowers/102/imagelabels.mat", raw=True),
        dict(url="https://www.robots.ox.ac.uk/~vgg/data/flowers/102/setid.mat", raw=True),
    ],
    "food101": [dict(url="http://data.vision.ee.ethz.ch/cvl/food-101.tar.gz")],
    "oxford_pets": [
        dict(url="https://www.robots.ox.ac.uk/~vgg/data/pets/data/images.tar.gz"),
        dict(url="https://www.robots.ox.ac.uk/~vgg/data/pets/data/annotations.tar.gz"),
    ],
    "stanford_cars": [
        dict(url="http://ai.stanford.edu/~jkrause/car196/cars_train.tgz"),
        dict(url="http://ai.stanford.edu/~jkrause/car196/cars_test.tgz"),
    ],
    "sun397": [
        dict(url="http://vision.princeton.edu/projects/2010/SUN/SUN397.tar.gz"),
        dict(url="https://vision.princeton.edu/projects/2010/SUN/download/Partitions.zip"),
    ],
    "ucf101": [
        dict(url="https://drive.google.com/uc?id=10Jqome3vtUA2keJkNanAiFpgbyC9Hc2O", gdrive=True)
    ],
}


def _fetch(name: str, cache_dir: str) -> Path:
    """Download + extract every archive for the benchmark; return the extraction root."""
    from lmms_owc_tpu_torch.utils import download_data, extract_data

    root = Path(cache_dir, "data", name)
    if root.exists():
        return root
    root.mkdir(parents=True, exist_ok=True)
    for spec in ARCHIVES[name]:
        url = spec["url"]
        filename = url.rsplit("/", 1)[-1].split("?")[0] or f"{name}.zip"
        if spec.get("gdrive"):
            filename = f"{name}.zip"
        target = root / filename
        download_data(url, target, from_gdrive=spec.get("gdrive", False))
        if not spec.get("raw"):
            extract_data(target, root)
            # Handle nested archives (caltech-101.zip contains a tar.gz).
            for inner in root.rglob("*.tar.gz"):
                if inner != target:
                    extract_data(inner, inner.parent)
    return root


# Where each benchmark's images land under our extraction root, relative to which
# the packaged split_coop.csv filenames resolve (the reference instead renames each
# extraction to a canonical dir, e.g. 101_ObjectCategories -> Caltech101 at
# _caltech101_utils.py:110-124; same images, different directory spelling).
_PACKAGED_IMAGE_SUBDIR = {
    "caltech101": "caltech-101/101_ObjectCategories",
    "dtd": "dtd/images",
    "eurosat": "2750",
    "flowers102": "jpg",
    "food101": "food-101/images",
    "oxford_pets": "images",
    "sun397": "SUN397",
    "ucf101": "UCF-101-midframes",
}


def _load_packaged_splits(name: str) -> dict | None:
    """Reference-schema split tables (metadata.csv + split_coop.csv [+ labels.csv]).

    Resolution order: ``$LMMS_OWC_ASSETS_DIR/<name>/`` override first, then the
    tables VENDORED in-tree under ``<name>/assets/`` (copied verbatim from the
    reference's packaged CoOp splits, e.g.
    src/data/tasks/_classification/caltech101/assets/split_coop.csv) — so a fresh
    offline checkout reproduces the paper's exact train/val/test splits by default.
    """
    candidates = []
    assets_dir = os.environ.get("LMMS_OWC_ASSETS_DIR")
    if assets_dir:
        candidates.append(Path(assets_dir) / name)
    candidates.append(Path(__file__).resolve().parent / name / "assets")
    for base in candidates:
        meta_fp = base / "metadata.csv"
        split_fp = base / "split_coop.csv"
        if not (meta_fp.exists() and split_fp.exists()):
            continue
        import pandas as pd

        meta = pd.read_csv(meta_fp)
        split = pd.read_csv(split_fp)
        labels_fp = base / "labels.csv"
        labels_map = None
        if labels_fp.exists():  # flowers102 / stanford_cars: filename -> class idx
            labels = pd.read_csv(labels_fp)
            labels_map = dict(zip(labels["filename"], labels["class_idx"]))
        return dict(
            folder_to_class=dict(zip(meta["folder_name"].astype(str), meta["class_name"])),
            idx_to_class=dict(zip(meta["idx"], meta["class_name"])),
            labels_map=labels_map,
            rows=list(zip(split["filename"], split["split"])),
        )
    return None


def _packaged_rel_to_path(name: str, root: Path, rel: str) -> Path:
    """Resolve a packaged split filename to the image under our extraction root."""
    if name == "oxford_pets":
        # The reference reorganizes the flat images/ dir into per-class folders
        # (_oxford_pets_utils.py:118-125); our extraction keeps it flat.
        return root / "images" / Path(rel).name
    if name == "stanford_cars":
        split_dir, fname = rel.split("/", 1)  # "train/05266.jpg" -> cars_train/
        return root / f"cars_{split_dir}" / fname
    subdir = _PACKAGED_IMAGE_SUBDIR.get(name)
    return root / subdir / rel if subdir else root / rel


def _load_coop_json_splits(name: str, root: Path) -> tuple | None:
    """Parse a CoOp ``split_zhou_*.json`` (the public split artifact the reference's
    CSVs were derived from): {"train"|"val"|"test": [[impath, label, classname], ...]}.

    Searched in $LMMS_OWC_ASSETS_DIR/<name>/ and the dataset root.
    """
    import json

    candidates = []
    assets_dir = os.environ.get("LMMS_OWC_ASSETS_DIR")
    if assets_dir:
        candidates += sorted(Path(assets_dir, name).glob("split_zhou_*.json"))
    candidates += sorted(root.glob("split_zhou_*.json")) + sorted(root.glob("*/split_zhou_*.json"))
    if not candidates:
        return None
    data = json.loads(Path(candidates[0]).read_text())

    split_rows = []
    path_to_class = {}
    for split_name in ("train", "val", "test"):
        for impath, _label, classname in data.get(split_name, []):
            split_rows.append((impath, split_name))
            path_to_class[impath] = classname
    return path_to_class, split_rows


def _coop_random_split(files: list[str], seed: int = 1234) -> list[tuple[str, str]]:
    """Seeded 50/20/30 train/val/test split (fallback when no official split exists)."""
    rnd = random.Random(seed)
    files = sorted(files)
    rnd.shuffle(files)
    n = len(files)
    n_train, n_val = int(n * 0.5), int(n * 0.2)
    return (
        [(f, "train") for f in files[:n_train]]
        + [(f, "val") for f in files[n_train : n_train + n_val]]
        + [(f, "test") for f in files[n_train + n_val :]]
    )


def _official_splits(name: str, root: Path) -> list[tuple[str, str]] | None:
    """Parse the dataset's own split files where the archive ships them."""
    if name == "dtd":
        labels = root / "dtd" / "labels"
        if labels.exists():
            rows = []
            for split, fname in [("train", "train1.txt"), ("val", "val1.txt"), ("test", "test1.txt")]:
                for line in (labels / fname).read_text().split():
                    rows.append((f"dtd/images/{line.strip()}", split))
            return rows
    if name == "food101":
        meta = root / "food-101" / "meta"
        if meta.exists():
            rows = []
            for split, fname in [("train", "train.txt"), ("test", "test.txt")]:
                for line in (meta / fname).read_text().split():
                    rows.append((f"food-101/images/{line.strip()}.jpg", split))
            return rows
    if name == "fgvc_aircraft":
        data = root / "fgvc-aircraft-2013b" / "data"
        if data.exists():
            rows = []
            for split, fname in [
                ("train", "images_variant_train.txt"),
                ("val", "images_variant_val.txt"),
                ("test", "images_variant_test.txt"),
            ]:
                for line in (data / fname).read_text().splitlines():
                    image_id, variant = line.split(" ", 1)
                    rows.append((f"fgvc-aircraft-2013b/data/images/{image_id}.jpg|{variant}", split))
            return rows
    if name == "oxford_pets":
        ann = root / "annotations"
        if ann.exists():
            rows = []
            for split, fname in [("train", "trainval.txt"), ("test", "test.txt")]:
                for line in (ann / fname).read_text().splitlines():
                    image_id = line.split(" ")[0]
                    rows.append((f"images/{image_id}.jpg", split))
            return rows
    return None


def _class_from_path(name: str, rel_path: str) -> str:
    """Derive the class name from the file path (dataset-specific conventions)."""
    rel = rel_path.split("|")[0]
    if name == "oxford_pets":
        stem = Path(rel).stem
        return "_".join(stem.split("_")[:-1]).lower()
    if name == "sun397":
        parts = Path(rel).parts
        return "_".join(p for p in parts[1:-1] if len(p) > 1) or parts[-2]
    if "|" in rel_path:  # fgvc_aircraft carries the variant label inline
        return rel_path.split("|", 1)[1]
    return Path(rel).parent.name


def download_benchmark(name: str, output_dir: str = "data", cache_dir: str = ".cache") -> None:
    """Fetch + convert one benchmark to an HF DatasetDict at ``output_dir/name``."""
    import datasets

    output_path = Path(output_dir) / name
    if output_path.exists():
        return

    root = _fetch(name, cache_dir)

    packaged = _load_packaged_splits(name)
    coop_json = None if packaged is not None else _load_coop_json_splits(name, root)
    rel_to_path = None
    if packaged is not None:
        split_rows = packaged["rows"]
        folder_to_class = packaged["folder_to_class"]
        labels_map = packaged["labels_map"]
        idx_to_class = packaged["idx_to_class"]

        def class_of(rel: str) -> str:
            if labels_map is not None:
                return idx_to_class[labels_map[rel]]
            parent = Path(rel).parent
            # sun397 keys folders by relative dir ("a/abbey"); the rest by name.
            return folder_to_class.get(
                parent.as_posix(), folder_to_class.get(parent.name, parent.name)
            )

        def rel_to_path(rel: str) -> Path:
            return _packaged_rel_to_path(name, root, rel)

    elif coop_json is not None:
        path_to_class, split_rows = coop_json

        def class_of(rel: str) -> str:
            return path_to_class[rel]

    else:
        split_rows = _official_splits(name, root)
        if split_rows is None:
            image_files = [
                str(p.relative_to(root))
                for p in root.rglob("*")
                if p.suffix.lower() in (".jpg", ".jpeg", ".png") and p.is_file()
            ]
            split_rows = _coop_random_split(image_files)

        def class_of(rel: str) -> str:
            return _class_from_path(name, rel)

    data = datasets.DatasetDict()
    rows_by_split: dict[str, list] = {}
    for rel, split in split_rows:
        rows_by_split.setdefault(split, []).append(rel)
    if rel_to_path is None:
        def rel_to_path(rel: str) -> Path:
            return root / rel.split("|")[0]

    for split, rels in rows_by_split.items():
        visuals = [str(rel_to_path(rel)) for rel in rels]
        targets = [class_of(rel) for rel in rels]
        data[split] = datasets.Dataset.from_dict({"visual": visuals, "target": targets})

    output_path.parent.mkdir(parents=True, exist_ok=True)
    data.save_to_disk(str(output_path))
