"""The paper's benchmarks in the port's task directory: the classification
asset pipeline (split resolution, dataset conversion, the vendored CoOp split
tables) and the example tasks' hooks, on the port's copy of
``lmms_owc_tpu/tasks/configs``, as ``tests/test_classification_assets.py``
and ``tests/test_example_tasks.py`` hold the JAX tree; the copy itself is
pinned to the original (every non-Python file byte for byte, every Python
file after the import rename); and ``caltech101`` runs end to end through
the port's CLI on the CPU from a synthesised image folder.
"""

import hashlib
import importlib.util
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from tests.test_classification_assets import VENDORED_SPLIT_PINS, _make_images

REPO_ROOT = Path(__file__).resolve().parent.parent
BENCHMARKS = ("caltech101", "dtd", "eurosat", "fgvc_aircraft", "flowers102", "food101", "oxford_pets",
              "stanford_cars", "sun397", "ucf101")
TREES = {"jax": REPO_ROOT / "lmms_owc_tpu" / "tasks" / "configs",
         "port": REPO_ROOT / "lmms_owc_tpu_torch" / "tasks" / "configs"}


def _rename(text: str) -> str:
    """The copy's only change: the JAX package's name becomes the port's (the
    imports, and the spec name of the shared classification module)."""
    return re.sub(r"\blmms_owc_tpu(?!_torch)", "lmms_owc_tpu_torch", text)


def _files(root: Path) -> set[str]:
    return {str(p.relative_to(root)) for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def _load(tree: str, rel: str, name: str):
    spec = importlib.util.spec_from_file_location(f"{name}_{tree}", TREES[tree] / rel)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module", params=["port", "jax"])
def common(request):
    return _load(request.param, "classification/_assets_common.py", "clf_common_test")


@pytest.fixture(scope="module")
def port_common():
    return _load("port", "classification/_assets_common.py", "clf_common_test")


# ------------------------------------------------------------------- the copy


def test_copy_is_identical_but_for_the_package_name():
    jax_files, port_files = _files(TREES["jax"]), _files(TREES["port"])
    assert jax_files == port_files and len(port_files) > 140
    renamed = 0
    for rel in sorted(jax_files):
        src, dst = (TREES["jax"] / rel).read_bytes(), (TREES["port"] / rel).read_bytes()
        if rel.endswith(".py"):
            assert dst.decode() == _rename(src.decode()), rel
            renamed += src != dst
        else:
            assert dst == src, rel
    # _assets_common.py, the ten benchmarks' utils and three example utils name the package.
    assert renamed == 14
    assert "lmms_owc_tpu." not in (TREES["port"] / "classification" / "_assets_common.py").read_text()


@pytest.mark.parametrize("name", BENCHMARKS)
def test_benchmark_utils_load_the_ports_common_module(name):
    utils = _load("port", f"classification/{name}/assets/_{name}_utils.py", f"_{name}_utils")
    assert utils.doc_to_target.__module__ == "lmms_owc_tpu_torch_classification_common"
    assert utils.doc_to_target({"target": "red_panda"}) == "red panda"
    assert utils.doc_to_text({}, {"prompt": "What type of object is in this photo?"}) == \
        "What type of object is in this photo?"


# ----------------------------------------------------------- split resolution


def test_coop_json_splits(common, tmp_path):
    root = tmp_path / ".cache" / "data" / "toybench"
    rels = _make_images(root, {"cat": 3, "dog": 3})
    split = {"train": [[rels[0], 0, "cat"], [rels[3], 1, "dog"]], "val": [[rels[1], 0, "cat"]],
             "test": [[rels[2], 0, "cat"], [rels[4], 1, "dog"], [rels[5], 1, "dog"]]}
    (root / "split_zhou_ToyBench.json").write_text(json.dumps(split))
    path_to_class, split_rows = common._load_coop_json_splits("toybench", root)
    assert len(split_rows) == 6
    assert path_to_class[rels[2]] == "cat"
    assert sum(1 for _, s in split_rows if s == "test") == 3


def test_coop_random_split_deterministic(common):
    files = [f"images/c/{i}.jpg" for i in range(20)]
    a = common._coop_random_split(files, seed=1234)
    assert a == common._coop_random_split(files, seed=1234)
    counts: dict = {}
    for _, split in a:
        counts[split] = counts.get(split, 0) + 1
    assert counts == {"train": 10, "val": 4, "test": 6}


def test_official_split_parsers_dtd(common, tmp_path):
    labels = tmp_path / "dtd" / "labels"
    labels.mkdir(parents=True)
    (labels / "train1.txt").write_text("banded/banded_0001.jpg\n")
    (labels / "val1.txt").write_text("banded/banded_0002.jpg\n")
    (labels / "test1.txt").write_text("dotted/dotted_0001.jpg\n")
    rows = common._official_splits("dtd", tmp_path)
    assert ("dtd/images/banded/banded_0001.jpg", "train") in rows
    assert ("dtd/images/dotted/dotted_0001.jpg", "test") in rows


def test_class_from_path_conventions(common):
    assert common._class_from_path("oxford_pets", "images/Abyssinian_12.jpg") == "abyssinian"
    assert common._class_from_path("food101", "food-101/images/apple_pie/1.jpg") == "apple_pie"
    assert common._class_from_path("fgvc_aircraft", "data/images/0034309.jpg|707-320") == "707-320"


# ----------------------------------------------------------- conversion


def _converted(common, tmp_path: Path, monkeypatch, tree: str):
    import datasets

    cache = tmp_path / ".cache"
    root = cache / "data" / "caltech101"
    if not root.exists():
        rels = _make_images(root, {"accordion": 2, "anchor": 2})
        split = {"train": [[rels[0], 0, "accordion"]], "val": [[rels[2], 1, "anchor"]],
                 "test": [[rels[1], 0, "accordion"], [rels[3], 1, "anchor"]]}
        (root / "split_zhou_Caltech101.json").write_text(json.dumps(split))
    monkeypatch.chdir(tmp_path)
    # The vendored tables outrank split_zhou JSONs by default; disable them to
    # exercise the JSON path in isolation, as the JAX test does.
    monkeypatch.setattr(common, "_load_packaged_splits", lambda name: None)
    common.download_benchmark("caltech101", output_dir=f"data_{tree}", cache_dir=str(cache))
    return datasets.load_from_disk(str(tmp_path / f"data_{tree}" / "caltech101"))


def test_download_benchmark_with_coop_json(common, tmp_path, monkeypatch):
    ds = _converted(common, tmp_path, monkeypatch, "x")
    assert set(ds.keys()) == {"train", "val", "test"}
    assert len(ds["test"]) == 2
    assert sorted(set(ds["test"]["target"])) == ["accordion", "anchor"]
    assert all(Path(v).exists() for v in ds["test"]["visual"])


def test_conversion_equals_the_jax_trees(tmp_path, monkeypatch):
    """The same synthesised folder converted by both trees: the same rows."""
    got = _converted(_load("port", "classification/_assets_common.py", "conv"), tmp_path, monkeypatch, "port")
    want = _converted(_load("jax", "classification/_assets_common.py", "conv"), tmp_path, monkeypatch, "jax")
    for split in ("train", "val", "test"):
        assert got[split].to_dict() == want[split].to_dict()


def test_synthesised_folder_converts_through_the_assets_override(tmp_path):
    """The chip smoke's caltech101 folder: the task's download hook reads the
    split tables through ``LMMS_OWC_ASSETS_DIR`` (no monkeypatching) and
    writes ``data/caltech101`` with the synthesised test classes."""
    import datasets

    folder = chip_smoke.write_classification_folder(tmp_path)
    path = chip_smoke.convert_classification_folder(folder)
    ds = datasets.load_from_disk(str(path))
    assert path == tmp_path / "data" / "caltech101"
    assert ds["test"]["target"] == ["face", "face", "leopard", "leopard", "accordion", "accordion",
                                    "airplane", "airplane"] == folder["test_classes"]
    assert len(ds["train"]) == 4 and all(Path(v).exists() for v in ds["test"]["visual"])


# ------------------------------------------------------ vendored split tables


@pytest.mark.parametrize("name", sorted(VENDORED_SPLIT_PINS))
def test_vendored_tables_load_by_default(port_common, name, monkeypatch):
    monkeypatch.delenv("LMMS_OWC_ASSETS_DIR", raising=False)
    packaged = port_common._load_packaged_splits(name)
    assert packaged is not None, f"{name}: vendored split tables not found"
    rows = packaged["rows"]
    digest = hashlib.sha256("\n".join(f"{s},{f}" for f, s in rows).encode()).hexdigest()[:16]
    counts: dict = {}
    for _, s in rows:
        counts[s] = counts.get(s, 0) + 1
    assert (digest, counts) == VENDORED_SPLIT_PINS[name]


@pytest.mark.parametrize("name", sorted(VENDORED_SPLIT_PINS))
def test_every_row_resolves_to_a_metadata_class(port_common, name, monkeypatch):
    monkeypatch.delenv("LMMS_OWC_ASSETS_DIR", raising=False)
    packaged = port_common._load_packaged_splits(name)
    classes = set(packaged["idx_to_class"].values())
    f2c, labels_map, i2c = packaged["folder_to_class"], packaged["labels_map"], packaged["idx_to_class"]
    for rel, _split in packaged["rows"]:
        if labels_map is not None:
            cls = i2c[labels_map[rel]]
        else:
            parent = Path(rel).parent
            cls = f2c.get(parent.as_posix(), f2c.get(parent.name))
        assert cls in classes, f"{name}: {rel} resolves to {cls!r}"


def test_packaged_rel_to_path_conventions(port_common):
    root = Path("/data/x")
    assert port_common._packaged_rel_to_path("caltech101", root, "Faces/image_0274.jpg") == (
        root / "caltech-101/101_ObjectCategories/Faces/image_0274.jpg")
    assert port_common._packaged_rel_to_path("oxford_pets", root, "Abyssinian/Abyssinian_122.jpg") == (
        root / "images/Abyssinian_122.jpg")
    assert port_common._packaged_rel_to_path("stanford_cars", root, "train/05266.jpg") == root / "cars_train/05266.jpg"
    assert port_common._packaged_rel_to_path("sun397", root, "a/abbey/sun_x.jpg") == root / "SUN397/a/abbey/sun_x.jpg"
    assert port_common._load_packaged_splits("fgvc_aircraft") is None  # no tables, as in the reference


# ------------------------------------------------------------ example tasks


@pytest.fixture(scope="module", params=["port", "jax"])
def examples(request):
    tree = request.param
    return {name: _load(tree, rel, f"{name}_utils_test") for name, rel in (
        ("ai2d", "examples/ai2d/_ai2d_utils.py"), ("mmmu", "examples/mmmu/_mmmu_utils.py"),
        ("ocr", "examples/ocr_bench/_ocr_bench_utils.py"), ("muir", "examples/muirbench/_muirbench_utils.py"))}


def test_example_tasks_indexed_in_the_port():
    from lmms_owc_tpu_torch.tasks import TaskManager

    tm = TaskManager()
    for task in ["ai2d", "mmmu_val", "muirbench", "ocr_bench"]:
        assert task in tm.all_subtasks, task
        assert "lmms_owc_tpu_torch" in tm.task_index[task]["yaml_path"]


def test_ai2d_hooks(examples):
    ai2d = examples["ai2d"]
    doc = {"question": "What is shown?", "options": ["cat", "dog"]}
    assert ai2d.doc_to_text(doc, {"prompt_format": "mcq", "pre_prompt": "", "post_prompt": "\nAnswer:"}) == \
        "What is shown?\nA. cat\nB. dog\nAnswer:"
    doc = {"options": ["cat", "dog"], "answer": "1"}
    assert ai2d.doc_to_target(doc, "mcq") == "B" and ai2d.doc_to_target(doc, "qa") == "dog"
    f = ai2d.CustomMultiChoiceRegexFilter(regex_pattern=r"([A-Z])\.")
    assert f.apply([["B. dog"], ["the dog"]], [{}, {}]) == ["B", "the dog"]
    assert type(f).__mro__[1].__module__.startswith(
        "lmms_owc_tpu_torch" if "port" in ai2d.__name__ else "lmms_owc_tpu.")


def test_mmmu_parsing(examples):
    mmmu = examples["mmmu"]
    index2ans = {"A": "red", "B": "blue"}
    assert mmmu._parse_multi_choice_response("The answer is (B)", ["A", "B"], index2ans) == "B"
    assert mmmu._parse_multi_choice_response("B.", ["A", "B"], index2ans) == "B"
    assert mmmu._parse_multi_choice_response("I believe the color shown in the image is blue overall", ["A", "B"],
                                             index2ans) == "B"
    assert 1234.5 in mmmu._parse_open_response("The total is 1,234.5")
    assert mmmu._eval_open("42", [42.0]) and mmmu._eval_open(["cat", "dog"], ["the dog barks"])
    assert not mmmu._eval_open("cat", ["dog"])
    results = [
        {"id": "validation_Art_1", "subdomain": "Art", "question_type": "multiple-choice", "answer": "A",
         "parsed_pred": ["A"]},
        {"id": "validation_Art_2", "subdomain": "Art", "question_type": "multiple-choice", "answer": "B",
         "parsed_pred": ["A"]},
        {"id": "validation_Math_1", "subdomain": "Math", "question_type": "open", "answer": "42",
         "parsed_pred": [[42.0]]},
    ]
    assert mmmu.aggregate_results(results) == pytest.approx(2 / 3, abs=1e-4)
    out = mmmu.process_results({"id": "validation_Art_1", "question_type": "multiple-choice",
                                "options": "['red', 'blue']", "answer": "A"}, ["(A)"])
    assert out["mmmu_acc"]["parsed_pred"] == ["A"] and out["mmmu_acc"]["subdomain"] == "Art"


def test_ocr_bench_and_muirbench(examples):
    ocr, muir = examples["ocr"], examples["muir"]
    out = ocr.process_results({"answer": "hello", "dataset": "IIIT5K", "question_type": "Regular Text Recognition"},
                              ["it says Hello there"])
    out2 = ocr.process_results({"answer": "x^2", "dataset": "HME100k",
                                "question_type": "Handwritten Mathematical Expression Recognition"}, ["x ^ 2"])
    assert out["ocr_bench_accuracy"]["score"] == out2["ocr_bench_accuracy"]["score"] == 1
    assert ocr.aggregate_accuracy([out["ocr_bench_accuracy"], out2["ocr_bench_accuracy"]]) == pytest.approx(2 / 1000)
    assert muir.aggregate_muirbench_score([{"pred": "A", "task": "t1", "answer": "A"},
                                           {"pred": "B", "task": "t1", "answer": "A"}]) == 0.5


def test_mmmu_judge_helper_through_the_ports_pipeline(monkeypatch):
    """The judge aggregation with no API key falls back to the port's own
    ``textual_inclusion_llama32`` (the heuristic judge without a checkpoint)."""
    mmmu = _load("port", "examples/mmmu/_mmmu_utils.py", "mmmu_judge")
    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    monkeypatch.delenv("LMMS_OWC_JUDGE_PATH", raising=False)
    monkeypatch.setenv("LMMS_OWC_SCORING_DEVICE", "cpu")
    score = mmmu.aggregate_judge_results([{"answer": "A", "response": "the answer is A"},
                                          {"answer": "B", "response": "the answer is B"}])
    assert 0.0 <= score <= 1.0
    import sys

    assert "lmms_owc_tpu_torch.pipelines.text" in sys.modules


# ---------------------------------------------------------------- the CLI


@pytest.fixture(scope="module")
def tiny_checkpoint(tmp_path_factory):
    from tests.test_torch_checkpoint import _build

    path = tmp_path_factory.mktemp("bench_ckpt")
    _build(path, "qwen2-vl-tiny")
    return path


def test_caltech101_through_the_cli_on_the_cpu(tiny_checkpoint, tmp_path, monkeypatch):
    """The chip smoke's benchmark run at a tiny size: ``python -m
    lmms_owc_tpu_torch.eval_model --tasks caltech101`` (``device=cpu``) in a
    working directory holding the converted folder, scored with a tiny
    MiniLM checkpoint; 8 documents, targets the synthesised classes, the four
    metrics finite and the base prompt's 64 tokens."""
    monkeypatch.setattr(chip_smoke, "MINILM_CONFIG", dict(chip_smoke.MINILM_CONFIG, hidden_size=48,
                                                          num_hidden_layers=2, num_attention_heads=4,
                                                          intermediate_size=64))
    sbert = tmp_path / "minilm"
    sbert.mkdir()
    chip_smoke.write_sbert_checkpoint(torch.device("cpu"), sbert)
    monkeypatch.setenv("LMMS_OWC_SBERT_PATH", str(sbert))
    monkeypatch.setenv("LMMS_OWC_SCORING_DEVICE", "cpu")
    work = tmp_path / "work"
    work.mkdir()
    summary = chip_smoke.run_cli_benchmark(torch.device("cpu"), "qwen2-vl-tiny", tiny_checkpoint, work,
                                           model_args="dtype=float32,device=cpu")
    assert summary["docs"] == 8 and summary["max_new_tokens"] == 64
    assert summary["dataset"] == "data/caltech101"
    assert set(summary["metrics"]) == set(chip_smoke.BENCHMARK_METRICS)
    assert all(np.isfinite(v) for v in summary["metrics"].values())


def test_caltech101_cli_fails_on_the_fallback_encoder(tiny_checkpoint, tmp_path, monkeypatch):
    monkeypatch.delenv("LMMS_OWC_SBERT_PATH", raising=False)
    monkeypatch.setenv("LMMS_OWC_SCORING_DEVICE", "cpu")
    with pytest.raises(AssertionError, match="fallback encoder"):
        chip_smoke.run_cli_benchmark(torch.device("cpu"), "qwen2-vl-tiny", tiny_checkpoint, tmp_path,
                                     model_args="dtype=float32,device=cpu")
