"""The port's task tests: task loading, request construction and end-to-end
evaluation with the fake model (no accelerator), as ``tests/test_tasks.py``
holds the JAX package, and the index of the paper's benchmarks.

This file is also what the port's ``--check_integrity`` runs
(:mod:`lmms_owc_tpu_torch.engine._integrity`): ``pytest --noconftest -k
<tasks>`` in a subprocess. So it imports nothing of JAX, brings its own
fixtures in place of the suite's ``conftest.py`` (which imports the JAX
package), and carries each task's name in its test ids, which ``-k`` selects.
Run that way, :func:`test_toy_integrity_run_loads_no_jax` asserts that no
``jax`` or ``lmms_owc_tpu`` module was loaded; under the suite's conftest it
runs ``--check_integrity``'s subprocess itself.
"""

import json
import os
import sys
from pathlib import Path

import pytest

REPO_ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO_ROOT))

from lmms_owc_tpu_torch.engine import EngineTracker, run_task_tests, simple_evaluate  # noqa: E402
from lmms_owc_tpu_torch.tasks import TaskManager, get_tasks_as_dict  # noqa: E402

TOY_TASKS = REPO_ROOT / "tests" / "fixtures" / "tasks"
BENCHMARKS = ("caltech101", "dtd", "eurosat", "fgvc_aircraft", "flowers102", "food101", "oxford_pets",
              "stanford_cars", "sun397", "ucf101")
PROMPT_VARIANTS = ("caption", "describe", "list", "llamav_o1", "llava_cot", "more_generic", "more_specific",
                   "zero_shot_cot")
EXAMPLES = ("ai2d", "mmmu_val", "mmmu_val_pass8", "mmmu_val_reasoning", "muirbench", "ocr_bench")


def _suite_conftest_loaded() -> bool:
    """Whether the test suite's ``conftest.py`` (which imports JAX) is loaded."""
    return any(getattr(m, "__file__", None) == str(REPO_ROOT / "tests" / "conftest.py")
               for m in list(sys.modules.values()))


@pytest.fixture(scope="module", autouse=True)
def _repo_root_cwd():
    """Task YAMLs use repo-root-relative dataset paths."""
    cwd = os.getcwd()
    os.chdir(REPO_ROOT)
    yield
    os.chdir(cwd)


@pytest.fixture(scope="module")
def toy_dataset():
    """The toy classification dataset, written once by the fixture's own recipe."""
    sys.path.insert(0, str(TOY_TASKS / "toy" / "assets"))
    import _toy_utils

    _toy_utils.download()
    return _toy_utils.data_dir()


@pytest.fixture(scope="module")
def task_manager(toy_dataset):
    return TaskManager(include_path=str(TOY_TASKS), model_name="fake")


@pytest.fixture(scope="module")
def default_manager():
    """The port's own task directory only (the paper's benchmarks and the examples)."""
    return TaskManager(model_name="fake")


# ------------------------------------------------------------------ task manager


def test_toy_index(task_manager):
    assert "toy" in task_manager.all_subtasks
    assert "toy_semantic" in task_manager.all_subtasks
    assert "toy_suite" in task_manager.all_tags


def test_toy_match_tasks(task_manager):
    assert task_manager.match_tasks(["toy*"]) == ["toy", "toy_mc", "toy_multiround", "toy_semantic", "toy_suite"]


def test_toy_listing(task_manager):
    listing = task_manager.list_all_tasks()
    assert "toy" in listing
    assert "generate_until" in listing


@pytest.mark.parametrize("name", BENCHMARKS)
def test_benchmark_indexed(default_manager, name):
    """Each of the paper's ten benchmarks is indexed from the port's own
    ``tasks/configs``, with its nine prompt variants, tagged ``classification``,
    and its ``base`` config resolves its ``!function`` hooks."""
    index = default_manager.task_index
    names = [name] + [f"{name}_{v}" for v in PROMPT_VARIANTS]
    for task in names:
        assert task in default_manager.all_subtasks, task
        path = Path(index[task]["yaml_path"])
        assert path.is_relative_to(REPO_ROOT / "lmms_owc_tpu_torch" / "tasks" / "configs" / "classification")
    assert index["classification"]["type"] == "tag"
    assert set(names) <= set(index["classification"]["task"])
    from lmms_owc_tpu_torch.utils import load_yaml_config

    full = load_yaml_config(index[name]["yaml_path"], mode="full")
    assert full["task"] == name and full["output_type"] == "generate_until"
    assert full["dataset_path"] == f"data/{name}"
    assert full["generation_kwargs"] == {"max_new_tokens": 64, "do_sample": False}
    for hook in ("doc_to_visual", "doc_to_text", "doc_to_target"):
        assert callable(full[hook]), hook
        # The hooks live in the port's copy of the common module (loaded under its own name).
        assert full[hook].__module__ == "lmms_owc_tpu_torch_classification_common", full[hook].__module__
    assert callable(full["dataset_kwargs"]["custom_download"])


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_indexed(default_manager, name):
    assert name in default_manager.all_subtasks
    path = Path(default_manager.task_index[name]["yaml_path"])
    assert path.is_relative_to(REPO_ROOT / "lmms_owc_tpu_torch" / "tasks" / "configs" / "examples")


# ------------------------------------------------------------ configurable task


def test_toy_load_and_probe(task_manager):
    task = get_tasks_as_dict(["toy"], task_manager)["toy"]
    assert task.OUTPUT_TYPE == "generate_until"
    assert task.has_test_docs()
    assert len(task.eval_docs) == 12
    doc = task.dataset["test"][0]
    assert task.doc_to_text(doc) == "What type of object is in this photo?"
    assert task.doc_to_target(doc) == "red panda"
    visuals = task.doc_to_visual(doc)
    assert len(visuals) == 1 and visuals[0].size == (32, 32)


def test_toy_tag_loading(task_manager):
    assert set(get_tasks_as_dict(["toy_suite"], task_manager)) == {"toy", "toy_mc", "toy_semantic"}


def test_toy_build_requests_sharded(task_manager):
    task = get_tasks_as_dict(["toy"], task_manager)["toy"]
    task.set_fewshot_seed(1234)
    task.set_config(key="num_fewshot", value=0)
    task.build_all_requests(limit=None, rank=0, world_size=2)
    assert [inst.doc_id for inst in task.instances] == [0, 2, 4, 6, 8, 10]
    args = task.instances[0].args
    assert args[0] == "What type of object is in this photo?"
    assert args[1]["max_new_tokens"] == 16
    assert callable(args[2])


# -------------------------------------------------------------------- end to end


def _evaluate(task_manager, tasks, limit, model_args="response_mode=target", **kw):
    return simple_evaluate(model_name="fake", model_args=model_args, tasks=tasks, limit=limit,
                           task_manager=task_manager, **kw)


def test_toy_simple_evaluate_fake_target(task_manager):
    """The fake model echoes the target: exact_match and textual_inclusion are 1.0."""
    results = _evaluate(task_manager, ["toy"], 8, bootstrap_iters=1000, log_samples=True)
    res = results["results"]["toy"]
    assert res["exact_match,none"] == 1.0
    assert res["textual_inclusion,none"] == 1.0
    assert res["exact_match_stderr,none"] == 0.0
    assert results["n-samples"]["toy"] == {"original": 12, "effective": 8}
    samples = results["samples"]["toy"]
    assert len(samples) == 8
    assert {"doc_id", "doc", "target", "arguments", "resps", "filtered_resps", "doc_hash", "prompt_hash",
            "target_hash"} <= set(samples[0])
    assert samples[0]["target"] == "red panda"
    assert samples[0]["filtered_resps"] == ["red panda"]


def test_toy_simple_evaluate_fake_const(task_manager):
    results = _evaluate(task_manager, ["toy"], 4, "response_mode=const,response_text=a violin", bootstrap_iters=0)
    assert results["results"]["toy"]["exact_match,none"] == 0.0
    assert results["results"]["toy"]["exact_match_stderr,none"] == "N/A"


def test_toy_predict_only_bypass(task_manager):
    results = _evaluate(task_manager, ["toy"], 4, predict_only=True, log_samples=True)
    assert results["results"]["toy"]["bypass,none"] == 999


def test_toy_semantic_task_with_fallback_encoder(task_manager, monkeypatch):
    monkeypatch.delenv("LMMS_OWC_SBERT_PATH", raising=False)
    results = _evaluate(task_manager, ["toy_semantic"], 4, bootstrap_iters=0)
    res = results["results"]["toy_semantic"]
    assert res["semantic_similarity,none"] == pytest.approx(1.0, abs=1e-5)
    assert res["exact_match,none"] == 1.0
    assert 0.0 <= res["concept_semantic_similarity,none"] <= 1.0 + 1e-6


def test_toy_results_config_block(task_manager):
    results = _evaluate(task_manager, ["toy"], 2, bootstrap_iters=0)
    assert results["config"]["model"] == "fake"
    assert results["config"]["limit"] == 2
    assert "date" in results


def test_toy_results_and_samples_files(task_manager, tmp_path):
    from lmms_owc_tpu_torch import utils as u

    tracker = EngineTracker(output_path=str(tmp_path))
    tracker.general_config_tracker.log_experiment_args(
        model_source="fake", model_args="pretrained=fake-model,x=1",
        system_instruction=None, chat_template=None, fewshot_as_multiturn=False,
    )
    results = _evaluate(task_manager, ["toy"], 3, bootstrap_iters=0, log_samples=True)
    samples = results.pop("samples")
    tracker.save_results_aggregated(results=results, samples=samples, datetime_str=u.get_datetime_str())
    tracker.save_results_samples(task_name="toy", samples=samples["toy"])
    model_dir = tmp_path / "fake-model"
    results_files = list(model_dir.glob("*_results.json"))
    samples_files = list(model_dir.glob("*_samples_toy.jsonl"))
    assert len(results_files) == 1 and len(samples_files) == 1
    saved = json.loads(results_files[0].read_text())
    assert saved["results"]["toy"]["exact_match,none"] == 1.0
    assert "toy" in saved["task_hashes"]
    assert saved["model_name"] == "fake-model"
    lines = [json.loads(line) for line in samples_files[0].read_text().splitlines()]
    assert len(lines) == 3
    assert lines[0]["target"] == "red panda"
    assert lines[0]["input"] == "What type of object is in this photo?"


def test_toy_table_renders(task_manager):
    from lmms_owc_tpu_torch.utils import make_table

    table = make_table(_evaluate(task_manager, ["toy"], 2, bootstrap_iters=0))
    assert "exact_match" in table and "toy" in table


# --------------------------------------------------------------- check_integrity


def test_toy_integrity_run_loads_no_jax(toy_dataset):
    """Run by ``--check_integrity`` (no suite conftest): nothing of JAX is
    loaded. Under the suite's conftest: ``--check_integrity``'s subprocess
    over the toy tasks passes (and runs this test in the child)."""
    if _suite_conftest_loaded():
        run_task_tests(["toy"])
        return
    bad = sorted(k for k in sys.modules if k in ("jax", "jaxlib") or k.startswith(("jax.", "jaxlib."))
                 or (k.startswith("lmms_owc_tpu") and not k.startswith("lmms_owc_tpu_torch")))
    assert not bad, bad


def test_integrity_raises_for_unknown_task():
    """A task with no test selects nothing: pytest exits 5 and the check raises."""
    with pytest.raises(RuntimeError, match="integrity tests failed"):
        run_task_tests(["no_such_task_anywhere"])
