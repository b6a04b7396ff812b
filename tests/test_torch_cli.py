"""The port's CLI (``python -m lmms_owc_tpu_torch.eval_model``) against the JAX CLI.

With the fake model: the pinned values of ``tests/test_cli_regression.py``,
results and samples equal to the JAX CLI's (the run-specific keys left out),
the ``toy_suite`` tag (its ``toy_semantic`` task scored through the scoring
pipelines, equal to the JAX CLI's), multi-run YAML configs, and a two-process ``gloo`` run
equal to the one-process run. With the tiny Qwen2-VL checkpoint of
``tests/test_torch_checkpoint.py`` (152064 tokens) on the CPU: the samples of
``toy`` and ``toy_multiround`` byte-equal to the JAX CLI's, ``toy_mc``'s
losses within 1e-4, and every metric equal. Without ``device=cpu`` the
Qwen2-VL adapter raises on a machine without CUDA.
"""

import json
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import pytest

from tests.test_cli_regression import PINNED

REPO = Path(__file__).resolve().parent.parent
TASKS = str(REPO / "tests" / "fixtures" / "tasks")
ENV = {"PATH": "/usr/bin:/bin", "HOME": os.path.expanduser("~"), "JAX_PLATFORMS": "cpu",
       "LMMS_OWC_TPU_LOG_LEVEL": "WARNING"}
# Keys that differ between any two runs.
RUN_KEYS = ("date", "git_hash", "timings", "start_time", "end_time", "total_evaluation_time_seconds")


def _cli(argv: list[str], jax: bool = False, env: dict | None = None) -> subprocess.CompletedProcess:
    entry = [str(REPO / "eval_model.py")] if jax else ["-m", "lmms_owc_tpu_torch.eval_model"]
    proc = subprocess.run([sys.executable, *entry, *argv], capture_output=True, text=True, timeout=600, cwd=REPO,
                          env={**ENV, **(env or {})})
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc


def _fake_argv(out: Path, mode: str = "target", tasks: str = "toy", limit: int = 6) -> list[str]:
    return ["--model", "fake", "--model_args", f"pretrained=fake-{mode},response_mode={mode}", "--tasks", tasks,
            "--include_path", TASKS, "--limit", str(limit), "--log_samples", "--output_path", str(out),
            "--seed", "0,1234,1234,1234"]


def _results(out: Path) -> dict:
    files = list(out.rglob("*_results.json"))
    assert len(files) == 1, files
    return json.loads(files[0].read_text())


def _comparable(results: dict) -> dict:
    """Results without the run-specific keys; the seed's key named by package;
    function addresses in the configs dropped."""
    out = {k: v for k, v in results.items() if k not in RUN_KEYS}
    config = dict(out["config"])
    config["seed3"] = config.pop("torch_seed", config.pop("jax_seed", None))
    out["config"] = config
    return json.loads(re.sub(r" at 0x[0-9a-f]+", "", json.dumps(out)))


def _samples(out: Path, task: str) -> str:
    files = list(out.rglob(f"*_samples_{task}.jsonl"))
    assert len(files) == 1, files
    return files[0].read_text()


@pytest.mark.parametrize("mode", ["target", "const"])
def test_pinned_cli_values(tmp_path, toy_dataset, mode):
    _cli(_fake_argv(tmp_path, mode))
    results = _results(tmp_path)
    for metric, value in PINNED[mode].items():
        assert results["results"]["toy"][metric] == value, (metric, results["results"]["toy"])
    assert results["n-samples"]["toy"] == {"original": 12, "effective": 6}
    assert results["config"]["torch_seed"] == 1234 and "jax_seed" not in results["config"]
    first = json.loads(_samples(tmp_path, "toy").splitlines()[0])
    assert {"doc_hash", "prompt_hash", "target_hash"} <= set(first)


def test_fake_model_run_matches_jax_cli(tmp_path, toy_dataset):
    """All three request types; the results and every samples file equal the JAX CLI's."""
    tasks = "toy,toy_mc,toy_multiround"
    _cli(_fake_argv(tmp_path / "port", tasks=tasks))
    _cli(_fake_argv(tmp_path / "jax", tasks=tasks), jax=True)
    assert _comparable(_results(tmp_path / "port")) == _comparable(_results(tmp_path / "jax"))
    for task in tasks.split(","):
        assert _samples(tmp_path / "port", task) == _samples(tmp_path / "jax", task)


def test_tag_expands_like_jax(tmp_path, toy_dataset, toy_task_path):
    """``toy_suite`` names the same tasks in both packages. Under --predict_only
    (no metric computed) the tag runs through the CLI as the JAX CLI runs it;
    with its metrics, toy_semantic scores (semantic and concept similarity
    through the scoring pipelines' fallback encoder) with results equal to
    the JAX CLI's."""
    from lmms_owc_tpu.tasks import TaskManager as JaxTaskManager
    from lmms_owc_tpu_torch.tasks import TaskManager

    port = TaskManager(include_path=toy_task_path).load_task_or_group("toy_suite")
    ref = JaxTaskManager(include_path=toy_task_path).load_task_or_group("toy_suite")
    assert sorted(port) == sorted(ref) == ["toy", "toy_mc", "toy_semantic"]
    argv = ["--model", "fake", "--model_args", "pretrained=fake-tag,response_mode=target", "--tasks", "toy_suite",
            "--include_path", TASKS, "--limit", "3", "--predict_only"]
    _cli([*argv, "--output_path", str(tmp_path / "port")])
    _cli([*argv, "--output_path", str(tmp_path / "jax")], jax=True)
    saved = _comparable(_results(tmp_path / "port"))
    assert {"toy", "toy_semantic"} <= set(saved["results"])
    assert saved == _comparable(_results(tmp_path / "jax"))
    _cli([*argv[:-1], "--output_path", str(tmp_path / "m_port")])
    _cli([*argv[:-1], "--output_path", str(tmp_path / "m_jax")], jax=True)
    scored = _comparable(_results(tmp_path / "m_port"))
    semantic = scored["results"]["toy_semantic"]
    assert {"semantic_similarity,none", "concept_semantic_similarity,none"} <= set(semantic)
    assert 0.0 < semantic["semantic_similarity,none"] <= 1.0 + 1e-6
    assert scored == _comparable(_results(tmp_path / "m_jax"))


def test_multi_config_yaml_runs(tmp_path, toy_dataset):
    """--config with a list of runs executes each in turn."""
    config_path = tmp_path / "runs.yaml"
    config_path.write_text("\n".join([
        "- model: fake",
        "  model_args: response_mode=target",
        f"  output_path: {tmp_path / 'run_a'}",
        "- model: fake",
        "  model_args: response_mode=const,response_text=zzz",
        f"  output_path: {tmp_path / 'run_b'}",
    ]))
    _cli(["--config", str(config_path), "--tasks", "toy", "--include_path", TASKS, "--limit", "2"])
    assert _results(tmp_path / "run_a")["results"]["toy"]["exact_match,none"] == 1.0
    assert _results(tmp_path / "run_b")["results"]["toy"]["exact_match,none"] == 0.0


def test_main_takes_an_argument_list(tmp_path, toy_dataset):
    """``main(argv)`` runs in-process and returns each run's results."""
    from lmms_owc_tpu_torch.eval_model import main

    (results,) = main(_fake_argv(tmp_path, limit=2))
    assert results["results"]["toy"]["exact_match,none"] == 1.0
    assert "samples" not in results and _results(tmp_path)["config"]["limit"] == 2.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("limit", [5, 1])
def test_two_process_gloo_run_matches_one_process(tmp_path, toy_dataset, limit):
    """Two ranks over ``torch.distributed`` (gloo on the CPU): rank 0's results
    and samples equal the one-process run's (``task_hashes`` aside, which
    follow the gather order). At ``--limit 1`` rank 1 draws no
    document, which takes the request-count padding and the empty-rank paths."""
    tasks = "toy,toy_mc,toy_multiround"
    _cli(_fake_argv(tmp_path / "one", tasks=tasks, limit=limit))
    port = str(_free_port())
    out = tmp_path / "two"
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "lmms_owc_tpu_torch.eval_model",
             *_fake_argv(out, tasks=tasks, limit=limit)],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env={**ENV, "WORLD_SIZE": "2", "RANK": str(rank), "LOCAL_RANK": str(rank),
                 "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port},
        )
        for rank in range(2)
    ]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for proc, log in zip(procs, logs):
        assert proc.returncode == 0, log[-3000:]
    one, two = _comparable(_results(tmp_path / "one")), _comparable(_results(out))
    # task_hashes join the sample hashes in gather order (rank-interleaved), as in the JAX tracker.
    one.pop("task_hashes"), two.pop("task_hashes")
    assert one == two
    for task in tasks.split(","):
        key = lambda line: json.loads(line)["doc_id"]  # noqa: E731
        assert sorted(_samples(out, task).splitlines(), key=key) == sorted(
            _samples(tmp_path / "one", task).splitlines(), key=key)


# ------------------------------------------------------------ tiny Qwen2-VL


@pytest.fixture(scope="module")
def tiny_checkpoint(tmp_path_factory):
    from tests.test_torch_checkpoint import _build

    path = tmp_path_factory.mktemp("qwen2_vl_tiny")
    _build(path, "qwen2-vl-tiny")
    return path


@pytest.fixture(scope="module")
def tiny_runs(tiny_checkpoint, toy_dataset, tmp_path_factory):
    """The port CLI (device=cpu, float32) and the JAX CLI, in-process, on the
    three toy tasks at --limit 4 --batch_size 2."""
    import eval_model as jax_cli

    from lmms_owc_tpu_torch.eval_model import main

    out = tmp_path_factory.mktemp("tiny_cli")
    argv = ["--model", "qwen2-vl-tiny", "--tasks", "toy,toy_mc,toy_multiround", "--include_path", TASKS,
            "--limit", "4", "--batch_size", "2", "--log_samples", "--seed", "0,1234,1234,1234"]
    main([*argv, "--model_args", f"pretrained={tiny_checkpoint},dtype=float32,device=cpu",
          "--output_path", str(out / "port")])
    jax_cli.main(jax_cli.build_parser().parse_args(
        [*argv, "--model_args", f"pretrained={tiny_checkpoint},dtype=float32", "--output_path", str(out / "jax")]))
    return out / "port", out / "jax"


@pytest.mark.parametrize("task", ["toy", "toy_multiround"])
def test_tiny_checkpoint_generation_samples_byte_equal(tiny_runs, task):
    port, jax = tiny_runs
    got = _samples(port, task)
    assert got == _samples(jax, task)
    assert all(json.loads(line)["resps"][0] for line in got.splitlines())


def test_tiny_checkpoint_loglikelihood_within_1e4(tiny_runs):
    port, jax = tiny_runs
    got = [json.loads(line) for line in _samples(port, "toy_mc").splitlines()]
    want = [json.loads(line) for line in _samples(jax, "toy_mc").splitlines()]
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert {k: v for k, v in a.items() if "resps" not in k} == {k: v for k, v in b.items() if "resps" not in k}
        for key in ("resps", "filtered_resps"):
            flat_a = [x for r in a[key] for x in (r[0] if key == "resps" else r)]
            flat_b = [x for r in b[key] for x in (r[0] if key == "resps" else r)]
            assert len(flat_a) == len(flat_b) == 16
            for (la, ga), (lb, gb) in zip(zip(flat_a[::2], flat_a[1::2]), zip(flat_b[::2], flat_b[1::2])):
                assert abs(float(la) - float(lb)) <= 1e-4 and ga == gb


def test_tiny_checkpoint_metrics_equal(tiny_runs):
    port, jax = tiny_runs
    got, want = _comparable(_results(port)), _comparable(_results(jax))
    assert got["results"] == want["results"]
    assert got["n-samples"] == want["n-samples"] and got["configs"] == want["configs"]
    for task, metrics in (("toy", ("exact_match", "textual_inclusion")), ("toy_mc", ("acc", "acc_norm"))):
        for metric in metrics:
            assert got["results"][task][f"{metric},none"] == want["results"][task][f"{metric},none"]


def test_qwen2_vl_without_device_cpu_raises_without_cuda(tiny_checkpoint, toy_dataset, tmp_path):
    """The adapter runs on the card unless asked for the CPU: no fallback."""
    import torch

    from lmms_owc_tpu_torch.eval_model import main

    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--model", "qwen2-vl-tiny", "--model_args", f"pretrained={tiny_checkpoint},dtype=float32",
              "--tasks", "toy", "--include_path", TASKS, "--limit", "1", "--output_path", str(tmp_path)])


def test_wandb_logger_degrades_to_noop():
    """Without the wandb package, the port's logger swallows every call, as the JAX one does."""
    import importlib.util

    from lmms_owc_tpu_torch.loggers import WandbLogger

    assert importlib.util.find_spec("wandb") is None
    logger = WandbLogger(project="x")
    logger.post_init({"results": {"toy": {"exact_match,none": 1.0}}, "configs": {}})
    logger.log_eval_result()
    logger.log_eval_samples({"toy": [{"doc_id": 0, "resps": [["a"]]}]})
    logger.finish()


def test_request_cache_round_trip(tmp_path, toy_dataset):
    """--cache_requests true pickles the built requests (with dill, as the JAX
    package does): the second run, built from the cache, gives the first run's
    results and samples, on all three request types."""
    tasks = "toy,toy_mc,toy_multiround"
    env = {"LMMS_OWC_TPU_DATASET_CACHE": str(tmp_path / "cache")}
    for run in ("first", "second"):
        _cli([*_fake_argv(tmp_path / run, tasks=tasks, limit=3), "--cache_requests", "true"], env=env)
    assert len(list((tmp_path / "cache").glob("*.pickle"))) == 3
    assert _comparable(_results(tmp_path / "first")) == _comparable(_results(tmp_path / "second"))
    for task in tasks.split(","):
        assert _samples(tmp_path / "first", task) == _samples(tmp_path / "second", task)


def test_profile_dir_writes_a_chrome_trace(tmp_path, toy_dataset):
    """LMMS_OWC_PROFILE_DIR traces the model phase with torch.profiler."""
    _cli(_fake_argv(tmp_path / "out", limit=2), env={"LMMS_OWC_PROFILE_DIR": str(tmp_path / "prof")})
    traces = list((tmp_path / "prof").glob("trace_*.json"))
    assert len(traces) == 1
    assert "traceEvents" in json.loads(traces[0].read_text())
