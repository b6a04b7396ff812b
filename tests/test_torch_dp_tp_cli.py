"""Data x tensor parallelism through the port's CLI, as ``tests/test_dp_tp_cli.py`` for JAX.

Four processes (``WORLD_SIZE=4``, gloo on the CPU) run ``python -m
lmms_owc_tpu_torch.eval_model`` on the tiny Qwen2-VL checkpoint of
``tests/test_torch_checkpoint.py`` (2 KV heads, as the JAX test's; the JAX
test's own checkpoint has a 512-token vocabulary that its pad id 151643 lies
outside, which the port refuses to load) with ``model_parallel=2``: two data groups
of two ranks, each pair holding one model's shards. The results file (one,
written by rank 0) and every sample's ``resps`` must equal one unsharded
process's. With ``--cache_requests true`` the two ranks of a model group
share each request-cache file: a run that writes the cache and one that
reads it both give the unsharded results.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
ENV = {"PATH": "/usr/bin:/bin", "HOME": os.path.expanduser("~"), "LMMS_OWC_TPU_LOG_LEVEL": "WARNING",
       "LMMS_OWC_DIST_TIMEOUT": "60", "OMP_NUM_THREADS": "2"}
VOLATILE = {"date", "total_evaluation_time_seconds", "phase_timings", "config", "configs", "start_time",
            "end_time", "timings", "task_hashes", "git_hash"}


@pytest.fixture(scope="module")
def qwen_tiny_checkpoint(tmp_path_factory):
    from tests.test_torch_checkpoint import _build

    path = tmp_path_factory.mktemp("torch_dptp_qwen_ckpt")
    _build(path, "qwen2-vl-tiny")
    return path


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(out: Path, ckpt: Path, processes: int, model_parallel: int, cache: Path | None = None) -> dict:
    model_args = f"pretrained={ckpt},dtype=float32,device=cpu"
    if model_parallel > 1:
        model_args += f",model_parallel={model_parallel}"
    argv = [sys.executable, "-m", "lmms_owc_tpu_torch.eval_model", "--model", "qwen2-vl-tiny",
            "--model_args", model_args, "--tasks", "toy", "--include_path", str(REPO / "tests" / "fixtures" / "tasks"),
            "--limit", "6", "--batch_size", "2", "--log_samples", "--output_path", str(out),
            "--seed", "0,1234,1234,1234"]
    env = dict(ENV)
    if cache is not None:
        argv += ["--cache_requests", "true"]
        env["LMMS_OWC_TPU_DATASET_CACHE"] = str(cache)
    port = str(_free_port())
    envs = [env] if processes == 1 else [
        {**env, "WORLD_SIZE": str(processes), "RANK": str(r), "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port}
        for r in range(processes)
    ]
    procs = [subprocess.Popen(argv, cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for env in envs]
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    files = list(out.rglob("*_results.json"))
    assert len(files) == 1, "exactly one rank (0) must write results"
    results = json.loads(files[0].read_text())
    samples = next(out.rglob("*_samples_toy.jsonl")).read_text().splitlines()
    results["_samples"] = sorted((json.loads(line) for line in samples), key=lambda s: s["doc_id"])
    return results


@pytest.fixture(scope="module")
def single(tmp_path_factory, qwen_tiny_checkpoint, toy_dataset):
    return _run(tmp_path_factory.mktemp("torch_dptp_one"), qwen_tiny_checkpoint, 1, 1)


def _assert_same(combined: dict, single: dict) -> None:
    comparable = lambda r: {k: v for k, v in r.items() if k not in VOLATILE}  # noqa: E731
    assert comparable(combined) == comparable(single)
    assert [s["resps"] for s in combined["_samples"]] == [s["resps"] for s in single["_samples"]]
    assert len(combined["_samples"]) == 6


def test_dp_tp_matches_single_process(tmp_path, qwen_tiny_checkpoint, single):
    _assert_same(_run(tmp_path / "dp2tp2", qwen_tiny_checkpoint, 4, 2), single)


def test_dp_tp_request_cache_matches_single_process(tmp_path, qwen_tiny_checkpoint, single):
    cache = tmp_path / "cache"
    _assert_same(_run(tmp_path / "write", qwen_tiny_checkpoint, 4, 2, cache), single)
    written = sorted(p.name for p in cache.iterdir())
    # One file per data coordinate, each written whole by its model group's ranks.
    assert len(written) == 2 and all(n.endswith(".pickle") and "world_size2" in n for n in written), written
    _assert_same(_run(tmp_path / "read", qwen_tiny_checkpoint, 4, 2, cache), single)
    assert sorted(p.name for p in cache.iterdir()) == written
