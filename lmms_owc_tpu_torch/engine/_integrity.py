"""--check_integrity support: run the port's task tests for the selected tasks.

The JAX package's ``engine._integrity`` runs ``tests/test_tasks.py`` with
``-k`` over the task names and raises on a non-zero exit. The port runs its
own task test file, ``tests/test_torch_tasks.py``, the same way, in a
subprocess: the test suite's ``conftest.py`` imports the JAX package, so the
child runs with ``--noconftest`` and the file brings its own fixtures (and
asserts that nothing of JAX was loaded). A task with no test (an unknown
name) selects nothing, and pytest's "no tests collected" exit raises too.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

__all__ = ["TASK_TEST_FILE", "run_task_tests"]

TASK_TEST_FILE = Path(__file__).resolve().parents[2] / "tests" / "test_torch_tasks.py"


def run_task_tests(task_list: list[str]) -> None:
    if not TASK_TEST_FILE.exists():
        raise RuntimeError(f"integrity test file not found: {TASK_TEST_FILE}")
    cmd = [sys.executable, "-m", "pytest", "-q", "--noconftest", "-p", "no:cacheprovider",
           str(TASK_TEST_FILE), "-k", " or ".join(task_list)]
    proc = subprocess.run(cmd, cwd=TASK_TEST_FILE.parents[1], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"integrity tests failed for tasks {task_list} (exit code {proc.returncode}):\n{proc.stdout[-3000:]}"
            f"{proc.stderr[-2000:]}"
        )
