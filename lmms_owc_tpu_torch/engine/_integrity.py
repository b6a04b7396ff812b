"""--check_integrity support (the JAX package's ``engine._integrity``).

The JAX package runs its task regression tests (``tests/test_tasks.py``) for
the selected tasks. Those tests, and the test suite's ``conftest.py``, import
the JAX package, and the port has no task test suite of its own that runs
without it, so the port's flag raises instead of loading JAX.
"""

from __future__ import annotations

__all__ = ["run_task_tests"]


def run_task_tests(task_list: list[str]) -> None:
    raise NotImplementedError(
        f"--check_integrity (tasks {task_list}): the port has no task test suite that runs without the"
        " JAX package; run `python -m pytest tests/test_tasks.py -k <task>` with the JAX package instead"
    )
