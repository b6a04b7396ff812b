"""Evaluation engine: orchestration + tracking (parity surface: reference src/engine/)."""

from lmms_owc_tpu_torch.engine._integrity import run_task_tests
from lmms_owc_tpu_torch.engine.evaluator import evaluate, simple_evaluate
from lmms_owc_tpu_torch.engine.tracker import EngineTracker, GeneralConfigTracker

__all__ = ["EngineTracker", "GeneralConfigTracker", "evaluate", "run_task_tests", "simple_evaluate"]
