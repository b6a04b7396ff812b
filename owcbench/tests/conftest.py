"""Fixtures of the benchmark's own tests (``python -m pytest owcbench/tests``).

They run on the CPU at tiny sizes. A test that needs the card takes the
``card`` fixture, which skips it where there is none; whether there is a card
is decided in the fixture, never while a module is imported.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA GPU; skipped where there is none")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")


def tiny_cell(config: str, limit: float = 1e-4):
    """A cell of a tiny test configuration (``data/configs``) under the ``mini`` mix, on the CPU."""
    from owcbench import harness

    cfg = json.loads((DATA / "configs" / f"{config}.json").read_text())
    mix = json.loads((DATA / "traffic" / "mini.json").read_text())
    return harness.Cell(f"{config}.mini", {"chips": 1}, cfg, mix, {"max_logit_gap": {"limit": limit}},
                        [], [])


@pytest.fixture
def tiny():
    return tiny_cell
