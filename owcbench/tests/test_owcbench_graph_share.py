"""``decode_graph_share``: the share of the decode steps that replayed CUDA
graphs, read from the program's counters ``decode_graph_steps`` and
``decode_steps``; None where the steps are absent or zero, or where the
program counts no graph steps (one without graphs), and reported in every
cell of ``BENCHMARK.json`` and in a traced run of a tiny configuration on the
CPU (0: graphs engage on a CUDA device only)."""

from __future__ import annotations

import json
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

from owcbench import harness
from owcbench.tests.test_owcbench_program_metrics import run_script

REPO = Path(__file__).resolve().parents[2]
NAME = "decode_graph_share"


@pytest.fixture
def store(monkeypatch):
    from lmms_owc_tpu_torch.utils import _hostprof

    def use(counters):
        monkeypatch.setattr(_hostprof, "counters", dict(counters))

    return use


@pytest.mark.parametrize("counters, want", [
    ({"decode_steps": 63, "decode_graph_steps": 61}, 100.0 * 61 / 63),
    ({"decode_steps": 63, "decode_graph_steps": 0}, 0.0),
    ({"decode_steps": 63}, None),  # a program without graphs
    ({"decode_graph_steps": 61}, None),
    ({"decode_steps": 0, "decode_graph_steps": 0}, None),
    ({}, None),
])
def test_the_share_reads_the_two_counters(store, counters, want):
    store(counters)
    got = harness.reader(NAME)(SimpleNamespace(hostprof={}))
    assert got == (None if want is None else pytest.approx(want))


def test_a_program_without_the_counter_store_reads_none(monkeypatch):
    from lmms_owc_tpu_torch.utils import _hostprof

    monkeypatch.delattr(_hostprof, "counters")
    assert harness.reader(NAME)(SimpleNamespace(hostprof={})) is None


def test_every_cell_reports_the_share():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    (entry,) = [m for m in bench["per_layer"] if m["name"] == NAME]
    assert entry["source"] == "program_counter" and entry["moves"] == "images_per_s"
    assert entry["workloads"] == [w["name"] for w in bench["workloads"]]
    for w in bench["workloads"]:
        assert NAME in {m["name"] for m in harness.cell(w["name"], bench).per_layer}


def test_a_traced_cpu_run_reads_no_replayed_step(tiny):
    from lmms_owc_tpu_torch.nn.layers import set_int8_activations
    from lmms_owc_tpu_torch.utils import _hostprof

    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cell = tiny("qwen2-vl-tiny-w8a8")
    cell.per_layer = [m for m in bench["per_layer"] if m["name"] == NAME]
    _hostprof.counters_reset()
    try:
        out = harness.run(cell, 2**31 + 7, 0.01, True, time.perf_counter(), device="cpu")
        metrics = run_script.result_line(cell, out, True, "cpu")["metrics"]
    finally:
        _hostprof.counters_reset()
        set_int8_activations(False)
    assert metrics[NAME]["value"] == 0.0
