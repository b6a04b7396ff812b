"""The per-layer metrics read from the program's own spans and counters
(``lmms_owc_tpu_torch/utils/_hostprof.py``): each reader on a hand-built
record and counter store, None where what it needs is absent (as in a
program that has no counter store), their entries in ``BENCHMARK.json``, and
a traced run of the tiny configurations on the CPU reporting them."""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

from owcbench import harness

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import run as run_script  # noqa: E402  (owcbench/run.py)

REPO = Path(__file__).resolve().parents[2]
W8A8_CELL = "qwen2-vl-7b-w8a8.sweep64"
# name -> (the hand-built record's host spans, the counter store, the reading)
READINGS = {
    "decode_issue_ms_per_step": ({"decode_issue": 6.0, "decode_stop_check": 2.0}, {"decode_steps": 100}, 60.0),
    "decode_stop_wait_ms_per_step": ({"decode_issue": 6.0, "decode_stop_check": 2.0}, {"decode_steps": 100}, 20.0),
    "decode_row_fill": ({}, {"decode_rows": 96 * 10, "decode_rows_computed": 128 * 10}, 75.0),
    "prefill_token_fill": ({}, {"prefill_tokens": 1070, "prefill_slots": 1536}, 100.0 * 1070 / 1536),
    "w8a8_requant_share": ({}, {"w8a8_quantize": 700, "w8a8_requantize": 300}, 100.0 * 3 / 7),
}


@pytest.fixture
def store(monkeypatch):
    from lmms_owc_tpu_torch.utils import _hostprof

    def use(counters):
        monkeypatch.setattr(_hostprof, "counters", dict(counters))

    return use


@pytest.mark.parametrize("name", list(READINGS))
def test_reader_on_a_hand_built_record(store, name):
    spans, counters, want = READINGS[name]
    store(counters)
    assert harness.reader(name)(SimpleNamespace(hostprof=dict(spans))) == pytest.approx(want)


@pytest.mark.parametrize("name", list(READINGS))
def test_reader_is_none_where_its_inputs_are_absent(store, monkeypatch, name):
    from lmms_owc_tpu_torch.utils import _hostprof

    spans, counters, _ = READINGS[name]
    read = harness.reader(name)
    store({})
    assert read(SimpleNamespace(hostprof=dict(spans))) is None
    store(counters)
    if spans:
        assert read(SimpleNamespace(hostprof={})) is None
    monkeypatch.delattr(_hostprof, "counters")  # a program without the counter store
    assert read(SimpleNamespace(hostprof=dict(spans))) is None


def test_manifest_lists_the_program_metrics_with_their_cells():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    cells = [w["name"] for w in bench["workloads"]]
    for name in READINGS:
        m = entries[name]
        assert m["moves"] == "images_per_s" and m["workloads"]
        assert m["source"] == ("program_span" if name.endswith("_ms_per_step") else "program_counter")
        assert m["workloads"] == ([W8A8_CELL] if name == "w8a8_requant_share" else cells)
    for cell_name in cells:
        names = {m["name"] for m in harness.cell(cell_name, bench).per_layer}
        assert set(READINGS) - {"w8a8_requant_share"} <= names
        assert ("w8a8_requant_share" in names) == (cell_name == W8A8_CELL)


@pytest.mark.parametrize("config", ["qwen2-vl-tiny-w8a8", "qwen2.5-vl-tiny"])
def test_a_traced_run_reports_the_program_metrics(tiny, config):
    """The tiny configurations on the CPU (no row blocks there: every
    computed row is a pool's): the new metrics are read from the program's
    spans and counters in a traced run; the requantization share only under
    W8A8."""
    from lmms_owc_tpu_torch.nn.layers import set_int8_activations
    from lmms_owc_tpu_torch.utils import _hostprof

    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cell = tiny(config)
    cell.per_layer = [m for m in bench["per_layer"] if m["name"] in READINGS]
    _hostprof.counters_reset()
    try:
        out = harness.run(cell, 2**31 + 5, 0.01, True, time.perf_counter(), device="cpu")
        metrics = run_script.result_line(cell, out, True, "cpu")["metrics"]
    finally:
        _hostprof.counters_reset()
        set_int8_activations(False)  # the W8A8 adapter sets it for the process
    assert {"decode_issue", "decode_stop_check"} <= set(out["record"].hostprof)
    w8a8 = config.endswith("w8a8")
    assert set(metrics) == set(READINGS) - ({"w8a8_requant_share"} if not w8a8 else set())
    assert metrics["decode_row_fill"]["value"] == 100.0
    assert 0 < metrics["prefill_token_fill"]["value"] < 100
    assert metrics["decode_issue_ms_per_step"]["value"] > 0 and metrics["decode_stop_wait_ms_per_step"]["value"] > 0
    if w8a8:
        assert 0 < metrics["w8a8_requant_share"]["value"] < 100.0 * 3 / 7  # the tower repeats none
