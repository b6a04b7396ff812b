"""BENCHMARK.json against the benchmark's contract, and the harness finding new files by name."""

from __future__ import annotations

import json
import re
import shutil
from pathlib import Path

import pytest

from owcbench import harness, traffic

REPO = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture
def bench():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_manifest_keys_names_and_files(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["owcbench"] and isinstance(bench["run_seconds"], int) and bench["run_seconds"] >= 1
    # A full check of 24 cells fits its 12 hours: 2 + 14 runs a cell, each run_seconds + 60 s, 2 x 90 s of
    # compilation a cell, 1200 s spare.
    assert (2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert all(not w.startswith("/") and ".." not in w for w in bench["command"])
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert (REPO / c["file"]).is_file() and c["file"].startswith("owcbench/")
        assert json.loads((REPO / c["file"]).read_text())["source"] == c["source"]
    used = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["config"] in configs and w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert (REPO / "owcbench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (REPO / "owcbench" / "limits" / f"{w['name']}.json").is_file()
        used.add(w["config"])
    assert used == set(configs)
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names
    ends = {m["name"] for m in bench["end_to_end"]}
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in {"host_clock", "device_trace"}
    layers = {}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in {"lower", "higher"} and m["source"] in SOURCES
        assert m["moves"] in ends and (REPO / "owcbench" / "metrics" / f"{m['name']}.py").is_file()
        layers.setdefault(m["layer"], []).append(m["name"])
    assert len(json.dumps(bench)) < 64 * 1024


def test_every_cell_resolves(bench):
    for w in bench["workloads"]:
        cell = harness.cell(w["name"], bench)
        assert cell.limits and all("limit" in v for v in cell.limits.values())
        assert {m["name"] for m in cell.end_to_end} == {m["name"] for m in bench["end_to_end"]}
        assert cell.per_layer, w["name"]
        for m in cell.per_layer:
            assert callable(harness.reader(m["name"]))


def test_new_files_are_found_without_editing_any(tmp_path, monkeypatch, bench):
    """A later configuration, mix, cell and per-layer metric are new files only."""
    root = tmp_path / "owcbench"
    for kind in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(REPO / "owcbench" / kind, root / kind)
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    cfg = json.loads((root / "configs" / "qwen2.5-vl-7b-bf16.json").read_text())
    cfg["name"] = "qwen2.5-vl-7b-bf16-wide"
    (root / "configs" / "qwen2.5-vl-7b-bf16-wide.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "traffic" / "sweep64.json").read_text())
    mix.update(name="cot256", generation_kwargs={"max_new_tokens": 256, "do_sample": False})
    (root / "traffic" / "cot256.json").write_text(json.dumps(mix))
    (root / "limits" / "qwen2.5-vl-7b-bf16-wide.cot256.json").write_text(json.dumps({"max_logit_gap": {"limit": 1}}))
    (root / "metrics" / "calls_per_window.py").write_text("def read(record):\n    return float(record.calls)\n")
    monkeypatch.setattr(harness, "HERE", root)
    new = dict(bench)
    new["workloads"] = bench["workloads"] + [{"name": "qwen2.5-vl-7b-bf16-wide.cot256", "chips": 1, "why": "x",
                                             "config": "qwen2.5-vl-7b-bf16-wide", "traffic": "cot256"}]
    new["per_layer"] = bench["per_layer"] + [{"name": "calls_per_window", "unit": "calls", "better": "higher",
                                             "source": "host_clock", "layer": "harness", "moves": "images_per_s",
                                             "workloads": ["qwen2.5-vl-7b-bf16-wide.cot256"]}]
    cell = harness.cell("qwen2.5-vl-7b-bf16-wide.cot256", new)
    assert cell.config["name"] == "qwen2.5-vl-7b-bf16-wide"
    assert cell.traffic["generation_kwargs"]["max_new_tokens"] == 256
    assert [m["name"] for m in cell.per_layer] == ["calls_per_window"]
    assert harness.reader("calls_per_window")(type("R", (), {"calls": 3})()) == 3.0
    assert {p: p.read_bytes() for p in before} == before  # nothing that was there changed


@pytest.mark.parametrize("mix", ["sweep64", "hires64"])
def test_every_seed_serves_the_same_sizes(mix):
    spec = json.loads((REPO / "owcbench" / "traffic" / f"{mix}.json").read_text())
    spec = dict(spec, requests_per_call=min(spec["requests_per_call"], 24))
    a, b = traffic.make_requests(spec, 2**31 + 7), traffic.make_requests(spec, 5)
    assert sorted((r.width, r.height) for r in a) == sorted((r.width, r.height) for r in b)
    assert [(r.width, r.height) for r in a] != [(r.width, r.height) for r in b] or len(a) < 3
    again = traffic.make_requests(spec, 2**31 + 7)
    assert all((x.image.tobytes() == y.image.tobytes()) for x, y in zip(a, again))
    assert all(r.image.size == (r.width, r.height) for r in a)


def test_sweep_shares_the_call_between_datasets():
    spec = json.loads((REPO / "owcbench" / "traffic" / "sweep64.json").read_text())
    sizes = traffic.call_sizes(spec)
    assert len(sizes) == spec["requests_per_call"]
    counts = {d["name"]: sum(1 for s in sizes if s[0] == d["name"]) for d in spec["datasets"]}
    assert set(counts.values()) <= {19, 20} and sum(counts.values()) == 192
