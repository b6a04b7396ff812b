"""A configuration of another model family needs new files only: its plain
reference, its configuration and, for a new attention entry, its shape reader.
The harness reads the family's requests, work, check and decode steps through them."""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from owcbench import harness, roofline, traffic

REPO = Path(__file__).resolve().parents[2]

# A toy family: one embedding and one head, prompts of a length set by the
# image's width and the configuration's own "tile" option (no pixel budget,
# no system prompt), a decode step whose arguments and cache layout differ
# from Qwen2-VL's.
TOY_REFERENCE = '''
import torch


def arch(hf):
    return dict(layers=hf["n_layer"], heads=hf["n_head"], vocab=hf["vocab"], width=hf["d"])


def hf_layout(hf):
    return [("embed.weight", (hf["vocab"], hf["d"]), "normal"), ("head.weight", (hf["vocab"], hf["d"]), "normal")]


def checkpoint_dir(path, cfg):
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text("{}")


def request_shape(a, cfg, request):
    return dict(prompt_tokens=3 + request.width // cfg["program"]["kwargs"]["tile"])


def count_work(a, cfg, work, shape, served):
    work.add(2.0 * (shape["prompt_tokens"] + served) * a["width"] * a["vocab"])


def served_logits(a, cfg, state, precision, requests, device):
    embed, head = state["embed.weight"].float(), state["head.weight"].float()
    if precision.get("weights") == "int4":  # the toy's coarse control: the head's signs alone
        head = head.sign()
    # position i's logits: embedding row i against the head (whatever was served before it)
    return [embed[torch.arange(len(r["served"]), device=device) % a["vocab"]] @ head.t() for r in requests]
'''

TOY_STEP = '''
def toy_step(model, cache, mask, position, tokens):
    return tokens
'''


@pytest.fixture
def toy(tmp_path, monkeypatch):
    root = tmp_path / "owcbench"
    for kind in ("configs", "traffic", "limits", "metrics", "attention", "reference"):
        shutil.copytree(REPO / "owcbench" / kind, root / kind, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    (root / "reference" / "toyfam.py").write_text(TOY_REFERENCE)
    (root / "attention" / "toy_attention.py").write_text(
        "def shape(args, kw):\n    q = args[0]\n    return (1, 2, 2, q.shape[0], q.shape[0], 8, True, None, 2)\n")
    cfg = {"name": "toyfam-1b", "source": "https://example.org/toyfam", "reference": "toyfam", "reduced": [],
           "program": {"model": "toyfam-1b", "kwargs": {"dtype": "float32", "tile": 100},
                       "decode_step": {"entry": "toy_module:toy_step", "cache": "cache", "cache_pos": "position",
                                       "kv_mask": "mask",
                                       "cache_dims": ["batch", "layers", "seq", "kv_heads", "head_dim"]}},
           "precision": {"weights": "bf16"}, "controls": {"int4": {"weights": "int4"}}, "check": {"requests": 3},
           "hf_config": {"n_layer": 2, "n_head": 2, "vocab": 32, "d": 16}}
    (root / "configs" / "toyfam-1b.json").write_text(json.dumps(cfg))
    (root / "limits" / "toyfam-1b.mini.json").write_text(json.dumps({"max_logit_gap": {"limit": 1e-5}}))
    shutil.copy(REPO / "owcbench" / "tests" / "data" / "traffic" / "mini.json", root / "traffic" / "mini.json")
    monkeypatch.setattr(harness, "HERE", root)
    monkeypatch.setattr(harness, "_MODULES", {})
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toyfam-1b", "source": cfg["source"], "file": "owcbench/configs/toyfam-1b.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "toyfam-1b.mini", "config": "toyfam-1b", "traffic": "mini", "chips": 1,
                               "why": "x"})
    yield harness.cell("toyfam-1b.mini", bench)
    assert {p: p.read_bytes() for p in before} == before  # nothing that was there changed


def test_the_harness_names_no_family():
    source = (REPO / "owcbench" / "harness.py").read_text()
    for word in ("min_pixels", "max_pixels", "system_prompt", "image_grid", "prompt_ids", "qwen"):
        assert word not in source.lower(), word


def test_a_second_family_drives_work_sample_and_check(toy):
    ref = harness.reference(toy.config)
    arch = ref.arch(toy.config["hf_config"])
    reqs = traffic.make_requests(toy.traffic, 2**31 + 5)
    rng = np.random.default_rng(0)
    served = [rng.integers(0, 32, size=4).tolist() for _ in reqs]
    served[3] = None  # no answer: no work, not sampled
    work = harness.window_work(toy, arch, reqs, [served, served])
    prompts = [3 + r.width // 100 for r in reqs]
    expect = 2 * sum(2.0 * (p + 4) * 16 * 32 for p, s in zip(prompts, served) if s)
    assert work.bf16 == pytest.approx(expect) and work.int8 == 0.0

    idx = harness.sample(reqs, served, 7, 3, arch, toy.config)
    assert len(idx) == 3 and 3 not in idx
    assert prompts[idx[0]] == max(p for p, s in zip(prompts, served) if s)

    # Tokens the reference puts first pass; the control, a coarser head, does not.
    state = harness.weights.draw(ref.hf_layout(toy.config["hf_config"]), 11, torch.float32, "cpu")
    best = [ref.served_logits(arch, toy.config, state, {}, [dict(served=s)], "cpu")[0].argmax(-1).tolist()
            if s else None for s in served]
    got = harness.compare(toy, 11, reqs, best, idx, toy.config["controls"], device="cpu")
    assert got["max_logit_gap"] == 0.0 and got["tokens"] == 12
    assert got["int4"]["max_logit_gap"] > 0.0


def test_a_second_familys_decode_step_and_attention_entry_are_read_as_its_files_say(toy, monkeypatch):
    import sys
    import types

    module = types.ModuleType("toy_module")
    exec(TOY_STEP, module.__dict__)
    monkeypatch.setitem(sys.modules, "toy_module", module)
    probes = harness.Probes()
    spec = toy.config["program"]["decode_step"]
    step = probes._step(module.toy_step, spec)
    cache = (torch.zeros(3, 2, 40, 4, 8, dtype=torch.int8), torch.zeros(3, 2, 40, 4, 8, dtype=torch.int8))
    mask = torch.zeros(3, 40, dtype=torch.bool)
    mask[:, :21] = True
    assert step(None, cache, mask, 20, "tokens") == "tokens"
    assert step(None, cache, mask=mask, position=21, tokens="more") == "more"
    assert probes.decode_steps == 2
    # (mask key, position, batch, seq, kv heads, head dim, int8)
    assert probes.steps == [(id(mask), 20, 3, 40, 4, 8, True), (id(mask), 21, 3, 40, 4, 8, True)]

    call = probes._attention(harness.module_file("attention", "toy_attention").shape, lambda q: q.sum())
    call(torch.ones(6, 8))
    assert probes.flash == [(1, 2, 2, 6, 6, 8, True, None, 2)]
    flash_s, _ = probes.bounds(dict(layers=2, heads=2))
    keys = torch.ones(1, 6, dtype=torch.bool)
    assert flash_s == roofline.attention_bound(keys, 2, 2, 6, 8, causal=True, elt=2)["bound_s"]


def test_a_traced_run_reads_steps_and_attention_through_the_configuration(tiny):
    """The tiny Qwen2-VL on the CPU: the configuration's decode step and
    attention entries are counted in a traced run, and its per-layer inputs filled."""
    out = harness.run(tiny("qwen2-vl-tiny-w8a8"), 2**31 + 3, 0.01, True, time.perf_counter(), device="cpu")
    rec = out["record"]
    assert rec.decode_steps > 0 and rec.flash_bound_s and rec.decode_bound_s
    assert {"vision", "prefill", "decode"} <= set(rec.phase_seconds) and "prep_wait" in rec.hostprof
