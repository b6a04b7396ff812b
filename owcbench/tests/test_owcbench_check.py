"""The check that decides ``correct``: the reference against the port, the
control failing it, and a run with its timed path broken coming out not correct."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

from owcbench import harness, traffic

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import run as run_script  # noqa: E402  (owcbench/run.py)

SEED = 2**31 + 11


def _serve(cell, seed=SEED):
    reqs = traffic.make_requests(cell.traffic, seed)
    program = harness.Program(cell, seed, device="cpu")
    served = program.serve(program.requests(reqs, "test"))
    arch = program.arch
    program.close()
    idx = harness.sample(reqs, served, seed, int(cell.config["check"]["requests"]), arch, cell.config)
    return reqs, served, idx


@pytest.mark.parametrize("config", ["qwen2-vl-tiny-w8a8", "qwen2.5-vl-tiny"])
def test_the_reference_agrees_with_the_port(tiny, config):
    """f32 at a tiny size: the served tokens are the reference's best (W8A8 and
    the int8 KV cache worked out again for the W8A8 configuration)."""
    cell = tiny(config)
    reqs, served, idx = _serve(cell)
    got = harness.compare(cell, SEED, reqs, served, idx, device="cpu")
    assert got["tokens"] >= 16 and got["max_logit_gap"] < 1e-5


@pytest.mark.parametrize("config", ["qwen2-vl-tiny-w8a8", "qwen2.5-vl-tiny"])
def test_the_control_fails_the_comparison(tiny, config):
    """The reference in the next precision below the configuration's (int4
    for W8A8, int8 W8A8 for bf16) puts other tokens first, past the limit."""
    cell = tiny(config)
    reqs, served, idx = _serve(cell)
    name, precision = next(iter(cell.config["controls"].items()))
    got = harness.compare(cell, SEED, reqs, served, idx, {name: precision}, device="cpu")
    assert got[name]["max_logit_gap"] > cell.limits["max_logit_gap"]["limit"]
    assert got[name]["mean_logit_gap"] > got["mean_logit_gap"] and got[name]["top1_miss_share"] > 0


def test_the_numbers_compared_are_read_over_every_token():
    gaps = [torch.tensor([0.0, 0.5, 0.0]), torch.tensor([0.0, 0.0, 2.0, 0.0, 0.5])]
    got = harness.gap_numbers(gaps)
    assert got["max_logit_gap"] == 2.0 and got["per_request"] == [0.5, 2.0] and got["tokens"] == 8
    assert got["mean_logit_gap"] == 3.0 / 8 and got["top1_miss_share"] == 3 / 8


def test_a_served_image_token_is_text_to_both_sides(tiny, monkeypatch):
    """Random weights can emit the image's token id as an answer token; the
    port then embeds it as text, and so does the reference: only the forced
    token itself lies below the reference's best."""
    from lmms_owc_tpu_torch.nn import qwen2_vl as nnq

    cell = tiny("qwen2.5-vl-tiny")
    image_id = cell.config["hf_config"]["image_token_id"]
    real, calls = nnq._sample_token, []

    def forced(logits, *args, **kw):
        calls.append(1)
        token = real(logits, *args, **kw)
        return torch.full_like(token, image_id) if len(calls) == 2 else token

    monkeypatch.setattr(nnq, "_sample_token", forced)
    reqs, served, idx = _serve(cell)
    hit = [i for i in idx if image_id in served[i]]
    assert hit
    ref = harness.reference(cell.config)
    arch = ref.arch(cell.config["hf_config"])
    state = harness.weights.draw(ref.hf_layout(cell.config["hf_config"]), SEED, torch.float32, "cpu")
    items = [dict(image=reqs[i].image, prompt=reqs[i].prompt, served=served[i]) for i in hit]
    for item, logits in zip(items, ref.served_logits(arch, cell.config, state, cell.config["precision"], items, "cpu")):
        tokens = torch.tensor(item["served"])
        gaps = logits.max(-1).values - logits.gather(-1, tokens[:, None])[:, 0]
        assert (gaps[tokens == image_id] > 0).all() and (gaps[tokens != image_id] < 1e-5).all(), gaps


def _run(cell, hook=None):
    import time

    out = harness.run(cell, SEED, 0.01, False, time.perf_counter(), device="cpu", program_hook=hook)
    return run_script.result_line(cell, out, False, "cpu")


def test_a_sound_run_is_correct(tiny):
    line = _run(tiny("qwen2-vl-tiny-w8a8"))
    assert line["correct"] and line["failed"] == 0 and list(line)[-1] == "checks"


def test_a_token_altered_where_it_is_produced_is_caught(tiny, monkeypatch):
    from lmms_owc_tpu_torch.nn import qwen2_vl as nnq

    real = nnq._sample_token
    calls = []

    def altered(logits, *args, **kw):
        token = real(logits, *args, **kw)
        calls.append(1)
        if len(calls) % 5 == 3:  # every fifth step's tokens, every row, in every call
            token = (token + 1) % logits.shape[-1]
        return token

    monkeypatch.setattr(nnq, "_sample_token", altered)
    line = _run(tiny("qwen2-vl-tiny-w8a8"))
    assert not line["correct"], line["checks"]


def test_a_step_that_leaves_the_cache_unchanged_is_caught(tiny, monkeypatch):
    from lmms_owc_tpu_torch.nn import qwen2_vl as nnq

    real = nnq.decode_step

    def stale(model, token_ids, position_ids, cache, *rest):
        return real(model, token_ids, position_ids, tuple(c.clone() for c in cache), *rest)

    monkeypatch.setattr(nnq, "decode_step", stale)
    line = _run(tiny("qwen2-vl-tiny-w8a8"))
    assert not line["correct"], line["checks"]


def test_a_missing_answer_is_a_failure(tiny):
    def drop(program):
        serve = program.model.generate_until
        program.model.generate_until = lambda reqs: serve(reqs)[:-1] + [None]

    line = _run(tiny("qwen2.5-vl-tiny"), drop)
    assert line["failed"] > 0 and not line["correct"]


@pytest.mark.card
def test_the_control_fails_at_the_cells_size_on_the_card(card):
    """One seed of each cell at its own size (the calibration's reading,
    ``owcbench/calibrate.py``): the program within every limit, the control
    past one of them; skipped without a card."""
    for w in harness.manifest()["workloads"]:
        cell = harness.cell(w["name"])
        reqs = traffic.make_requests(cell.traffic, SEED)
        program = harness.Program(cell, SEED)
        served = program.serve(program.requests(reqs, "test"))
        arch = program.arch
        program.close()
        idx = harness.sample(reqs, served, SEED, int(cell.config["check"]["requests"]), arch, cell.config)
        name, precision = next(iter(cell.config["controls"].items()))
        got = harness.compare(cell, SEED, reqs, served, idx, {name: precision})
        assert all(got[k] <= spec["limit"] for k, spec in cell.limits.items()), (w["name"], got)
        assert any(got[name][k] > spec["limit"] for k, spec in cell.limits.items()), (w["name"], got[name])
