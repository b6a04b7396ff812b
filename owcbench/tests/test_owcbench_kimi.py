"""Kimi-VL's configuration, reference and readers: the published size, the
work count, the two MoE metrics on synthetic records, and the check at a
tiny size (the port agrees with the reference; the int8 control fails)."""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from owcbench import harness, moe, roofline, traffic

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import run as run_script  # noqa: E402  (owcbench/run.py)

REPO = Path(__file__).resolve().parents[2]
CELL = "kimi-vl-a3b-bf16.sweep64"
SEED = 2**31 + 23


def _config():
    return json.loads((REPO / "owcbench" / "configs" / "kimi-vl-a3b-bf16.json").read_text())


def test_the_published_layout_holds_16_4_billion_parameters():
    ref = harness.reference(_config())
    layout = ref.hf_layout(_config()["hf_config"])
    n = sum(int(np.prod(shape)) for _, shape, _ in layout)
    assert abs(n / 1e9 - 16.4) <= 0.1
    names = {name for name, _, _ in layout}
    assert "language_model.model.layers.26.mlp.experts.63.down_proj.weight" in names
    assert "language_model.model.layers.0.mlp.gate_proj.weight" in names
    assert "language_model.model.layers.0.mlp.gate.weight" not in names
    kinds = {name: kind for name, _, kind in layout}
    assert kinds["language_model.model.layers.1.mlp.gate.e_score_correction_bias"] == "bias"


def test_the_configuration_is_the_catalogs_with_nothing_reduced():
    cfg = _config()
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    (entry,) = [c for c in bench["configs"] if c["name"] == cfg["name"]]
    assert entry["reduced"] == [] and entry["source"] == cfg["source"]
    hf = cfg["hf_config"]
    assert (hf["num_hidden_layers"], hf["n_routed_experts"], hf["num_experts_per_tok"], hf["n_shared_experts"]) == \
        (27, 64, 6, 2)
    assert (hf["hidden_size"], hf["moe_intermediate_size"], hf["kv_lora_rank"], hf["vocab_size"]) == \
        (2048, 1408, 512, 163840)
    # The published text config also stands at the file's top level, key for key.
    text = {k: v for k, v in hf.items() if k != "vision_config"}
    assert {k: cfg[k] for k in text} == text
    assert harness.cell(CELL, bench).traffic["name"] == "sweep64"


def test_work_counts_six_routed_and_two_shared_experts_a_token_and_the_tower():
    cfg = _config()
    ref = harness.reference(cfg)
    a = ref.arch(cfg["hf_config"])
    shape = dict(grid=(1, 16, 20), prompt_tokens=120)
    work = roofline.Work()
    ref.count_work(a, cfg, work, shape, 1)  # the prefill alone
    h, i, n = 2048, 1408, 120
    tower = roofline.Work()
    roofline.tower_work(tower, a["tower"], 320, None, False)
    per_token_moe = 26 * (6 + 2) * 3 * 2 * h * i + 26 * 2 * h * 64
    dense = 3 * 2 * h * 11264
    mla = 27 * (2 * h * 16 * 192 + 2 * h * 576 + 2 * 512 * 16 * 256 + 2 * 16 * 128 * h)
    attention = 27 * 2 * 16 * (192 + 128) * n * (n + 1) / 2
    head = 2 * h * 163840
    want = tower.bf16 + n * (per_token_moe + dense + mla) + attention + head
    assert work.int8 == 0 and work.bf16 == pytest.approx(want, rel=1e-12)
    more = roofline.Work()
    ref.count_work(a, cfg, more, shape, 3)  # two decode steps, absorbed attention over 121 and 122 keys
    step = per_token_moe + dense + 27 * (2 * h * 16 * 192 + 2 * h * 576 + 2 * 16 * 128 * 512 * 2 + 2 * 16 * 128 * h)
    assert more.bf16 - work.bf16 == pytest.approx(2 * (step + head) + 27 * 2 * 16 * (576 + 512) * (121 + 122),
                                                  rel=1e-12)


def _tallies():
    # Two shapes of call: decode calls of 96 rows x 6 (576 pairs) over 64 and
    # 63 experts, and one prefill call of 1000 pairs over 64.
    touched = [0.0] * 65
    touched[64], touched[63] = 10.0, 2.0
    prefill = [0.0] * 65
    prefill[64] = 1.0
    return [dict(routed_rows=576, experts=64, touched=touched, busiest_rows=12 * 20.0,
                 mean_rows=10 * 9.0 + 2 * 576 / 63),
            dict(routed_rows=1000, experts=64, touched=prefill, busiest_rows=40.0, mean_rows=1000 / 64)]


def _record(kernel_s, timeline=True):
    cfg = _config()
    tl = SimpleNamespace(kernel_s=kernel_s, busy_s=1.0, window_s=2.0) if timeline else None
    return SimpleNamespace(cell=SimpleNamespace(config=cfg), timeline=tl, hostprof={})


@pytest.fixture
def tallies(monkeypatch):
    from lmms_owc_tpu_torch.nn import kimi_vl

    monkeypatch.setattr(kimi_vl, "moe_tallies", _tallies)


def test_moe_roofline_sums_each_calls_bound_over_the_grouped_kernels(tallies):
    h, i = 2048, 1408
    bound = 0.0
    for rows, touched, calls in ((576, 64, 10), (576, 63, 2), (1000, 64, 1)):
        flops, nbytes = 6.0 * h * i * rows, 2 * (touched * 3.0 * h * i + 2.0 * rows * h)
        bound += calls * max(flops / roofline.PEAK_BF16_FLOPS, nbytes / roofline.PEAK_BYTES_PER_S)
    kernels = {"_ZN7cutlass13device_kernelIN2at4cuda6detail25GroupProblemShapeX": 0.02,
               "void at::cuda::detail::prepare_grouped_gemm_data<x>": 0.001, "nvjet_tst_64x48": 5.0}
    got = harness.reader("moe_roofline")(_record(kernels))
    assert got == pytest.approx(100.0 * bound / 0.021)
    assert 0 < got <= 100
    assert harness.reader("moe_roofline")(_record({"nvjet_tst_64x48": 5.0})) is None
    assert harness.reader("moe_roofline")(_record(kernels, timeline=False)) is None


def test_moe_load_balance_is_the_mean_over_the_busiest(tallies):
    got = harness.reader("moe_load_balance")(_record({}))
    t = _tallies()
    assert got == pytest.approx(100.0 * (t[0]["mean_rows"] + t[1]["mean_rows"]) / (240.0 + 40.0))
    assert moe.load_balance([]) is None


def test_readers_find_nothing_in_a_program_without_tallies(monkeypatch):
    from lmms_owc_tpu_torch.nn import kimi_vl

    monkeypatch.delattr(kimi_vl, "moe_tallies")
    assert harness.reader("moe_load_balance")(_record({})) is None
    assert harness.reader("moe_roofline")(_record({"GroupProblemShape": 1.0})) is None


def _serve(cell, seed=SEED):
    reqs = traffic.make_requests(cell.traffic, seed)
    program = harness.Program(cell, seed, device="cpu")
    served = program.serve(program.requests(reqs, "test"))
    arch = program.arch
    program.close()
    return reqs, served, harness.sample(reqs, served, seed, int(cell.config["check"]["requests"]), arch,
                                        cell.config)


def test_the_reference_agrees_with_the_port_and_the_int8_control_fails(tiny):
    """f32 at a tiny size: the served tokens are the reference's best; int8
    W8A8 (the configuration's first control) puts other tokens first, past
    the limit."""
    cell = tiny("kimi-vl-tiny")
    reqs, served, idx = _serve(cell)
    name, precision = next(iter(cell.config["controls"].items()))
    got = harness.compare(cell, SEED, reqs, served, idx, {name: precision}, device="cpu")
    assert got["tokens"] >= 16 and got["max_logit_gap"] < 1e-5
    assert got[name]["max_logit_gap"] > cell.limits["max_logit_gap"]["limit"] and got[name]["top1_miss_share"] > 0


def test_a_traced_cpu_run_reports_the_moe_metrics(tiny):
    """The tiny configuration traced on the CPU: the load balance is read
    from the program's tallies, the routed rows are the rows times the
    experts per token, the prefill's spans are there; the roofline needs a
    device trace."""
    from lmms_owc_tpu_torch.nn import kimi_vl
    from lmms_owc_tpu_torch.utils import _hostprof

    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cell = tiny("kimi-vl-tiny")
    cell.per_layer = [m for m in bench["per_layer"] if CELL in m.get("workloads", [])]
    _hostprof.counters_reset()
    kimi_vl.moe_tallies_reset()
    try:
        out = harness.run(cell, SEED, 0.01, True, time.perf_counter(), device="cpu")
        line = run_script.result_line(cell, out, True, "cpu")
        counters = dict(_hostprof.counters)
    finally:
        _hostprof.counters_reset()
        kimi_vl.moe_tallies_reset()
    assert line["correct"]
    metrics = line["metrics"]
    assert 0 < metrics["moe_load_balance"]["value"] <= 100 and "moe_roofline" not in metrics
    assert {"decode_row_fill", "prefill_token_fill", "decode_graph_share"} <= set(metrics)
    k = cell.config["hf_config"]["num_experts_per_tok"]
    assert counters["moe_routed_rows"] % k == 0 and counters["moe_calls"] > 0
    assert {"mla_attention", "moe_experts"} <= set(out["record"].hostprof)


def test_round_bf16_gives_bf16_values_without_bias():
    """Stochastic rounding: every value is a bf16 value, one of the two
    around it; the mean error vanishes; a generator of the same seed rounds
    the same way."""
    import torch

    ref = harness.reference(_config())
    x = torch.randn(4096, generator=torch.Generator().manual_seed(0)) * 3
    got = ref.round_bf16(x, torch.Generator().manual_seed(1))
    assert torch.equal(got, got.bfloat16().float())
    down = x.bfloat16().float()
    up = torch.nextafter(down.bfloat16(), torch.where(x > down, torch.inf, -torch.inf).bfloat16()).float()
    assert bool(((got == down) | (got == up) | (x == down)).all())
    assert abs(float((ref.round_bf16(x.repeat(64), torch.Generator().manual_seed(2)) - x.repeat(64)).mean())) < 1e-4
    assert torch.equal(got, ref.round_bf16(x, torch.Generator().manual_seed(1)))


def test_a_tokens_gap_is_its_least_over_the_held_trajectories(tiny, monkeypatch):
    """In the configuration's own precision each row is minus the least gap
    over the f32 trajectory and the held ones: a token's gap (best minus its
    logit) is that least gap, the f32 trajectory's row without held ones. A
    control's rows are one trajectory's logits."""
    import torch

    cell = tiny("kimi-vl-tiny")
    cfg = cell.config
    ref = harness.reference(cfg)
    a = ref.arch(cfg["hf_config"])
    state = harness.weights.draw(ref.hf_layout(cfg["hf_config"]), SEED, torch.float32, "cpu")
    reqs = traffic.make_requests(cell.traffic, SEED)[:2]
    items = [dict(image=r.image, prompt=r.prompt, served=[5, 6, 7, 8]) for r in reqs]
    seen = []
    real = ref.decoder_logits

    def spy(*args, **kw):
        out = real(*args, **kw)
        seen.append((args[5] if len(args) > 5 else kw.get("held", 0), out))
        return out

    monkeypatch.setattr(ref, "decoder_logits", spy)
    rows = ref.served_logits(a, cfg, state, cfg["precision"], items, "cpu")
    control = ref.served_logits(a, cfg, state, cfg["controls"]["int8"], items, "cpu")
    assert [h for h, _ in seen] == [ref.TRAJECTORIES, 0]
    monkeypatch.setattr(ref, "TRAJECTORIES", 0)
    plain = ref.served_logits(a, cfg, state, cfg["precision"], items, "cpu")
    for r, f32 in zip(rows, plain):
        assert float(r.max()) == 0.0
        least = -r
        assert bool((least <= f32.max(-1, keepdim=True).values - f32 + 1e-6).all())
        assert bool((least >= 0).all())
    assert all(not torch.equal(c, p) for c, p in zip(control, plain))
