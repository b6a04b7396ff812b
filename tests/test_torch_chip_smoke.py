"""``chip_smoke.py`` without a GPU: it must fail clearly and print no result."""

import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO_ROOT = Path(__file__).resolve().parent.parent


def _run(cwd: Path) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True, text=True, timeout=300
    )


def test_exits_nonzero_without_gpu():
    proc = _run(REPO_ROOT)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert '"ok": true' not in proc.stdout


def test_exits_nonzero_alone_in_a_directory(tmp_path):
    shutil.copy(REPO_ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run(tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_main_returns_1_when_cuda_is_absent(monkeypatch, capsys):
    import chip_smoke

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() == 1
    out = capsys.readouterr()
    assert "needs an NVIDIA GPU" in out.err and out.out == ""


def test_requests_match_the_main_path_workload():
    """Six 448x448 and two 336x448 images (the second size pads 768 patches to
    the 1024 bucket, so the masked vision path runs), 64 greedy tokens."""
    import chip_smoke
    from lmms_owc_tpu_torch.models import get_model

    model = get_model("qwen2-vl-tiny", batch_size=8, dtype="float32", device="cpu")
    reqs = chip_smoke._requests(model)
    assert len(reqs) == chip_smoke.NUM_REQUESTS == 8
    sizes = [model._fetch_visuals(r.args)[0].size for r in reqs]
    assert sizes.count((448, 448)) == 6 and sizes.count((448, 336)) == 2
    assert all(r.args[1]["max_new_tokens"] == 64 and not r.args[1]["do_sample"] for r in reqs)
    # Every kernel entry's launches come from a phase that requires them:
    # phases 3, 5 and 6, phase 7 (the combined-qkv entry) and phase 8 (packed).
    per_phase = set(chip_smoke.MIN_LAUNCHES) | set(chip_smoke.MIN_LAUNCHES_PER_DECODE_STEP)
    assert per_phase | {"fused_qkv_attention", "packed_vision_attention"} == set(chip_smoke.KERNELS)
    assert chip_smoke.MIN_LAUNCHES_PER_DECODE_STEP == {"gqa_decode_attention_int8": 28, "int4_matmul": 197}


@pytest.mark.parametrize(
    "name",
    [
        "vision_qkv_attention", "flash_attention", "gqa_decode_attention", "int4_matmul",
        "gqa_decode_attention_int8", "fused_qkv_attention", "packed_vision_attention",
    ],
)
def test_kernel_sources_exist(name):
    import chip_smoke

    source, replaces = chip_smoke.KERNELS[name]
    assert (REPO_ROOT / source).is_file()
    path, line = replaces.split(":")
    lines = (REPO_ROOT / path).read_text().splitlines()
    assert lines[int(line) - 1].startswith("def _")  # the Pallas kernel body


def test_pool_phase_workload():
    """Phase 5 is the JAX bench's serving shape: 96 448x448 requests at batch
    48, so two chunks of 48 rows make one pool of 96."""
    import chip_smoke
    from lmms_owc_tpu_torch.models import get_model

    model = get_model("qwen2-vl-tiny", batch_size=chip_smoke.POOL_BATCH, dtype="float32", device="cpu")
    reqs = chip_smoke._requests(model, [(448, 448)] * chip_smoke.POOL_REQUESTS)
    assert (chip_smoke.POOL_BATCH, chip_smoke.POOL_REQUESTS) == (48, 96) and len(reqs) == 96
    assert {model._fetch_visuals(r.args)[0].size for r in reqs} == {(448, 448)}
    assert set(chip_smoke.INT4_ROWS) == {96, 8}
    assert chip_smoke.INT4_SHAPES["down"] == (18944, 3584) and chip_smoke.INT4_SHAPES["lm_head"] == (3584, 152064)


def test_v25_phase_workload():
    """Phase 7 serves qwen2.5-vl-7b on six 448x448 and two 392x448 requests:
    the 448 grid's windows divide evenly, the 392x448 grid (28x32 patches)
    pads its last window row, so its 32 tower layers carry a tensor mask."""
    import chip_smoke
    from lmms_owc_tpu_torch.models import get_model
    from lmms_owc_tpu_torch.nn.qwen2_5_vl import Qwen25VisionConfig, get_window_layout

    model = get_model("qwen2.5-vl-tiny", batch_size=8, dtype="float32", device="cpu")
    reqs = chip_smoke._requests(model, chip_smoke.V25_SIZES)
    sizes = [model._fetch_visuals(r.args)[0].size for r in reqs]
    assert sizes.count((448, 448)) == 6 and sizes.count((448, 392)) == 2 and len(reqs) == 8
    v25 = Qwen25VisionConfig()
    even, _, _ = get_window_layout((1, 32, 32), v25)
    padded, windows, tokens = get_window_layout((1, 28, 32), v25)
    assert (even >= 0).all() and (windows, tokens) == (16, 64)
    assert int((padded >= 0).sum()) * 4 == 896 and not (padded >= 0).all()
    assert chip_smoke.MIN_LAUNCHES_V25 == {
        "fused_qkv_attention": 64, "flash_attention_tensor_mask": 32,
        "flash_attention": 28, "gqa_decode_attention": 28,
    }
    assert chip_smoke.PACKED_LAUNCHES == 32


def test_window_layout_helper_matches_the_adapter():
    """Phase 2 builds the 392x448 window mask as the adapter does."""
    import chip_smoke

    slot_src, valid, tok_idx, wn, s = chip_smoke._v25_window_layout((1, 28, 32))
    assert valid.shape == (wn * s,) == tok_idx.shape and int(valid.sum()) == 896
    assert (tok_idx[valid == 1] < 896).all() and sorted(tok_idx[valid == 1].tolist()) == list(range(896))


def test_compare_holds_max_abs_and_relative_l2(monkeypatch):
    """``_compare`` raises past atol + rtol * |want| on any element, and past
    the relative-L2 bound when one is given, even with every element inside."""
    import chip_smoke

    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    want = torch.full((4, 8), 0.01)
    err = chip_smoke._compare("x", want + 1e-4, want, atol=2e-3, rtol=0.0, rel_l2=2e-2)
    assert err == pytest.approx(1e-4, rel=1e-3)
    with pytest.raises(AssertionError, match="0 of 32 elements outside"):  # relative L2 0.1
        chip_smoke._compare("x", want + 1e-3, want, atol=2e-3, rtol=0.0, rel_l2=2e-2)
    with pytest.raises(AssertionError, match="32 of 32 elements outside atol=0.002 rtol=0.0"):
        chip_smoke._compare("x", want + 3e-3, want, atol=2e-3, rtol=0.0)
    with pytest.raises(AssertionError, match="non-finite"):
        chip_smoke._compare("x", want / 0, want)


@pytest.mark.parametrize("label", ["bf16", "f32", "int8"])
def test_long_cache_tolerance_rejects_dropped_keys(monkeypatch, label):
    """At the longest cache the adapter builds, the decode output with the last
    256 valid keys left out fails ``LONG_CACHE_TOL`` for each cache type."""
    import chip_smoke
    from lmms_owc_tpu_torch.nn.qwen2_vl import quantize_kv_cache
    from lmms_owc_tpu_torch.ops import attention as att

    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    b, nh, kvh, hd, s = 2, 28, 4, 128, chip_smoke.LONG_CACHE
    dtype = torch.float32 if label == "f32" else torch.bfloat16
    rng = np.random.default_rng(0)
    q, ck, cv = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dtype)
                 for shape in ((b, nh, hd), (1, b, kvh, s, hd), (1, b, kvh, s, hd)))
    cache = quantize_kv_cache(ck, cv) if label == "int8" else (ck, cv)
    spos = torch.arange(s)
    mask = ((spos[None, :] >= torch.tensor([0, 3])[:, None]) & (spos[None, :] < s - 300)).to(torch.int32)
    dropped = mask.clone()
    dropped[:, s - 556 : s - 300] = 0
    want = att.gqa_decode_attention_plain(q, *cache[:2], 0, mask, *cache[2:])
    got = att.gqa_decode_attention_plain(q, *cache[:2], 0, dropped, *cache[2:])
    atol, rel_l2 = chip_smoke.LONG_CACHE_TOL[label]
    assert atol <= (1e-4 if label == "f32" else 2e-3)
    with pytest.raises(AssertionError, match="outside atol"):
        chip_smoke._compare(label, got, want, atol=atol, rtol=0.0, rel_l2=rel_l2)
    assert chip_smoke._rel_l2(got.float(), want.float()) > 5 * rel_l2


def test_decode_row_instance_is_read_from_the_profiler():
    """A K3 row's instance comes from the kernel names the profiler saw: a
    bf16 query must have run the Hopper instance (``sm90::decode_kernel``,
    demangled or not), an f32 query the general kernel; any other pairing
    fails the row, and a row that ran no attention kernel names none."""
    import chip_smoke

    hopper = "void (anonymous namespace)::sm90::decode_kernel<signed char, 96>(DecodeArgs)"
    mangled = "_ZN12_GLOBAL__N_14sm9013decode_kernelI13__nv_bfloat16Li128EEEv10DecodeArgs"
    general = "void (anonymous namespace)::decode_kernel<float, float>(DecodeArgs)"
    bf16_row = "q [8, 32, 96] bf16, cache [32, 8, 32, 3136, 96] int8 + f32 scales, G = 1"
    f32_row = "q [8, 28, 128] f32, cache [2, 8, 4, 8704, 128] f32"
    assert chip_smoke._check_instance(bf16_row, [hopper, "elementwise_kernel"]) == "sm90"
    assert chip_smoke._check_instance(bf16_row, [mangled]) == "sm90"
    assert chip_smoke._check_instance(f32_row, [general]) == "general"
    assert chip_smoke._check_instance(bf16_row, ["elementwise_kernel"]) is None
    for shape, symbols in ((bf16_row, [general]), (f32_row, [hopper]), (bf16_row, [hopper, general])):
        with pytest.raises(AssertionError, match="decode kernel"):
            chip_smoke._check_instance(shape, symbols)


def test_int8_long_rows_reject_dropped_keys(monkeypatch):
    """The int8 rows past 2048 positions (``_decode_rows``: ``TOL`` element-wise
    with ``LONG_CACHE_TOL``'s relative L2) fail a decode that leaves out one
    64-key tile of valid keys, at InternVL2's G = 6 over 2112 positions with
    its 279- and 1815-token prompts."""
    import chip_smoke
    from lmms_owc_tpu_torch.nn.qwen2_vl import quantize_kv_cache
    from lmms_owc_tpu_torch.ops import attention as att

    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    b, nh, kvh, hd, prompt, s = 2, 12, 2, 128, 2048, 2112
    rng = np.random.default_rng(1)
    q, ck, cv = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(torch.bfloat16)
                 for shape in ((b, nh, hd), (1, b, kvh, s, hd), (1, b, kvh, s, hd)))
    cache = quantize_kv_cache(ck, cv)
    spos = torch.arange(s)
    starts = prompt - torch.tensor([279, 1815])
    mask = ((spos[None, :] >= starts[:, None]) & (spos[None, :] < prompt + 5)).to(torch.int32)
    dropped = mask.clone()
    dropped[:, 1984:2048] = 0
    want = att.gqa_decode_attention_plain(q, *cache[:2], 0, mask, *cache[2:])
    got = att.gqa_decode_attention_plain(q, *cache[:2], 0, dropped, *cache[2:])
    with pytest.raises(AssertionError, match="relative L2"):
        chip_smoke._compare("int8", got, want, atol=chip_smoke.TOL, rtol=chip_smoke.TOL,
                            rel_l2=chip_smoke.LONG_CACHE_TOL["int8"][1])
    assert chip_smoke._rel_l2(got.float(), want.float()) > 5 * chip_smoke.LONG_CACHE_TOL["int8"][1]


def test_int4_step_sums_one_decode_step():
    """The per-step K4 sum weighs each product by its calls in one decode step:
    q, o, k, v, gate, up and down in each of 28 layers, then the head."""
    import chip_smoke

    rows = {f"{p} M=8": dict(device_ms=t, library_device_ms=2 * t, bound_ms=t / 10)
            for p, t in (("q/o", 1.0), ("k/v", 2.0), ("gate/up", 3.0), ("down", 4.0), ("lm_head", 5.0))}
    step = chip_smoke._int4_step(rows, 8)
    assert step["launches"] == 197
    assert step["device_ms"] == pytest.approx(28 * (2 * 1 + 2 * 2 + 2 * 3 + 4) + 5)
    assert step["library_device_ms"] == pytest.approx(2 * step["device_ms"])
    rows["down M=8"]["library_device_ms"] = None
    assert chip_smoke._int4_step(rows, 8)["library_device_ms"] is None


def test_safetensors_writer_matches_safe_open(tmp_path):
    """Phase 9's writer: every dtype the port's reader takes, odd shapes, a
    scalar and an empty tensor, read back by ``safetensors.safe_open``."""
    import chip_smoke
    from safetensors import safe_open

    g = torch.Generator().manual_seed(0)
    tensors = {
        "bf16": torch.randn(3, 5, generator=g).bfloat16(), "f16": torch.randn(7, generator=g).half(),
        "f32": torch.randn(2, 3, 4, generator=g), "i8": torch.randint(-128, 127, (1, 9), generator=g).to(torch.int8),
        "i32": torch.randint(-(2**31), 2**31 - 1, (), generator=g, dtype=torch.int64).to(torch.int32),
        "i64": torch.randint(-(2**40), 2**40, (0, 4), generator=g, dtype=torch.int64),
        "u8": torch.randint(0, 255, (33,), generator=g).to(torch.uint8),
        "bool": torch.randint(0, 2, (4, 4), generator=g).bool(),
        "view": torch.randn(6, 4, generator=g)[:, 1:3],  # not contiguous
    }
    path = tmp_path / "w.safetensors"
    assert chip_smoke.write_safetensors(path, tensors) == path.stat().st_size
    with safe_open(str(path), framework="pt") as f:
        assert list(f.keys()) == sorted(tensors)
        for name, want in tensors.items():
            got = f.get_tensor(name)
            assert got.dtype == want.dtype and got.shape == want.shape and torch.equal(got, want), name


def test_checkpoint_writer_round_trip(tmp_path, monkeypatch):
    """Phase 9's checkpoint, cut into several shards, is what the JAX package's
    reader (``safe_open``) and the port's loader read back: the published
    names, the Conv3d patch kernel in its 5-d shape, and every parameter of
    the port model loaded with ``pretrained=`` bit-equal to the written one."""
    import json

    import chip_smoke
    from lmms_owc_tpu.nn.loader import load_safetensors_state as jax_reader
    from lmms_owc_tpu_torch.models import get_model

    src = get_model("qwen2-vl-tiny", random_init=True, batch_size=2, dtype="bfloat16", device="cpu")
    monkeypatch.setattr(chip_smoke, "SHARD_BYTES", 4 << 20)
    out = chip_smoke.write_checkpoint(src.model, "qwen2-vl-tiny", tmp_path)
    index = json.loads((tmp_path / "model.safetensors.index.json").read_text())
    assert out["shards"] == len(set(index["weight_map"].values())) > 1
    state = jax_reader(tmp_path)
    assert len(state) == len(index["weight_map"]) == len(list(src.model.parameters()))
    assert state["visual.patch_embed.proj.weight"].shape == (32, 3, 2, 14, 14)
    assert "lm_head.weight" not in state  # the tiny preset ties its head to the embedding
    assert {"model.embed_tokens.weight", "model.norm.weight", "visual.merger.mlp.0.bias",
            "model.layers.1.self_attn.q_proj.bias", "visual.blocks.0.attn.qkv.weight"} <= set(state)
    loaded = get_model("qwen2-vl-tiny", pretrained=str(tmp_path), batch_size=2, dtype="bfloat16", device="cpu")
    assert loaded.tokenizer.eos_token_id == chip_smoke.QWEN2_SPECIAL_IDS["<|im_end|>"]
    assert chip_smoke._same_parameters(loaded.model, src.model, "round trip") == len(state)


# ------------------------------------------------------------------ phase 12


@pytest.fixture(scope="module")
def tiny_checkpoint(tmp_path_factory):
    from tests.test_torch_checkpoint import _build

    path = tmp_path_factory.mktemp("phase12_ckpt")
    _build(path, "qwen2-vl-tiny")
    return path


def test_cli_phase_argument_lists():
    """Phase 12 runs the four toy tasks (all three request types, and
    toy_semantic's scoring metrics; 12 documents each) from the checkpoint at
    batch 8; the subprocess runs ``toy`` on 4 documents."""
    import chip_smoke

    argv = chip_smoke.cli_argv("qwen2-vl-7b", Path("/ckpt"), "dtype=bfloat16", chip_smoke.CLI_TASKS, Path("/out"))
    flags = {flag: argv[i + 1] for i, flag in enumerate(argv) if flag.startswith("--") and flag != "--log_samples"}
    assert flags["--model"] == "qwen2-vl-7b" and flags["--model_args"] == "pretrained=/ckpt,dtype=bfloat16"
    assert flags["--tasks"] == "toy,toy_mc,toy_multiround,toy_semantic" and flags["--batch_size"] == "8"
    assert Path(flags["--include_path"]) == (REPO_ROOT / "tests" / "fixtures" / "tasks")
    assert "--log_samples" in argv and flags["--seed"] == "0,1234,1234,1234" and "--limit" not in argv
    sub = chip_smoke.cli_argv("qwen2-vl-7b", Path("/ckpt"), "dtype=bfloat16", ("toy",), Path("/o"), limit=4)
    assert sub[-2:] == ["--limit", "4"] and chip_smoke.CLI_SUBPROCESS_LIMIT == 4
    assert chip_smoke.CLI_SUITE == ("toy_suite", ("toy", "toy_mc", "toy_semantic"))
    assert chip_smoke.CLI_DOCS == 12 and set(chip_smoke.CLI_METRICS) == set(chip_smoke.CLI_TASKS)
    assert set(chip_smoke.CLI_LAUNCHES) == set(chip_smoke.MIN_LAUNCHES)


def test_cli_phase_runs_on_the_cpu(tiny_checkpoint, toy_dataset):
    """Phase 12's code on the tiny checkpoint with ``device=cpu``: the
    reference, the in-process CLI run, its checks and the subprocess; the
    summary carries its seconds, timings, metrics, launches, peak and load."""
    import chip_smoke
    from lmms_owc_tpu_torch.models import get_model

    model = get_model("qwen2-vl-tiny", pretrained=str(tiny_checkpoint), dtype="float32", device="cpu")
    reference = chip_smoke.cli_reference(model, "qwen2-vl-tiny")
    assert len(reference) == chip_smoke.CLI_DOCS and model.batch_size == 8
    summary = chip_smoke.run_cli(torch.device("cpu"), "qwen2-vl-tiny", tiny_checkpoint, reference,
                                 model_args="dtype=float32,device=cpu", pooled_int8=False, min_launches=())
    assert set(summary) == {"bf16", "subprocess", "phase_seconds"}
    assert set(summary["bf16"]) == {"seconds", "timings", "load_seconds", "metrics", "counts", "peak_gb"}
    assert set(summary["bf16"]["timings"]["inference"]) == {"generate_until", "loglikelihood",
                                                            "generate_until_multi_round"}
    assert set(summary["bf16"]["metrics"]) == {f"{t}/{m}" for t, ms in chip_smoke.CLI_METRICS.items() for m in ms}
    assert summary["subprocess"]["returncode"] == 0 and set(summary["subprocess"]["metrics"]) == {
        f"{t}/{m}" for t in chip_smoke.CLI_SUITE[1] for m in chip_smoke.CLI_METRICS[t]}


@pytest.mark.parametrize("fault", ["reference", "launches", "subprocess"])
def test_cli_phase_fails_loudly(tiny_checkpoint, toy_dataset, fault, monkeypatch):
    """A toy response that differs from the reference, a kernel of the path
    that did not launch, or a subprocess that fails raises; ``main`` catches
    nothing, so the smoke exits non-zero."""
    import ast

    import chip_smoke
    from lmms_owc_tpu_torch.models import get_model

    model = get_model("qwen2-vl-tiny", pretrained=str(tiny_checkpoint), dtype="float32", device="cpu")
    reference = chip_smoke.cli_reference(model, "qwen2-vl-tiny")
    kwargs = dict(model_args="dtype=float32,device=cpu", pooled_int8=False, min_launches=())
    if fault == "reference":
        reference[5] += " changed"
    elif fault == "launches":
        kwargs["min_launches"] = chip_smoke.CLI_LAUNCHES  # nothing launches a kernel on the CPU
    else:
        monkeypatch.setattr(chip_smoke, "CLI_SUBPROCESS_LIMIT", "not-a-number")
    with pytest.raises(AssertionError, match="CLI"):
        chip_smoke.run_cli(torch.device("cpu"), "qwen2-vl-tiny", tiny_checkpoint, reference, **kwargs)
    tree = ast.parse((REPO_ROOT / "chip_smoke.py").read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    assert not [n for n in ast.walk(main) if isinstance(n, ast.ExceptHandler)]
    assert "run_cli" in {n.func.id for n in ast.walk(main) if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)}


# ------------------------------------------------------------------ phase 13


def test_scoring_phase_workload():
    """Phase 13's shapes: MiniLM-L6's published config and a 30522-entry
    vocabulary holding the toy answers' words; 4096 sentences at batch 1024;
    the judge at Llama-3.2-3B's width (its checkpoint cut in depth only), 256
    prompts at batch 64, pool 2; the four scoring metrics; the Llama-3
    specials at their published ids."""
    import chip_smoke
    from lmms_owc_tpu_torch.nn.judge import LLAMA32_3B_CONFIG

    assert (chip_smoke.SBERT_SENTENCES, chip_smoke.SBERT_BATCH) == (4096, 1024)
    assert (chip_smoke.JUDGE_PROMPTS, chip_smoke.JUDGE_BATCH, chip_smoke.JUDGE_POOL) == (256, 64, 2)
    cfg = chip_smoke.MINILM_CONFIG
    assert (cfg["hidden_size"], cfg["num_hidden_layers"], cfg["num_attention_heads"], cfg["vocab_size"]) == (
        384, 6, 12, 30522)
    vocab = chip_smoke.minilm_vocab()
    assert len(vocab) == len(set(vocab)) == 30522 and vocab[100:104] == ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    assert {"red", "panda", "golden", "retriever", "turtle", "jay"} <= set(vocab)
    judge_cfg = chip_smoke.judge_checkpoint_config()
    assert {k: v for k, v in judge_cfg.items() if k not in ("num_hidden_layers", "model_type", "architectures")} == (
        {k: v for k, v in LLAMA32_3B_CONFIG.items() if k != "num_hidden_layers"})
    assert judge_cfg["num_hidden_layers"] == chip_smoke.JUDGE_CKPT_LAYERS < LLAMA32_3B_CONFIG["num_hidden_layers"]
    ids = chip_smoke.LLAMA3_SPECIAL_IDS
    assert sorted(ids.values()) == list(range(128000, 128256)) and ids["<|eot_id|>"] == 128009
    assert chip_smoke.SCORING_METRICS == ("semantic_similarity", "mean_average_semantic_similarity",
                                          "concept_semantic_similarity", "textual_inclusion_llama32")
    sentences = chip_smoke.scoring_sentences(64)
    assert len(sentences) == 64 and all(3 <= len(x.split()) <= 28 for x in sentences)
    assert chip_smoke.scoring_sentences(64) == sentences  # from the seed


@pytest.fixture
def tiny_scoring(monkeypatch, tmp_path):
    """Phase 13 at a tiny size on the CPU: a 2-layer MiniLM, a 1-layer judge
    (full vocabulary), few sentences and prompts; the scoring models on the
    CPU; phase 12's samples as two players."""
    import json

    import chip_smoke
    from lmms_owc_tpu_torch.nn import judge

    tiny = dict(judge.LLAMA32_3B_CONFIG, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, intermediate_size=64)
    monkeypatch.setattr(judge, "LLAMA32_3B_CONFIG", tiny)
    monkeypatch.setattr(chip_smoke, "MINILM_CONFIG", dict(chip_smoke.MINILM_CONFIG, hidden_size=48,
                                                          num_hidden_layers=2, num_attention_heads=4,
                                                          intermediate_size=64))
    for name, value in (("SBERT_SENTENCES", 40), ("SBERT_BATCH", 16), ("JUDGE_PROMPTS", 12), ("JUDGE_BATCH", 4),
                        ("RANKING_GAMES", 24), ("RANKING_ROUNDS", 4)):
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setenv("LMMS_OWC_SCORING_DEVICE", "cpu")
    for var in ("LMMS_OWC_SBERT_PATH", "LMMS_OWC_JUDGE_PATH", "LMMS_OWC_JUDGE_DECODE_POOL", "LMMS_OWC_KV_INT8"):
        monkeypatch.delenv(var, raising=False)
    cli = tmp_path / "cli"
    for run, tasks in (("a", ("toy", "toy_mc", "toy_multiround", "toy_semantic")), ("b", ("toy",))):
        out = cli / run / "model"
        out.mkdir(parents=True)
        for task in tasks:
            rows = [{"doc_id": i, "target": ["red panda", "blue jay"][i % 2],
                     "filtered_resps": [["a red panda"]] if task == "toy_multiround" else [f"a {run} bird {i}"]}
                    for i in range(6)]
            (out / f"x_samples_{task}.jsonl").write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    sbert_dir = tmp_path / "minilm"
    sbert_dir.mkdir()
    chip_smoke.write_sbert_checkpoint(torch.device("cpu"), sbert_dir)
    return tmp_path, cli, sbert_dir


def test_scoring_phase_runs_on_the_cpu(tiny_scoring):
    """Phase 13's code on the CPU at a tiny size: (a) the written MiniLM
    checkpoint encodes and agrees with the plain path, (b) the judge forms
    give pooled answers equal to unpooled ones, (c) the judge checkpoint and
    the offline CLIs score with no fallback; the summary keys."""
    import chip_smoke
    from lmms_owc_tpu_torch.nn.judge import JudgeModel

    root, cli, sbert_dir = tiny_scoring
    summary = chip_smoke.run_scoring(torch.device("cpu"), cli, root, sbert_dir)
    assert set(summary) == {"sbert", "judge", "judge_checkpoint", "offline", "phase_seconds"}
    assert set(summary["sbert"]) == {"sentences", "batch", "length_buckets", "seconds", "sentences_per_s",
                                     "flash_launches", "max_abs_err"}
    assert summary["sbert"]["sentences"] == 40 and summary["sbert"]["max_abs_err"] == 0.0
    forms = summary["judge"]["forms"]
    assert set(forms) == {"bf16", "bf16_pool2", "int8_kv_int8", "int8_kv_int8_pool2"}
    assert forms["bf16"]["pooled_same_rows"] == forms["int8_kv_int8"]["pooled_same_rows"] == 12
    assert {"prompts", "seconds", "prompts_per_s", "peak_gb", "decode_steps", "counts"} <= set(forms["bf16_pool2"])
    offline = summary["offline"]
    assert offline["scorers"] == {"sentence_encoder": "SentenceEncoder", "judge": "JudgeModel"}
    assert offline["judge_checkpoint_layers"] == chip_smoke.JUDGE_CKPT_LAYERS
    assert set(offline["players"]) == {"qwen2-vl-7b-bf16", "qwen2-vl-7b-int8-pool2"}
    assert set(offline["eval_metrics"]["results"]) == {"toy", "toy_multiround", "toy_semantic"}
    assert set(offline["ranking"]) == {"llama_score", "semantic_similarity"}
    from lmms_owc_tpu_torch.pipelines import text

    assert text._sentence_encoder is None and text._judge is None  # the phase frees its scorers
    assert JudgeModel  # the type the phase requires of the judge singleton


@pytest.mark.parametrize("fault", ["fallback", "pooled"])
def test_scoring_phase_fails_loudly(tiny_scoring, fault, monkeypatch):
    """A fallback scorer taken by the offline CLIs (the judge path missing), or
    pooled answers that differ from unpooled ones, raises; ``main`` catches
    nothing and calls the phase."""
    import ast

    import chip_smoke
    from lmms_owc_tpu_torch.nn.judge import JudgeModel

    root, cli, sbert_dir = tiny_scoring
    dev = torch.device("cpu")
    if fault == "fallback":
        with pytest.raises(AssertionError, match="fallback"):
            chip_smoke.run_offline(dev, cli, root, sbert_dir, root / "no_judge_here")
    else:
        pooled = JudgeModel._generate_pooled
        monkeypatch.setattr(JudgeModel, "_generate_pooled",
                            lambda self, prompts, n: [s + " x" for s in pooled(self, prompts, n)])
        with pytest.raises(AssertionError, match="pooled answers differ"):
            chip_smoke.check_judge(dev, make=lambda int8: JudgeModel.random_init(0, dtype=torch.float32,
                                                                                 load_in_8bit=int8, device="cpu"))
    tree = ast.parse((REPO_ROOT / "chip_smoke.py").read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    assert not [n for n in ast.walk(main) if isinstance(n, ast.ExceptHandler)]
    assert "run_scoring" in {n.func.id for n in ast.walk(main) if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)}


# ------------------------------------------------------------- phases 3b, 14-17


def test_clip_and_llava_phase_workloads():
    """Phase 14 scores 64 images of eight sizes against 16 prompts at
    openai/clip-vit-large-patch14's config; phase 17's two llava-next images
    make prompts of bucket 3072 and a decode cache past 2048 positions."""
    import chip_smoke
    from lmms_owc_tpu_torch.models.llava_hf import PRESET_CONFIGS, _FallbackLlavaTokenizer
    from lmms_owc_tpu_torch.nn import anyres
    from lmms_owc_tpu_torch.utils import pad_to_bucket

    assert chip_smoke.MIN_POOL_AGREEMENT == 1.0 and chip_smoke.POOL_CHECK_BATCH == 4
    vision, text = chip_smoke.CLIP_CONFIG["vision_config"], chip_smoke.CLIP_CONFIG["text_config"]
    assert (vision["hidden_size"], vision["num_hidden_layers"], vision["num_attention_heads"], vision["patch_size"],
            vision["image_size"]) == (1024, 24, 16, 14, 224)
    assert (text["hidden_size"], text["num_hidden_layers"], text["num_attention_heads"], text["vocab_size"],
            text["max_position_embeddings"]) == (768, 12, 12, 49408, 77)
    assert chip_smoke.CLIP_IMAGES == 64 and len(chip_smoke.CLIP_CLASSES) == 16
    assert (chip_smoke.CLIP_VISION_LAUNCHES, chip_smoke.CLIP_TEXT_LAUNCHES) == (
        vision["num_hidden_layers"], text["num_hidden_layers"])
    pins = PRESET_CONFIGS["llava-next-vicuna-7b"]["image_grid_pinpoints"]
    prompt = _FallbackLlavaTokenizer(32000).encode("USER: <image>\n" + chip_smoke.PROMPT + " ASSISTANT:")
    lengths = []
    for hw in chip_smoke.LLAVA_NEXT_SIZES:
        n_h, n_w = anyres.anyres_grid_shape(hw, pins, 336)
        tiles = torch.zeros(1 + n_h * n_w, 576, 1)
        packed = anyres.pack_anyres_features(tiles, hw, pins, 336, 14, torch.zeros(1), max_patches=None)
        lengths.append(len(prompt) - 1 + packed.shape[0])
    assert tuple(lengths) == chip_smoke.LLAVA_NEXT_PROMPT_TOKENS
    assert pad_to_bucket(max(lengths)) == 3072 and pad_to_bucket(max(lengths)) + chip_smoke.MAX_NEW_TOKENS > 2048
    assert len(prompt) - 1 + 576 == chip_smoke.LLAVA_PROMPT_TOKENS and pad_to_bucket(587) == 640
    cfg = chip_smoke.llava_checkpoint_config()
    assert cfg["text_config"]["num_hidden_layers"] == chip_smoke.LLAVA_CKPT_LAYERS == 2
    assert cfg["text_config"]["hidden_size"] == 4096 and cfg["pad_token_id"] == 32001


def test_clip_vocab_is_clips_layout():
    import chip_smoke
    from lmms_owc_tpu_torch.tokenizer import Tokenizer, clip_tokenizer_spec

    vocab, merges = chip_smoke.clip_vocab()
    specials = [{"id": vocab[t], "content": t, "normalized": True, "special": True}
                for t in ("<|startoftext|>", "<|endoftext|>")]
    tok = Tokenizer(clip_tokenizer_spec(vocab, merges, specials, "<|startoftext|>", "<|endoftext|>",
                                        "<|endoftext|>"), pad_token="<|endoftext|>")
    prompts = [f"a photo of a {c}." for c in chip_smoke.CLIP_CLASSES]
    assert tok(prompts)["input_ids"].shape == (16, chip_smoke.CLIP_TEXT_LEN)  # phase 2's CLIP text row
    assert len(vocab) == 49408 and sorted(vocab.values()) == list(range(49408))
    assert vocab["<|startoftext|>"] == 49406 and vocab["<|endoftext|>"] == 49407
    assert all(a + b in vocab for a, b in (m.split() for m in merges)) and "cat</w>" in vocab


def test_clip_checkpoint_writer_round_trip(tmp_path, monkeypatch):
    """Phase 14's checkpoint at a tiny config: ``transformers``' CLIPModel and
    processor read it, and the port's scorer gives their logits."""
    from PIL import Image
    from transformers import CLIPModel, CLIPProcessor

    import chip_smoke
    from lmms_owc_tpu_torch import no_tf32
    from lmms_owc_tpu_torch.nn.clip import ClipScorer

    no_tf32()
    tiny = dict(chip_smoke.CLIP_CONFIG, projection_dim=16,
                vision_config=dict(chip_smoke.CLIP_CONFIG["vision_config"], hidden_size=32, num_hidden_layers=2,
                                   num_attention_heads=2, intermediate_size=64, projection_dim=16),
                text_config=dict(chip_smoke.CLIP_CONFIG["text_config"], hidden_size=32, num_hidden_layers=2,
                                 num_attention_heads=2, intermediate_size=64, projection_dim=16))
    monkeypatch.setattr(chip_smoke, "CLIP_CONFIG", tiny)
    out = chip_smoke.write_clip_checkpoint(torch.device("cpu"), tmp_path)
    assert out["vocab"] == 49408
    rng = np.random.RandomState(0)
    images = [Image.fromarray(rng.randint(0, 255, (h, w, 3), dtype=np.uint8)) for h, w in chip_smoke.CLIP_SIZES[:4]]
    prompts = [f"a photo of a {c}." for c in chip_smoke.CLIP_CLASSES[:5]]
    hf = CLIPModel.from_pretrained(str(tmp_path)).eval()
    inputs = CLIPProcessor.from_pretrained(str(tmp_path))(images=images, text=prompts, return_tensors="pt",
                                                          padding=True)
    with torch.no_grad():
        want = hf(**inputs).logits_per_image.numpy()
    got = ClipScorer.from_pretrained(str(tmp_path), device="cpu").score(images, prompts)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_llava_checkpoint_writer_round_trip(tmp_path):
    """Phase 16's writer at llava-tiny's widths: ``transformers``'
    LlavaForConditionalGeneration reads every tensor, and the port loads
    every parameter bit-equal with the Llama-2-form tokenizer."""
    from transformers import AutoTokenizer, LlavaForConditionalGeneration

    import chip_smoke
    from lmms_owc_tpu_torch.models import get_model
    from lmms_owc_tpu_torch.models.llava_hf import PRESET_CONFIGS
    from lmms_owc_tpu_torch.nn import llava as lv

    cfg = dict(PRESET_CONFIGS["llava-tiny"], model_type="llava", pad_token_id=32001)
    cfg["text_config"] = dict(cfg["text_config"], tie_word_embeddings=False)
    written = lv.init_llava_params(lv.LlavaModel(lv.llava_config_from_hf(cfg), torch.float32, "meta"),
                                   torch.Generator().manual_seed(0))
    chip_smoke.write_llava_checkpoint(written, cfg, tmp_path, "tiny")
    hf = LlavaForConditionalGeneration.from_pretrained(str(tmp_path))
    hf_state = hf.state_dict()
    layout = dict(chip_smoke._hf_layout(written, chip_smoke._NameProbe(chip_smoke.LLAVA_HF_PREFIXES)))
    assert len(layout) == len(list(written.parameters()))
    assert torch.equal(hf_state["model.language_model.layers.1.self_attn.o_proj.weight"],
                       written.text.layers[1].o.weight)
    assert torch.equal(hf_state["model.vision_tower.vision_model.embeddings.patch_embedding.weight"].flatten(1),
                       written.vision.patch_embed.weight)
    assert torch.equal(hf_state["lm_head.weight"], written.text.lm_head.weight)
    loaded = get_model("llava-1.5-7b", pretrained=str(tmp_path), dtype="float32", device="cpu")
    assert chip_smoke._same_parameters(loaded.model, written, "round trip") == len(layout)
    prompt = "USER: <image>\n" + chip_smoke.PROMPT + " ASSISTANT:"
    assert loaded.tokenizer.encode(prompt) == AutoTokenizer.from_pretrained(str(tmp_path)).encode(prompt)


def _cpu_serve(model, requests, tokens=None, require_text=True):
    """``_serve`` without the card's clocks and counters."""
    import chip_smoke

    with chip_smoke._decode_steps() as steps, chip_smoke._tokens(model, tokens if tokens is not None else []):
        model.generate_until(requests)
    return dict(seconds=0.0, decode_steps=len(steps), phase_seconds={})


@pytest.mark.parametrize("fault", [False, True])
def test_pool_rows_check(monkeypatch, fault):
    """Phase 3b's check on qwen2-vl-tiny on the CPU with the card's 128-row
    blocks: two chunks of 4 unpooled, one pool of 8; every row the same, and
    a row that differs fails the phase."""
    import chip_smoke
    from lmms_owc_tpu_torch.models import get_model
    from lmms_owc_tpu_torch.models.qwen2_vl import DECODE_ROWS

    model = get_model("qwen2-vl-tiny", batch_size=8, dtype="float32", device="cpu")
    model.decode_rows = DECODE_ROWS
    serve = _cpu_serve
    if fault:
        def serve(model, requests, tokens=None, require_text=True):
            out = _cpu_serve(model, requests, tokens)
            if len(tokens) == 1:  # the pooled run
                tokens[0][5, 3] += 1
            return out
    monkeypatch.setattr(chip_smoke, "_serve", serve)
    if fault:
        with pytest.raises(AssertionError, match=r"differ from unpooled ones on rows \[5\]"):
            chip_smoke.check_pool_rows(model, "cpu")
        return
    out = chip_smoke.check_pool_rows(model, "cpu")
    assert out["rows"] == out["same_rows"] == 8 and out["decode_rows"] == 128 and model.batch_size == 8
    assert out["decode_steps"]["unpooled"] > out["decode_steps"]["pool2"] > 0 and model.decode_rows == DECODE_ROWS


def test_per_call_reads_launches_around_each_call():
    """``_per_call`` records each call's launches (the counters' difference
    across it) and puts the entry back afterwards."""
    import types

    import chip_smoke
    from lmms_owc_tpu_torch.ops import attention as att

    def tower(n):
        att.launch_counts["flash_attention"] += n
        return n

    mod = types.SimpleNamespace(tower=tower)
    chip_smoke._reset_counts()
    try:
        with chip_smoke._per_call((mod, "tower")) as calls:
            assert [mod.tower(24), mod.tower(0), mod.tower(12)] == [24, 0, 12]
    finally:
        chip_smoke._reset_counts()
    assert calls == {"tower": [{"flash_attention": 24}, {}, {"flash_attention": 12}]} and mod.tower is tower


@pytest.mark.parametrize("fault", [None, "tower_and_prefill_swapped", "decode_steps_uneven", "int8_cache"])
def test_llava_launch_check_reads_each_call(fault):
    """Phases 15 and 17 hold the launches of each tower call (23), the prefill
    (32) and each decode step (32 K3): equal totals split otherwise fail."""
    import chip_smoke

    steps = 3
    tower, prefill, decode = [{"flash_attention": 23}] * 2, [{"flash_attention": 32}], [{"gqa_decode_attention": 32}] * 3
    if fault == "tower_and_prefill_swapped":
        tower, prefill = [{"flash_attention": 32}, {"flash_attention": 14}], [{"flash_attention": 32}]
    elif fault == "decode_steps_uneven":
        decode = [{"gqa_decode_attention": 31}, {"gqa_decode_attention": 33}, {"gqa_decode_attention": 32}]
    run = dict(decode_steps=steps, per_call={"encode_images": tower, "prefill": prefill, "decode_step": decode},
               counts={"flash_attention": 78, "gqa_decode_attention": 96, "gqa_decode_attention_int8": 0})
    check = lambda: chip_smoke._check_llava_launches(run, "tiny", tower_calls=2, kv_int8=fault == "int8_cache")
    if fault is None:
        check()
    else:
        with pytest.raises(AssertionError, match="launches per call"):
            check()


def test_pool_divergence_probe_on_the_cpu():
    """The decode-rows probe's divergence finder on qwen2-vl-tiny: on the
    CPU the float products part by row count, so pooled decoding parts from
    unpooled at some step whose inputs were still equal, in a named call."""
    import chip_smoke
    from lmms_owc_tpu_torch.models import get_model

    model = get_model("qwen2-vl-tiny", batch_size=8, dtype="float32", device="cpu")
    out = chip_smoke._pool_divergence(model)
    assert out["steps"] == chip_smoke.MAX_NEW_TOKENS - 1 and out["first_parting_step"]["chunk 0"] is not None
    assert all(out["inputs_equal"][k] for k in ("token_ids", "position_ids", "kv_mask")) and all(out["inputs_equal"]["cache"])
    assert out["parting_calls"] and model.batch_size == 8 and model.decode_rows is None


# ------------------------------------------------------- phases 18-20 (SigLIP)


def test_siglip_phase_workloads():
    """Phases 18-20's shapes: the presets' published widths (SigLIP 1152 wide,
    16 heads of 72; 26 layers for onevision, 27 for Idefics2; Qwen2-7B 28/4
    heads, Mistral-7B 32/8), phase 3's images tiled by anyres into the prompt
    lengths phase 2 holds (a cache past 2048 positions), Idefics2's four
    images padded to one grid where every patch mask has gaps, and the
    checkpoints cut in depth only."""
    import chip_smoke
    from lmms_owc_tpu_torch.models.idefics2 import PRESET_CONFIGS as IDF, _FallbackIdeficsTokenizer
    from lmms_owc_tpu_torch.models.llava_onevision import PRESET_CONFIGS as OV, _FallbackOVTokenizer
    from lmms_owc_tpu_torch.nn import anyres
    from lmms_owc_tpu_torch.utils import pad_to_bucket

    ov, idf = OV[chip_smoke.ONEVISION_PRESET], IDF[chip_smoke.IDEFICS2_PRESET]
    for cfg, layers in ((ov, chip_smoke.ONEVISION_TOWER_LAUNCHES), (idf, chip_smoke.IDEFICS2_TOWER_LAUNCHES)):
        v = cfg["vision_config"]
        assert (v["hidden_size"], v["num_attention_heads"], v["num_hidden_layers"]) == (1152, 16, layers)
        assert v["hidden_size"] // v["num_attention_heads"] == 72
    t = ov["text_config"]
    assert (t["hidden_size"], t["num_hidden_layers"], t["num_attention_heads"], t["num_key_value_heads"]) == (
        3584, chip_smoke.ONEVISION_LAYERS, 28, 4)
    t = idf["text_config"]
    assert (t["hidden_size"], t["num_hidden_layers"], t["num_attention_heads"], t["num_key_value_heads"]) == (
        4096, chip_smoke.IDEFICS2_LAYERS, 32, 8)
    pins = anyres.default_grid_pinpoints(384, 6)
    prompt = _FallbackOVTokenizer(chip_smoke.ONEVISION_IMAGE_ID).encode(
        f"<|im_start|>user\n<image>\n{chip_smoke.PROMPT}<|im_end|>\n<|im_start|>assistant\n")
    for hw, want in chip_smoke.ONEVISION_PROMPT_TOKENS.items():
        n_h, n_w = anyres.anyres_grid_shape(hw, pins, 384)
        assert 1 + n_h * n_w == chip_smoke.ONEVISION_TILES[hw]
        tiles = torch.zeros(1 + n_h * n_w, 729, 1)
        packed = anyres.pack_anyres_features(tiles, hw, pins, 384, 14, torch.zeros(1), max_patches=9)
        assert len(prompt) - 1 + packed.shape[0] == want
    bucket = pad_to_bucket(max(chip_smoke.ONEVISION_PROMPT_TOKENS.values()))
    assert bucket == 4096 and bucket + chip_smoke.MAX_NEW_TOKENS > 2048
    image_block = "<fake_token_around_image>" + "<image>" * 64 + "<fake_token_around_image>"
    assert len(_FallbackIdeficsTokenizer(32001).encode(
        f"User:{image_block}{chip_smoke.PROMPT}<end_of_utterance>\nAssistant:")) == chip_smoke.IDEFICS2_PROMPT_TOKENS
    mask = chip_smoke.idefics2_patch_mask()
    assert mask.shape == (4, 32 * 48) and (mask == 0).any(1).all() and mask.sum(1).tolist() == [1024, 864, 864, 1296]
    for cfg in (chip_smoke.onevision_checkpoint_config(), chip_smoke.idefics2_checkpoint_config()):
        assert cfg["text_config"]["num_hidden_layers"] == chip_smoke.SIGLIP_CKPT_LAYERS == 2
        assert cfg["vision_config"]["num_hidden_layers"] in (26, 27)


@pytest.mark.parametrize("fault", [None, "tower_call_short", "no_tensor_mask", "decode_steps_uneven"])
def test_siglip_launch_check_reads_each_call(fault):
    """Phases 18 and 19 hold each tower call's K2 launches at head_dim 72 (in
    the tensor-mask form for Idefics2), the prefill's and each step's K3."""
    import chip_smoke

    tower = [{"flash_attention": 27, "flash_attention_tensor_mask": 27}]
    prefill, decode = [{"flash_attention": 32}], [{"gqa_decode_attention": 32}] * 3
    if fault == "tower_call_short":
        tower = [{"flash_attention": 26, "flash_attention_tensor_mask": 26}]
    elif fault == "no_tensor_mask":
        tower = [{"flash_attention": 27}]
    elif fault == "decode_steps_uneven":
        decode = [{"gqa_decode_attention": 31}, {"gqa_decode_attention": 33}, {"gqa_decode_attention": 32}]
    counts = {"flash_attention": sum(c["flash_attention"] for c in tower + prefill),
              "flash_attention_tensor_mask": sum(c.get("flash_attention_tensor_mask", 0) for c in tower),
              "gqa_decode_attention": 96}
    run = dict(decode_steps=3, per_call={"siglip_vision_forward": tower, "prefill": prefill, "decode_step": decode},
               counts=counts)
    check = lambda: chip_smoke._check_tower_launches(run, "tiny", "siglip_vision_forward", 1, 27, 32,
                                                     tensor_mask=True)
    if fault is None:
        check()
    else:
        with pytest.raises(AssertionError, match="launches per call"):
            check()


@pytest.mark.parametrize("family", ["onevision", "idefics2"])
def test_siglip_checkpoint_writer_round_trip(tmp_path, monkeypatch, family):
    """Phase 20's writer at the tiny presets' widths: ``transformers`` reads
    every tensor of the checkpoint under the published names (none missing,
    none unexpected), the port loads every parameter bit-equal, and the
    port's tokenizer encodes the family's prompt as ``AutoTokenizer`` does."""
    from tokenizers import Tokenizer
    from transformers import Idefics2ForConditionalGeneration, LlavaOnevisionForConditionalGeneration

    import chip_smoke
    from lmms_owc_tpu_torch.models import get_model

    monkeypatch.setattr(chip_smoke, "ONEVISION_PRESET", "llava-onevision-tiny")
    monkeypatch.setattr(chip_smoke, "IDEFICS2_PRESET", "idefics2-tiny")
    written, cfg, out = chip_smoke.write_siglip_checkpoint(family, torch.device("cpu"), tmp_path, 0)
    assert out["bytes"] > 0 and cfg["text_config"]["num_hidden_layers"] == 2
    cls = LlavaOnevisionForConditionalGeneration if family == "onevision" else Idefics2ForConditionalGeneration
    hf, info = cls.from_pretrained(str(tmp_path), output_loading_info=True)
    assert not info["missing_keys"] and not info["unexpected_keys"], info
    state = hf.state_dict()
    if family == "onevision":
        assert torch.equal(state["model.vision_tower.vision_model.encoder.layers.1.self_attn.q_proj.weight"].bfloat16(),
                           written.vision.layers[1].q.weight)
        assert torch.equal(state["model.image_newline"].bfloat16(), written.image_newline)
        preset, prompt = "llava-onevision-tiny", f"<|im_start|>user\n<image>\n{chip_smoke.PROMPT}<|im_end|>\n"
    else:
        assert torch.equal(state["model.connector.perceiver_resampler.latents"].bfloat16(), written.perceiver.latents)
        assert torch.equal(state["model.vision_model.embeddings.patch_embedding.weight"].flatten(1).bfloat16(),
                           written.vision.patch_embed.weight)
        preset = "idefics2-tiny"
        prompt = f"User:<fake_token_around_image><image><image><fake_token_around_image>{chip_smoke.PROMPT}" \
                 "<end_of_utterance>\nAssistant:"
    loaded = get_model(preset, pretrained=str(tmp_path), dtype="bfloat16", device="cpu")
    assert chip_smoke._same_parameters(loaded.model, written, "round trip") == len(list(written.parameters()))
    # The ``tokenizers`` library reading the same tokenizer.json (AutoTokenizer
    # adds the Qwen2 class's own specials for a llava_onevision config).
    want = Tokenizer.from_file(str(tmp_path / "tokenizer.json")).encode(prompt).ids
    assert loaded.tokenizer.encode(prompt) == want
    specials = (chip_smoke.ONEVISION_IMAGE_ID,) if family == "onevision" else tuple(
        chip_smoke.IDEFICS2_SPECIAL_IDS.values())
    assert set(specials) <= set(want)


def test_internvl_blip_phase_workloads():
    """Phases 21-23's shapes: the presets' published widths (InternViT-300M 1024
    wide, 16 heads of 64, 24 layers, over Qwen2-1.5B 12/2 heads; BLIP ViT-g
    1408 wide, 16 heads of 88, 39 layers, over Vicuna-7B 32/32 heads), phase
    3's images tiled into the prompt lengths phase 2 holds (bucket 2048, a
    cache past 2048 positions; 32 queries and 9 text tokens in bucket 128),
    and the checkpoints cut in depth only."""
    import chip_smoke
    from PIL import Image

    from lmms_owc_tpu_torch.models import instructblip as blip
    from lmms_owc_tpu_torch.models import internvl2 as ivl
    from lmms_owc_tpu_torch.utils import pad_to_bucket

    iv_cfg, ib_cfg = ivl.PRESET_CONFIGS[chip_smoke.INTERNVL_PRESET], blip.PRESET_CONFIGS[chip_smoke.BLIP_PRESET]
    for v, layers, hd in ((iv_cfg["vision_config"], chip_smoke.INTERNVL_TOWER_LAUNCHES, 64),
                          (ib_cfg["vision_config"], chip_smoke.BLIP_TOWER_LAUNCHES, 88)):
        assert (v["num_attention_heads"], v["num_hidden_layers"], v["hidden_size"] // v["num_attention_heads"]) == (
            16, layers, hd)
    t = iv_cfg["text_config"]
    assert (t["num_hidden_layers"], t["num_attention_heads"], t["num_key_value_heads"]) == (
        chip_smoke.INTERNVL_LAYERS, 12, 2)
    t = ib_cfg["text_config"]
    assert (t["num_hidden_layers"], t["num_attention_heads"], t["num_key_value_heads"]) == (
        chip_smoke.BLIP_LAYERS, 32, 32)
    fallback = ivl._FallbackInternVLTokenizer(151667)
    for (h, w), tiles in chip_smoke.INTERNVL_TILES.items():
        assert len(ivl.dynamic_preprocess(Image.new("RGB", (w, h)), max_num=6, image_size=448)) == tiles
        prompt = ("<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n<|im_start|>user\n<img>"
                  + "<IMG_CONTEXT>" * (256 * tiles) + f"</img>\n{chip_smoke.PROMPT}<|im_end|>\n<|im_start|>assistant\n")
        assert len(fallback.encode(prompt)) == chip_smoke.INTERNVL_PROMPT_TOKENS[(h, w)]
    bucket = pad_to_bucket(max(chip_smoke.INTERNVL_PROMPT_TOKENS.values()))
    assert bucket == 2048 and bucket + chip_smoke.MAX_NEW_TOKENS == 2112
    assert 32 + len(blip._FallbackBlipTokenizer().encode(chip_smoke.PROMPT)) == chip_smoke.BLIP_PROMPT_TOKENS
    assert pad_to_bucket(chip_smoke.BLIP_PROMPT_TOKENS) + chip_smoke.MAX_NEW_TOKENS == 192
    for cfg, layers in ((chip_smoke.internvl_checkpoint_config(), 24), (chip_smoke.instructblip_checkpoint_config(), 39)):
        assert cfg["text_config"]["num_hidden_layers"] == chip_smoke.FAMILY_CKPT_LAYERS == 2
        assert cfg["vision_config"]["num_hidden_layers"] == layers


@pytest.mark.parametrize("family", ["internvl", "instructblip"])
def test_family_checkpoint_writer_round_trip(tmp_path, monkeypatch, family):
    """Phase 23's writer at the tiny presets' widths: ``transformers`` reads
    every tensor of the checkpoint under the published names (none missing,
    none unexpected) in the published shapes, the port loads every parameter
    bit-equal (the Q-Former tokenizer from ``qformer_tokenizer/``), and the
    port's tokenizer encodes the family's prompt as ``tokenizers`` does."""
    from tokenizers import Tokenizer
    from transformers import InstructBlipForConditionalGeneration, InternVLForConditionalGeneration

    import chip_smoke
    from lmms_owc_tpu_torch.models import get_model

    monkeypatch.setattr(chip_smoke, "INTERNVL_PRESET", "internvl2-tiny")
    monkeypatch.setattr(chip_smoke, "BLIP_PRESET", "instructblip-tiny")
    tiny_vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [w.lower() for w in chip_smoke.PROMPT.split()]
    monkeypatch.setattr(chip_smoke, "minilm_vocab", lambda: tiny_vocab)
    written, out = chip_smoke.write_family_checkpoint(family, torch.device("cpu"), tmp_path, 0)
    assert out["bytes"] > 0
    cls = InternVLForConditionalGeneration if family == "internvl" else InstructBlipForConditionalGeneration
    hf, info = cls.from_pretrained(str(tmp_path), output_loading_info=True)
    assert not info["missing_keys"] and not info["unexpected_keys"], info
    state = {k: v.bfloat16() for k, v in hf.state_dict().items()}
    if family == "internvl":
        assert torch.equal(state["model.vision_tower.encoder.layer.1.lambda_1"], written.vision.layers[1].lambda_1)
        assert torch.equal(state["model.vision_tower.embeddings.position_embeddings"][0],
                           written.vision.position_embeddings)
        preset = "internvl2-tiny"
        prompt = f"<|im_start|>user\n<img><IMG_CONTEXT></img>\n{chip_smoke.PROMPT}<|im_end|>\n"
        specials = tuple(chip_smoke.INTERNVL_SPECIAL_IDS.values())
    else:
        assert torch.equal(state["query_tokens"][0], written.qformer.query_tokens)
        assert torch.equal(state["vision_model.embeddings.patch_embedding.weight"].flatten(1),
                           written.vision.patch_embed.weight)
        preset, prompt, specials = "instructblip-tiny", chip_smoke.PROMPT, (1,)
    loaded = get_model(preset, pretrained=str(tmp_path), dtype="bfloat16", device="cpu")
    assert chip_smoke._same_parameters(loaded.model, written, "round trip") == len(list(written.parameters()))
    want = Tokenizer.from_file(str(tmp_path / "tokenizer.json")).encode(prompt).ids
    assert loaded.tokenizer.encode(prompt) == want and set(specials) <= set(want)
    if family == "instructblip":
        assert loaded.qformer_tokenizer is not None
        assert loaded._qformer_encode("What is it?")[0] == tiny_vocab.index("[CLS]")


def test_phi3v_phase_workloads():
    """Phase 24's shapes, computed: Phi-3-mini's 32 layers of 32 heads of 96
    over CLIP-L/336 (23 of its 24 layers per tower call, 16 heads of 64);
    phase 3's 448x448 images expand to 2509 image rows and the 336x448 ones
    to 1921 (4x4 and 3x4 crops), prompts of 2521 and 1933 tokens, bucket
    3072, decode cache 3136 (past 2048: K3's general kernel); the longrope
    scaling's 48 factors give an attention factor of 1.19; the checkpoint is
    cut in depth only and has no vision_config (the adapter takes CLIP-L/336)."""
    import chip_smoke
    from lmms_owc_tpu_torch.models import phi3v as p3
    from lmms_owc_tpu_torch.nn.llama import llama_config_from_hf
    from lmms_owc_tpu_torch.utils import pad_to_bucket

    cfg = chip_smoke.phi3v_smoke_config()
    text = llama_config_from_hf(cfg["text_config"]).to_decoder_config()
    assert (text.num_layers, text.num_heads, text.num_kv_heads, text.head_dim) == (chip_smoke.PHI3V_LAYERS, 32, 32, 96)
    assert len(text.rope_longrope[1]) == 48 and abs(text.rope_longrope[0] - 1.1902380714238083) < 1e-12
    vision = p3.clip_config(cfg["vision_config"])
    assert vision.num_layers - 1 == chip_smoke.PHI3V_TOWER_LAUNCHES and vision.hidden_size // vision.num_heads == 64
    lengths = chip_smoke.phi3v_prompt_tokens()
    assert lengths == [2509 + 12] * 6 + [1921 + 12] * 2
    bucket = pad_to_bucket(max(lengths))
    assert bucket == 3072 and bucket + chip_smoke.MAX_NEW_TOKENS == 3136
    ckpt = chip_smoke.phi3v_checkpoint_config()
    assert ckpt["num_hidden_layers"] == chip_smoke.FAMILY_CKPT_LAYERS == 2 and "vision_config" not in ckpt
    assert ckpt["hidden_size"] == 3072 and ckpt["rope_scaling"] == cfg["text_config"]["rope_scaling"]


def test_phi3v_checkpoint_writer_round_trip(tmp_path, monkeypatch):
    """Phase 23's phi3v writer at tiny widths: the layout's names and shapes
    are those of the released layout (as ``tests/test_checkpoint_matrix.py``
    synthesizes it: fused ``qkv_proj`` / ``gate_up_proj``, the CLIP tower
    under ``model.vision_embed_tokens.img_processor.``, ``sub_GN`` and
    ``glb_GN``), the port loads every parameter bit-equal and the longrope
    scaling as written, and its tokenizer encodes the Phi-3 prompt as
    ``tokenizers`` does, the specials at their published ids."""
    import json

    from tokenizers import Tokenizer

    import chip_smoke
    from lmms_owc_tpu_torch.models import get_model
    from lmms_owc_tpu_torch.models import phi3v as p3
    from lmms_owc_tpu_torch.nn.llama import llama_config_from_hf
    from lmms_owc_tpu_torch.nn.loader import load_safetensors_state
    from tests.test_checkpoint_matrix import _build_phi3v

    monkeypatch.setattr(chip_smoke, "PHI3V_PRESET", "phi3v-tiny")
    monkeypatch.setattr(chip_smoke, "PHI3V_SHORT_FACTORS", [1.0 + 0.1 * i for i in range(8)])
    monkeypatch.setattr(chip_smoke, "PHI3V_LONG_FACTORS", [2.0] * 8)
    cfg = chip_smoke.phi3v_checkpoint_config()
    # The tiny tower at 336 px (the released crop size): the shapes of _build_phi3v's tower.
    vis = dict(p3.PRESET_CONFIGS["phi3v-tiny"]["vision_config"], image_size=336)
    cfg.update(vision_config=vis, max_position_embeddings=512, original_max_position_embeddings=128,
               tie_word_embeddings=False)  # the released form: its own lm_head
    gen = torch.Generator().manual_seed(0)
    written = p3.init_phi3v_params(llama_config_from_hf(cfg), p3.clip_config(vis), gen, torch.bfloat16)
    with torch.no_grad():
        written.sub_gn.normal_(generator=gen)
        written.glb_gn.normal_(generator=gen)
    layout = chip_smoke.phi3v_layout(written)
    ckpt, released = tmp_path / "ckpt", tmp_path / "released"
    ckpt.mkdir()
    released.mkdir()
    _build_phi3v(released)
    want = {name: tuple(t.shape) for name, t in load_safetensors_state(released).items()}
    got = {name: tuple(t.shape) for name, t in layout}
    assert set(want) - set(got) <= {"model.vision_embed_tokens.img_processor.vision_model.embeddings.position_ids"}
    assert {n: s for n, s in want.items() if n in got} == got
    assert chip_smoke.write_tensors(layout, ckpt, "tiny phi3v")["bytes"] > 0
    (ckpt / "config.json").write_text(json.dumps(cfg))
    (ckpt / "tokenizer.json").write_text(json.dumps(chip_smoke.phi3v_tokenizer()))
    (ckpt / "tokenizer_config.json").write_text(json.dumps(dict(
        chip_smoke.LLAMA2_TOKENIZER_CONFIG, eos_token="<|end|>", pad_token="<|endoftext|>")))
    loaded = get_model("phi3v-tiny", pretrained=str(ckpt), dtype="bfloat16", device="cpu")
    assert chip_smoke._same_parameters(loaded.model, written, "round trip") == len(list(written.parameters()))
    assert loaded.decoder_config.rope_longrope == llama_config_from_hf(cfg).to_decoder_config().rope_longrope
    assert (loaded.pad_token_id, loaded.tokenizer.eos_token_id) == (32000, 32007)
    prompt = loaded._build_prompt(chip_smoke.PROMPT, 1)
    ids = Tokenizer.from_file(str(ckpt / "tokenizer.json")).encode(prompt).ids
    assert loaded.tokenizer.encode(prompt) == ids
    assert {32010, 32044, 32007, 32001} <= set(ids) and ids[0] == 1


def _tp_results(fault: str | None):
    """Rank 0's phase-25 output as ``check_tp_results`` reads it, with one ``fault``."""
    import chip_smoke as cs

    gen = torch.Generator().manual_seed(0)
    steps, refs, logits, forms = 63, {}, {}, {}
    for label, key in (("bf16", "bf16"), ("int8_w8a8_kv_int8", "int8_w8a8"), ("int4", "int4")):
        base = torch.randn(8, 512, generator=gen)
        tokens = np.arange(8 * 64).reshape(8, 64) % 97
        refs[key] = {"logits": base, "tokens": tokens}
        noise = torch.randn(8, 512, generator=gen)
        if label == "int8_w8a8_kv_int8" and fault not in (f"logits {label}", "w8a8 last bits"):
            noise.zero_()  # the row-parallel W8A8 product is the unsharded one
        logits[label] = base + (1.0 if fault == f"logits {label}" else 1e-3) * noise
        decode = "gqa_decode_attention_int8" if "kv_int8" in label else "gqa_decode_attention"
        counts = {"vision_qkv_attention": 32, "flash_attention": 28, "gqa_decode_attention": 0,
                  "gqa_decode_attention_int8": 0, "int4_matmul": 0}
        counts[decode] = 28 * steps if fault != f"launches {label}" else 27
        if label == "int4":
            counts["int4_matmul"] = cs.MIN_LAUNCHES_PER_DECODE_STEP["int4_matmul"] * steps
        got = tokens.copy()
        if fault == f"tokens {label}":
            got[3, 40] += 1
        forms[label] = {"decode_steps": steps, "counts": counts, "tokens": got.tolist()}
    refs["bf16"]["exact"] = refs["bf16"]["logits"]
    flagship = ["tok1 tok2", "tok3", "", "tok4"]
    answers = ["yes"] * 255 + ["no"]
    out = {"forms": forms, "flagship": flagship[:3] + (["tok5"] if fault == "flagship" else flagship[3:]),
           "judge": {"answers": answers[:-1] + (["yes"] if fault == "judge" else ["no"]), "ranks": 2}}
    return out, logits, flagship, refs, answers


@pytest.mark.parametrize("fault", [None, "logits bf16", "logits int8_w8a8_kv_int8", "logits int4",
                                   "w8a8 last bits", "tokens int8_w8a8_kv_int8",
                                   "launches bf16", "launches int8_w8a8_kv_int8", "flagship", "judge"])
def test_tensor_parallel_phase_gates(fault):
    """Phase 25's gates: the logits rule per form (bf16 against f32
    attention, the quantized forms against their unsharded logits; W8A8
    bit-equal to them, every token the same), each form's decode kernel (the
    int8 cache's for W8A8) in every step, the flagship preset's rows and the
    judge's answers."""
    import chip_smoke as cs

    args = _tp_results(fault)
    if fault is None:
        out = cs.check_tp_results(*args, plain_vs_exact=0.04)
        assert out["flagship"] == {"rows": 4, "same_rows": 4} and out["judge"]["same_rows"] == 256
        assert all(run["token_agreement"] == 1.0 for run in out["forms"].values())
    else:
        with pytest.raises(AssertionError):
            cs.check_tp_results(*args, plain_vs_exact=0.04)


def test_tensor_parallel_phase_shapes():
    """Phase 2's sharded K4 shapes (K -> N) and head counts are those of one
    rank of ``qwen2-vl-7b`` at tp = 2, read off the port's sharding of the
    model built on ``meta``."""
    import chip_smoke as cs
    from lmms_owc_tpu_torch.models.qwen2_vl import PRESET_CONFIGS
    from lmms_owc_tpu_torch.nn import qwen2_vl as qvl
    from lmms_owc_tpu_torch.parallel.mesh import ModelGroup
    from lmms_owc_tpu_torch.parallel.sharding import shard_model

    model = qvl.Qwen2VLModel(qvl.Qwen2VLConfig.from_hf_dict(PRESET_CONFIGS["qwen2-vl-7b"]), torch.bfloat16, "meta")
    shard_model(model, ModelGroup(None, 0, cs.TP_RANKS))
    layer = model.layers[0]
    want = {"q": layer.q, "o": layer.o.inner, "k/v": layer.k, "gate/up": layer.up, "down": layer.down.inner,
            "lm_head": model.lm_head}
    assert {name: tuple(lin.weight.shape[::-1]) for name, lin in want.items()} == cs.TP_INT4_SHAPES
    assert (layer.heads, layer.kv_heads, model.vision.heads) == (14, 2, 8)
