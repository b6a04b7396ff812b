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
