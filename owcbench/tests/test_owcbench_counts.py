"""The operation and byte counts of the rooflines and of ``mfu`` against hand counts at small shapes."""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from owcbench import roofline
from owcbench.reference import qwen2_vl as ref

REPO = Path(__file__).resolve().parents[2]


def test_attention_bound_counts_the_pairs_the_masks_leave():
    keys = torch.tensor([[0, 1, 1, 1], [1, 1, 1, 1]], dtype=torch.bool)  # one left-padded row
    b = roofline.attention_bound(keys, heads=4, kv_heads=2, lq=4, d=8, causal=True)
    # causal, aligned to the end: row 0 sees 0+1+2+3 valid keys, row 1 1+2+3+4
    assert b["work_flops"] == 4 * 8 * 4 * (6 + 10)
    assert b["work_bytes"] == 2 * (2 * 2 * 4 * 4 * 8 + 2 * 2 * 8 * 7)
    full = roofline.attention_bound(keys, heads=4, kv_heads=4, lq=4, d=8, causal=False)
    assert full["work_flops"] == 4 * 8 * 4 * 7 * 4
    assert full["bound_s"] == max(full["work_flops"] / roofline.PEAK_BF16_FLOPS,
                                  full["work_bytes"] / roofline.PEAK_BYTES_PER_S)


@pytest.mark.parametrize("int8", [False, True])
def test_decode_bound_bytes(int8):
    b = roofline.decode_bound(batch=2, heads=4, kv_heads=2, d=8, seq=16, valid=20, int8=int8)
    q_out = 2 * 2 * 2 * 4 * 8  # q read and the output written, bf16
    kv = 2 * 20 * (2 * 8 + 2 * 4) if int8 else 2 * 2 * 2 * 8 * 20  # int8 rows + two f32 scales, or bf16 rows
    assert b["work_bytes"] == q_out + kv + 4 * 2 * 16 and b["work_flops"] == 4 * 8 * 4 * 20


def _tiny_arch():
    cfg = json.loads((REPO / "owcbench" / "tests" / "data" / "configs" / "qwen2.5-vl-tiny.json").read_text())
    return ref.arch(cfg["hf_config"])


def test_model_work_against_hand_counts():
    a = _tiny_arch()
    h, kv, inter, layers = a["hidden"], a["kv_heads"] * a["head_dim"], a["intermediate"], a["layers"]
    w = roofline.Work()
    roofline.prefill_work(w, a, tokens=10, int8=True)
    per_token = 2 * (h * h * 2 + h * kv * 2 + 3 * h * inter)
    assert w.int8 == layers * 10 * per_token
    assert w.bf16 == layers * 4 * a["head_dim"] * a["heads"] * 55 + 2 * h * a["vocab"]
    d = roofline.Work()
    roofline.decode_work(d, a, prompt=10, generated=3, int8=False)  # two steps, over 11 and 12 keys
    assert d.bf16 == layers * 2 * per_token + layers * 4 * a["head_dim"] * a["heads"] * 23 + 2 * 2 * h * a["vocab"]
    assert d.int8 == 0
    assert d.least_seconds() == d.bf16 / roofline.PEAK_BF16_FLOPS


def test_tower_work_counts_windows_and_real_patches():
    a = _tiny_arch()
    t = a["tower"]
    grid = (1, 10, 6)  # 60 patches, 5 x 3 merge units, windows of 2 x 2 units at 56 px
    windows = ref.window_patches(a, grid)
    assert windows == [16, 8, 16, 8, 8, 4] and sum(windows) == 60
    w = roofline.Work()
    roofline.tower_work(w, t, 60, windows, int8=False)
    e, i, heads = t["embed_dim"], t["intermediate_size"], t["num_heads"]
    d = e // heads
    linear = 2 * 60 * t["patch_dim"] * e + t["depth"] * 2 * 60 * (3 * e * e + e * e + 3 * e * i)
    attn = 4 * d * heads * (60 * 60 + sum(s * s for s in windows))  # one global layer, one windowed
    merger = 2 * 15 * (4 * e) * (4 * e) + 2 * 15 * (4 * e) * t["out_hidden"]
    assert w.bf16 == pytest.approx(linear + attn + merger, rel=1e-12)
