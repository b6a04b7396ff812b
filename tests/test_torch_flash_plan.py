"""The schedule of the flash kernel's Hopper instance, which folds the query
heads of a GQA group into one CTA's rows.

The CUDA kernel runs only on the card, where ``chip_smoke.py`` holds each GQA
row's output bit for bit to per-head launches and checks that
:func:`~lmms_owc_tpu_torch.ops.attention.flash_plan` agrees with the
library's own plan. Here, on the CPU:

- ``flash_plan`` at the main-path shapes, and the slot map it implies: a slot
  is one (64-row q tile, head of the group) pair, numbered q-tile-major, and
  CTA ``x``'s warpgroup ``w`` takes slot ``x * warpgroups + w``; every slot
  is taken exactly once and no CTA is left without one.
- A torch emulation of the folded schedule, tile by tile as the kernel runs
  it: a CTA's key range is the union of its warpgroups' ranges (the
  (start, end) run, clipped by the causal diagonal of its last q tile), and a
  warpgroup skips every tile past its own diagonal. The online softmax is the
  kernel's (scores unscaled, the running max in scaled base-2 units, p
  rounded to bf16 for the PV product, f32 accumulation). Skipping whole tiles
  gives the same bits as running them with every key masked, and the result
  stays within ``TOL`` of the JAX package's ``gqa_attention_reference``.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lmms_owc_tpu.ops import attention as jatt
from lmms_owc_tpu_torch.ops import attention as tatt

# The emulation rounds p to bf16 before the PV product, as the kernel does;
# the JAX reference keeps its f32 weights (relative 2^-9 per weight).
TOL = 1e-2
ROWS = 64  # query rows per warpgroup, keys per tile


@pytest.mark.parametrize("shape,plan", [
    ((24, 8, 128, 128), (3, 2)),      # the judge (Llama-3.2-3B), G = 3
    ((32, 8, 128, 128), (3, 3)),      # Mistral-7B, G = 4: two warpgroups measured no faster
    ((32, 32, 128, 128), (2, 1)),     # Vicuna-7B at bucket 128, G = 1
    ((28, 4, 320, 128), (3, 12)),     # Qwen2-7B, the main path's prefill, G = 7
    ((14, 2, 320, 128), (3, 12)),     # the same at tp = 2
    ((28, 4, 4096, 128), (3, 150)),   # onevision's bucket: three warpgroups (two ran 1.3 times slower)
    ((12, 2, 2048, 128), (3, 64)),    # Qwen2-1.5B, G = 6
    ((32, 32, 640, 128), (3, 4)),     # llava-1.5's Vicuna prefill
    ((32, 32, 3072, 96), (3, 16)),    # Phi-3-mini
    ((16, 16, 577, 64), (2, 5)),      # CLIP-L/336: two warpgroups, five CTAs
    ((16, 16, 1025, 64), (3, 6)),     # InternViT-300M
    ((16, 16, 729, 72), (3, 4)),      # SigLIP (onevision)
    ((16, 16, 257, 88), (3, 2)),      # BLIP ViT-g
    ((16, 16, 1024, 80), (2, 8)),     # the Qwen2-VL tower (K1, K5)
    ((48, 48, 64, 80), (1, 1)),       # a Qwen2.5-VL window: one slot
])
def test_flash_plan_at_the_main_path_shapes(shape, plan):
    assert tatt.flash_plan(*shape) == plan


@pytest.mark.parametrize("args", [(24, 8, 128, 32), (24, 8, 128, 100), (24, 7, 128, 128), (24, 8, 0, 128)])
def test_flash_plan_refuses_what_the_instance_does_not_run(args):
    with pytest.raises(ValueError):
        tatt.flash_plan(*args)


def _slots(heads, kv_heads, lq, head_dim):
    """[(cta, warpgroup, slot or None)] of one (batch row, KV head)."""
    wg, ctas = tatt.flash_plan(heads, kv_heads, lq, head_dim)
    n = -(-lq // ROWS) * (heads // kv_heads)
    return n, [(x, w, x * wg + w if x * wg + w < n else None) for x in range(ctas) for w in range(wg)]


@pytest.mark.parametrize("head_dim", [64, 72, 80, 88, 96, 128])
def test_every_slot_is_taken_once(head_dim):
    for heads, kv_heads in ((1, 1), (16, 16), (24, 8), (32, 8), (28, 4), (12, 2), (14, 2), (32, 4)):
        for lq in (1, 40, 64, 65, 128, 129, 257, 320, 577, 729, 1024, 1025, 2048, 3072, 4096):
            n, slots = _slots(heads, kv_heads, lq, head_dim)
            taken = [s for _, _, s in slots if s is not None]
            assert sorted(taken) == list(range(n)), (heads, kv_heads, lq)
            wg = tatt.flash_plan(heads, kv_heads, lq, head_dim)[0]
            last = [s for x, _, s in slots if x == slots[-1][0]]
            assert any(s is not None for s in last) and len(slots) - n < wg, (heads, kv_heads, lq)


def test_a_cta_folds_the_group_at_one_q_tile():
    """The judge's first CTA holds the three heads of a KV head at q tile 0,
    its second the same heads at q tile 1; Mistral's second CTA mixes them."""
    group = 3
    _, slots = _slots(24, 8, 128, 128)
    assert [(s // group, s % group) for x, _, s in slots if x == 0] == [(0, 0), (0, 1), (0, 2)]
    assert [(s // group, s % group) for x, _, s in slots if x == 1] == [(1, 0), (1, 1), (1, 2)]
    group = 4
    _, slots = _slots(32, 8, 128, 128)
    assert [(s // group, s % group) for x, _, s in slots if x == 1] == [(0, 3), (1, 0), (1, 1)]


def _folded(q, k, v, runs, *, causal, skip):
    """The Hopper instance's schedule emulated in torch: q [B, H, L, D], k/v
    [B, KVH, L, D] (values exact in bf16, held in f32), ``runs`` the (start,
    end) of each row's valid keys. Per (batch row, KV head, CTA, warpgroup),
    tile by tile over the CTA's key range; with ``skip`` a warpgroup runs
    only the tiles before its own causal diagonal, as the kernel does."""
    b, h, lq, d = q.shape
    kvh, lk = k.shape[1], k.shape[2]
    group = h // kvh
    wg_count, ctas = tatt.flash_plan(h, kvh, lq, d)
    n_slots = -(-lq // ROWS) * group
    scale_log2 = 1.0 / math.sqrt(d) * 1.4426950408889634
    offset = lk - lq
    out = torch.zeros_like(q)
    for bi in range(b):
        k_lo, k_hi = runs[bi]
        for kv in range(kvh):
            for x in range(ctas):
                last = min(x * wg_count + wg_count, n_slots) - 1
                cta_hi = min(k_hi, min(last // group * ROWS + ROWS, lq) + offset) if causal else k_hi
                tiles = list(range(k_lo // ROWS, -(-cta_hi // ROWS) if cta_hi > k_lo else k_lo // ROWS))
                for w in range(wg_count):
                    slot = x * wg_count + w
                    if slot >= n_slots:
                        continue
                    head, q0 = kv * group + slot % group, slot // group * ROWS
                    rows = torch.arange(q0, min(q0 + ROWS, lq))
                    wg_hi = min(k_hi, min(q0 + ROWS, lq) + offset) if causal else k_hi
                    hi = torch.clamp(rows + offset + 1, max=k_hi) if causal else torch.full_like(rows, k_hi)
                    m = torch.full((len(rows),), -math.inf)
                    l = torch.zeros(len(rows))
                    o = torch.zeros(len(rows), d)
                    for t in tiles:
                        kb0 = t * ROWS
                        if skip and (wg_hi <= k_lo or kb0 >= wg_hi):
                            continue
                        keys = torch.arange(kb0, min(kb0 + ROWS, lk))
                        s = q[bi, head, rows] @ k[bi, kv, keys].T
                        ok = (keys[None] >= k_lo) & (keys[None] < hi[:, None])
                        s = torch.where(ok, s, -math.inf)
                        m_new = torch.maximum(m, (s * scale_log2).amax(1))
                        corr = torch.where(m_new == -math.inf, 1.0, torch.exp2(m - m_new))
                        neg_m = torch.where(m_new == -math.inf, 0.0, -m_new)
                        p = torch.exp2(s * scale_log2 + neg_m[:, None])
                        l = l * corr + p.sum(1)
                        o = o * corr[:, None] + p.to(torch.bfloat16).float() @ v[bi, kv, keys]
                        m = m_new
                    inv = torch.where(l > 0, 1.0 / l, 0.0)
                    out[bi, head, rows] = o * inv[:, None]
    return out


def _operands(seed, b, h, kvh, l, d):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, n, l, d).astype(np.float32) for n in (h, kvh, kvh))
    return [torch.from_numpy(x).to(torch.bfloat16).float() for x in (q, k, v)]


@pytest.mark.parametrize("h,kvh,l,runs", [
    (6, 2, 128, [(0, 128), (37, 128)]),    # G = 3 (the judge's fold), left-padded
    (8, 2, 128, [(0, 128), (50, 128)]),    # G = 4 (Mistral's): a CTA mixes q tiles
    (14, 2, 320, [(3, 320), (191, 320)]),  # G = 7 over five q tiles (the main prefill's fold)
])
@pytest.mark.parametrize("causal", [True, False])
def test_folded_schedule_skips_whole_tiles_exactly(h, kvh, l, runs, causal):
    """Skipping the tiles past a warpgroup's diagonal gives the same bits as
    running them fully masked; the result is GQA attention (the JAX
    package's reference) on every row with a valid key."""
    d = 64
    q, k, v = _operands(0, len(runs), h, kvh, l, d)
    skipped = _folded(q, k, v, runs, causal=causal, skip=True)
    assert torch.equal(skipped, _folded(q, k, v, runs, causal=causal, skip=False))
    mask = np.zeros((len(runs), l), np.int32)
    for i, (s, e) in enumerate(runs):
        mask[i, s:e] = 1
    ref = np.asarray(jatt.gqa_attention_reference(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                                                  jnp.asarray(v.numpy()), causal=causal,
                                                  kv_mask=jnp.asarray(mask)))
    pos = np.arange(l)
    seen = np.stack([pos >= s if causal else pos >= 0 for s, _ in runs])  # the rows with a valid key
    seen = np.broadcast_to(seen[:, None, :], (len(runs), h, l))
    np.testing.assert_allclose(skipped.numpy()[seen], ref[seen], atol=TOL, rtol=TOL)
    assert not skipped.numpy()[~seen].any()  # a row with no valid key is zero, as on the card
