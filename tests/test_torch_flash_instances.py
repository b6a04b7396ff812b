"""Which flash instance the towers reach, and the numerics of the f32 one.

The CUDA kernels run only on the card (``chip_smoke.py`` holds them to their
plain versions there and reads each row's kernel symbol from the profiler).
Here, on the CPU:

- :func:`~lmms_owc_tpu_torch.ops.attention.flash_takes_hopper`, the mirror of
  ``sm90::takes``, over the q/k/v views the towers really pass, captured from
  their forward functions at full width (one layer, two images; the batch
  count does not change a view's strides): CLIP-L/336 (the LLaVA and Phi-3
  towers, 577 tokens) and InternViT-300M (1025) reach the Hopper instance in
  bf16; BLIP's views with a 90-element row stride, rope at head_dim 72 and
  88, and f32 do not.
- The f32 instance's 3xTF32 products emulated with integer bit operations
  (``cvt.rna.tf32``: round half away from zero to 10 mantissa bits): each
  operand splits into hi = tf32(x) and lo = tf32(x - hi), and a product is
  lo*hi + hi*lo + hi*hi in f32. Attention so computed at the MiniLM, CLIP
  vision and CLIP text shapes stays within ``F32_TOL`` (the smoke's
  ``SBERT_TOL``, ``CLIP_TOL`` and f32 forms' bound) of f64 attention, while
  one TF32 product per pair (hi*hi) lands far outside it.
"""

import math

import numpy as np
import pytest
import torch

from lmms_owc_tpu_torch.nn import clip as nclip
from lmms_owc_tpu_torch.nn import internvl as ninternvl
from lmms_owc_tpu_torch.ops import attention as tatt

F32_TOL = 1e-4


class _Captured(Exception):
    pass


def _capture_views(monkeypatch, module, run):
    """The (q, k, v) of the first ``flash_attention`` call ``run`` makes in ``module``."""
    seen = []

    def spy(q, k, v, **kw):
        seen.append((q, k, v))
        raise _Captured

    monkeypatch.setattr(module, "flash_attention", spy)
    with pytest.raises(_Captured):
        run()
    return seen[0]


def _zeroed(module):
    for p in module.parameters():
        p.data.zero_()
    return module


def _clip_views(monkeypatch, image: int = 336):
    config = nclip.ClipVisionConfig(image_size=image, num_layers=1)
    tower = _zeroed(nclip.ClipVisionTower(config, dtype=torch.bfloat16, with_projection=False))
    pixels = torch.zeros(2, 3, image, image)
    return _capture_views(monkeypatch, nclip, lambda: nclip.clip_vision_forward(tower, pixels, config, -1))


def _internvit_views(monkeypatch):
    config = ninternvl.InternVLVisionConfig(num_layers=1)
    tower = _zeroed(ninternvl.InternViT(config, dtype=torch.bfloat16, final_ln=False))
    pixels = torch.zeros(2, 3, config.image_size, config.image_size)
    return _capture_views(monkeypatch, ninternvl, lambda: ninternvl.internvit_forward(tower, pixels, config))


@pytest.mark.parametrize("tower", ["clip-l-336", "internvit-300m"])
def test_tower_views_take_the_hopper_instance(monkeypatch, tower):
    q, k, v = _clip_views(monkeypatch) if tower == "clip-l-336" else _internvit_views(monkeypatch)
    want = {"clip-l-336": 577, "internvit-300m": 1025}[tower]
    assert q.shape == (2, 16, want, 64) and q.dtype == torch.bfloat16 and not q.is_contiguous()
    out = torch.empty(q.shape, dtype=q.dtype)
    assert tatt.flash_takes_hopper(q, k, v, out, False)
    assert tatt.flash_takes_hopper(q, k, v, out, True)  # rope fits head_dim 64 too
    assert not tatt.flash_takes_hopper(q.float(), k.float(), v.float(), out.float(), False)


@pytest.mark.parametrize("d,rope,wide", [(88, False, 2), (72, True, 0), (88, True, 0), (64, False, 2)])
def test_other_views_take_the_general_instance(d, rope, wide):
    """BLIP's 90-element row stride (the smoke's ``blip_tower_general``), its
    66-element kin at head_dim 64, and rope at 72 and 88."""
    q, k, v = (torch.zeros(2, 16, 257, d + wide, dtype=torch.bfloat16)[..., :d] for _ in range(3))
    assert not tatt.flash_takes_hopper(q, k, v, torch.empty(q.shape, dtype=q.dtype), rope)


def _tf32(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32: round half away from zero to 10 mantissa bits, the
    low 13 bits cleared (on the sign-magnitude bit pattern)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((bits + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def _split(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _product(a: np.ndarray, b: np.ndarray, terms: int) -> np.ndarray:
    """a @ b in f32 from split operands: lo*hi + hi*lo + hi*hi (terms 3), or
    hi*hi alone (terms 1, plain TF32)."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    mm = lambda x, y: torch.matmul(torch.from_numpy(x), torch.from_numpy(y)).numpy()  # noqa: E731
    if terms == 1:
        return mm(ah, bh)
    return mm(al, bh) + mm(ah, bl) + mm(ah, bh)


def _split_attention(q, k, v, keep, terms: int) -> np.ndarray:
    """The f32 kernel's arithmetic: split QK products, scores scaled by
    scale*log2(e), base-2 softmax in f32 over the kept keys, split PV."""
    scale = np.float32(1.0 / math.sqrt(q.shape[-1]) * 1.4426950408889634)
    s = _product(q, np.swapaxes(k, -1, -2), terms) * scale
    s = np.where(keep, s, np.float32(-np.inf))
    m = s.max(-1, keepdims=True)
    p = np.exp2(s - m).astype(np.float32)
    return _product(p, v, terms) / p.sum(-1, keepdims=True)


def _f64_attention(q, k, v, keep) -> np.ndarray:
    s = np.matmul(q.astype(np.float64), np.swapaxes(k, -1, -2).astype(np.float64)) / math.sqrt(q.shape[-1])
    s = np.where(keep, s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    return np.matmul(p / p.sum(-1, keepdims=True), v.astype(np.float64))


# (batch, heads, length, head_dim, mask) at the phase-2 f32 rows' shapes, the
# batch cut (each row and head is independent): MiniLM rows of 3 to 32 valid
# keys from 0, the CLIP ViT-L/14 tower over 257 tokens, CLIP's causal text tower.
SHAPES = {
    "minilm": (64, 12, 32, 32, "lengths"),
    "clip_vision": (4, 16, 257, 64, None),
    "clip_text": (16, 12, 16, 64, "causal"),
}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_split_tf32_attention_within_f32_tolerance(shape):
    b, h, l, d, mask = SHAPES[shape]
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(b, h, l, d).astype(np.float32) for _ in range(3))
    keep = np.ones((b, 1, l, l), bool)
    if mask == "lengths":
        lengths = rng.randint(3, l + 1, b)
        keep &= np.arange(l)[None, None, None, :] < lengths[:, None, None, None]
    elif mask == "causal":
        keep &= np.tril(np.ones((l, l), bool))[None, None]
    want = _f64_attention(q, k, v, keep)
    errs = {}
    for terms in (3, 1):
        got = _split_attention(q, k, v, keep, terms)
        errs[terms] = float(np.abs(got - want).max())
        bound_ok = np.abs(got - want) <= F32_TOL + F32_TOL * np.abs(want)
        assert bool(bound_ok.all()) == (terms == 3), (shape, terms, errs)
    assert errs[3] < F32_TOL / 10 < errs[1], errs
