"""Attention of the PyTorch port against the JAX package's Pallas kernels.

The JAX kernels run in Pallas interpret mode (``use_pallas=True,
interpret=True``), as the JAX package's own kernel tests run them on the CPU;
the port's wrappers take their plain PyTorch versions for CPU tensors. Inputs
are float32 numpy arrays from a seed, so the tolerance ``atol = rtol = 1e-4``
covers summation order only. Query rows with no valid key are excluded (the
JAX kernel averages over the blocks it visited there; the CUDA kernel writes
zeros). The CUDA kernels themselves run only on the card (``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lmms_owc_tpu.ops import attention as jatt
from lmms_owc_tpu_torch import utils as tutils
from lmms_owc_tpu_torch.models import qwen2_vl as tqvl
from lmms_owc_tpu_torch.ops import _build
from lmms_owc_tpu_torch.ops import attention as tatt

TOL = 1e-4


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def _rope_tables(rng, b, l, d):
    freqs = rng.uniform(0, 6.28, (b, l, d // 2)).astype(np.float32)
    return np.cos(freqs), np.sin(freqs)


def _run_mask(b, l, runs):
    """[B, L] int32 with one contiguous valid run (start, end) per row."""
    m = np.zeros((b, l), np.int32)
    for i, (s, e) in enumerate(runs):
        m[i, s:e] = 1
    return m


@pytest.mark.parametrize("with_rope", [False, True])
@pytest.mark.parametrize("block_q,block_k", [(128, 128), (64, 32)])
def test_flash_attention_matches_pallas_k2(with_rope, block_q, block_k):
    """Causal GQA prefill with contiguous masks; (64, 32) runs the multi-block
    online softmax of the JAX kernel (block_k < L)."""
    rng = np.random.RandomState(0)
    b, h, kvh, l, d = 3, 4, 2, 128, 32
    q = rng.randn(b, h, l, d).astype(np.float32)
    k = rng.randn(b, kvh, l, d).astype(np.float32)
    v = rng.randn(b, kvh, l, d).astype(np.float32)
    runs = [(0, l), (37, l), (10, 90)]
    mask = _run_mask(b, l, runs)
    cos = sin = None
    if with_rope:
        cos, sin = _rope_tables(rng, b, l, d)

    ref = jatt.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True, kv_mask=jnp.asarray(mask),
        kv_mask_contiguous=True, block_q=block_q, block_k=block_k, use_pallas=True, interpret=True,
        rope_cos=None if cos is None else jnp.asarray(cos),
        rope_sin=None if sin is None else jnp.asarray(sin),
    )
    out = tatt.flash_attention(
        _t(q), _t(k), _t(v), causal=True, kv_mask=_t(mask), kv_mask_contiguous=True,
        rope_cos=None if cos is None else _t(cos), rope_sin=None if sin is None else _t(sin),
    )
    assert out.shape == (b, h, l, d) and out.dtype == torch.float32
    ref = np.asarray(ref)
    for i, (s, _e) in enumerate(runs):  # rows before the run start have no valid key
        np.testing.assert_allclose(out[i, :, s:].numpy(), ref[i, :, s:], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("masked,with_rope", [(False, False), (True, True), (True, False)])
@pytest.mark.parametrize("block_k", [128, 32])
def test_vision_qkv_attention_matches_pallas_k1(masked, with_rope, block_k):
    """Token-major port entry vs the feature-major K1 kernel: the JAX input is
    the transposed qkv projection, the JAX output is transposed back."""
    rng = np.random.RandomState(1)
    n, h, d, p = 2, 4, 16, 128
    qkv = rng.randn(n, p, 3 * h * d).astype(np.float32)  # token-major, role-major channels
    mask = _run_mask(n, p, [(0, p), (0, 96)]) if masked else None
    cos = sin = None
    if with_rope:
        cos, sin = _rope_tables(rng, n, p, d)

    ref_fm = jatt.fused_qkv_attention_fm(
        jnp.asarray(qkv.transpose(0, 2, 1)), h, d,
        kv_mask=None if mask is None else jnp.asarray(mask),
        rope_cos=None if cos is None else jnp.asarray(cos.transpose(0, 2, 1)),
        rope_sin=None if sin is None else jnp.asarray(sin.transpose(0, 2, 1)),
        block_q=64, block_k=block_k, use_pallas=True, interpret=True,
    )  # [N, H*D, P]
    out = tatt.vision_qkv_attention(
        _t(qkv), h, d, kv_mask=None if mask is None else _t(mask),
        rope_cos=None if cos is None else _t(cos), rope_sin=None if sin is None else _t(sin),
    )
    assert out.shape == (n, p, h * d)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(ref_fm).transpose(0, 2, 1), atol=TOL, rtol=TOL
    )


@pytest.mark.parametrize("b,h,kvh,d", [(2, 8, 2, 32), (3, 4, 4, 16)])
def test_gqa_decode_attention_matches_pallas_k3(b, h, kvh, d):
    """Single-token decode against two layers of the stacked cache."""
    rng = np.random.RandomState(2)
    layers, s = 3, 64
    q = rng.randn(b, h, d).astype(np.float32)
    ck = rng.randn(layers, b, kvh, s, d).astype(np.float32)
    cv = rng.randn(layers, b, kvh, s, d).astype(np.float32)
    mask = (rng.rand(b, s) > 0.3).astype(np.int32)
    mask[0] = 1
    for layer in (0, 2):
        ref = jatt.gqa_decode_attention(
            jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(layer, jnp.int32),
            jnp.asarray(mask), use_pallas=True, interpret=True,
        )
        out = tatt.gqa_decode_attention(_t(q), _t(ck), _t(cv), layer, _t(mask))
        assert out.shape == (b, h, d)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)


def test_references_match_jax_references():
    """The plain versions mirror the JAX references, -1e30 masking included
    (a fully masked row averages v uniformly in both)."""
    rng = np.random.RandomState(3)
    q = rng.randn(2, 4, 8, 16).astype(np.float32)
    k = rng.randn(2, 2, 12, 16).astype(np.float32)
    v = rng.randn(2, 2, 12, 16).astype(np.float32)
    mask = _run_mask(2, 12, [(0, 12), (12, 12)])  # second row: no valid key
    ref = jatt.gqa_attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True, kv_mask=jnp.asarray(mask)
    )
    out = tatt.gqa_attention_reference(_t(q), _t(k), _t(v), causal=True, kv_mask=_t(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)
    kf = np.repeat(k, 2, axis=1)
    vf = np.repeat(v, 2, axis=1)
    ref = jatt.attention_reference(jnp.asarray(q), jnp.asarray(kf), jnp.asarray(vf), kv_mask=jnp.asarray(mask))
    out = tatt.attention_reference(_t(q), _t(kf), _t(vf), kv_mask=_t(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)


def test_cpu_calls_take_plain_path_and_count_no_launch():
    tatt.reset_launch_counts()
    x = torch.randn(1, 2, 8, 16)
    gappy = torch.tensor([[1, 0, 1, 1, 0, 1, 1, 1]])
    tatt.flash_attention(x, x, x, causal=True)
    tatt.flash_attention(x, x, x, kv_mask=gappy)
    tatt.fused_qkv_attention(torch.randn(1, 6, 8, 16), 2, 2, kv_mask=gappy)
    tatt.packed_vision_attention(torch.randn(1, 8, 3 * 2 * 128), 2, 16)
    tatt.vision_qkv_attention(torch.randn(1, 8, 3 * 2 * 16), 2, 16)
    tatt.gqa_decode_attention(torch.randn(1, 2, 16), torch.randn(2, 1, 2, 8, 16),
                              torch.randn(2, 1, 2, 8, 16), 1, torch.ones(1, 8))
    assert all(count == 0 for count in tatt.launch_counts.values())


def _raise_unavailable():
    raise _build.KernelBuildError("kernels unavailable (test)")


def test_device_tensor_without_kernels_raises(monkeypatch):
    """A tensor off the CPU never takes the plain path: with the kernel library
    unavailable, every wrapper raises instead of falling back. (Meta tensors
    stand in for CUDA tensors, which this CPU-only test process cannot make.)"""
    monkeypatch.setattr(_build, "load_library", _raise_unavailable)
    meta = dict(device="meta", dtype=torch.bfloat16)
    q = torch.empty(1, 4, 8, 16, **meta)
    kv = torch.empty(1, 2, 8, 16, **meta)
    with pytest.raises(_build.KernelBuildError):
        tatt.flash_attention(q, kv, kv, causal=True)
    with pytest.raises(_build.KernelBuildError):
        tatt.vision_qkv_attention(torch.empty(1, 8, 3 * 4 * 16, **meta), 4, 16)
    with pytest.raises(_build.KernelBuildError):
        tatt.fused_qkv_attention(torch.empty(1, 8, 8, 16, **meta), 4, 2)
    with pytest.raises(_build.KernelBuildError):
        tatt.packed_vision_attention(torch.empty(1, 8, 3 * 4 * 128, **meta), 4, 80)
    with pytest.raises(_build.KernelBuildError):
        tatt.gqa_decode_attention(
            torch.empty(1, 4, 16, **meta), torch.empty(2, 1, 2, 8, 16, **meta),
            torch.empty(2, 1, 2, 8, 16, **meta), 0, torch.ones(1, 8, device="meta"),
        )
    assert all(count == 0 for count in tatt.launch_counts.values())


def test_gappy_mask_on_device_raises(monkeypatch):
    """A gappy mask on a device tensor goes to the kernel (K2's tensor-mask
    form): without the kernel library the call raises the build error, and
    nothing raises ``NotImplementedError`` or falls back to the plain path."""
    monkeypatch.setattr(_build, "load_library", _raise_unavailable)
    q = torch.empty(1, 2, 8, 16, device="meta")
    gappy = torch.tensor([[1, 0, 1, 1, 0, 0, 1, 1]], device="meta")
    with pytest.raises(_build.KernelBuildError):
        tatt.flash_attention(q, q, q, kv_mask=gappy)
    with pytest.raises(_build.KernelBuildError):
        tatt.fused_qkv_attention(torch.empty(1, 6, 8, 16, device="meta"), 2, 2, kv_mask=gappy)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "NVCC_CANDIDATES", ())
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(_build.KernelBuildError, match="nvcc"):
        _build.build()
    assert not (tmp_path / "kernels").exists() or not any((tmp_path / "kernels").iterdir())


def test_build_flags_target_hopper():
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    sources = {p.name for p in _build._sources()}
    assert {"flash_attn.cu", "decode_attn.cu"} <= sources
    assert _build.library_path().parent == _build.BUILD_DIR


def _gappy_mask(rng, b, l):
    """[B, L] int32 with gaps: random holes, a masked head run and a masked tail."""
    m = (rng.rand(b, l) > 0.35).astype(np.int32)
    m[0, :40] = 0
    m[-1, l - 50 :] = 0
    m[:, 64] = 1  # every row keeps a valid key
    return m


def _rows_with_a_key(mask, causal, lq):
    """[B, Lq] bool: query rows that see at least one valid key."""
    if not causal:
        return np.broadcast_to(mask.any(axis=1)[:, None], (mask.shape[0], lq))
    offset = mask.shape[1] - lq
    seen = np.cumsum(mask, axis=1) > 0
    return seen[:, offset:]


def _assert_rows_close(out, ref, rows):
    """out/ref [B, H, L, D]; compare the query rows marked in rows [B, L]."""
    out = np.asarray(out).transpose(0, 2, 1, 3)[rows]
    ref = np.asarray(ref).transpose(0, 2, 1, 3)[rows]
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("with_rope", [False, True])
def test_flash_attention_gappy_mask_matches_pallas_k2(causal, with_rope):
    """K2's tensor-mask form at L = 256 with 128-key blocks (the multi-block
    online softmax), GQA 8/2."""
    rng = np.random.RandomState(4)
    b, h, kvh, l, d = 2, 8, 2, 256, 32
    q = rng.randn(b, h, l, d).astype(np.float32)
    k = rng.randn(b, kvh, l, d).astype(np.float32)
    v = rng.randn(b, kvh, l, d).astype(np.float32)
    mask = _gappy_mask(rng, b, l)
    cos, sin = _rope_tables(rng, b, l, d) if with_rope else (None, None)
    ref = jatt.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, kv_mask=jnp.asarray(mask),
        block_q=128, block_k=128, use_pallas=True, interpret=True,
        rope_cos=None if cos is None else jnp.asarray(cos),
        rope_sin=None if sin is None else jnp.asarray(sin),
    )
    out = tatt.flash_attention(
        _t(q), _t(k), _t(v), causal=causal, kv_mask=_t(mask),
        rope_cos=None if cos is None else _t(cos), rope_sin=None if sin is None else _t(sin),
    )
    assert out.shape == (b, h, l, d)
    _assert_rows_close(out.numpy(), ref, _rows_with_a_key(mask, causal, l))


@pytest.mark.parametrize("token_major", [False, True])
@pytest.mark.parametrize("mask_kind,causal,with_rope,kvh", [
    ("gappy", False, True, 8),   # the Qwen2.5-VL tower's global layers
    ("gappy", True, False, 2),
    ("contiguous", True, True, 2),
    (None, False, True, 8),
])
def test_fused_qkv_attention_matches_pallas_k2(token_major, mask_kind, causal, with_rope, kvh):
    """The combined-qkv entry against JAX ``fused_qkv_attention`` (Pallas
    interpret) at L = 256, 128-key blocks; the token-major form takes the
    [B, L, H + 2*KVH, D] view and returns [B, L, H*D]."""
    rng = np.random.RandomState(5)
    b, h, l, d = 2, 8, 256, 16
    qkvh = rng.randn(b, h + 2 * kvh, l, d).astype(np.float32)
    if mask_kind == "gappy":
        mask = _gappy_mask(rng, b, l)
    elif mask_kind == "contiguous":
        mask = _run_mask(b, l, [(0, l), (70, 230)])
    else:
        mask = np.ones((b, l), np.int32)
    cos, sin = _rope_tables(rng, b, l, d) if with_rope else (None, None)
    jmask = None if mask_kind is None else jnp.asarray(mask)
    ref = jatt.fused_qkv_attention(
        jnp.asarray(qkvh), h, kvh, causal=causal, kv_mask=jmask,
        kv_mask_contiguous=mask_kind == "contiguous", block_q=128, block_k=128,
        use_pallas=True, interpret=True,
        rope_cos=None if cos is None else jnp.asarray(cos),
        rope_sin=None if sin is None else jnp.asarray(sin),
    )
    x = _t(qkvh.transpose(0, 2, 1, 3)) if token_major else _t(qkvh)
    out = tatt.fused_qkv_attention(
        x, h, kvh, causal=causal, kv_mask=None if mask_kind is None else _t(mask),
        kv_mask_contiguous=mask_kind == "contiguous", token_major=token_major,
        rope_cos=None if cos is None else _t(cos), rope_sin=None if sin is None else _t(sin),
    )
    if token_major:
        assert out.shape == (b, l, h * d)
        out = out.view(b, l, h, d).permute(0, 2, 1, 3)
    assert out.shape == (b, h, l, d)
    _assert_rows_close(out.numpy(), ref, _rows_with_a_key(mask, causal, l))


def _packed(q, k, v, hp=128):
    """[B, NH, L, HD] x3 -> packed [B, L, 3*NH*HP] with zero padding columns."""
    b, nh, l, hd = q.shape
    stack = np.pad(np.stack([q, k, v], axis=2), ((0, 0),) * 4 + ((0, hp - hd),))
    return stack.transpose(0, 3, 2, 1, 4).reshape(b, l, 3 * nh * hp)


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("with_freqs", [True, False])
def test_packed_vision_attention_matches_pallas_k5(masked, with_freqs):
    """K5's entry against JAX ``packed_vision_attention`` (Pallas interpret) at
    L = 256 with 128-key blocks, head_dim 80 padded to 128; the padding columns
    are exact zeros in both."""
    rng = np.random.RandomState(6)
    b, nh, l, hd = 2, 2, 256, 80
    qkv = _packed(*(rng.randn(b, nh, l, hd).astype(np.float32) for _ in range(3)))
    mask = _run_mask(b, l, [(0, l), (0, 180)])
    freqs = rng.uniform(0, 6.28, (b, l, hd // 2)).astype(np.float32)
    kw_j = dict(kv_mask=jnp.asarray(mask) if masked else None, freqs=jnp.asarray(freqs) if with_freqs else None)
    ref = jatt.packed_vision_attention(
        jnp.asarray(qkv), nh, hd, block_q=128, block_k=128, use_pallas=True, interpret=True, **kw_j
    )
    out = tatt.packed_vision_attention(
        _t(qkv), nh, hd, kv_mask=_t(mask) if masked else None, freqs=_t(freqs) if with_freqs else None
    )
    assert out.shape == (b, l, nh * 128)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)
    assert not out.view(b, l, nh, 128)[..., hd:].any()
    if with_freqs:  # ready cos/sin tables compute the same as the freqs table
        again = tatt.packed_vision_attention(
            _t(qkv), nh, hd, kv_mask=_t(mask) if masked else None,
            rope_cos=torch.cos(_t(freqs)), rope_sin=torch.sin(_t(freqs)),
        )
        torch.testing.assert_close(again, out, atol=0, rtol=0)


class _FakeLibrary:
    """Stands in for the kernel library: records each FlashArgs it is given."""

    def __init__(self):
        self.calls = []

    def owc_flash_attention(self, args, stream):
        a = args._obj
        self.calls.append({name: getattr(a, name) for name, _ in a._fields_})
        return 0


def test_launch_marshals_masks_and_strides(monkeypatch):
    """What the wrappers hand the kernel, checked on host tensors with the
    library faked: a gappy mask goes as an int32 [B, Lk] pointer (no (start,
    end) table) and counts as a tensor-mask launch; a contiguous one as (start,
    end); the token-major combined view passes (batch, head, token) strides of
    the [B, L, H + 2*KVH, D] array; the packed entry reads 80 of each 128 columns."""
    lib = _FakeLibrary()
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(tatt, "_check_operands", lambda tensors: next(iter(tensors.values())).dtype)
    monkeypatch.setattr(tatt, "_stream_handle", lambda device: 0)
    tatt.reset_launch_counts()
    b, l, h, kvh, d = 2, 8, 4, 2, 16
    qkvh = torch.randn(b, l, h + 2 * kvh, d)
    q, k, v = tatt._fused_views(qkvh, h, kvh, token_major=True)
    out = torch.empty(b, l, h * d)
    gappy = torch.tensor([[1, 0, 1, 1, 0, 1, 1, 1], [0, 1, 1, 1, 1, 1, 0, 1]])
    kw = dict(causal=False, scale=0.25, rope_cos=None, rope_sin=None)
    tatt._launch_flash("fused_qkv_attention", q, k, v, out.view(b, l, h, d).permute(0, 2, 1, 3),
                       kv_mask=gappy, kv_mask_contiguous=False, **kw)
    a = lib.calls[-1]
    assert a["mask"] and not a["mask_se"]
    row = h + 2 * kvh
    assert (a["q_sb"], a["q_sh"], a["q_sl"]) == (l * row * d, d, row * d)
    assert a["k"] == qkvh.data_ptr() + h * d * 4 and a["v"] == qkvh.data_ptr() + (h + kvh) * d * 4
    assert (a["o_sb"], a["o_sh"], a["o_sl"]) == (l * h * d, d, h * d)
    assert (a["heads"], a["kv_heads"], a["lq"], a["lk"], a["head_dim"], a["dtype"]) == (h, kvh, l, l, d, 0)
    contiguous = torch.tensor([[1] * 8, [0, 0, 1, 1, 1, 0, 0, 0]])
    tatt._launch_flash("flash_attention", q, k, v, torch.empty(b, h, l, d),
                       kv_mask=contiguous, kv_mask_contiguous=True, **kw)
    assert lib.calls[-1]["mask_se"] and not lib.calls[-1]["mask"]
    assert tatt.launch_counts["fused_qkv_attention"] == 1 and tatt.launch_counts["flash_attention"] == 1
    assert tatt.launch_counts["flash_attention_tensor_mask"] == 1
    tatt.reset_launch_counts()


# ------------------------------------------------- the Hopper redesign's host side


class _FakeDecodeLibrary:
    """Stands in for the kernel library: records each DecodeArgs it is given."""

    def __init__(self):
        self.calls = []

    def owc_gqa_decode_attention(self, args, stream):
        a = args._obj
        self.calls.append({name: getattr(a, name) for name, _ in a._fields_})
        return 0


@pytest.fixture
def fake_decode(monkeypatch):
    lib = _FakeDecodeLibrary()
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(tatt, "_check_operands", lambda tensors: next(iter(tensors.values())).dtype)
    monkeypatch.setattr(tatt, "_stream_handle", lambda device: 0)
    tatt.reset_launch_counts()
    yield lib
    tatt.reset_launch_counts()


@pytest.mark.parametrize("seq", [1, 17, 63, 64, 65, 100, 129, 320, 384, 448, 520, 1000, 2048, 2049, 8192])
def test_decode_split_plan_covers_the_cache(seq):
    """Up to 8 splits (one per 64 positions), keys a multiple of 16, that
    cover the cache with none empty; 384 positions split as 6 x 64."""
    splits, keys = tatt.decode_split_plan(seq)
    assert 1 <= splits <= 8 and keys % 16 == 0
    assert splits * keys >= seq and (splits - 1) * keys < seq
    assert splits <= -(-seq // 64)
    if seq == 384:
        assert (splits, keys) == (6, 64)


@pytest.mark.parametrize("int8", [False, True])
def test_decode_split_depends_on_cache_length_only(fake_decode, int8):
    """A pooled batch of 96 rows and an unpooled one of 48 at S = 384 reach the
    kernel with the same split plan, so they split the keys alike and give the
    same bits; the plan changes with S only."""
    layers, kvh, s, d = 2, 4, 384, 128
    for b in (48, 96):
        q = torch.randn(b, 28, d, dtype=torch.bfloat16)
        dt = torch.int8 if int8 else torch.bfloat16
        cache = torch.zeros(layers, b, kvh, s, d, dtype=dt)
        scales = (torch.ones(layers, b, kvh, s), torch.ones(layers, b, kvh, s)) if int8 else (None, None)
        out = tatt._launch_decode(q, cache, cache.clone(), 1, torch.ones(b, s, dtype=torch.int32), *scales, 0.1)
        assert out.shape == (b, 28, d)
    first, second = fake_decode.calls
    assert (first["batch"], second["batch"]) == (48, 96)
    assert (first["splits"], first["split_keys"]) == (second["splits"], second["split_keys"]) == (6, 64)
    assert first["cache_int8"] == second["cache_int8"] == int(int8)
    name = "gqa_decode_attention_int8" if int8 else "gqa_decode_attention"
    assert tatt.launch_counts[name] == 2


def _decode_kernel_takes(a: dict) -> tuple[bool, bool]:
    """(whether a kernel of csrc/decode_attn.cu takes these DecodeArgs, whether
    the general kernel would need the score workspace), restated from the
    source: the Hopper instances (``sm90::takes``), else the general kernel,
    whose q, output accumulator and, without a workspace, score rows must fit
    in 232448 bytes of shared memory."""
    g, d, s = a["heads"] // a["kv_heads"], a["head_dim"], a["seq"]
    hopper = (a["dtype"] == 1 and d in (64, 128) and g <= 8 and 1 <= a["splits"] <= 8
              and a["split_keys"] % 16 == 0 and a["split_keys"] <= 256
              and a["splits"] * a["split_keys"] >= s and (a["splits"] - 1) * a["split_keys"] < s)
    needs = not hopper and 4 * (2 * g * d + g * s) > 232448
    smem = 4 * (2 * g * d + (0 if a["workspace"] else g * s))
    return hopper or smem <= 232448, needs


_ADAPTER_CACHE_LENGTHS = sorted({
    p + g for p in tutils.DEFAULT_LENGTH_BUCKETS for g in tqvl.GEN_LEN_BUCKETS
})


@pytest.mark.parametrize("seq", _ADAPTER_CACHE_LENGTHS)
def test_decode_launch_is_taken_at_every_adapter_cache_length(fake_decode, seq):
    """Every cache length the adapter builds (prompt bucket + generation
    bucket, up to 8192 + 512) reaches a kernel that takes it, for a bf16, an
    f32 and an int8 cache at the 7B's group of 7 and head dim 128: the Hopper
    instances up to S = 2048, else the general kernel, with the f32 score
    workspace exactly where its score rows would not fit in shared memory
    (S = 8256 and 8704 get one, S = 384 none)."""
    b, kvh, h, d = 1, 1, 7, 128
    for q_dtype, c_dtype in ((torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
                             (torch.bfloat16, torch.int8)):
        cache = torch.zeros(1, b, kvh, seq, d, dtype=c_dtype)
        scales = (torch.ones(1, b, kvh, seq), torch.ones(1, b, kvh, seq)) if c_dtype == torch.int8 else (None, None)
        tatt._launch_decode(torch.zeros(b, h, d, dtype=q_dtype), cache, cache, 0,
                            torch.ones(b, seq, dtype=torch.int32), *scales, 0.1)
        a = fake_decode.calls[-1]
        taken, needs = _decode_kernel_takes(a)
        assert taken, (seq, q_dtype, c_dtype)
        assert bool(a["workspace"]) == needs
        if seq in (8256, 8704):
            assert a["workspace"]
        if seq == 384:
            assert not a["workspace"]
    assert len(fake_decode.calls) == 3


def _decode_operands(b=2, h=8, kvh=2, s=32, d=64, dtype=torch.bfloat16):
    return torch.randn(b, h, d).to(dtype), torch.randn(3, b, kvh, s, d).to(dtype), torch.ones(b, s)


@pytest.mark.parametrize("case", ["group", "head_dim", "layer", "mask", "noncontiguous", "scales"])
def test_decode_wrapper_checks_raise(fake_decode, case):
    """The decode wrapper's checks still raise before any launch."""
    q, cache, mask = _decode_operands()
    args = [q, cache, cache.clone(), 1, mask]
    if case == "group":
        args[0] = torch.randn(2, 18, 64).to(torch.bfloat16)  # 9 query heads per KV head
    elif case == "head_dim":
        args[0], args[1] = torch.randn(2, 8, 72).to(torch.bfloat16), torch.randn(3, 2, 2, 32, 72).to(torch.bfloat16)
        args[2] = args[1].clone()
        args[0] = args[0][..., :68]  # 68 is not a multiple of 8 values
        args[1], args[2] = args[1][..., :68].contiguous(), args[2][..., :68].contiguous()
    elif case == "layer":
        args[3] = 3
    elif case == "mask":
        args[4] = torch.ones(2, 31)
    elif case == "noncontiguous":
        args[1] = cache.transpose(3, 4).contiguous().transpose(3, 4)
    elif case == "scales":
        args[1], args[2] = cache.to(torch.int8), cache.to(torch.int8)
        args += [torch.ones(3, 2, 2, 32), torch.ones(3, 2, 2, 31)]
    with pytest.raises(ValueError):
        tatt._launch_decode(*args[:5], *(args[5:] or [None, None]), 0.125)
    assert fake_decode.calls == []


@pytest.fixture
def fake_flash(monkeypatch):
    lib = _FakeLibrary()
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(tatt, "_check_operands", lambda tensors: next(iter(tensors.values())).dtype)
    monkeypatch.setattr(tatt, "_stream_handle", lambda device: 0)
    tatt.reset_launch_counts()
    yield lib
    tatt.reset_launch_counts()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_launch_passes_key_rotation_scratch(fake_flash, dtype):
    """With rope, a bf16 launch carries a [B, KVH, Lk, D] scratch for the keys
    the Hopper instances rotate once; without rope, or in f32, it carries none."""
    b, h, kvh, l, d = 2, 4, 2, 16, 80
    q, k = torch.randn(b, h, l, d).to(dtype), torch.randn(b, kvh, l, d).to(dtype)
    cos, sin = torch.ones(b, l, d // 2), torch.zeros(b, l, d // 2)
    kw = dict(causal=False, kv_mask=None, kv_mask_contiguous=False, scale=0.1)
    tatt._launch_flash("flash_attention", q, k, k, torch.empty(q.shape, dtype=dtype), rope_cos=cos, rope_sin=sin, **kw)
    tatt._launch_flash("flash_attention", q, k, k, torch.empty(q.shape, dtype=dtype), rope_cos=None, rope_sin=None, **kw)
    with_rope, without = fake_flash.calls
    assert bool(with_rope["k_rot"]) == (dtype == torch.bfloat16) and not without["k_rot"]
    assert with_rope["cos"] and with_rope["rope_sb"] == l * d // 2 and not without["cos"]


@pytest.mark.parametrize("case", ["head_dim", "unit_stride", "bf16_alignment", "shape", "gqa", "mask", "rope"])
def test_flash_wrapper_checks_raise(fake_flash, case):
    """The flash launcher's checks still raise before any launch."""
    b, h, kvh, l, d = 1, 4, 2, 8, 16
    q, k = torch.randn(b, h, l, d).to(torch.bfloat16), torch.randn(b, kvh, l, d).to(torch.bfloat16)
    v, out, kw = k, torch.empty(b, h, l, d, dtype=torch.bfloat16), {}
    if case == "head_dim":
        q, k = torch.randn(b, h, l, 96).to(torch.bfloat16), torch.randn(b, kvh, l, 96).to(torch.bfloat16)
        v, out = k, torch.empty(b, h, l, 96, dtype=torch.bfloat16)
    elif case == "unit_stride":
        q = torch.randn(b, h, d, l).to(torch.bfloat16).transpose(2, 3)
    elif case == "bf16_alignment":
        q = torch.randn(b, h, l, d + 1).to(torch.bfloat16)[..., 1:]
    elif case == "shape":
        v = torch.randn(b, kvh, l + 1, d).to(torch.bfloat16)
    elif case == "gqa":
        k = v = torch.randn(b, 3, l, d).to(torch.bfloat16)
    elif case == "mask":
        kw["kv_mask"] = torch.ones(b, l + 1)
    elif case == "rope":
        kw.update(rope_cos=torch.ones(b, l + 1, d // 2), rope_sin=torch.ones(b, l + 1, d // 2))
    kw = dict(dict(kv_mask=None, rope_cos=None, rope_sin=None), **kw)
    with pytest.raises(ValueError):
        tatt._launch_flash("flash_attention", q, k, v, out, causal=False, kv_mask_contiguous=False, scale=0.25, **kw)
    assert fake_flash.calls == [] and tatt.launch_counts["flash_attention"] == 0


def _split_decode_emulation(q, k, v, mask, scale, splits, keys):
    """The cluster kernel's order in numpy (f32): per split, scores, max and sum
    of exponentials; combined in rank order; weights normalised in f32 and
    rounded to the value type (here f32), per-split PV partials added in rank order."""
    b, h, d = q.shape
    kvh, s = k.shape[1], k.shape[2]
    g = h // kvh
    out = np.zeros((b, h, d), np.float32)
    for bi in range(b):
        for kh in range(kvh):
            qg = q[bi, kh * g : (kh + 1) * g]
            parts, stats = [], []
            for r in range(splits):
                lo, hi_ = r * keys, min(s, (r + 1) * keys)
                sc = (qg @ k[bi, kh, lo:hi_].T) * scale
                sc = np.where(mask[bi, lo:hi_][None] != 0, sc, np.float32(-1e30))
                m = sc.max(axis=1)
                stats.append((m, np.exp(sc - m[:, None]).sum(axis=1), sc, lo, hi_))
            gm = np.max([st[0] for st in stats], axis=0)
            total = np.zeros_like(gm)
            for m, l_, *_ in stats:
                total += l_ * np.exp(m - gm)
            for _, _, sc, lo, hi_ in stats:
                w = np.exp(sc - gm[:, None]) / total[:, None]
                parts.append(w @ v[bi, kh, lo:hi_])
            out[bi, kh * g : (kh + 1) * g] = np.sum(parts, axis=0)
    return out


@pytest.mark.parametrize("seq", [40, 384, 520])
def test_split_decode_order_matches_jax_reference(seq):
    """The decode kernel's split order (per-split max and sum combined across
    the cluster, normalised before PV, partials added in rank order), emulated
    in f32, agrees with the JAX package's ``gqa_attention_reference``."""
    rng = np.random.RandomState(seq)
    b, h, kvh, d = 2, 14, 2, 64
    q = rng.randn(b, h, d).astype(np.float32)
    k = rng.randn(b, kvh, seq, d).astype(np.float32)
    v = rng.randn(b, kvh, seq, d).astype(np.float32)
    mask = (rng.rand(b, seq) > 0.2).astype(np.int32)
    mask[1, : seq // 2] = 0
    scale = 1.0 / np.sqrt(d)
    got = _split_decode_emulation(q, k, v, mask, np.float32(scale), *tatt.decode_split_plan(seq))
    ref = jatt.gqa_attention_reference(
        jnp.asarray(q[:, :, None]), jnp.asarray(k), jnp.asarray(v), kv_mask=jnp.asarray(mask), scale=scale
    )
    np.testing.assert_allclose(got, np.asarray(ref)[:, :, 0], atol=TOL, rtol=TOL)
