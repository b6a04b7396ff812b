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
    tatt.flash_attention(x, x, x, causal=True)
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
        tatt.gqa_decode_attention(
            torch.empty(1, 4, 16, **meta), torch.empty(2, 1, 2, 8, 16, **meta),
            torch.empty(2, 1, 2, 8, 16, **meta), 0, torch.ones(1, 8, device="meta"),
        )
    assert all(count == 0 for count in tatt.launch_counts.values())


def test_gappy_mask_on_device_raises():
    """The CUDA flash kernel takes contiguous masks only (the gappy form of K2
    is still to be ported); a device call without the promise raises."""
    q = torch.empty(1, 2, 8, 16, device="meta")
    with pytest.raises(NotImplementedError, match="gappy"):
        tatt.flash_attention(q, q, q, kv_mask=torch.ones(1, 8, device="meta"))


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
