"""Layers and image ops of the PyTorch port against the JAX package.

Same float32 numpy inputs from a seed into both; tolerance ``atol = rtol =
1e-5`` (summation order only). JAX linear kernels are ``[in, out]``; the port
stores ``weight = w.T`` (``[out, in]``).
"""

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from lmms_owc_tpu.nn import layers as jl
from lmms_owc_tpu.nn import qwen2_vl as jq
from lmms_owc_tpu.ops import image as jimg
from lmms_owc_tpu_torch import get_device, no_tf32
from lmms_owc_tpu_torch.nn import layers as tl
from lmms_owc_tpu_torch.nn import qwen2_vl as tq
from lmms_owc_tpu_torch.ops import image as timg

TOL = 1e-5


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("bias", [False, True])
def test_dense_f32(bias):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 24).astype(np.float32)
    w = rng.randn(24, 40).astype(np.float32) * 0.1
    b = rng.randn(40).astype(np.float32)
    params = {"w": jnp.asarray(w), **({"b": jnp.asarray(b)} if bias else {})}
    ref = jl.dense(params, jnp.asarray(x))
    out = tl.dense(_t(x), _t(w.T), _t(b) if bias else None)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)


def test_dense_bf16_keeps_dtype():
    """bf16 in, bf16 out (products accumulate in f32 inside the matmul); the
    result stays within bf16 rounding of the f32 product."""
    rng = np.random.RandomState(1)
    x = rng.randn(3, 32).astype(np.float32)
    w = rng.randn(32, 16).astype(np.float32) * 0.1
    out = tl.dense(_t(x).bfloat16(), _t(w.T).bfloat16(), _t(np.ones(16, np.float32)).bfloat16())
    assert out.dtype == torch.bfloat16
    ref = np.asarray(jl.dense({"w": jnp.asarray(w, jnp.bfloat16), "b": jnp.ones(16, jnp.bfloat16)},
                              jnp.asarray(x, jnp.bfloat16)), np.float32)
    np.testing.assert_allclose(out.float().numpy(), ref, atol=2e-2, rtol=2e-2)


def test_linear_module_is_dense():
    lin = tl.Linear(8, 4, True, torch.float32, "cpu")
    lin.weight.copy_(torch.arange(32, dtype=torch.float32).reshape(4, 8) / 10)
    x = torch.randn(2, 8)
    torch.testing.assert_close(lin(x), x @ lin.weight.T + lin.bias, atol=0, rtol=0)


def test_norms():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 7, 32).astype(np.float32) * 3 + 1
    scale = rng.randn(32).astype(np.float32)
    bias = rng.randn(32).astype(np.float32)
    ref = jl.layer_norm({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}, jnp.asarray(x), eps=1e-6)
    out = tl.layer_norm(_t(x), _t(scale), _t(bias), eps=1e-6)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)
    ref = jl.rms_norm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-6)
    out = tl.rms_norm(_t(x), _t(scale), 1e-6)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)


def test_activations_embedding_and_mlp():
    rng = np.random.RandomState(3)
    x = rng.randn(4, 16).astype(np.float32)
    np.testing.assert_allclose(tl.gelu(_t(x)).numpy(), np.asarray(jl.gelu(jnp.asarray(x))), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(
        tl.quick_gelu(_t(x)).numpy(), np.asarray(jq.quick_gelu(jnp.asarray(x))), atol=TOL, rtol=TOL
    )
    table = rng.randn(50, 16).astype(np.float32)
    ids = rng.randint(0, 50, (3, 5))
    np.testing.assert_array_equal(
        tl.embedding(_t(table), _t(ids)).numpy(), np.asarray(jl.embedding(jnp.asarray(table), jnp.asarray(ids)))
    )
    gate, up = (rng.randn(16, 24).astype(np.float32) * 0.2 for _ in range(2))
    down = rng.randn(24, 16).astype(np.float32) * 0.2
    ref = jl.mlp_swiglu(
        {"gate": {"w": jnp.asarray(gate)}, "up": {"w": jnp.asarray(up)}, "down": {"w": jnp.asarray(down)}},
        jnp.asarray(x),
    )
    out = tl.mlp_swiglu(_t(x), _t(gate.T), _t(up.T), _t(down.T))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("table_rank", [2, 3])
def test_apply_rope(table_rank):
    rng = np.random.RandomState(4)
    x = rng.randn(2, 3, 6, 16).astype(np.float32)
    shape = (6, 8) if table_rank == 2 else (2, 6, 8)
    freqs = rng.uniform(0, 6.28, shape).astype(np.float32)
    cos, sin = np.cos(freqs), np.sin(freqs)
    ref = jl.apply_rope(jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin))
    out = tl.apply_rope(_t(x), _t(cos), _t(sin))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)
    # bf16 input: rotation in f32, one rounding to bf16 on the way out.
    xb = _t(x).bfloat16()
    outb = tl.apply_rope(xb, _t(cos), _t(sin))
    assert outb.dtype == torch.bfloat16
    refb = jl.apply_rope(jnp.asarray(x, jnp.bfloat16), jnp.asarray(cos), jnp.asarray(sin))
    np.testing.assert_array_equal(outb.float().numpy(), np.asarray(refb, np.float32))


@pytest.mark.parametrize("preset", ["qwen2-vl-tiny", "qwen2-vl-7b"])
def test_mrope_cos_sin(preset):
    """M-RoPE tables for both section layouts: (2, 3, 3) tiny, (16, 24, 24) at 7B."""
    from lmms_owc_tpu_torch.models.qwen2_vl import PRESET_CONFIGS

    cfg_t = tq.Qwen2VLConfig.from_hf_dict(PRESET_CONFIGS[preset])
    cfg_j = jq.Qwen2VLConfig.from_hf_dict(PRESET_CONFIGS[preset])
    assert cfg_t.mrope_section == cfg_j.mrope_section
    rng = np.random.RandomState(5)
    pos = rng.randint(0, 4000, (3, 2, 11)).astype(np.int64)
    cj, sj = jq.mrope_cos_sin(jnp.asarray(pos), cfg_j)
    ct, st = tq.mrope_cos_sin(_t(pos), cfg_t)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=TOL, rtol=TOL)


# ------------------------------------------------------------------ image ops


@pytest.mark.parametrize("dims", [(32, 32), (480, 640), (1080, 1920), (300, 500), (28, 4000), (448, 448)])
def test_smart_resize_matches(dims):
    kw = dict(factor=28, min_pixels=4 * 28 * 28, max_pixels=1024 * 28 * 28)
    assert timg.smart_resize(*dims, **kw) == jimg.smart_resize(*dims, **kw)


@pytest.mark.parametrize("hw", [(32, 32), (100, 70), (336, 448)])
def test_resize_host_same_pixels(hw):
    rng = np.random.RandomState(6)
    img = Image.fromarray(rng.randint(0, 255, (*hw, 3), dtype=np.uint8))
    chw_t, size_t = timg.resize_host(img)
    chw_j, size_j = jimg.resize_host(img)
    assert size_t == size_j
    np.testing.assert_array_equal(chw_t, chw_j)
    batch = timg.resize_host_batch([img, img])
    assert [s for _, s in batch] == [size_j, size_j]
    np.testing.assert_array_equal(batch[1][0], chw_j)


def test_patchify_images_batch_matches():
    rng = np.random.RandomState(7)
    pixels = rng.randint(0, 255, (2, 3, 56, 84), dtype=np.uint8)
    ref = jimg.patchify_images_batch(jnp.asarray(pixels), 14, 2, 2, jnp.float32)
    out = timg.patchify_images_batch(_t(pixels), 14, 2, 2, torch.float32)
    assert out.shape == (2, 4 * 6, 3 * 2 * 14 * 14)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)


# ------------------------------------------------------------------- device


def test_get_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_device("cuda")
    with pytest.raises(RuntimeError):
        get_device()  # the default is the card
    assert get_device("cpu") == torch.device("cpu")


def test_no_tf32_turns_both_flags_off(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    no_tf32()
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
