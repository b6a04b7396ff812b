"""Quantized pieces of the PyTorch port against the JAX package.

Inputs are numpy arrays from a seed, handed to both packages. The quantizers
must agree bit for bit (the port's ``[out, in]`` layout is the JAX ``[in, out]``
transposed); ``dense`` in float32 within ``rtol = 1e-5`` (summation order), in
bf16 within the relative bound of ``tests/test_quantization.py``; the plain
version of K4 against the Pallas kernel in interpret mode within 2e-2 relative
(bf16 operands); the int8-cache decode against the JAX fallback in float32
within 1e-5 and against the Pallas kernel in interpret mode in bf16 within
2e-2. The CUDA kernels themselves run only on the card (``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lmms_owc_tpu.nn import layers as jl
from lmms_owc_tpu.nn import qwen2_vl as jq
from lmms_owc_tpu.ops import attention as jatt
from lmms_owc_tpu.ops import int4_matmul as ji4
from lmms_owc_tpu.ops import quant as jquant
from lmms_owc_tpu_torch.nn import layers as tl
from lmms_owc_tpu_torch.nn import qwen2_vl as tq
from lmms_owc_tpu_torch.ops import _build
from lmms_owc_tpu_torch.ops import attention as tatt
from lmms_owc_tpu_torch.ops import int4_matmul as ti4
from lmms_owc_tpu_torch.ops import quant as tquant


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _swap(a) -> np.ndarray:
    """The last two axes swapped: JAX [.., in, out] <-> port [.., out, in]."""
    return np.swapaxes(np.asarray(a), -1, -2)


@pytest.fixture
def w8a8():
    """Turns W8A8 on in both packages and off again afterwards."""

    def on():
        jl.set_int8_activations(True)
        tl.set_int8_activations(True)

    yield on
    jl.set_int8_activations(False)
    tl.set_int8_activations(False)


# ------------------------------------------------------------------ quantizers


@pytest.mark.parametrize("shape", [(64, 48), (3, 16, 8), (200, 24)], ids=["2d", "stacked", "in200"])
def test_quantize_int8_bit_identical(shape):
    rng = np.random.RandomState(0)
    w = (rng.randn(*shape) * rng.uniform(0.01, 3.0, shape[-1])).astype(np.float32)
    ref = jquant.quantize_int8(jnp.asarray(w))
    got = tquant.quantize_int8(_t(_swap(w)))
    assert got["q"].dtype == torch.int8 and got["scale"].dtype == torch.float32
    np.testing.assert_array_equal(got["q"].numpy(), _swap(ref["q"]))
    np.testing.assert_array_equal(got["scale"].numpy(), np.asarray(ref["scale"]))
    np.testing.assert_array_equal(
        tquant.dequantize_int8(got).numpy(), _swap(jquant.dequantize_int8(ref))
    )


@pytest.mark.parametrize(
    "shape,group", [((256, 48), 128), ((3, 256, 16), 128), ((200, 24), 128), ((512, 32), 64)],
    ids=["2d", "stacked", "in200-one-group", "group64"],
)
def test_quantize_int4_bit_identical(shape, group):
    rng = np.random.RandomState(1)
    w = rng.randn(*shape).astype(np.float32)
    ref = jquant.quantize_int4(jnp.asarray(w), group=group)
    got = tquant.quantize_int4(_t(_swap(w)), group=group)
    assert got["q4"].shape == _swap(ref["q4"]).shape and got["q4"].dtype == torch.int8
    np.testing.assert_array_equal(got["q4"].numpy(), _swap(ref["q4"]))
    np.testing.assert_array_equal(got["scale"].numpy(), _swap(ref["scale"]))
    np.testing.assert_array_equal(tquant.unpack_int4(got).numpy(), _swap(jquant.unpack_int4(ref)))
    np.testing.assert_array_equal(
        tquant.dequantize_int4(got).numpy(), _swap(jquant.dequantize_int4(ref))
    )


def test_quantize_kv_cache_matches_after_scale_layout():
    """The port keeps [L, B, KVH, S] scales; the JAX package replicates them
    over a TPU sublane axis, [L, B, KVH, 8, S]."""
    rng = np.random.RandomState(2)
    ks = rng.randn(2, 3, 2, 10, 16).astype(np.float32)
    vs = rng.randn(2, 3, 2, 10, 16).astype(np.float32)
    ks[:, :, :, 7:] = 0.0  # cache padding: scale 1e-6/127, zeros
    ref = jq.quantize_kv_cache(jnp.asarray(ks), jnp.asarray(vs))
    got = tq.quantize_kv_cache(_t(ks), _t(vs))
    for i in range(2):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(ref[i]))
    for i in range(2, 4):
        assert np.all(np.asarray(ref[i]) == np.asarray(ref[i])[:, :, :, :1, :])
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(ref[i])[:, :, :, 0, :])


# ---------------------------------------------------------------------- dense


def _dense_pair(kind, rng, d_in=256, d_out=128):
    w = (rng.randn(d_in, d_out) * 0.05).astype(np.float32)
    b = (rng.randn(d_out) * 0.1).astype(np.float32)
    if kind == "q4":
        qp = jquant.quantize_int4(jnp.asarray(w))
        jparams = {"w_q4": qp, "b": jnp.asarray(b)}
        lin = tl.Int4Linear(d_in, d_out, True, torch.float32, "cpu")
        lin.q4.copy_(_t(_swap(qp["q4"])))
        lin.scale.copy_(_t(_swap(qp["scale"])))
    else:
        qp = jquant.quantize_int8(jnp.asarray(w))
        jparams = {"w_q8": qp, "b": jnp.asarray(b)}
        lin = tl.Int8Linear(d_in, d_out, True, torch.float32, "cpu")
        lin.q.copy_(_t(_swap(qp["q"])))
        lin.scale.copy_(_t(qp["scale"]))
    lin.bias.data.copy_(_t(b))
    return jparams, lin


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["q8", "w8a8", "q4"])
def test_dense_quantized_matches_jax(kind, dtype, w8a8):
    rng = np.random.RandomState(3)
    jparams, lin = _dense_pair("q4" if kind == "q4" else "q8", rng)
    x = rng.randn(6, 5, 256).astype(np.float32)
    if kind == "w8a8":
        w8a8()
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    if dtype == "bfloat16":
        jparams = {**jparams, "b": jparams["b"].astype(jnp.bfloat16)}
        lin.bias.data = lin.bias.data.to(torch.bfloat16)
    ref = np.asarray(jl.dense(jparams, jnp.asarray(x).astype(jdt)).astype(jnp.float32))
    out = lin(_t(x).to(tdt))
    assert out.dtype == tdt and out.shape == (6, 5, 128)
    out = out.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    else:
        assert np.abs(out - ref).max() / np.abs(ref).max() < 0.02


def test_w8a8_switch_read_per_call(monkeypatch, w8a8):
    """The W8A8 product is an exact s8 x s8 -> s32 ``torch._int_mm``, chosen on
    every call by the process-wide switch; nothing caches the choice."""
    rng = np.random.RandomState(4)
    _, lin = _dense_pair("q8", rng)
    x = _t(rng.randn(3, 256).astype(np.float32))
    calls = []
    real = torch._int_mm
    monkeypatch.setattr(torch, "_int_mm", lambda a, b: calls.append(a.shape) or real(a, b))
    weight_only = lin(x)
    assert calls == []
    w8a8()
    quantized = lin(x)
    assert calls == [(3, 256)]
    assert not torch.equal(weight_only, quantized)
    tl.set_int8_activations(False)
    torch.testing.assert_close(lin(x), weight_only, rtol=0, atol=0)


@pytest.mark.parametrize("m,k,n", [(3, 1280, 3420), (40, 3420, 1280), (17, 1285, 8), (96, 256, 512)])
def test_int_mm_operands_pad_to_the_cards_shapes(m, k, n):
    """On CUDA ``torch._int_mm`` takes M > 16 and K, N multiples of 8; the
    operands W8A8 hands it there are zero-padded so that the product is
    exact at any shape (the Qwen2.5-VL tower's 3420-wide MLP raised under
    W8A8 on the card), and operands that need no padding are not copied."""
    gen = torch.Generator().manual_seed(m + k + n)
    a = torch.randint(-127, 128, (m, k), generator=gen, dtype=torch.int8)
    q = torch.randint(-127, 128, (n, k), generator=gen, dtype=torch.int8)
    pa, pq = tl._int_mm_operands(a, q)
    assert pa.shape[0] > 16 and pa.shape[1] % 8 == 0 and pq.shape == (-(-n // 8) * 8, pa.shape[1])
    got = torch._int_mm(pa, pq.t())[:m, :n]
    assert torch.equal(got, (a.long() @ q.long().t()).int())
    if m > 16 and k % 8 == 0 and n % 8 == 0:
        assert pa is a and pq is q


# ------------------------------------------------------------------------- K4


@pytest.mark.parametrize("m", [1, 16, 96])
def test_int4_matmul_plain_matches_pallas_k4(m):
    rng = np.random.RandomState(5)
    k_dim, n_dim = 512, 256
    w = rng.randn(k_dim, n_dim).astype(np.float32)
    qp = jquant.quantize_int4(jnp.asarray(w), group=128)
    x = rng.randn(m, k_dim).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    ref = np.asarray(ji4.int4_matmul(xb, qp["q4"], qp["scale"], interpret=True), np.float32)
    q4, scale = _t(_swap(qp["q4"])), _t(_swap(qp["scale"]))
    xt = _t(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16)
    ti4.reset_launch_counts()
    out = ti4.int4_matmul(xt, q4, scale)  # a CPU tensor takes the plain version
    assert out.dtype == torch.bfloat16 and out.shape == (m, n_dim)
    assert ti4.launch_counts["int4_matmul"] == 0
    torch.testing.assert_close(out, ti4.int4_matmul_plain(xt, q4, scale), rtol=0, atol=0)
    rel = np.abs(out.float().numpy() - ref).max() / (np.abs(ref).max() + 1e-6)
    assert rel < 2e-2


@pytest.mark.parametrize(
    "k,n,groups",
    [(3584, 18944, 28), (18944, 3584, 148), (3584, 152064, 28), (3584, 3584, 28), (3584, 512, 28),
     (1536, 8960, 12), (8960, 1536, 70), (1280, 3840, 10), (3584, 18000, 28), (3585, 512, 28),
     (64, 128, 1), (128, 64, 1)],
)
def test_int4_supported_agrees_with_pick_blocks(k, n, groups):
    assert ti4.int4_matmul_supported(k, n, groups) == (ji4.pick_blocks(k, n, groups) is not None)
    assert ti4.pick_blocks(k, n, groups) == ji4.pick_blocks(k, n, groups)


INT4_7B_PRODUCTS = [(3584, 3584), (3584, 512), (3584, 18944), (18944, 3584), (3584, 152064)]


@pytest.mark.parametrize(
    "k,n", INT4_7B_PRODUCTS + [(1536, 8960), (8960, 1536), (1280, 3840), (512, 256), (256, 128), (1024, 256)],
)
def test_int4_split_plan_covers_k_in_whole_groups(k, n):
    """The splits cut the K/2 packed bytes in 128-byte units, i.e. whole
    128-column scale groups of both halves of the input, and cover them with
    no empty split; the column tile divides N."""
    splits, split_bytes, block_n = ti4.int4_split_plan(k, n)
    assert splits >= 1 and split_bytes % 128 == 0 and block_n in (32, 64) and n % block_n == 0
    assert splits * split_bytes >= k // 2 and (splits - 1) * split_bytes < k // 2


@pytest.mark.parametrize("k,n", INT4_7B_PRODUCTS)
def test_int4_split_plan_fills_the_card(k, n):
    """Every 7B decode product launches at least one wave of CTAs on the
    H100's 132 SMs (one split per 64-column tile gave 8 for k/v and 56 for q/o and down)."""
    splits, _, block_n = ti4.int4_split_plan(k, n)
    assert n // block_n * splits >= 132


class _FakeInt4Library:
    """Stands in for the kernel library: records each Int4MatmulArgs it is given."""

    def __init__(self):
        self.calls = []

    def owc_int4_matmul(self, args, stream):
        a = args._obj
        self.calls.append({name: getattr(a, name) for name, _ in a._fields_})
        return 0


@pytest.mark.parametrize("k,n", [(3584, 3584), (18944, 3584), (3584, 512)])
def test_int4_split_depends_on_k_and_n_only(monkeypatch, k, n):
    """A pooled call of 96 rows and an unpooled one of 8 reach the kernel with
    the same plan, so each row's sum runs in the same order and gives the same
    bits; the partials get a [splits, M, N] workspace."""
    lib = _FakeInt4Library()
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(ti4, "_stream_handle", lambda device: 0)
    ti4.reset_launch_counts()
    q4, scale = torch.zeros(n, k // 2, dtype=torch.int8), torch.ones(n, k // 128)
    for m in (96, 8):
        assert ti4._launch_int4(torch.zeros(m, k, dtype=torch.bfloat16), q4, scale).shape == (m, n)
    pooled, unpooled = lib.calls
    assert (pooled["m"], unpooled["m"]) == (96, 8)
    plan = ti4.int4_split_plan(k, n)
    for call in lib.calls:
        assert (call["splits"], call["split_bytes"], call["block_n"]) == tuple(plan)
        assert bool(call["workspace"]) == (plan.splits > 1) and call["dtype"] == 1
    assert ti4.launch_counts["int4_matmul"] == 2
    ti4.reset_launch_counts()


def _bf16(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("m", [8, 96])
def test_int4_split_k_order_matches_pallas_k4(m):
    """A numpy f32 emulation of the kernel's split-K order (each split's
    partial over its packed bytes' low and high input columns, the partials
    added in split order, then cast) agrees with the Pallas K4 in interpret mode."""
    rng = np.random.RandomState(7)
    k_dim, n_dim = 1024, 256
    splits, split_bytes, _ = ti4.int4_split_plan(k_dim, n_dim)
    assert splits > 1
    w = rng.randn(k_dim, n_dim).astype(np.float32)
    qp = jquant.quantize_int4(jnp.asarray(w), group=128)
    x = _bf16(rng.randn(m, k_dim))
    ref = np.asarray(ji4.int4_matmul(jnp.asarray(x).astype(jnp.bfloat16), qp["q4"], qp["scale"], interpret=True),
                     np.float32)
    q4 = _swap(qp["q4"]).astype(np.int8)  # [N, K/2], halves layout
    k2 = k_dim // 2
    nib = np.concatenate([(q4 << 4).astype(np.int8) >> 4, q4 >> 4], axis=1).astype(np.float32)  # [N, K]
    wq = _bf16(nib * np.repeat(_swap(qp["scale"]), 128, axis=1))  # scaled in f32, rounded to bf16
    acc = np.zeros((m, n_dim), np.float32)
    for j0 in range(0, k2, split_bytes):
        cols = np.r_[j0:min(k2, j0 + split_bytes), k2 + j0:k2 + min(k2, j0 + split_bytes)]
        acc = acc + x[:, cols] @ wq[:, cols].T
    out = _bf16(acc)
    rel = np.abs(out - ref).max() / (np.abs(ref).max() + 1e-6)
    assert rel < 2e-2


def _raise_unavailable():
    raise _build.KernelBuildError("kernels unavailable (test)")


def test_int4_dense_dispatch_has_no_fallback(monkeypatch):
    """Off the CPU, a K4-shaped product with at most 256 rows launches the
    kernel or raises (meta tensors stand in for CUDA tensors here); more rows
    dequantize, as the JAX dispatch."""
    monkeypatch.setattr(_build, "load_library", _raise_unavailable)
    meta = dict(device="meta")
    q4 = torch.empty(256, 256, dtype=torch.int8, **meta)
    scale = torch.empty(256, 4, dtype=torch.float32, **meta)
    with pytest.raises(_build.KernelBuildError):
        tl.dense_q4(torch.empty(8, 512, dtype=torch.bfloat16, **meta), q4, scale)
    out = tl.dense_q4(torch.empty(300, 512, dtype=torch.bfloat16, **meta), q4, scale)
    assert out.shape == (300, 256)
    with pytest.raises(_build.KernelBuildError):
        ti4.int4_matmul(torch.empty(300, 512, dtype=torch.bfloat16, **meta), q4, scale)


def test_int4_dense_on_cpu_never_takes_the_kernel(monkeypatch):
    """On the CPU the JAX package has no int4 kernel and dequantizes; so does the port."""
    monkeypatch.setattr(ti4, "int4_matmul", lambda *a: pytest.fail("kernel path on the CPU"))
    monkeypatch.setattr(tl, "int4_matmul", lambda *a: pytest.fail("kernel path on the CPU"))
    rng = np.random.RandomState(6)
    _, lin = _dense_pair("q4", rng, d_in=512, d_out=256)
    assert lin(_t(rng.randn(4, 512).astype(np.float32))).shape == (4, 256)


# ------------------------------------------------------------------ K3, int8


def _int8_cache_inputs(rng, b=3, h=8, kvh=2, s=40, d=32, layers=2):
    q = rng.randn(b, h, d).astype(np.float32)
    ck = rng.randn(layers, b, kvh, s, d).astype(np.float32)
    cv = rng.randn(layers, b, kvh, s, d).astype(np.float32)
    mask = (rng.rand(b, s) > 0.3).astype(np.int32)
    mask[0] = 1
    kq, vq, sk8, sv8 = jq.quantize_kv_cache(jnp.asarray(ck), jnp.asarray(cv))
    return q, kq, vq, sk8, sv8, mask


@pytest.mark.parametrize("layer", [0, 1])
def test_int8_decode_plain_matches_jax_fallback(layer):
    rng = np.random.RandomState(7)
    q, kq, vq, sk8, sv8, mask = _int8_cache_inputs(rng)
    ref = jatt.gqa_decode_attention(
        jnp.asarray(q), kq, vq, jnp.asarray(layer, jnp.int32), jnp.asarray(mask), sk8, sv8,
        use_pallas=False,
    )
    out = tatt.gqa_decode_attention(
        _t(q), _t(kq), _t(vq), layer, _t(mask), _t(np.asarray(sk8)[:, :, :, 0]), _t(np.asarray(sv8)[:, :, :, 0])
    )
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_int8_decode_plain_matches_pallas_k3_bf16():
    rng = np.random.RandomState(8)
    q, kq, vq, sk8, sv8, mask = _int8_cache_inputs(rng, b=2, h=8, kvh=2, s=128, d=32)
    qb = jnp.asarray(q).astype(jnp.bfloat16)
    ref = jatt.gqa_decode_attention(
        qb, kq, vq, jnp.asarray(1, jnp.int32), jnp.asarray(mask), sk8, sv8,
        use_pallas=True, interpret=True,
    )
    out = tatt.gqa_decode_attention(
        _t(np.asarray(qb.astype(jnp.float32))).to(torch.bfloat16), _t(kq), _t(vq), 1, _t(mask),
        _t(np.asarray(sk8)[:, :, :, 0]), _t(np.asarray(sv8)[:, :, :, 0]),
    )
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), atol=2e-2, rtol=2e-2)


def test_int8_decode_on_device_has_no_fallback(monkeypatch):
    monkeypatch.setattr(_build, "load_library", _raise_unavailable)
    tatt.reset_launch_counts()
    meta = dict(device="meta")
    cache = torch.empty(2, 1, 2, 8, 16, dtype=torch.int8, **meta)
    scales = torch.empty(2, 1, 2, 8, **meta)
    with pytest.raises(_build.KernelBuildError):
        tatt.gqa_decode_attention(
            torch.empty(1, 4, 16, dtype=torch.bfloat16, **meta), cache, cache, 0,
            torch.ones(1, 8, **meta), scales, scales,
        )
    assert all(count == 0 for count in tatt.launch_counts.values())
    with pytest.raises(ValueError, match="int8 cache"):
        tatt.gqa_decode_attention(torch.randn(1, 4, 16), torch.zeros(2, 1, 2, 8, 16, dtype=torch.int8),
                                  torch.zeros(2, 1, 2, 8, 16, dtype=torch.int8), 0, torch.ones(1, 8))


# ------------------------------------------------------- heads, trees, init


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_head_logits_match_jax(bits):
    """int8 head: bf16 x bf16 with f32 accumulation, then the channel scale;
    int4 head: its dense on bf16 x. Held at bf16 rounding of the inputs."""
    rng = np.random.RandomState(9)
    hidden, vocab = 256, 512
    w = (rng.randn(hidden, vocab) * 0.05).astype(np.float32)
    quantize = jquant.quantize_params_int8 if bits == 8 else jquant.quantize_params_int4
    head = quantize({"lm_head": {"w": jnp.asarray(w)}})["lm_head"]
    x = rng.randn(4, hidden).astype(np.float32)
    ref = np.asarray(jq._head_logits({"lm_head": head}, jnp.asarray(x)))

    class _M:
        lm_head = (tl.Int8Linear if bits == 8 else tl.Int4Linear)(hidden, vocab, False, torch.float32, "cpu")

    model = _M()
    if bits == 8:
        model.lm_head.q.copy_(_t(_swap(head["w_q8"]["q"])))
        model.lm_head.scale.copy_(_t(head["w_q8"]["scale"]))
    else:
        model.lm_head.q4.copy_(_t(_swap(head["w_q4"]["q4"])))
        model.lm_head.scale.copy_(_t(_swap(head["w_q4"]["scale"])))
    out = tq._head_logits(model, _t(x))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-2, rtol=2e-2)
    if bits == 8:  # f32 accumulation of exact bf16 products: summation order only
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("bits", [8, 4])
def test_params_from_jax_quantized_layout(bits):
    from lmms_owc_tpu_torch.models.qwen2_vl import PRESET_CONFIGS

    hf = {**PRESET_CONFIGS["qwen2-vl-tiny"], "tie_word_embeddings": False}
    cfg_j, cfg_t = jq.Qwen2VLConfig.from_hf_dict(hf), tq.Qwen2VLConfig.from_hf_dict(hf)
    tree = jq.init_params(jax.random.PRNGKey(0), cfg_j, jnp.float32)
    tree = (jquant.quantize_params_int8 if bits == 8 else jquant.quantize_params_int4)(tree)
    tree = jax.tree_util.tree_map(np.asarray, tree)
    model = tq.params_from_jax(tq.Qwen2VLModel(cfg_t, torch.float32, "cpu"), tree)
    cls, key, qname = (tl.Int8Linear, "w_q8", "q") if bits == 8 else (tl.Int4Linear, "w_q4", "q4")
    lin = model.layers[1].down
    assert isinstance(lin, cls) and isinstance(model.lm_head, cls) and isinstance(model.vision.blocks[0].qkv, cls)
    assert isinstance(model.vision.patch_embed, tl.Linear)  # excluded, as in the JAX package
    np.testing.assert_array_equal(getattr(lin, qname).numpy(), tree["layers"]["mlp"]["down"][key][qname][1].T)
    want_scale = tree["layers"]["mlp"]["down"][key]["scale"][1]
    np.testing.assert_array_equal(lin.scale.numpy(), want_scale if bits == 8 else want_scale.T)
    np.testing.assert_array_equal(model.layers[0].q.bias.numpy(), tree["layers"]["attn"]["q"]["b"][0])


@pytest.mark.parametrize("bits", [8, 4])
def test_init_quantized_on_device(bits):
    """Built on the meta device, drawn and quantized layer by layer: eligible
    linears quantized (lm_head included), the exclusions and norms in float."""
    from lmms_owc_tpu_torch.models.qwen2_vl import PRESET_CONFIGS

    cfg = tq.Qwen2VLConfig.from_hf_dict({**PRESET_CONFIGS["qwen2-vl-tiny"], "tie_word_embeddings": False})
    model = tq.Qwen2VLModel(cfg, torch.float32, "meta")
    tquant.init_quantized_on_device(model, torch.Generator().manual_seed(0), bits=bits, dtype=torch.float32)
    assert not any(t.is_meta for t in list(model.parameters()) + list(model.buffers()))
    cls = tl.Int8Linear if bits == 8 else tl.Int4Linear
    assert isinstance(model.lm_head, cls) and isinstance(model.layers[0].gate, cls)
    assert isinstance(model.vision.patch_embed, tl.Linear)
    assert torch.all(model.final_norm.weight == 1) and torch.all(model.layers[0].q.bias == 0)
    assert abs(float(model.embed_tokens.std()) - 0.02) < 1e-3
    head = model.lm_head
    if bits == 8:
        w = tquant.dequantize_int8({"q": head.q, "scale": head.scale})
    else:
        w = tquant.dequantize_int4({"q4": head.q4, "scale": head.scale})
    assert abs(float(w.std()) - 0.02) < 2e-3


def test_module_tree_quantizers_follow_jax_exclusions():
    from lmms_owc_tpu_torch.models.qwen2_vl import PRESET_CONFIGS

    cfg = tq.Qwen2VLConfig.from_hf_dict({**PRESET_CONFIGS["qwen2-vl-tiny"], "tie_word_embeddings": False})
    model = tq.init_params(tq.Qwen2VLModel(cfg, torch.float32, "cpu"), torch.Generator().manual_seed(0))
    weight = model.layers[0].up.weight.detach().clone()
    tquant.quantize_params_int8(model)
    assert isinstance(model.layers[0].up, tl.Int8Linear) and isinstance(model.lm_head, tl.Int8Linear)
    assert isinstance(model.vision.patch_embed, tl.Linear)
    want = tquant.quantize_int8(weight)
    torch.testing.assert_close(model.layers[0].up.q, want["q"], rtol=0, atol=0)
    model4 = tquant.quantize_params_int4(tq.init_params(tq.Qwen2VLModel(cfg, torch.float32, "cpu"),
                                                          torch.Generator().manual_seed(0)))
    assert isinstance(model4.layers[1].down, tl.Int4Linear) and isinstance(model4.vision.patch_embed, tl.Linear)
