"""The port's quantized and pooled serving against the JAX package.

``plan_decode_pools`` and the pool writes must equal the JAX package's. End to
end, the JAX adapter ``qwen2-vl-tiny`` (float32, weights re-drawn from a numpy
seed so greedy tokens vary) and the port's adapter loaded from the same tree
(float, or quantized by the JAX package and carried with ``params_from_jax``)
answer the same requests through ``generate_until``: int8 weights, int8 with
W8A8, int4, a decode pool of 2, and a pool of 2 with the int8 KV cache
(``LMMS_OWC_KV_INT8=force``). Tokens and strings must be identical. The port's
pooled output must also equal its own unpooled output.
"""

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from lmms_owc_tpu.models import qwen2_vl as jmod
from lmms_owc_tpu.nn import layers as jl
from lmms_owc_tpu.nn import qwen2_vl as jq
from lmms_owc_tpu.ops import quant as jquant
from lmms_owc_tpu_torch.models import qwen2_vl as tmod
from lmms_owc_tpu_torch.nn import layers as tl
from lmms_owc_tpu_torch.nn import qwen2_vl as tq
from tests.test_torch_qwen2_vl import _redraw

# ------------------------------------------------------------------ planner

GK = {"max_new_tokens": 64, "do_sample": False, "until": None}
GK_512 = {"max_new_tokens": 512, "do_sample": False, "until": None}
GK_32 = {"max_new_tokens": 32, "do_sample": False, "until": None}


def _chunks(rows_list, gk=GK):
    return [[("ctx", gk)] * rows for rows in rows_list]


PLAN_CASES = {
    # The chunk lists of tests/test_decode_pool.py.
    "grouping": ([[("c1", {"m": 1})], [("c2", {"m": 1})], [("c3", {"m": 1})],
                  [("c4", {"m": 2})], [("c5", {"m": 2})]], 2, 1, None, {}),
    "uniform": (_chunks([48] * 5), 2, 48, 320, {}),
    "extend-to-row-target": (_chunks([30] * 7), 2, 48, 512, {}),
    "kv-cap-stops": (_chunks([40] * 4), 2, 48, 640, {}),
    "envelope-ignores-cap": (_chunks([48] * 4, GK_512), 2, 48, 320, {}),
    "no-bucket-fn": (_chunks([48] * 4), 2, 48, None, {}),
    "gen-kwargs-boundary": (_chunks([30, 30]) + _chunks([30, 30], GK_32), 2, 48, 512, {}),
    "extended-16": (_chunks([10, 10, 10]), 2, 16, 512, {}),
    "cap-x-2.0": (_chunks([40] * 4), 2, 48, 640, {"LMMS_OWC_POOL_KV_CAP_X": "2.0"}),
    "cap-x-2.5": (_chunks([40] * 4), 2, 48, 640, {"LMMS_OWC_POOL_KV_CAP_X": "2.5"}),
    "kv-int8-512": (_chunks([30] * 7), 2, 48, 512, {"LMMS_OWC_KV_INT8": "force"}),
    "kv-int8-640": (_chunks([40] * 6), 2, 48, 640, {"LMMS_OWC_KV_INT8": "force"}),
    "kv-int8-cap-x": (_chunks([40] * 6), 2, 48, 640,
                      {"LMMS_OWC_KV_INT8": "force", "LMMS_OWC_POOL_KV_CAP_X": "2.0"}),
    "pool-3": (_chunks([48, 20, 20, 20, 48]), 3, 48, 448, {}),
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_plan_decode_pools_matches_jax(case, monkeypatch):
    chunks, pool_n, batch, bucket, env = PLAN_CASES[case]
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    bucket_fn = None if bucket is None else (lambda c: bucket)
    want = jmod.plan_decode_pools(chunks, pool_n, batch, bucket_fn)
    got = tmod.plan_decode_pools(chunks, pool_n, batch, bucket_fn, torch.device("cpu"))
    assert [len(p) for p in got] == [len(p) for p in want]
    assert got == want


def test_kv_int8_gate(monkeypatch):
    monkeypatch.setenv("LMMS_OWC_KV_INT8", "1")
    assert not tq.kv_cache_int8_enabled("cpu") and tq.kv_cache_int8_enabled("cuda")
    monkeypatch.setenv("LMMS_OWC_KV_INT8", "force")
    assert tq.kv_cache_int8_enabled("cpu")
    monkeypatch.delenv("LMMS_OWC_KV_INT8")
    assert not tq.kv_cache_int8_enabled("cuda")


# ---------------------------------------------------------------- pool writes


def test_write_pool_chunk_and_scales_match_jax():
    rng = np.random.RandomState(0)
    shape = (2, 5, 2, 12, 8)
    pool_k, pool_v = rng.randn(*shape).astype(np.float32), rng.randn(*shape).astype(np.float32)
    ks, vs = rng.randn(2, 2, 2, 7, 8).astype(np.float32), rng.randn(2, 2, 2, 7, 8).astype(np.float32)
    ref = jq.write_pool_chunk(jnp.asarray(pool_k), jnp.asarray(pool_v), jnp.asarray(ks), jnp.asarray(vs),
                              jnp.asarray(3, jnp.int32), jnp.asarray(4, jnp.int32))
    got = tq.write_pool((torch.from_numpy(pool_k.copy()), torch.from_numpy(pool_v.copy())),
                        (torch.from_numpy(ks), torch.from_numpy(vs)), 5, 12, 3, 4)
    for g, w in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # A first chunk makes the pool: zeros but its own rows and positions, in its dtype.
    made = tq.write_pool((), (torch.from_numpy(ks).bfloat16(),), 5, 12, 3, 4)
    assert made[0].shape == shape and made[0].dtype == torch.bfloat16
    np.testing.assert_array_equal(made[0][:, 3:5, :, 4:11].float().numpy(), torch.from_numpy(ks).bfloat16().float().numpy())
    assert float(made[0].float().abs().sum()) == float(made[0][:, 3:5, :, 4:11].float().abs().sum())

    sshape = shape[:4]
    pool_sk, pool_sv = rng.rand(*sshape).astype(np.float32), rng.rand(*sshape).astype(np.float32)
    sk, sv = rng.rand(2, 2, 2, 7).astype(np.float32), rng.rand(2, 2, 2, 7).astype(np.float32)

    def rep8(a):  # the JAX package's [L, B, KVH, 8, S] scale layout
        return jnp.asarray(np.repeat(a[:, :, :, None, :], 8, axis=3))

    ref = jq.write_pool_scales(rep8(pool_sk), rep8(pool_sv), rep8(sk), rep8(sv),
                               jnp.asarray(1, jnp.int32), jnp.asarray(5, jnp.int32))
    got = tq.write_pool((torch.from_numpy(pool_sk.copy()), torch.from_numpy(pool_sv.copy())),
                        (torch.from_numpy(sk), torch.from_numpy(sv)), 5, 12, 1, 5)
    for g, w in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w)[:, :, :, 0, :])


# ------------------------------------------------------------- end to end


@pytest.fixture(scope="module")
def jax_and_tree():
    from lmms_owc_tpu.models import get_model as jax_get_model

    jax_model = jax_get_model("qwen2-vl-tiny", batch_size=2, random_init=True, dtype="float32")
    tree = _redraw(jax.tree_util.tree_map(np.asarray, jax_model.params), np.random.default_rng(2))
    return jax_model, tree


def _requests(model, n=6):
    """Six 56x56-image requests with short and long prompts, 8 greedy tokens.
    Under ``LMMS_OWC_SORT_BY_VISION=0`` and batch 2 they form three chunks in
    two prompt buckets: the first pool front-pads its second chunk."""
    rng = np.random.RandomState(7)
    docs = [{"image": Image.fromarray(rng.randint(0, 255, (56, 56, 3), dtype=np.uint8))} for _ in range(n)]

    class _Task:
        dataset = {"test": docs}

    model.task_dict["pool"] = _Task()
    gk = {"max_new_tokens": 8, "do_sample": False, "until": None}
    contexts = ["Describe the scene in detail. " * 12, "What is this?", "Name it."]

    class _Req:
        def __init__(self, i):
            self.args = (contexts[i % 3], gk, lambda d: [d["image"]], i, "pool", "test")

    return [_Req(i) for i in range(n)]


def _generate(model, monkeypatch):
    seen = []
    detok = model._detokenize

    def spy(tokens):
        seen.append(np.asarray(tokens).copy())
        return detok(tokens)

    monkeypatch.setattr(model, "_detokenize", spy)
    out = model.generate_until(_requests(model))
    monkeypatch.undo()
    return out, seen


E2E_CASES = {
    "int8": dict(bits=8),
    "int8-w8a8": dict(bits=8, w8a8=True),
    "int4": dict(bits=4),
    "pool2": dict(pool=2),
    "pool2-kv-int8": dict(pool=2, kv_int8=True),
}


@pytest.mark.parametrize("case", list(E2E_CASES))
def test_generate_until_identical_to_jax(case, jax_and_tree, monkeypatch):
    opts = E2E_CASES[case]
    bits, pool = opts.get("bits"), opts.get("pool", 1)
    jax_model, tree = jax_and_tree
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    if bits:
        jtree = (jquant.quantize_params_int8 if bits == 8 else jquant.quantize_params_int4)(jtree)
    port = tmod.Qwen2VL(
        preset="qwen2-vl-tiny", batch_size=2, dtype="float32", device="cpu",
        jax_params=jax.tree_util.tree_map(np.asarray, jtree),
        load_in_8bit=bits == 8, load_in_4bit=bits == 4,
    )
    saved = jax_model.params
    jax_model.params = jtree
    env = {
        "LMMS_OWC_DECODE_POOL": str(pool),
        "LMMS_OWC_KV_INT8": "force" if opts.get("kv_int8") else "",
        "LMMS_OWC_SORT_BY_VISION": "0",
    }
    try:
        outs, tokens = [], []
        for model in (jax_model, port):
            with monkeypatch.context() as m:
                for key, value in env.items():
                    m.setenv(key, value)
                jax.clear_caches()  # the JAX package reads the KV switch at trace time
                jl.set_int8_activations(bool(opts.get("w8a8")))
                tl.set_int8_activations(bool(opts.get("w8a8")))
                out, seen = _generate(model, monkeypatch)
            outs.append(out)
            tokens.append(seen)
    finally:
        jax_model.params = saved
        jl.set_int8_activations(False)
        tl.set_int8_activations(False)
        jax.clear_caches()
    out_jax, out_port = outs
    assert len(out_port) == 6 and all(isinstance(s, str) and s for s in out_port)
    assert out_port == out_jax
    assert len(tokens[1]) == len(tokens[0]) == (2 if pool > 1 else 3)  # pools / chunks decoded
    for got, want in zip(tokens[1], tokens[0]):
        np.testing.assert_array_equal(got, want)
    assert len(set(np.concatenate([t.ravel() for t in tokens[1]]))) > 2  # tokens vary
    if bits:
        assert any(isinstance(mod, (tl.Int8Linear, tl.Int4Linear)) for mod in port.model.modules())


@pytest.mark.parametrize("kv_int8", [False, True], ids=["bf16-cache", "int8-cache"])
def test_port_pooled_equals_unpooled(kv_int8, jax_and_tree, monkeypatch):
    """The pattern of tests/test_decode_pool.py: front-padded pools decode the
    same tokens as chunk-by-chunk decoding (int8 cache: quantized per chunk
    before the pool write vs after the unpooled prefill)."""
    _, tree = jax_and_tree
    port = tmod.Qwen2VL(preset="qwen2-vl-tiny", batch_size=2, dtype="float32", device="cpu", jax_params=tree)
    pooled_runs = []
    real = tmod.Qwen2VL._run_pooled
    monkeypatch.setattr(tmod.Qwen2VL, "_run_pooled", lambda self, *a: pooled_runs.append(1) or real(self, *a))
    monkeypatch.setenv("LMMS_OWC_SORT_BY_VISION", "0")
    if kv_int8:
        monkeypatch.setenv("LMMS_OWC_KV_INT8", "force")
    monkeypatch.delenv("LMMS_OWC_DECODE_POOL", raising=False)
    base = port.generate_until(_requests(port))
    monkeypatch.setenv("LMMS_OWC_DECODE_POOL", "2")
    pooled = port.generate_until(_requests(port))
    assert pooled_runs == [1, 1]
    assert pooled == base


@pytest.mark.parametrize("rows", [3, 128])
@pytest.mark.parametrize("pool", [1, 2], ids=["unpooled", "pool2"])
def test_adapter_blocked_decode_equals_unblocked(rows, pool, jax_and_tree, monkeypatch):
    """The adapter's row-blocked decode (``decode_rows``, on the card
    ``DECODE_ROWS``) gives the tokens of the unblocked one, pooled and
    unpooled: blocks of 3 rows split and pad the 2-row chunks and the 4-row
    pool, a block of 128 pads them all to one block."""
    _, tree = jax_and_tree
    port = tmod.Qwen2VL(preset="qwen2-vl-tiny", batch_size=2, dtype="float32", device="cpu", jax_params=tree)
    assert port.decode_rows is None and tmod.DECODE_ROWS == 128  # the CPU keeps the JAX shapes
    monkeypatch.setenv("LMMS_OWC_SORT_BY_VISION", "0")
    monkeypatch.setenv("LMMS_OWC_DECODE_POOL", str(pool))
    want, want_tokens = _generate(port, monkeypatch)
    monkeypatch.setenv("LMMS_OWC_SORT_BY_VISION", "0")
    monkeypatch.setenv("LMMS_OWC_DECODE_POOL", str(pool))
    port.decode_rows = rows
    seen_rows = []
    real = tq.decode_step
    monkeypatch.setattr(tq, "decode_step", lambda *a: seen_rows.append(a[-1]) or real(*a))
    got, got_tokens = _generate(port, monkeypatch)
    assert set(seen_rows) == {rows}
    assert got == want
    for g, w in zip(got_tokens, want_tokens):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case", ["float", "int8", "int8-w8a8", "int4-kernel", "int4-dequantized"])
def test_decode_step_blocks_only_row_dependent_products(case, jax_and_tree, monkeypatch):
    """``decode_step(rows=...)`` pads to row blocks only the products whose bits
    depend on the row count (:func:`row_invariant`): float and weight-only int8
    layers, every head but K4's; W8A8 layers and K4 (here a device where K4
    takes the rows, stood in for by its plain version) keep the batch's rows,
    padded to ``REDUCE_ROWS`` for the norms. Either way the tokens equal the
    unblocked decode's."""
    _, tree = jax_and_tree
    bits = {"int8": 8, "int8-w8a8": 8, "int4-kernel": 4, "int4-dequantized": 4}.get(case)
    if bits:
        jtree = jax.tree_util.tree_map(jnp.asarray, tree)
        tree = jax.tree_util.tree_map(
            np.asarray, (jquant.quantize_params_int8 if bits == 8 else jquant.quantize_params_int4)(jtree))
    port = tmod.Qwen2VL(preset="qwen2-vl-tiny", batch_size=2, dtype="float32", device="cpu", jax_params=tree,
                        load_in_8bit=bits == 8, load_in_4bit=bits == 4)
    if case == "int4-kernel":
        monkeypatch.setattr(tl, "_int4_kernel_takes", lambda q4, scale, m: m <= tl.INT4_KERNEL_MAX_ROWS)
    monkeypatch.setenv("LMMS_OWC_SORT_BY_VISION", "0")
    tl.set_int8_activations(case == "int8-w8a8")
    try:
        want, want_tokens = _generate(port, monkeypatch)
        if case == "int4-kernel":
            monkeypatch.setattr(tl, "_int4_kernel_takes", lambda q4, scale, m: m <= tl.INT4_KERNEL_MAX_ROWS)
        monkeypatch.setenv("LMMS_OWC_SORT_BY_VISION", "0")
        port.decode_rows = 3
        seen = []
        real = tq._row_blocks
        monkeypatch.setattr(tq, "_row_blocks", lambda fn, rows, *xs: seen.append(rows) or real(fn, rows, *xs))
        got, got_tokens = _generate(port, monkeypatch)
    finally:
        tl.set_int8_activations(False)
    layers = len(port.model.layers)
    steps = len(seen) // (2 * layers + 1)
    assert steps > 0 and len(seen) == steps * (2 * layers + 1)
    layer_rows = tq.REDUCE_ROWS if case in ("int8-w8a8", "int4-kernel") else 3  # the batches are below 16 rows
    assert port.model.lm_head is None  # tied: the head reads the float embedding, so it is blocked
    head_rows = 3
    assert [r for i, r in enumerate(seen) if (i + 1) % (2 * layers + 1)] == [layer_rows] * (2 * layers * steps)
    assert seen[2 * layers::2 * layers + 1] == [head_rows] * steps
    assert got == want
    for g, w in zip(got_tokens, want_tokens):
        np.testing.assert_array_equal(g, w)


def test_row_invariant():
    """Which products keep their bits at any row count: W8A8 int8 and K4 up
    to its 256 rows; float, weight-only int8 and the dequantized int4 product
    (on the CPU, or past K4's rows) do not."""
    w = torch.randn(64, 256, generator=torch.Generator().manual_seed(0))
    lin = tl.Linear(256, 64, False, torch.float32, "cpu")
    q8, q4 = tl.Int8Linear.from_weight(w, False, torch.float32), tl.Int4Linear.from_weight(w, False, torch.float32)
    assert not tl.row_invariant(lin, 8) and not tl.row_invariant(q8, 8) and not tl.row_invariant(q4, 8)
    tl.set_int8_activations(True)
    try:
        assert tl.row_invariant(q8, 8) and tl.row_invariant(q8, 4096)
    finally:
        tl.set_int8_activations(False)
    # Off the CPU (a meta tensor stands in for the card) K4 takes 256-block shapes up to 256 rows.
    q4 = tl.Int4Linear(512, 256, False, torch.bfloat16, "meta")
    assert tl.row_invariant(q4, 256) and not tl.row_invariant(q4, 257)
    assert not tl.row_invariant(tl.Int4Linear(512, 64, False, torch.bfloat16, "meta"), 8)  # N off K4's blocks
