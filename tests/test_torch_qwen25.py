"""Qwen2.5-VL in the PyTorch port against the JAX package at ``qwen2.5-vl-tiny``.

The window layout helpers must equal the JAX package's exactly; the tower,
loaded by ``params_from_jax`` from a re-drawn JAX tree, must match
``vision25_encode`` in float32 within ``atol = rtol = 1e-4`` (summation order
only), on a grid whose windows divide evenly and on one whose edge windows
carry padding slots (a gappy mask in the global layers); and the adapter's
``generate_until`` must give the JAX adapter's tokens and strings.
"""

import dataclasses

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from lmms_owc_tpu.nn import qwen2_5_vl as jq25
from lmms_owc_tpu_torch.models.qwen2_vl import PRESET_CONFIGS
from lmms_owc_tpu_torch.nn import qwen2_5_vl as tq25
from lmms_owc_tpu_torch.nn import qwen2_vl as tq
from lmms_owc_tpu_torch.ops import attention as tatt
from tests.test_torch_qwen2_vl import _redraw
from tests.test_torch_slice import _generate_both, _Req

TOL = 1e-4
V25_PRESETS = ("qwen2.5-vl-tiny", "qwen2.5-vl-3b", "qwen2.5-vl-7b")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _vcfg(preset="qwen2.5-vl-tiny"):
    vis = PRESET_CONFIGS[preset]["vision_config"]
    return jq25.Qwen25VisionConfig.from_hf_dict(vis), tq25.Qwen25VisionConfig.from_hf_dict(vis)


@pytest.mark.parametrize("preset", V25_PRESETS)
def test_vision25_config_matches_jax(preset):
    cj, ct = _vcfg(preset)
    assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
    assert (ct.head_dim, ct.patch_dim) == (cj.head_dim, cj.patch_dim)


@pytest.mark.parametrize("grid", [(1, 8, 8), (1, 10, 10), (1, 6, 8), (1, 28, 32), (2, 12, 6)])
@pytest.mark.parametrize("preset", ["qwen2.5-vl-tiny", "qwen2.5-vl-7b"])
def test_window_layout_matches_jax(grid, preset):
    """Window order, uniform padded layout and rope table, bit for bit."""
    cj, ct = _vcfg(preset)
    for got, want in zip(tq25.get_window_order(grid, ct), jq25.get_window_order(grid, cj)):
        np.testing.assert_array_equal(got, want)
    got, want = tq25.get_window_layout(grid, ct), jq25.get_window_layout(grid, cj)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    np.testing.assert_array_equal(tq25.vision25_rope_freqs(grid, ct), np.asarray(jq25.vision25_rope_freqs(grid, cj)))


@pytest.fixture(scope="module")
def tower_pair():
    """(jax config, numpy vision tree, port config, port tower) sharing weights."""
    cj, ct = _vcfg()
    tree = _redraw(
        jax.tree_util.tree_map(np.asarray, jq25.init_vision25_params(jax.random.PRNGKey(0), cj, jnp.float32)),
        np.random.default_rng(0),
    )
    tower = tq25.vision25_params_from_jax(tq25.Vision25Tower(ct, torch.float32, "cpu"), tree)
    return cj, tree, ct, tower


def test_vision25_params_from_jax_layout(tower_pair):
    _, tree, ct, tower = tower_pair
    blk = tower.blocks[1]
    np.testing.assert_array_equal(blk.mlp_gate.weight.numpy(), tree["layers"]["mlp_gate"]["w"][1].T)
    np.testing.assert_array_equal(blk.qkv.bias.numpy(), tree["layers"]["qkv"]["b"][1])
    np.testing.assert_array_equal(blk.norm2.weight.numpy(), tree["layers"]["norm2"]["scale"][1])
    np.testing.assert_array_equal(tower.patch_embed.weight.numpy(), tree["patch_embed"]["w"].T)
    np.testing.assert_array_equal(tower.merger.fc2.bias.numpy(), tree["merger"]["fc2"]["b"])
    assert len(tower.blocks) == ct.depth
    assert sum(p.numel() for p in tower.parameters()) == sum(np.size(x) for x in jax.tree_util.tree_leaves(tree))


def _window_inputs(grid, cfg, n, rng):
    """Patches, freqs and mask of ``n`` images of one grid in the padded window layout."""
    mu = cfg.spatial_merge_size**2
    slot_src, wn, s = tq25.get_window_layout(grid, cfg)
    valid_units = slot_src >= 0
    tok_idx = (np.where(valid_units, slot_src, 0)[:, None] * mu + np.arange(mu)).reshape(-1)
    valid = np.repeat(valid_units, mu).astype(np.int32)
    p = grid[0] * grid[1] * grid[2]
    patches = rng.randn(n, p, cfg.patch_dim).astype(np.float32)[:, tok_idx] * valid[None, :, None]
    freqs = (tq25.vision25_rope_freqs(grid, cfg)[tok_idx] * valid[:, None]).astype(np.float32)
    freqs = np.broadcast_to(freqs.reshape(1, wn, s, -1), (n, wn, s, freqs.shape[-1]))
    mask = np.broadcast_to(valid.reshape(1, wn, s), (n, wn, s)).astype(np.int32)
    return patches.reshape(n, wn, s, -1), np.ascontiguousarray(freqs), np.ascontiguousarray(mask)


@pytest.mark.parametrize("grid", [(1, 8, 8), (1, 10, 10)], ids=["even", "padded-windows"])
def test_vision25_tower_matches_vision25_encode(tower_pair, grid):
    """Window layers over [N*W, S], the global layer over [N, W*S]. The
    (1, 10, 10) grid at window 56 pads 5x5 merge units to 6x6, so the global
    layer's mask has gaps inside the key run; merged units of padding slots
    are garbage in both and are not compared."""
    cj, tree, ct, tower = tower_pair
    rng = np.random.RandomState(1)
    patches, freqs, mask = _window_inputs(grid, ct, 2, rng)
    ref = jq25.vision25_encode(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(patches), jnp.asarray(freqs),
        jnp.asarray(mask), cj,
    )
    padded = not mask.all()
    assert padded == (grid == (1, 10, 10))
    out = tower(_t(patches), _t(freqs), _t(mask) if padded else None)
    mu = ct.spatial_merge_size**2
    assert out.shape == (2, patches.shape[1] * patches.shape[2] // mu, ct.out_hidden_size)
    real_units = mask.reshape(2, -1, mu)[0, :, 0].astype(bool)
    np.testing.assert_allclose(out.numpy()[:, real_units], np.asarray(ref)[:, real_units], atol=TOL, rtol=TOL)


def test_vision25_tower_goes_through_fused_qkv_entry(tower_pair, monkeypatch):
    """Every layer calls the combined-qkv entry once, token-major, with its own
    view: the window layer [N*W, S] and the global layer [N, W*S]; the padded
    grid hands both a mask view of one tower-wide buffer."""
    _, _, ct, tower = tower_pair
    patches, freqs, mask = _window_inputs((1, 10, 10), ct, 2, np.random.RandomState(2))
    calls = []
    real = tq25.fused_qkv_attention

    def spy(qkvh, h, kvh, **kw):
        calls.append((tuple(qkvh.shape), tuple(kw["kv_mask"].shape), kw["kv_mask"].data_ptr(), kw["token_major"]))
        return real(qkvh, h, kvh, **kw)

    monkeypatch.setattr(tq25, "fused_qkv_attention", spy)
    tower(_t(patches), _t(freqs), _t(mask))
    n, wn, s = mask.shape
    nh, hd = ct.num_heads, ct.head_dim
    assert [c[:2] for c in calls] == [((n * wn, s, 3 * nh, hd), (n * wn, s)), ((n, wn * s, 3 * nh, hd), (n, wn * s))]
    assert calls[0][2] == calls[1][2] and all(c[3] for c in calls)


@pytest.fixture(scope="module")
def adapters25():
    from lmms_owc_tpu.models import get_model as jax_get_model
    from lmms_owc_tpu_torch.models import get_model

    jax_model = jax_get_model("qwen2.5-vl-tiny", batch_size=4, random_init=True, dtype="float32")
    tree = _redraw(jax.tree_util.tree_map(np.asarray, jax_model.params), np.random.default_rng(1))
    jax_model.params = jax.tree_util.tree_map(jnp.asarray, tree)
    port = get_model("qwen2.5-vl-tiny", batch_size=4, dtype="float32", device="cpu", jax_params=tree)
    return jax_model, port


def _docs(sizes, seed):
    rng = np.random.RandomState(seed)
    return [{"image": Image.fromarray(rng.randint(0, 255, (*hw, 3), dtype=np.uint8))} for hw in sizes]


def test_generate_until_identical_v25(adapters25, monkeypatch):
    """84x112 (a 6x8 patch grid: 3x4 merge units in 2x2 windows, so the edge
    windows pad), 112x112, 56x56, 200x150 (resized), the same size twice (a
    replicated row bucket), prompts of different lengths: identical tokens and
    strings from the JAX adapter and the port."""
    docs = _docs([(84, 112), (112, 112), (56, 56), (84, 112), (200, 150), (84, 112)], seed=3)

    class _Task:
        dataset = {"test": docs}

    gen_kwargs = {"max_new_tokens": 10, "do_sample": False, "until": None}
    contexts = ["What type of object is in this photo?", "Name it.", "Describe the scene " * 5]
    requests = [_Req((contexts[i % 3], gen_kwargs, lambda d: [d["image"]], i, "v25", "test")) for i in range(len(docs))]
    (out_jax, out_port), (tok_jax, tok_port) = _generate_both(adapters25, monkeypatch, "v25", _Task(), requests)
    assert out_port == out_jax and all(isinstance(o, str) and o for o in out_port)
    assert len(tok_port) == len(tok_jax) > 0
    for got, want in zip(tok_port, tok_jax):
        np.testing.assert_array_equal(got, want)


def test_encode_images_flat_v25_matches_jax(adapters25):
    """Grid grouping, row buckets, the window gather and the restore gather:
    same spans and grids, merged embeddings within the float32 tolerance. The
    padded grid's mask reaches the tower; an evenly divided grid's does not."""
    jax_model, port = adapters25
    images = [d["image"] for d in _docs([(84, 112), (112, 112), (84, 112)], seed=4)]
    vj, spans_j, grids_j = jax_model._encode_images_flat(images)
    masks = []
    real = port.model.vision.forward
    port.model.vision.forward = lambda p, f, m: masks.append(m) or real(p, f, m)
    try:
        vp, spans_p, grids_p = port._encode_images_flat(images)
    finally:
        del port.model.vision.forward
    assert spans_p == spans_j and grids_p == grids_j
    np.testing.assert_allclose(vp.numpy(), np.asarray(vj), atol=TOL, rtol=TOL)
    assert [m is None for m in masks] == [False, True]  # grids (1, 6, 8), then (1, 8, 8)


def test_registry_and_tower_kind(adapters25):
    from lmms_owc_tpu_torch.models import MODELS

    assert set(V25_PRESETS) <= set(MODELS)
    _, port = adapters25
    assert port.is_v25 and isinstance(port.model.vision, tq25.Vision25Tower)
    assert port.vision25_config.window_size == 56 and port.vision25_config.fullatt_block_indexes == (1,)


def test_qwen2_tree_does_not_load_into_a_v25_model():
    """``params_from_jax`` loads the tower the model holds and refuses the other layout."""
    from lmms_owc_tpu.nn import qwen2_vl as jq

    hf = PRESET_CONFIGS["qwen2-vl-tiny"]
    tree = jax.tree_util.tree_map(np.asarray, jq.init_params(jax.random.PRNGKey(0), jq.Qwen2VLConfig.from_hf_dict(hf), jnp.float32))
    v25 = tq.Qwen2VLModel(tq.Qwen2VLConfig.from_hf_dict(hf), torch.float32, "cpu", vision25=_vcfg()[1])
    with pytest.raises(ValueError, match="Qwen2.5-VL"):
        tq.params_from_jax(v25, tree)
    tree["vision"] = jax.tree_util.tree_map(
        np.asarray, jq25.init_vision25_params(jax.random.PRNGKey(1), _vcfg()[0], jnp.float32)
    )
    with pytest.raises(ValueError, match="Qwen2.5-VL"):
        tq.params_from_jax(tq.Qwen2VLModel(tq.Qwen2VLConfig.from_hf_dict(hf), torch.float32, "cpu"), tree)


def test_v25_random_init_counts_no_launch_on_cpu():
    """Random init draws the 2.5 tower too (norm scales one, biases zero), and
    a CPU run takes the plain versions: no kernel launch is counted."""
    from lmms_owc_tpu_torch.models import get_model

    model = get_model("qwen2.5-vl-tiny", batch_size=2, dtype="float32", device="cpu")
    tower = model.model.vision
    assert torch.all(tower.blocks[0].norm1.weight == 1) and torch.all(tower.blocks[1].mlp_up.bias == 0)
    assert 0.015 < float(tower.blocks[0].qkv.weight.std()) < 0.025
    docs = _docs([(84, 112), (56, 56)], seed=5)

    class _Task:
        dataset = {"test": docs}

    model.task_dict["t"] = _Task()
    tatt.reset_launch_counts()
    out = model.generate_until(
        [_Req(("What?", {"max_new_tokens": 4}, lambda d: [d["image"]], i, "t", "test")) for i in range(2)]
    )
    assert len(out) == 2 and all(c == 0 for c in tatt.launch_counts.values())


@pytest.mark.parametrize("bits", [8, 4], ids=["int8", "int4"])
def test_generate_until_identical_v25_quantized(adapters25, bits, monkeypatch):
    """int8 and int4 weights (the JAX quantizers' trees, tower included)
    through the port's ``load_in_8bit``/``load_in_4bit`` adapter: the JAX
    adapter's tokens and strings, on a padded-window grid."""
    from lmms_owc_tpu.ops import quant as jquant
    from lmms_owc_tpu_torch.models import qwen2_vl as tmod
    from lmms_owc_tpu_torch.nn.layers import Int4Linear, Int8Linear

    jax_model, _ = adapters25
    quantize = jquant.quantize_params_int8 if bits == 8 else jquant.quantize_params_int4
    saved = jax_model.params
    jtree = quantize(saved)
    port = tmod.Qwen2VL(
        preset="qwen2.5-vl-tiny", batch_size=4, dtype="float32", device="cpu",
        jax_params=jax.tree_util.tree_map(np.asarray, jtree), load_in_8bit=bits == 8, load_in_4bit=bits == 4,
    )
    assert isinstance(port.model.vision.blocks[0].qkv, Int8Linear if bits == 8 else Int4Linear)
    docs = _docs([(84, 112), (112, 112), (84, 112)], seed=6)

    class _Task:
        dataset = {"test": docs}

    gen_kwargs = {"max_new_tokens": 8, "do_sample": False, "until": None}
    requests = [_Req(("What is this?", gen_kwargs, lambda d: [d["image"]], i, "q", "test")) for i in range(3)]
    jax_model.params = jtree
    try:
        (out_jax, out_port), (tok_jax, tok_port) = _generate_both((jax_model, port), monkeypatch, "q", _Task(), requests)
    finally:
        jax_model.params = saved
    assert out_port == out_jax
    for got, want in zip(tok_port, tok_jax):
        np.testing.assert_array_equal(got, want)
