"""Qwen2-VL modules of the PyTorch port against the JAX package at ``qwen2-vl-tiny``.

The JAX parameter tree is drawn once, its leaves re-drawn from a numpy seed
(non-trivial biases and norm scales, so every load path matters), and loaded
into the port with ``params_from_jax``. Both run in float32 on the CPU; the
tolerance ``atol = rtol = 1e-4`` covers summation order only.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lmms_owc_tpu.nn import qwen2_vl as jq
from lmms_owc_tpu_torch.models.qwen2_vl import PRESET_CONFIGS
from lmms_owc_tpu_torch.nn import qwen2_vl as tq

TOL = 1e-4


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _configs(tied: bool = True):
    hf = {**PRESET_CONFIGS["qwen2-vl-tiny"], "tie_word_embeddings": tied}
    return jq.Qwen2VLConfig.from_hf_dict(hf), tq.Qwen2VLConfig.from_hf_dict(hf)


def _redraw(tree, rng):
    """Numpy copy of a JAX tree with every leaf re-drawn: weights ~ N(0, 0.1),
    biases ~ N(0, 0.05), norm scales ~ 1 + N(0, 0.1)."""
    out = {}
    for key, leaf in tree.items():
        if isinstance(leaf, dict):
            out[key] = _redraw(leaf, rng)
            continue
        shape = np.shape(leaf)
        noise = rng.standard_normal(shape).astype(np.float32)
        if key == "scale":
            out[key] = 1.0 + 0.1 * noise
        elif key in ("b", "bias"):
            out[key] = 0.05 * noise
        else:
            out[key] = 0.1 * noise
    return out


@pytest.fixture(scope="module", params=[True, False], ids=["tied", "untied"])
def pair(request):
    """(jax config, numpy tree, port config, port model) sharing weights."""
    cfg_j, cfg_t = _configs(tied=request.param)
    tree = _redraw(jq.init_params(jax.random.PRNGKey(0), cfg_j, jnp.float32), np.random.default_rng(0))
    assert ("lm_head" in tree) is (not request.param)
    model = tq.params_from_jax(tq.Qwen2VLModel(cfg_t, torch.float32, "cpu"), tree)
    return cfg_j, tree, cfg_t, model


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def test_configs_match_jax():
    for preset in PRESET_CONFIGS:
        cj = jq.Qwen2VLConfig.from_hf_dict(PRESET_CONFIGS[preset])
        ct = tq.Qwen2VLConfig.from_hf_dict(PRESET_CONFIGS[preset])
        for f in dataclasses.fields(ct):
            want = getattr(cj, f.name)
            got = getattr(ct, f.name)
            if f.name == "vision":
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
            else:
                assert got == want, f.name
        assert ct.head_dim == cj.head_dim and ct.vision.head_dim == cj.vision.head_dim
    assert tq.Qwen2VLConfig.from_hf_dict(PRESET_CONFIGS["qwen2-vl-7b"]).tie_word_embeddings is False


def test_params_from_jax_layout(pair):
    """``[in, out]`` JAX kernels land as ``[out, in]`` weights; stacked leaves split per layer."""
    _, tree, cfg_t, model = pair
    np.testing.assert_array_equal(model.layers[1].q.weight.numpy(), tree["layers"]["attn"]["q"]["w"][1].T)
    np.testing.assert_array_equal(model.layers[0].q.bias.numpy(), tree["layers"]["attn"]["q"]["b"][0])
    np.testing.assert_array_equal(model.layers[1].post_ln.weight.numpy(), tree["layers"]["post_ln"]["scale"][1])
    blk = model.vision.blocks[1]
    np.testing.assert_array_equal(blk.qkv.weight.numpy(), tree["vision"]["layers"]["qkv"]["w"][1].T)
    np.testing.assert_array_equal(blk.norm1.bias.numpy(), tree["vision"]["layers"]["norm1"]["bias"][1])
    np.testing.assert_array_equal(model.embed_tokens.numpy(), tree["embed_tokens"])
    assert len(model.layers) == cfg_t.num_layers and len(model.vision.blocks) == cfg_t.vision.depth
    n_jax = sum(np.size(x) for x in jax.tree_util.tree_leaves(tree))
    assert sum(p.numel() for p in model.parameters()) == n_jax


def test_init_params_distribution():
    _, cfg_t = _configs()
    model = tq.Qwen2VLModel(cfg_t, torch.float32, "cpu")
    tq.init_params(model, torch.Generator().manual_seed(0))
    emb = model.embed_tokens
    assert abs(float(emb.std()) - 0.02) < 2e-4 and abs(float(emb.mean())) < 1e-4
    assert torch.all(model.layers[0].q.bias == 0) and torch.all(model.vision.blocks[0].norm1.bias == 0)
    assert torch.all(model.final_norm.weight == 1) and torch.all(model.vision.merger.ln_q.weight == 1)
    again = tq.init_params(tq.Qwen2VLModel(cfg_t, torch.float32, "cpu"), torch.Generator().manual_seed(0))
    torch.testing.assert_close(again.layers[1].down.weight, model.layers[1].down.weight, atol=0, rtol=0)


def test_rope_index_and_vision_rope_match():
    cfg_j, cfg_t = _configs()
    grids = [(1, 4, 6), (1, 8, 8)]
    v, img = cfg_t.vision_start_token_id, cfg_t.image_token_id
    row0 = [5, 6, v] + [img] * 6 + [7, 8, v] + [img] * 16 + [9]
    ids = np.full((2, 40), cfg_t.pad_token_id, np.int64)
    mask = np.zeros((2, 40), np.int64)
    ids[0, -len(row0):], mask[0, -len(row0):] = row0, 1
    ids[1, -5:], mask[1, -5:] = [11, 12, 13, 14, 15], 1
    pj, nj = jq.get_rope_index(ids, mask, grids, cfg_j)
    pt, nt = tq.get_rope_index(ids, mask, grids, cfg_t)
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(nt, nj)
    np.testing.assert_array_equal(
        tq.vision_rope_cos_sin(grids, cfg_t.vision), jq.vision_rope_cos_sin(grids, cfg_j.vision)
    )


@pytest.mark.parametrize("masked", [False, True])
def test_vision_tower_matches_vision_encode_batch(pair, masked):
    """Token-major tower plus merger; the masked case pads a 4x4 grid to the 64 bucket."""
    cfg_j, tree, cfg_t, model = pair
    vc = cfg_t.vision
    rng = np.random.RandomState(1)
    n, p = 3, 64
    patches = rng.randn(n, p, vc.patch_dim).astype(np.float32)
    freqs = np.zeros((n, p, vc.head_dim // 2), np.float32)
    mask = None
    if masked:
        mask = np.zeros((n, p), np.int32)
        mask[:, :16] = 1
        freqs[:, :16] = tq.vision_rope_cos_sin([(1, 4, 4)], vc)
    else:
        freqs[:] = tq.vision_rope_cos_sin([(1, 8, 8)], vc)
    ref = jq.vision_encode_batch(
        _jtree(tree["vision"]), jnp.asarray(patches), jnp.asarray(freqs),
        None if mask is None else jnp.asarray(mask), cfg_j.vision,
    )
    out = model.vision(_t(patches), _t(freqs), None if mask is None else _t(mask))
    assert out.shape == (n, p // 4, cfg_t.hidden_size)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)


def _prompt_inputs(cfg, rng, b=3, l=24):
    """Left-padded prompts with an image block on row 0: (embeds, pos, mask, next_pos)."""
    v, img = cfg.vision_start_token_id, cfg.image_token_id
    lens = [l, 17, 9]
    ids = np.full((b, l), cfg.pad_token_id, np.int64)
    mask = np.zeros((b, l), np.int64)
    for i, n in enumerate(lens[:b]):
        row = rng.randint(1000, 5000, n)
        if i == 0:
            row[2], row[3:7] = v, img
        ids[i, l - n:], mask[i, l - n:] = row, 1
    pos, next_pos = tq.get_rope_index(ids, mask, [(1, 4, 4)], cfg)
    embeds = rng.randn(b, l, cfg.hidden_size).astype(np.float32)
    return embeds, pos, mask.astype(np.int32), next_pos.astype(np.int32)


def test_prefill_and_decode_step_match(pair):
    cfg_j, tree, cfg_t, model = pair
    rng = np.random.RandomState(2)
    embeds, pos, mask, next_pos = _prompt_inputs(cfg_t, rng)
    b, l = mask.shape
    cache_len = l + 8
    jparams = _jtree(tree)
    logits_j, cache_j = jq.prefill(jparams, jnp.asarray(embeds), jnp.asarray(pos), jnp.asarray(mask), cfg_j, cache_len)
    logits_t, cache_t = tq.prefill(model, _t(embeds), _t(pos), _t(mask), cache_len)
    assert logits_t.dtype == torch.float32 and logits_t.shape == (b, cfg_t.vocab_size)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), atol=TOL, rtol=TOL)
    for got, want in zip(cache_t, cache_j):
        assert got.shape == (cfg_t.num_layers, b, cfg_t.num_kv_heads, cache_len, cfg_t.head_dim)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)

    token = np.asarray(jnp.argmax(logits_j, -1), np.int64)
    step_pos = np.broadcast_to(next_pos[None, :, None], (3, b, 1)).astype(np.int64)
    kv_mask = np.zeros((b, cache_len), np.int32)
    kv_mask[:, :l] = mask
    kv_mask[:, l] = 1
    logits_j2, cache_j2 = jq.decode_step(
        jparams, jnp.asarray(token), jnp.asarray(step_pos), cache_j, jnp.asarray(l, jnp.int32),
        jnp.asarray(kv_mask), cfg_j,
    )
    logits_t2 = tq.decode_step(model, _t(token), _t(step_pos), cache_t, l, _t(kv_mask))
    np.testing.assert_allclose(logits_t2.numpy(), np.asarray(logits_j2), atol=TOL, rtol=TOL)
    for got, want in zip(cache_t, cache_j2):  # the port's cache was updated in place
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_greedy_generate_tokens_identical(pair):
    """Prefill + decode loop, with one row hitting EOS at its first token
    (pad after EOS) while the others run on."""
    cfg_j, tree, cfg_t, model = pair
    rng = np.random.RandomState(3)
    embeds, pos, mask, next_pos = _prompt_inputs(cfg_t, rng)
    l = mask.shape[1]
    first, _ = tq.prefill(model, _t(embeds), _t(pos), _t(mask), l + 8)
    eos = [cfg_t.eos_token_id, int(first[0].argmax())]
    kw = dict(max_new_tokens=6, cache_len=l + 64)
    ref = jq.greedy_generate(
        _jtree(tree), jnp.asarray(embeds), jnp.asarray(pos), jnp.asarray(mask),
        jnp.asarray(next_pos), cfg_j, eos_ids=jnp.asarray(eos, jnp.int32), **kw,
    )
    out = tq.greedy_generate(
        model, _t(embeds), _t(pos), _t(mask), _t(next_pos), eos_ids=torch.tensor(eos), **kw
    )
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert int(out[0, 0]) == eos[1] and torch.all(out[0, 1:] == cfg_t.pad_token_id)


def test_decode_loop_stops_when_all_rows_done(pair, monkeypatch):
    _, _, cfg_t, model = pair
    rng = np.random.RandomState(4)
    embeds, pos, mask, next_pos = _prompt_inputs(cfg_t, rng)
    l = mask.shape[1]
    first, _ = tq.prefill(model, _t(embeds), _t(pos), _t(mask), l + 8)
    calls = []
    real_step = tq.decode_step
    monkeypatch.setattr(tq, "decode_step", lambda *a, **k: calls.append(1) or real_step(*a, **k))
    out = tq.greedy_generate(
        model, _t(embeds), _t(pos), _t(mask), _t(next_pos), max_new_tokens=8, cache_len=l + 64,
        eos_ids=first.argmax(-1).unique(),
    )
    assert calls == []  # every row emitted EOS as its first token
    assert torch.all(out[:, 1:] == cfg_t.pad_token_id)


def test_sample_token():
    gen = torch.Generator().manual_seed(0)
    logits = torch.tensor([[0.0, 5.0, 4.9, -3.0], [2.0, 0.0, 0.0, 0.0]])
    torch.testing.assert_close(tq._sample_token(logits, None, 1.0, 1.0, False), torch.tensor([1, 0]))
    # A tiny nucleus keeps only the top token.
    torch.testing.assert_close(tq._sample_token(logits, gen, 1.0, 1e-6, True), torch.tensor([1, 0]))
    draws = torch.stack([tq._sample_token(logits, gen, 1.0, 0.9, True) for _ in range(50)])
    assert set(draws[:, 0].tolist()) <= {1, 2} and len(set(draws[:, 0].tolist())) == 2
    again = torch.Generator().manual_seed(0)
    tq._sample_token(logits, again, 1.0, 1e-6, True)
    redo = torch.stack([tq._sample_token(logits, again, 1.0, 0.9, True) for _ in range(50)])
    torch.testing.assert_close(redo, draws)  # an explicit generator makes draws repeatable


def _tower_inputs(vc, masked: bool):
    rng = np.random.RandomState(7)
    n, p = 2, 64
    patches = rng.randn(n, p, vc.patch_dim).astype(np.float32)
    freqs = np.zeros((n, p, vc.head_dim // 2), np.float32)
    freqs[:] = tq.vision_rope_cos_sin([(1, 8, 8)], vc)
    mask = None
    if masked:
        mask = np.ones((n, p), np.int32)
        mask[1, 40:] = 0
    return patches, freqs, mask


def _tower(model, patches, freqs, mask):
    return model.vision(_t(patches), _t(freqs), None if mask is None else _t(mask))


@pytest.mark.parametrize("masked", [False, True])
def test_vision_tower_packed_matches_unpacked(pair, masked, monkeypatch):
    """``LMMS_OWC_VISION_PACKED=force`` (K5's entry over 128-wide padded heads,
    the padded qkv and proj weights) against the unpacked tower: the same math
    in float32, so the tolerance is summation order only. Rows past a masked
    row's prefix are garbage in both and are not compared."""
    _, _, cfg_t, model = pair
    patches, freqs, mask = _tower_inputs(cfg_t.vision, masked)
    monkeypatch.delenv("LMMS_OWC_VISION_PACKED", raising=False)
    base = _tower(model, patches, freqs, mask)
    monkeypatch.setenv("LMMS_OWC_VISION_PACKED", "force")
    packed = _tower(model, patches, freqs, mask)
    valid = 40 // 4 if masked else None
    np.testing.assert_allclose(packed[0].numpy(), base[0].numpy(), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(packed[1, :valid].numpy(), base[1, :valid].numpy(), atol=TOL, rtol=TOL)


def test_vision_tower_packed_matches_jax_packed(pair, monkeypatch):
    """The port's packed tower against the JAX package's (``force`` there too,
    jit caches cleared so the gate is read again)."""
    cfg_j, tree, cfg_t, model = pair
    patches, freqs, mask = _tower_inputs(cfg_t.vision, masked=True)
    monkeypatch.setenv("LMMS_OWC_VISION_PACKED", "force")
    jax.clear_caches()
    try:
        ref = jq.vision_encode_batch(
            _jtree(tree["vision"]), jnp.asarray(patches), jnp.asarray(freqs), jnp.asarray(mask), cfg_j.vision
        )
    finally:
        jax.clear_caches()
    out = _tower(model, patches, freqs, mask)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref)[0], atol=TOL, rtol=TOL)
    np.testing.assert_allclose(out[1, :10].numpy(), np.asarray(ref)[1, :10], atol=TOL, rtol=TOL)


def test_vision_tower_packed_int8_and_gate(monkeypatch):
    """int8 weights pack too (padded scales one, as in the JAX package); int4
    never packs; ``1`` packs only on CUDA; the padded copies are built once per
    set of weights and rebuilt after an in-place weight write."""
    from lmms_owc_tpu_torch.nn.layers import Int4Linear, Int8Linear
    from lmms_owc_tpu_torch.ops.quant import quantize_params_int8

    cfg_j, cfg_t = _configs()
    tree = _redraw(jq.init_params(jax.random.PRNGKey(0), cfg_j, jnp.float32), np.random.default_rng(3))
    model = quantize_params_int8(tq.params_from_jax(tq.Qwen2VLModel(cfg_t, torch.float32, "cpu"), tree))
    tower = model.vision
    assert isinstance(tower.blocks[0].qkv, Int8Linear)
    patches, freqs, mask = _tower_inputs(cfg_t.vision, masked=True)
    monkeypatch.delenv("LMMS_OWC_VISION_PACKED", raising=False)
    base = _tower(model, patches, freqs, mask)
    monkeypatch.setenv("LMMS_OWC_VISION_PACKED", "force")
    packed = _tower(model, patches, freqs, mask)
    np.testing.assert_allclose(packed[0].numpy(), base[0].numpy(), atol=TOL, rtol=TOL)
    first = tower._packed_attn_layers()
    qkv_p, proj_p = first[0]
    hd = cfg_t.vision.head_dim
    assert isinstance(qkv_p, Int8Linear) and qkv_p.q.shape[0] == 3 * cfg_t.vision.num_heads * 128
    assert torch.all(qkv_p.scale.view(3, -1, 128)[..., hd:] == 1) and not qkv_p.q.view(3, -1, 128, qkv_p.q.shape[1])[:, :, hd:].any()
    assert proj_p.q.shape[1] == cfg_t.vision.num_heads * 128
    assert tower._packed_attn_layers() is first
    with torch.no_grad():
        tower.blocks[1].proj.bias.add_(1.0)
    assert tower._packed_attn_layers() is not first

    assert tq._vision_packed_enabled(tower.blocks[0].qkv, torch.device("cpu"))  # force
    monkeypatch.setenv("LMMS_OWC_VISION_PACKED", "1")
    assert not tq._vision_packed_enabled(tower.blocks[0].qkv, torch.device("cpu"))
    assert tq._vision_packed_enabled(tower.blocks[0].qkv, torch.device("cuda"))
    monkeypatch.setenv("LMMS_OWC_VISION_PACKED", "force")
    int4 = Int4Linear(32, 96, True, torch.float32, "cpu", group=8)
    assert not tq._vision_packed_enabled(int4, torch.device("cuda"))
