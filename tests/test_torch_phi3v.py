"""The port's Phi-3-Vision adapter (``models/phi3v.py``) against the JAX package.

Decoder config: the longrope mapping of ``LlamaConfig.to_decoder_config``
gives the JAX ``rope_longrope`` (attention factor and short factors), and
``mrope_cos_sin`` the JAX rope tables within ``TABLE_TOL`` = 1e-5 (float32).
Host transforms, numpy and PIL in both packages: ``_hd_transform`` and
``_to_chw_normalized`` give the same pixels, ``_bicubic_resize_tensor`` the
same array (and torch's ``interpolate`` within 1e-4, as
``tests/test_phi3_parity.py`` holds the JAX one), and the token count follows
the formula (h*w)*half^2 + h*half + 1 + half*(half+1) on portrait, landscape,
square and odd-sized images. Modules: the JAX ``phi3v-tiny`` tree (float32,
re-drawn from a numpy seed) carried into the port with ``jax_params``; one
image's rows from ``_encode_one_image`` agree within ``TOL`` = 1e-4 at
``num_crops`` 16 and 0. Adapter: ``generate_until`` gives the JAX tokens and
strings, ``loglikelihood`` its greedy flags and losses within ``LOSS_TOL`` =
1e-4. The tiny checkpoint of ``tests/test_checkpoint_matrix.py`` (released
layout: fused projections, the embedded CLIP tower, longrope) loads in both
packages to the same weights, tokens and losses. The port's CLI answers
``toy`` with ``phi3v-tiny`` without loading JAX.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from lmms_owc_tpu.models import phi3v as jax_adapter
from lmms_owc_tpu.nn import llama as jllama
from lmms_owc_tpu.nn import qwen2_vl as jqvl
from lmms_owc_tpu_torch import no_tf32
from lmms_owc_tpu_torch.models import MODELS, get_model
from lmms_owc_tpu_torch.models import phi3v as adapter
from lmms_owc_tpu_torch.nn import llama as tllama
from lmms_owc_tpu_torch.nn import qwen2_vl as tqvl
from lmms_owc_tpu_torch.utils import _hostprof
from tests.test_checkpoint_matrix import _build_phi3v
from tests.test_torch_onevision import _Req, _Task, generate_both
from tests.test_torch_siglip import redraw

REPO_ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-4
LOSS_TOL = 1e-4
TABLE_TOL = 1e-5
GEN = {"max_new_tokens": 8, "do_sample": False, "until": None}
# (height, width): portrait, landscape, square, odd-sized.
SIZES = [(100, 60), (60, 100), (56, 56), (33, 57), (61, 29), (28, 90), (97, 211)]


@pytest.fixture(autouse=True)
def _full_f32():
    no_tf32()


def _image(seed: int, hw) -> Image.Image:
    return Image.fromarray(np.random.RandomState(seed).randint(0, 255, (*hw, 3), dtype=np.uint8))


def _docs(seed=0):
    return [{"images": [_image(seed * 10 + i + j, SIZES[(i + j) % len(SIZES)]) for j in range(2)]}
            for i in range(4)]


def _visuals(n):
    return lambda doc: doc["images"][:n]


def _gen_requests():
    counts = [1, 0, 1, 2, 1]
    prompts = ["What is this?", "Describe the weather.", "Name the object.", "Compare them.", "Is it red?"]
    return [_Req((p, GEN, _visuals(n), i % 4, "smoke", "test")) for i, (p, n) in enumerate(zip(prompts, counts))]


def _ll_requests():
    return [_Req(("What is this?", " a cat", _visuals(n), i, "smoke", "test")) for i, n in enumerate([1, 0, 2])] + [
        _Req(("hello", " world"))]


# ----------------------------------------------------------------- longrope


def _phi3_text(**over) -> dict:
    return dict(model_type="phi3", vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=4, rope_theta=10000.0, rms_norm_eps=1e-5,
                max_position_embeddings=512, original_max_position_embeddings=128, **over)


SHORT = [1.0 + 0.1 * i for i in range(8)]
SCALINGS = {
    "longrope": _phi3_text(rope_scaling={"type": "longrope", "short_factor": SHORT, "long_factor": [2.0] * 8}),
    "rope_type_key": _phi3_text(rope_scaling={"rope_type": "longrope", "short_factor": SHORT,
                                              "long_factor": [2.0] * 8}),
    "original_max_in_scaling": _phi3_text(rope_scaling={
        "type": "longrope", "short_factor": SHORT, "long_factor": [2.0] * 8, "original_max_position_embeddings": 64}),
    "no_original_max": {**{k: v for k, v in _phi3_text().items() if k != "original_max_position_embeddings"},
                        "rope_scaling": {"type": "longrope", "short_factor": SHORT, "long_factor": SHORT}},
    "published": dict(_phi3_text(), hidden_size=3072, num_attention_heads=32, num_key_value_heads=32,
                      max_position_embeddings=131072, original_max_position_embeddings=4096,
                      rope_scaling={"type": "longrope", "short_factor": [1.0 + 0.05 * i for i in range(48)],
                                    "long_factor": [4.0] * 48}),
    "su": _phi3_text(rope_scaling={"type": "su", "short_factor": SHORT, "long_factor": [2.0] * 8}),
    "none": _phi3_text(),
}


@pytest.mark.parametrize("name", sorted(SCALINGS))
def test_longrope_maps_as_in_jax(name):
    """Every field of the decoder config, ``rope_longrope`` included, equals
    the JAX one: short factors at every length, the attention factor
    sqrt(1 + ln(max / original_max) / ln(original_max)) (1 when max does not
    exceed original_max), ``su`` and no scaling as plain RoPE."""
    cfg = SCALINGS[name]
    want = jllama.llama_config_from_hf(cfg).to_decoder_config()
    got = tllama.llama_config_from_hf(cfg).to_decoder_config()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if name in ("su", "none"):
        assert got.rope_longrope is None
    else:
        factor, short = got.rope_longrope
        assert short == tuple(cfg["rope_scaling"]["short_factor"]) and factor >= 1.0
    if name == "published":
        assert abs(got.rope_longrope[0] - 1.190238) < 1e-6 and got.head_dim == 96


@pytest.mark.parametrize("name", ["longrope", "published", "none"])
def test_mrope_cos_sin_matches_jax(name):
    """The rope tables the prefill and every decode step read: inverse
    frequencies divided by the short factors, cos and sin times the attention
    factor, at positions up to 4096."""
    cfg = SCALINGS[name]
    want_cfg = jllama.llama_config_from_hf(cfg).to_decoder_config()
    got_cfg = tllama.llama_config_from_hf(cfg).to_decoder_config()
    pos = np.random.RandomState(0).randint(0, 4096, (2, 40))
    position_ids = np.broadcast_to(pos[None], (3, 2, 40)).copy()
    want = jqvl.mrope_cos_sin(jnp.asarray(position_ids), want_cfg)
    got = tqvl.mrope_cos_sin(torch.from_numpy(position_ids), got_cfg)
    for g, w in zip(got, want):
        assert g.shape == (2, 40, got_cfg.head_dim // 2) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TABLE_TOL, rtol=0)


def test_longrope_decoder_prefill_matches_jax():
    """A longrope decoder's prefill logits from the same tree, within ``TOL``:
    the attention factor reaches q and k through the tables."""
    cfg = jllama.llama_config_from_hf(SCALINGS["longrope"])
    tree = jax.tree_util.tree_map(np.asarray, jllama.init_llama_params(jax.random.PRNGKey(0), cfg, jnp.float32))
    tree = redraw(tree, np.random.default_rng(0))
    model = tllama.llama_params_from_jax(tree, tllama.llama_config_from_hf(SCALINGS["longrope"]))
    ids = np.random.RandomState(1).randint(3, 250, (2, 24))
    mask = np.ones((2, 24), np.int64)
    mask[1, :5] = 0
    pos, _ = jllama.llama_positions(mask)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    want, _ = jllama.prefill(params, jnp.take(params["embed_tokens"], jnp.asarray(ids), axis=0), jnp.asarray(pos),
                             jnp.asarray(mask.astype(np.int32)), cfg.to_decoder_config(), cache_len=32)
    got, _ = tllama.prefill(model, torch.nn.functional.embedding(torch.from_numpy(ids), model.embed_tokens),
                            torch.from_numpy(pos), torch.from_numpy(mask.astype(np.int32)), 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


# ----------------------------------------------------------- host transforms


def test_split_phi3_fused_weights_matches_jax():
    rng = np.random.RandomState(0)
    state = {"model.layers.0.self_attn.qkv_proj.weight": rng.randn(48, 16).astype(np.float32),
             "model.layers.0.mlp.gate_up_proj.weight": rng.randn(64, 16).astype(np.float32),
             "model.layers.0.self_attn.o_proj.weight": rng.randn(16, 16).astype(np.float32)}
    want = jax_adapter.split_phi3_fused_weights(state)
    for given in (state, {k: torch.from_numpy(v) for k, v in state.items()}):
        got = adapter.split_phi3_fused_weights(given)
        assert sorted(got) == sorted(want)
        for name, value in want.items():
            np.testing.assert_array_equal(np.asarray(got[name]), value)


@pytest.fixture(scope="module")
def tiny_models():
    """A JAX ``phi3v-tiny`` with its tree re-drawn and the port over the same
    tree, at ``num_crops`` 16 and 0."""
    out = {}
    for crops in (16, 0):
        jax_model = jax_adapter.Phi3v(preset="phi3v-tiny", batch_size=4, random_init=True, dtype="float32",
                                      num_crops=crops)
        tree = redraw(jax.tree_util.tree_map(np.asarray, jax_model.params), np.random.default_rng(1))
        jax_model.params = jax.tree_util.tree_map(jnp.asarray, tree)
        port = adapter.Phi3v(preset="phi3v-tiny", batch_size=4, dtype="float32", device="cpu", num_crops=crops,
                             jax_params=tree)
        for m in (jax_model, port):
            m.task_dict["smoke"] = _Task(_docs(1))
        out[crops] = (jax_model, port, tree)
    return out


@pytest.mark.parametrize("hw", SIZES + [(336, 448), (448, 448), (1000, 700)])
def test_hd_transform_matches_jax(tiny_models, hw):
    """Same padded HD image and normalised pixels, at the tiny tower's 28 px
    crops and at CLIP-L/336's crops (phase 24's image sizes among them)."""
    jax_model, port, _ = tiny_models[16]
    image = _image(hw[0], hw)
    for j, p in ((jax_model, port),
                 (SimpleNamespace(vision_config=SimpleNamespace(image_size=336)),) * 2):
        want = jax_adapter.Phi3v._hd_transform(j, image, 16)
        got = adapter.Phi3v._hd_transform(p, image, 16)
        assert got.size == want.size
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        np.testing.assert_array_equal(port._to_chw_normalized(got), jax_model._to_chw_normalized(want))
    w, h = got.size
    assert w % 336 == 0 and h % 336 == 0 and (h >= w) == (hw[0] >= hw[1])
    assert (w // 336) * (h // 336) <= 16


@pytest.mark.parametrize("in_hw,out_hw", [((672, 1008), (336, 336)), ((336, 672), (336, 336)),
                                          ((100, 73), (336, 336)), ((50, 50), (200, 100))])
def test_bicubic_resize_tensor_matches_jax(in_hw, out_hw):
    arr = np.random.RandomState(0).randn(3, *in_hw).astype(np.float32)
    got = adapter.Phi3v._bicubic_resize_tensor(arr, *out_hw)
    np.testing.assert_array_equal(got, jax_adapter.Phi3v._bicubic_resize_tensor(arr, *out_hw))
    theirs = torch.nn.functional.interpolate(torch.from_numpy(arr)[None], size=out_hw, mode="bicubic",
                                             align_corners=False)[0].numpy()
    np.testing.assert_allclose(got, theirs, atol=1e-4, rtol=1e-5)


def test_units_2x2_matches_jax(tiny_models):
    jax_model, port, _ = tiny_models[16]
    feats = np.random.RandomState(2).randn(3, 4, 32).astype(np.float32)  # side 2 at the tiny tower
    np.testing.assert_array_equal(port._units_2x2(torch.from_numpy(feats)).numpy(), jax_model._units_2x2(feats))


@pytest.mark.parametrize("crops", [16, 0])
@pytest.mark.parametrize("hw", SIZES)
def test_encode_one_image_matches_jax(tiny_models, crops, hw):
    """One image's rows (tower, 2x2 units, separators, projector) and their
    count: (h*w)*half^2 + h*half + 1 + half*(half+1) with crops, half*(half+1)
    + 1 without (half = 1 at the tiny tower)."""
    jax_model, port, _ = tiny_models[crops]
    image = _image(hw[1], hw)
    want = jax_model._encode_one_image(image)
    got = port._encode_one_image(image)
    if crops:
        w_px, h_px = port._hd_transform(image, crops).size
        h, w = h_px // 28, w_px // 28
        assert got.shape[0] == h * w + h + 1 + 2
    else:
        assert got.shape[0] == 3
    assert got.shape == want.shape == (got.shape[0], 64)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_phase_images_token_counts():
    """Phase 24's images at CLIP-L/336 and 16 crops: a 448x448 image is 4x4
    crops and 2509 rows, a 336x448 (height x width) one 3x4 crops and 1921."""
    fake = SimpleNamespace(vision_config=SimpleNamespace(image_size=336))
    for (h, w), crops, rows in (((448, 448), (4, 4), 2509), ((336, 448), (3, 4), 1921)):
        w_px, h_px = adapter.Phi3v._hd_transform(fake, Image.new("RGB", (w, h)), 16).size
        assert (h_px // 336, w_px // 336) == crops
        assert crops[0] * crops[1] * 144 + crops[0] * 12 + 1 + 12 * 13 == rows


# ------------------------------------------------------------------- adapter


def test_generate_until_identical(tiny_models, monkeypatch):
    jax_model, port, _ = tiny_models[16]
    want, got, want_tokens, got_tokens = generate_both(monkeypatch, jax_model, port, _gen_requests())
    assert got == want and len(got) == 5
    assert len(got_tokens) == len(want_tokens) == 2
    for a, b in zip(got_tokens, want_tokens):
        np.testing.assert_array_equal(a, b)
    assert len(set(np.concatenate(got_tokens).ravel())) > 2  # the tokens vary


def test_generate_until_identical_global_view_only(tiny_models, monkeypatch):
    jax_model, port, _ = tiny_models[0]
    want, got, want_tokens, got_tokens = generate_both(monkeypatch, jax_model, port, _gen_requests()[:3])
    assert got == want
    for a, b in zip(got_tokens, want_tokens):
        np.testing.assert_array_equal(a, b)


def test_loglikelihood_matches_jax(tiny_models):
    jax_model, port, _ = tiny_models[16]
    want, got = jax_model.loglikelihood(_ll_requests()), port.loglikelihood(_ll_requests())
    assert len(got) == len(want) == 4
    np.testing.assert_allclose([g[0] for g in got], [w[0] for w in want], rtol=0, atol=LOSS_TOL)
    assert [g[1] for g in got] == [w[1] for w in want]


def test_host_timers_change_no_output(tiny_models, monkeypatch, capsys):
    """With ``LMMS_OWC_HOST_PROF`` on, one ``generate_until`` gives the JAX
    tokens, and the chunk pipeline's and the adapter's stages are timed."""
    jax_model, port, _ = tiny_models[16]
    monkeypatch.setenv("LMMS_OWC_HOST_PROF", "1")
    monkeypatch.setattr(_hostprof, "ENABLED", True)
    _hostprof.hostprof_reset()
    want, got, want_tokens, got_tokens = generate_both(monkeypatch, jax_model, port, _gen_requests())
    assert got == want
    for a, b in zip(got_tokens, want_tokens):
        np.testing.assert_array_equal(a, b)
    stages = {"prep_wait", "run_total", "prep_resize", "prep_tower", "build_inputs", "fetch", "detok"}
    assert stages <= set(_hostprof._acc)
    _hostprof.hostprof_dump("phi3v")
    printed = capsys.readouterr().out
    assert "[hostprof phi3v]" in printed and all(name in printed for name in stages)
    _hostprof.hostprof_reset()


def test_configs_and_prompts_match_jax(tiny_models):
    jax_model, port, _ = tiny_models[16]
    from lmms_owc_tpu.models import MODELS as JAX_MODELS

    assert {"phi3v", "phi3v-tiny"} <= set(MODELS) & set(JAX_MODELS)
    assert adapter.PRESET_CONFIGS == jax_adapter.PRESET_CONFIGS
    assert adapter.IMAGE_TOKEN_ID == jax_adapter.IMAGE_TOKEN_ID
    assert dataclasses.asdict(port.text_config) == dataclasses.asdict(jax_model.text_config)
    assert dataclasses.asdict(port.decoder_config) == dataclasses.asdict(jax_model.decoder_config)
    assert dataclasses.asdict(port.vision_config) == dataclasses.asdict(jax_model.vision_config)
    assert port.pad_token_id == jax_model.decoder_config.pad_token_id
    messages = [{"role": "user", "content": "hi"}, {"role": "assistant", "content": "hello"}]
    assert port.apply_chat_template(messages) == jax_model.apply_chat_template(messages)
    assert port.chat_template == jax_model.chat_template == "phi3"
    assert port.tokenizer_name == jax_model.tokenizer_name and port.eos_token_ids == jax_model.eos_token_ids
    ours, theirs = adapter._FallbackPhi3Tokenizer(), jax_adapter._FallbackPhi3Tokenizer()
    for text in [port._build_prompt("What is this?", 2), "a<|image_3|>b<|end|>", "", "  x  <|user|>"]:
        assert port._build_prompt(text, 1) == jax_model._build_prompt(text, 1)
        assert ours.encode(text) == theirs.encode(text)
        assert ours.encode(text, add_special_tokens=False) == theirs.encode(text, add_special_tokens=False)
    assert ours.decode([1, 32000, 31999, 5]) == theirs.decode([1, 32000, 31999, 5])


def test_params_from_jax_copies_every_leaf(tiny_models):
    _, port, tree = tiny_models[16]
    model = port.model
    np.testing.assert_array_equal(model.sub_gn.numpy(), tree["sub_gn"])
    np.testing.assert_array_equal(model.glb_gn.numpy(), tree["glb_gn"])
    np.testing.assert_array_equal(model.projector.fc1.weight.numpy(), tree["projector"]["fc1"]["w"].T)
    np.testing.assert_array_equal(model.projector.fc2.bias.numpy(), tree["projector"]["fc2"]["b"])
    np.testing.assert_array_equal(model.text.embed_tokens.numpy(), tree["text"]["embed_tokens"])
    # The JAX tower tree also carries CLIP's visual projection, which the adapter never reads.
    unused = np.size(tree["vision"]["visual_projection"]["w"])
    n_params = sum(np.size(leaf) for leaf in jax.tree_util.tree_leaves(tree))
    assert sum(p.numel() for p in model.parameters()) == n_params - unused


def test_published_preset_widths():
    """``phi3v`` draws Phi-3-mini (32 layers, 32/32 heads of 96) over
    CLIP-L/336 (24 layers, 16 heads of 64) at the published widths."""
    text = tllama.llama_config_from_hf(adapter.PRESET_CONFIGS["phi3v"]["text_config"])
    vision = adapter.clip_config(adapter.PRESET_CONFIGS["phi3v"]["vision_config"])
    assert (text.num_layers, text.num_heads, text.num_kv_heads, text.hidden_size // text.num_heads) == (32, 32, 32, 96)
    assert (vision.num_layers, vision.num_heads, vision.hidden_size // vision.num_heads) == (24, 16, 64)
    assert text.vocab_size == 32064 and vision.num_positions == 577


def test_quantized_loads_are_refused():
    """Kept under its name, now the other way round: ``load_in_8bit`` /
    ``load_in_4bit`` are served (drawn and quantized one layer at a time),
    the linear layers the JAX base class's generic path quantizes turned
    int8/int4, ``patch_embed`` kept in full precision; the mesh flags, which
    the JAX adapter ignores, are refused."""
    from lmms_owc_tpu_torch.nn.layers import Int4Linear, Int8Linear, Linear

    for flag, cls in (("load_in_8bit", Int8Linear), ("load_in_4bit", Int4Linear)):
        model = get_model("phi3v-tiny", dtype="float32", device="cpu", **{flag: True})
        kinds = {name: type(m) for name, m in model.model.named_modules() if isinstance(m, (Linear, cls))}
        assert kinds.pop("vision.patch_embed", Linear) is Linear
        assert kinds and set(kinds.values()) == {cls}
        assert not model.model.sub_gn.any() and not model.model.glb_gn.any()
    with pytest.raises(ValueError, match="no tensor-parallel path"):
        get_model("phi3v-tiny", dtype="float32", device="cpu", model_parallel=2)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_checkpoint_matches_jax(checkpoint_pair, monkeypatch, bits):
    """The released-layout checkpoint loaded with ``load_in_8bit`` /
    ``load_in_4bit`` in both packages (JAX: the base class's generic path,
    host build then ``stream_quantize_to_device``; the port: each layer read,
    quantized on the device and dropped): the same int leaves and the same tokens."""
    _, _, path = checkpoint_pair
    flag = {f"load_in_{bits}bit": True}
    jax_model = jax_adapter.Phi3v(pretrained=str(path), preset="phi3v-tiny", batch_size=4, dtype="float32",
                                  num_crops=4, **flag)
    port = adapter.Phi3v(pretrained=str(path), preset="phi3v-tiny", batch_size=4, dtype="float32", device="cpu",
                         num_crops=4, **flag)
    tree = jax.tree_util.tree_map(np.asarray, jax_model.params)
    key, leaf = ("w_q8", "q") if bits == 8 else ("w_q4", "q4")
    down = port.model.text.layers[1].down
    np.testing.assert_array_equal(getattr(down, leaf).numpy(), tree["text"]["layers"]["mlp"]["down"][key][leaf][1].T)
    np.testing.assert_array_equal(port.model.projector.fc1.scale.numpy().T if bits == 4 else
                                  port.model.projector.fc1.scale.numpy(), tree["projector"]["fc1"][key]["scale"])
    for m in (jax_model, port):
        m.task_dict["smoke"] = _Task(_docs(3))
    requests = [_Req((p, GEN, _visuals(n), i, "smoke", "test"))
                for i, (p, n) in enumerate([("What is this?", 1), ("Describe it.", 0), ("Colour?", 1)])]
    want, got, want_tokens, got_tokens = generate_both(monkeypatch, jax_model, port, requests)
    assert got == want
    for a, b in zip(got_tokens, want_tokens):
        np.testing.assert_array_equal(a, b)


def test_entry_points_run_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_model("phi3v-tiny")


# ---------------------------------------------------------------- checkpoint


@pytest.fixture(scope="module")
def checkpoint_pair(tmp_path_factory):
    path = tmp_path_factory.mktemp("tiny_phi3v")
    _build_phi3v(path)
    # At most 4 crops of 336 px a request keeps the CPU's tower calls short.
    jax_model = jax_adapter.Phi3v(pretrained=str(path), preset="phi3v-tiny", batch_size=4, dtype="float32",
                                  num_crops=4)
    port = adapter.Phi3v(pretrained=str(path), preset="phi3v-tiny", batch_size=4, dtype="float32", device="cpu",
                         num_crops=4)
    for m in (jax_model, port):
        m.task_dict["smoke"] = _Task(_docs(3))
    return jax_model, port, path


def test_checkpoint_loads_alike_in_both_packages(checkpoint_pair, monkeypatch):
    """The released layout's tree in both packages (fused q/k/v and gate/up
    split, the tower from the embedded CLIP names, the separators), longrope
    in the decoder, the checkpoint tokenizer's specials, the same tokens and
    losses. The 336 px tower encodes one image per request here: the
    checkpoint tokenizer gives ``<|image_2|>`` its own id, which neither
    package expands."""
    jax_model, port, _ = checkpoint_pair
    tree = jax.tree_util.tree_map(np.asarray, jax_model.params)
    assert port.decoder_config.rope_longrope == jax_model.decoder_config.rope_longrope
    assert port.decoder_config.rope_longrope[0] > 1.0
    np.testing.assert_array_equal(port.model.text.embed_tokens.numpy(), tree["text"]["embed_tokens"])
    np.testing.assert_array_equal(port.model.text.layers[1].k.weight.numpy(), tree["text"]["layers"]["attn"]["k"]["w"][1].T)
    np.testing.assert_array_equal(port.model.text.layers[0].up.weight.numpy(), tree["text"]["layers"]["mlp"]["up"]["w"][0].T)
    np.testing.assert_array_equal(port.model.vision.patch_embed.weight.numpy(), tree["vision"]["patch_embed"]["w"].T)
    np.testing.assert_array_equal(port.model.projector.fc1.weight.numpy(), tree["projector"]["fc1"]["w"].T)
    np.testing.assert_array_equal(port.model.sub_gn.numpy(), tree["sub_gn"])
    np.testing.assert_array_equal(port.model.glb_gn.numpy(), tree["glb_gn"])
    assert (port.pad_token_id, port.tokenizer.eos_token_id) == (32000, 32007)
    prompt = port._build_prompt("What is this?", 1)
    ids = port.tokenizer.encode(prompt)
    assert ids == jax_model.tokenizer.encode(prompt) and adapter.IMAGE_TOKEN_ID in ids
    assert {32010, 32001, 32007} <= set(ids)
    requests = [_Req((p, GEN, _visuals(n), i, "smoke", "test"))
                for i, (p, n) in enumerate([("What is this?", 1), ("Describe it.", 0), ("Colour?", 1)])]
    want, got, want_tokens, got_tokens = generate_both(monkeypatch, jax_model, port, requests)
    assert got == want
    for a, b in zip(got_tokens, want_tokens):
        np.testing.assert_array_equal(a, b)
    ll = [_Req(("What is this?", " a cat", _visuals(1), 0, "smoke", "test")), _Req(("hello", " world"))]
    want_ll, got_ll = jax_model.loglikelihood(ll), port.loglikelihood(ll)
    assert np.isfinite([w[0] for w in want_ll]).all()
    np.testing.assert_allclose([g[0] for g in got_ll], [w[0] for w in want_ll], rtol=0, atol=LOSS_TOL)
    assert [g[1] for g in got_ll] == [w[1] for w in want_ll]


def test_checkpoint_pad_outside_the_vocabulary_is_refused(checkpoint_pair, tmp_path):
    import json
    import shutil

    _, _, path = checkpoint_pair
    for f in path.iterdir():
        shutil.copy(f, tmp_path / f.name)
    cfg = json.loads((tmp_path / "config.json").read_text())
    (tmp_path / "config.json").write_text(json.dumps(dict(cfg, pad_token_id=40000)))
    with pytest.raises(ValueError, match="outside the checkpoint's vocabulary"):
        adapter.Phi3v(pretrained=str(tmp_path), preset="phi3v-tiny", dtype="float32", device="cpu")


def test_cli_run_loads_no_jax(tmp_path, toy_dataset):
    """``python -m lmms_owc_tpu_torch.eval_model`` (run as ``__main__`` by
    runpy, as ``-m`` runs it) answers ``toy`` with ``phi3v-tiny`` on the CPU
    and leaves no ``jax`` or ``lmms_owc_tpu`` module in ``sys.modules``."""
    argv = ["eval_model", "--model", "phi3v-tiny", "--model_args", "dtype=float32,device=cpu", "--tasks", "toy",
            "--include_path", str(REPO_ROOT / "tests" / "fixtures" / "tasks"), "--limit", "2", "--batch_size", "2",
            "--output_path", str(tmp_path)]
    code = (
        "import runpy, sys\n"
        f"sys.argv = {argv!r}\n"
        "runpy.run_module('lmms_owc_tpu_torch.eval_model', run_name='__main__', alter_sys=True)\n"
        "bad = sorted(k for k in sys.modules if k in ('jax', 'jaxlib') or k.startswith(('jax.', 'jaxlib.'))\n"
        "             or (k.startswith('lmms_owc_tpu') and not k.startswith('lmms_owc_tpu_torch')))\n"
        "assert not bad, bad\n"
        "print('PHI3V_CLI_NO_JAX_OK')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "PHI3V_CLI_NO_JAX_OK" in proc.stdout
    assert len(list(tmp_path.rglob("*_results.json"))) == 1
