"""The port's InternVL2 (``nn/internvl.py``, ``models/internvl2.py``) against the JAX package.

Modules: the JAX tree of ``init_internvl_params`` (float32) is re-drawn from
a numpy seed and carried into the port with ``internvl_params_from_jax``; on
numpy pixels from a seed the InternViT tower, the pixel shuffle and
``encode_tiles`` agree with the JAX functions within ``TOL`` = 1e-4 (float32
in, float32 out: summation order only), with and without the QK RMSNorm.
``dynamic_preprocess`` gives the JAX tiles pixel for pixel, as
``tests/test_internvl_parity.py`` holds JAX's tiling. Adapter: the JAX
``internvl2-tiny`` (float32, random init, re-drawn tree) and the port's over
the same tree give the same tokens and strings from ``generate_until``, and
``loglikelihood`` the same greedy flags and losses within ``LOSS_TOL`` = 1e-4.
The tiny HF checkpoint of ``tests/test_checkpoint_matrix.py`` (a 512-token
vocabulary; the adapter's fixed ids 151643/151645 and the fallback's
``<img>`` 151665 never reach an embedding there: the pad is the config's 0,
the tokenizer's EOS 2 and ``<img>`` 501) loads in both packages to the same
weights, tokens and losses.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from lmms_owc_tpu.models import internvl2 as jax_adapter
from lmms_owc_tpu.nn import internvl as jiv
from lmms_owc_tpu.nn import llama as jllama
from lmms_owc_tpu_torch import no_tf32
from lmms_owc_tpu_torch.models import MODELS, get_model
from lmms_owc_tpu_torch.models import internvl2 as adapter
from lmms_owc_tpu_torch.nn import internvl as iv
from lmms_owc_tpu_torch.nn import llama as tllama
from lmms_owc_tpu_torch.nn.layers import Int4Linear, Int8Linear
from tests.test_checkpoint_matrix import _build_internvl2
from tests.test_torch_onevision import _Task, _docs, _gen_requests, _ll_requests, generate_both
from tests.test_torch_siglip import redraw

TOL = 1e-4
LOSS_TOL = 1e-4
REGISTERED = ("internvl2-1b", "internvl2-2b", "internvl2-4b", "internvl2-8b", "internvl2-26b", "internvl2-40b",
              "internvl2.5-1b", "internvl2.5-2b", "internvl2.5-4b", "internvl2.5-8b", "internvl2.5-26b",
              "internvl2.5-38b", "internvl2-tiny")

HF_CONFIG = dict(
    vision_config=dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
                       image_size=[28, 28], patch_size=[14, 14], use_qk_norm=False, layer_norm_eps=1e-6,
                       attention_bias=True),
    text_config=dict(model_type="qwen2", vocab_size=256, hidden_size=48, intermediate_size=96,
                     num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2, rope_theta=10000.0,
                     rms_norm_eps=1e-6, tie_word_embeddings=False),
    image_token_id=200,
    downsample_ratio=0.5,
)


@pytest.fixture(autouse=True)
def _full_f32():
    no_tf32()


def _module_pair(qk_norm: bool, seed: int = 0):
    hf = dict(HF_CONFIG, vision_config=dict(HF_CONFIG["vision_config"], use_qk_norm=qk_norm))
    cfg_j, cfg_t = jiv.internvl_config_from_hf(hf), iv.internvl_config_from_hf(hf)
    tree = jiv.init_internvl_params(jax.random.PRNGKey(seed), cfg_j, jnp.float32)
    tree = redraw(jax.tree_util.tree_map(np.asarray, tree), np.random.default_rng(seed))
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    return cfg_j, cfg_t, params, iv.internvl_params_from_jax(tree, cfg_t), tree


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "qk_norm"])
def modules(request):
    return _module_pair(request.param)


def _pixels(seed: int, n: int = 3, size: int = 28) -> np.ndarray:
    return np.random.RandomState(seed).randn(n, 3, size, size).astype(np.float32)


def test_configs_match_jax(modules):
    cfg_j, cfg_t, *_ = modules
    assert dataclasses.asdict(cfg_t.vision) == dataclasses.asdict(cfg_j.vision)
    assert dataclasses.asdict(cfg_t.text) == dataclasses.asdict(cfg_j.text)
    for name in ("image_token_id", "downsample_ratio", "vision_feature_select_strategy", "text_attn_bias",
                 "tokens_per_tile"):
        assert getattr(cfg_t, name) == getattr(cfg_j, name)


def test_internvit_matches_jax(modules):
    cfg_j, cfg_t, params, model, _ = modules
    pixels = _pixels(0)
    want = jiv._vision_tower(params["vision"], jnp.asarray(pixels), cfg_j.vision)
    got = iv.internvit_forward(model.vision, torch.from_numpy(pixels), cfg_t.vision)
    assert got.shape == (3, 1 + cfg_t.vision.num_patches, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shape,scale", [((2, 4, 4, 8), 0.5), ((3, 32, 32, 16), 0.5), ((1, 6, 6, 4), 0.5)])
def test_pixel_shuffle_matches_jax(shape, scale):
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    want = np.asarray(jiv._pixel_shuffle(jnp.asarray(x), scale))
    np.testing.assert_array_equal(iv._pixel_shuffle(torch.from_numpy(x), scale).numpy(), want)


def test_encode_tiles_matches_jax(modules):
    cfg_j, cfg_t, params, model, _ = modules
    pixels = _pixels(2, n=4)
    want = jiv.encode_tiles(params, jnp.asarray(pixels), cfg_j)
    got = iv.encode_tiles(model, torch.from_numpy(pixels), cfg_t)
    assert got.shape == (4, cfg_t.tokens_per_tile, 48)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_params_from_jax_copies_every_leaf(modules):
    _, cfg_t, _, model, tree = modules
    vt = tree["vision"]
    np.testing.assert_array_equal(model.vision.patch_embed.weight.numpy(), vt["patch_embed"]["w"].T)
    np.testing.assert_array_equal(model.vision.cls_token.numpy(), vt["cls_token"])
    np.testing.assert_array_equal(model.vision.position_embeddings.numpy(), vt["position_embeddings"])
    layer = model.vision.layers[1]
    np.testing.assert_array_equal(layer.lambda_2.numpy(), vt["layers"]["lambda_2"][1])
    np.testing.assert_array_equal(layer.q.bias.numpy(), vt["layers"]["attn"]["q"]["b"][1])
    np.testing.assert_array_equal(layer.o.weight.numpy(), vt["layers"]["attn"]["o"]["w"][1].T)
    if cfg_t.vision.use_qk_norm:
        np.testing.assert_array_equal(layer.k_norm.weight.numpy(), vt["layers"]["attn"]["k_norm"]["scale"][1])
    np.testing.assert_array_equal(model.vision.final_ln.bias.numpy(), vt["final_ln"]["bias"])
    np.testing.assert_array_equal(model.projector.ln.weight.numpy(), tree["projector"]["ln"]["scale"])
    np.testing.assert_array_equal(model.projector.fc2.weight.numpy(), tree["projector"]["fc2"]["w"].T)
    np.testing.assert_array_equal(model.text.embed_tokens.numpy(), tree["text"]["embed_tokens"])
    n_params = sum(np.size(leaf) for leaf in jax.tree_util.tree_leaves(tree))
    assert sum(p.numel() for p in model.parameters()) == n_params


def test_mrope_text_config_maps_as_in_jax():
    """The tiny preset's ``mrope`` rope scaling gives standard RoPE in both
    packages (a scaling type other than llama3 and longrope changes nothing;
    longrope is not ported and raises)."""
    text = adapter.PRESET_CONFIGS["internvl2-tiny"]["text_config"]
    want = jllama.llama_config_from_hf(text).to_decoder_config()
    got = tllama.llama_config_from_hf(text).to_decoder_config()
    assert got.rope_llama3 is want.rope_llama3 is None
    assert got.mrope_section == want.mrope_section
    with pytest.raises(NotImplementedError, match="longrope"):
        tllama.llama_config_from_hf(dict(text, rope_scaling={"type": "longrope"})).to_decoder_config()


@pytest.mark.parametrize("size", [(300, 300), (896, 448), (336, 448), (640, 200), (97, 211), (1200, 900)])
def test_dynamic_preprocess_matches_jax(size):
    rng = np.random.RandomState(size[0])
    image = Image.fromarray(rng.randint(0, 255, (size[1], size[0], 3), dtype=np.uint8))
    want = jax_adapter.dynamic_preprocess(image, max_num=6, image_size=448, use_thumbnail=True)
    got = adapter.dynamic_preprocess(image, max_num=6, image_size=448, use_thumbnail=True)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_phase_images_tile_to_seven():
    """A 336x448 image (phase 3's second size) tiles into 6 + a thumbnail:
    1792 image tokens at InternViT-448's 256 per tile."""
    image = Image.new("RGB", (448, 336))
    assert len(adapter.dynamic_preprocess(image, max_num=6, image_size=448)) == 7
    assert len(adapter.dynamic_preprocess(Image.new("RGB", (448, 448)), max_num=6, image_size=448)) == 1


# -------------------------------------------------------------------- adapter


def _pair(seed: int, **kw):
    jax_model = jax_adapter.InternVL2(preset="internvl2-tiny", batch_size=4, random_init=True, dtype="float32", **kw)
    tree = redraw(jax.tree_util.tree_map(np.asarray, jax_model.params), np.random.default_rng(seed))
    jax_model.params = jax.tree_util.tree_map(jnp.asarray, tree)
    port = adapter.InternVL2(preset="internvl2-tiny", batch_size=4, dtype="float32", device="cpu", jax_params=tree,
                             **kw)
    docs = _docs(seed)
    for m in (jax_model, port):
        m.task_dict["smoke"] = _Task(docs)
    return jax_model, port, tree


@pytest.fixture(scope="module")
def tiny():
    return _pair(1)


def test_generate_until_identical(tiny, monkeypatch):
    jax_model, port, _ = tiny
    want, got, want_tokens, got_tokens = generate_both(monkeypatch, jax_model, port, _gen_requests())
    assert got == want and len(got) == 6
    assert len(got_tokens) == len(want_tokens) == 2
    for a, b in zip(got_tokens, want_tokens):
        np.testing.assert_array_equal(a, b)
    assert len(set(np.concatenate(got_tokens).ravel())) > 2  # the tokens vary


def test_generate_until_identical_with_two_tiles_per_image(monkeypatch):
    """``max_tiles=2``: wide and tall images tile 2 + a thumbnail."""
    jax_model, port, _ = _pair(3, max_tiles=2)
    want, got, want_tokens, got_tokens = generate_both(monkeypatch, jax_model, port, _gen_requests())
    assert got == want
    for a, b in zip(got_tokens, want_tokens):
        np.testing.assert_array_equal(a, b)


def test_loglikelihood_matches_jax(tiny):
    jax_model, port, _ = tiny
    want, got = jax_model.loglikelihood(_ll_requests()), port.loglikelihood(_ll_requests())
    assert len(got) == len(want) == 5
    np.testing.assert_allclose([g[0] for g in got], [w[0] for w in want], rtol=0, atol=LOSS_TOL)
    assert [g[1] for g in got] == [w[1] for w in want]


def test_tiles_and_prompt_ids_match_jax(tiny):
    jax_model, port, _ = tiny
    images = _docs(4)[0]["images"]
    got, want = port._tile_images(images), jax_model._tile_images(images)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    prompt = port._build_prompt("What is this?", got[1])
    assert prompt == jax_model._build_prompt("What is this?", want[1])
    assert port.tokenizer.encode(prompt) == jax_model.tokenizer.encode(prompt)


def test_configs_and_prompts_match_jax(tiny):
    jax_model, port, _ = tiny
    from lmms_owc_tpu.models import MODELS as JAX_MODELS

    for name in REGISTERED:
        assert name in MODELS and name in JAX_MODELS
    assert adapter.PRESET_CONFIGS == jax_adapter.PRESET_CONFIGS
    assert dataclasses.asdict(port.config.vision) == dataclasses.asdict(jax_model.config.vision)
    assert dataclasses.asdict(port.config.text) == dataclasses.asdict(jax_model.config.text)
    assert port.pad_token_id == jax_model.decoder_config.pad_token_id
    messages = [{"role": "user", "content": "hi"}, {"role": "assistant", "content": "hello"}]
    assert port.apply_chat_template(messages) == jax_model.apply_chat_template(messages)
    assert port.chat_template == jax_model.chat_template == "internvl2"
    assert port.tokenizer_name == jax_model.tokenizer_name and port.eos_token_ids == jax_model.eos_token_ids
    ours, theirs = adapter._FallbackInternVLTokenizer(151667), jax_adapter._FallbackInternVLTokenizer(151667)
    for text in [port._build_prompt("What is this?", [2, 1]), "a<img>b</img>", "", "  x  "]:
        assert ours.encode(text) == theirs.encode(text)
    assert ours.decode([1, 2, 3]) == theirs.decode([1, 2, 3])


def test_large_names_draw_the_2b_preset(monkeypatch):
    """Every registration but the tiny one builds the ``internvl2-2b`` preset
    (the JAX preset mapping: a larger variant takes its widths from its
    checkpoint's config), at InternViT-300M and Qwen2-1.5B widths."""
    built = []
    monkeypatch.setattr(adapter, "InternVL2", lambda **kw: built.append(kw["preset"]))
    for name in REGISTERED:
        get_model(name)
    assert built == ["internvl2-2b"] * (len(REGISTERED) - 1) + ["internvl2-tiny"]
    cfg = iv.internvl_config_from_hf(adapter.PRESET_CONFIGS["internvl2-2b"])
    assert (cfg.text.num_heads, cfg.text.num_kv_heads, cfg.text.hidden_size // cfg.text.num_heads) == (12, 2, 128)
    assert (cfg.vision.num_layers, cfg.vision.num_heads, cfg.vision.hidden_size // cfg.vision.num_heads) == (24, 16, 64)
    assert cfg.tokens_per_tile == 256


@pytest.mark.parametrize("bits", [8, 4])
def test_random_init_quantized_on_the_device(bits):
    model = get_model("internvl2-tiny", device="cpu", dtype="float32",
                      **{"load_in_8bit" if bits == 8 else "load_in_4bit": True})
    cls = Int8Linear if bits == 8 else Int4Linear
    names = {n for n, m in model.model.named_modules() if isinstance(m, cls)}
    assert {"text.layers.0.q", "vision.layers.1.fc1", "vision.layers.0.q", "projector.fc1"} <= names
    assert not any("patch_embed" in n for n in names)
    model.task_dict["smoke"] = _Task(_docs(2))
    out = model.generate_until(_gen_requests()[:2])
    assert len(out) == 2 and all(isinstance(o, str) for o in out)


def test_entry_points_run_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_model("internvl2-tiny")


# ----------------------------------------------------------------- checkpoint


@pytest.fixture(scope="module")
def checkpoint_pair(tmp_path_factory):
    path = tmp_path_factory.mktemp("tiny_internvl")
    _build_internvl2(path)
    jax_model = jax_adapter.InternVL2(pretrained=str(path), preset="internvl2-tiny", batch_size=4, dtype="float32")
    port = adapter.InternVL2(pretrained=str(path), preset="internvl2-tiny", batch_size=4, dtype="float32",
                             device="cpu")
    docs = _docs(3)
    for m in (jax_model, port):
        m.task_dict["smoke"] = _Task(docs)
    return jax_model, port


def test_checkpoint_loads_alike_in_both_packages(checkpoint_pair, monkeypatch):
    jax_model, port = checkpoint_pair
    tree = jax.tree_util.tree_map(np.asarray, jax_model.params)
    assert port.model.vision.final_ln is None and "final_ln" not in tree["vision"]  # the released 300M form
    np.testing.assert_array_equal(port.model.text.embed_tokens.numpy(), tree["text"]["embed_tokens"])
    np.testing.assert_array_equal(port.model.vision.patch_embed.weight.numpy(), tree["vision"]["patch_embed"]["w"].T)
    np.testing.assert_array_equal(port.model.vision.layers[1].lambda_1.numpy(), tree["vision"]["layers"]["lambda_1"][1])
    np.testing.assert_array_equal(port.model.projector.fc1.weight.numpy(), tree["projector"]["fc1"]["w"].T)
    # The ids that reach an embedding lie inside the 512-token vocabulary.
    assert (port.pad_token_id, port.tokenizer.eos_token_id, port.config.image_token_id) == (0, 2, 500)
    prompt = port._build_prompt("What is this?", [1])
    ids = port.tokenizer.encode(prompt)
    assert ids == jax_model.tokenizer.encode(prompt) and max(ids) < 512 and 501 in ids and 502 in ids
    requests = _gen_requests()[:4]
    want, got, want_tokens, got_tokens = generate_both(monkeypatch, jax_model, port, requests)
    assert got == want
    for a, b in zip(got_tokens, want_tokens):
        np.testing.assert_array_equal(a, b)
    want_ll, got_ll = jax_model.loglikelihood(_ll_requests()), port.loglikelihood(_ll_requests())
    assert np.isfinite([w[0] for w in want_ll]).all()
    np.testing.assert_allclose([g[0] for g in got_ll], [w[0] for w in want_ll], rtol=0, atol=LOSS_TOL)
    assert [g[1] for g in got_ll] == [w[1] for w in want_ll]
