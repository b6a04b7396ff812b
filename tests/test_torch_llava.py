"""The port's LLaVA (``nn/llava.py``, ``nn/anyres.py``, ``models/llava_hf.py``)
against the JAX package.

The JAX adapter ``llava-tiny`` (float32, random init) and a tiny llava-next
(the same widths with anyres pinpoints at 28-pixel tiles) have their trees
re-drawn from a numpy seed (weights large enough that greedy tokens vary)
and carried into the port with ``jax_params``; on the same requests, one
batch mixing 0-, 1- and 2-image requests, ``generate_until`` gives the same
tokens and strings and ``loglikelihood`` the same losses within 1e-4 and
the same greedy flags. A tiny HF ``LlavaForConditionalGeneration``
checkpoint at vocabulary 32064 (``<image>`` at 32000, ``<pad>`` at 32001,
the ``byte_fallback`` tokenizer of ``chip_smoke.llama2_tokenizer``) loads in
both packages and gives the same tokens. Every anyres function agrees with
JAX (the bilinear ``max_patches`` downscale within 1e-5), and the
``load_in_8bit`` / ``load_in_4bit`` leaf sets are the JAX quantizers'.
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from lmms_owc_tpu.models import llava_hf as jax_adapter
from lmms_owc_tpu.nn import anyres as jax_anyres
from lmms_owc_tpu.nn import llava as jax_lv
from lmms_owc_tpu.ops import quant as jax_quant
from lmms_owc_tpu_torch import no_tf32
from lmms_owc_tpu_torch.models import MODELS, get_model
from lmms_owc_tpu_torch.models import llava_hf as adapter
from lmms_owc_tpu_torch.nn import anyres, llava
from lmms_owc_tpu_torch.nn.layers import Int4Linear, Int8Linear
from lmms_owc_tpu_torch.ops import quant
from tests.test_torch_qwen2_vl import _redraw

LOSS_TOL = 1e-4
NEXT_TINY = dict(adapter.PRESET_CONFIGS["llava-tiny"], model_type="llava_next",
                 image_grid_pinpoints=[[28, 56], [56, 28], [56, 56], [84, 28]])
GEN = {"max_new_tokens": 8, "do_sample": False, "until": None}
PRESETS = ("llava-1.5-7b", "llava-1.5-13b", "llava-next-vicuna-7b", "llava-next-mistral-7b", "llava-tiny")


@pytest.fixture(autouse=True)
def _full_f32():
    no_tf32()


class _Req:
    def __init__(self, args):
        self.args = args


class _Task:
    def __init__(self, docs):
        self.dataset = {"test": docs}


def _docs(seed=0):
    rng = np.random.RandomState(seed)
    sizes = [(40, 40), (33, 57), (61, 29), (28, 90), (50, 31)]
    return [{"images": [Image.fromarray(rng.randint(0, 255, (h, w, 3), dtype=np.uint8))
                        for h, w in sizes[i : i + 2]]} for i in range(4)]


def _visuals(n):
    return lambda doc: doc["images"][:n]


def _gen_requests():
    """One batch of four mixing 2-, 0-, 1- and 1-image requests, then two more."""
    counts = [2, 0, 1, 1, 2, 1]
    prompts = ["What is this?", "Describe the weather.", "Name the object.", "Colour?", "Compare them.", "Is it red?"]
    return [_Req((p, GEN, _visuals(n), i % 4, "smoke", "test")) for i, (p, n) in enumerate(zip(prompts, counts))]


def _ll_requests():
    return [_Req(("What is this?", " a cat", _visuals(n), i, "smoke", "test")) for i, n in enumerate([2, 0, 1, 1])] + [
        _Req(("hello", " world"))]


def _make_pair(preset: str, seed: int):
    jax_model = jax_adapter.LlavaHf(preset=preset, batch_size=4, random_init=True, dtype="float32")
    tree = _redraw(jax.tree_util.tree_map(np.asarray, jax_model.params), np.random.default_rng(seed))
    jax_model.params = jax.tree_util.tree_map(jnp.asarray, tree)
    port = adapter.LlavaHf(preset=preset, batch_size=4, dtype="float32", device="cpu", jax_params=tree)
    docs = _docs(seed)
    for m in (jax_model, port):
        m.task_dict["smoke"] = _Task(docs)
    return jax_model, port, tree


@pytest.fixture(scope="module")
def tiny():
    return _make_pair("llava-tiny", 1)


@pytest.fixture(scope="module")
def tiny_next():
    jax_adapter.PRESET_CONFIGS["llava-next-tiny"] = NEXT_TINY
    adapter.PRESET_CONFIGS["llava-next-tiny"] = NEXT_TINY
    try:
        yield _make_pair("llava-next-tiny", 2)
    finally:
        del jax_adapter.PRESET_CONFIGS["llava-next-tiny"], adapter.PRESET_CONFIGS["llava-next-tiny"]


def _tokens_of(monkeypatch, module, calls: list):
    real = module.greedy_generate

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append(np.asarray(out))
        return out

    monkeypatch.setattr(module, "greedy_generate", spy)


def _generate_both(monkeypatch, pair, requests):
    from lmms_owc_tpu.nn import llama as jax_llama
    from lmms_owc_tpu_torch.nn import qwen2_vl as port_decoder

    jax_model, port, _ = pair
    want_tokens, got_tokens = [], []
    _tokens_of(monkeypatch, jax_llama, want_tokens)
    _tokens_of(monkeypatch, port_decoder, got_tokens)
    want, got = jax_model.generate_until(requests), port.generate_until(requests)
    return want, got, want_tokens, got_tokens


@pytest.mark.parametrize("which", ["llava-1.5", "llava-next"])
def test_generate_until_identical(request, monkeypatch, which):
    pair = request.getfixturevalue("tiny" if which == "llava-1.5" else "tiny_next")
    want, got, want_tokens, got_tokens = _generate_both(monkeypatch, pair, _gen_requests())
    assert got == want and len(got) == 6
    assert len(got_tokens) == len(want_tokens) == 2
    for a, b in zip(got_tokens, want_tokens):
        np.testing.assert_array_equal(a, b)
    assert len(set(np.concatenate(got_tokens).ravel())) > 2  # the tokens vary


@pytest.mark.parametrize("which", ["llava-1.5", "llava-next"])
def test_loglikelihood_matches_jax(request, which):
    jax_model, port, _ = request.getfixturevalue("tiny" if which == "llava-1.5" else "tiny_next")
    want, got = jax_model.loglikelihood(_ll_requests()), port.loglikelihood(_ll_requests())
    assert len(got) == len(want) == 5
    np.testing.assert_allclose([g[0] for g in got], [w[0] for w in want], rtol=0, atol=LOSS_TOL)
    assert [g[1] for g in got] == [w[1] for w in want]


@pytest.mark.parametrize("which", ["llava-1.5", "llava-next"])
def test_encode_images_matches_jax(request, which):
    jax_model, port, tree = request.getfixturevalue("tiny" if which == "llava-1.5" else "tiny_next")
    pixels = np.random.RandomState(3).randn(3, 3, 28, 28).astype(np.float32)
    want = np.asarray(jax_lv.encode_images(jax_model.params, jnp.asarray(pixels), jax_model.config))
    got = llava.encode_images(port.model, torch.from_numpy(pixels), port.config)
    assert tuple(got.shape) == want.shape == (3, 4, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_anyres_packing_matches_jax(tiny_next):
    """The packed llava-next features of one image (tiles, unpadding, newline column)."""
    jax_model, port, _ = tiny_next
    for image in _docs(4)[1]["images"] + _docs(4)[3]["images"]:
        want = jax_model._encode_anyres_image(image)
        got = port._encode_anyres_image(image)
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_preprocess_images_match_jax(tiny):
    jax_model, port, _ = tiny
    images = [img for doc in _docs(5) for img in doc["images"]]
    np.testing.assert_array_equal(port._preprocess_images(images), jax_model._preprocess_images(images))


def test_configs_match_jax():
    for preset in PRESETS:
        cfg = adapter.PRESET_CONFIGS[preset]
        assert cfg == jax_adapter.PRESET_CONFIGS[preset]
        got, want = llava.llava_config_from_hf(cfg), jax_lv.llava_config_from_hf(cfg)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.image_seq_length == want.image_seq_length
        assert got.decoder_config().pad_token_id == got.pad_token_id == 32001
    # A pad_token_id of 0 becomes 32001 (the JAX ``or 32001``).
    zero = dict(adapter.PRESET_CONFIGS["llava-tiny"], pad_token_id=0)
    assert llava.llava_config_from_hf(zero).pad_token_id == jax_lv.llava_config_from_hf(zero).pad_token_id == 32001
    assert llava.llava_config_from_hf(dict(zero, pad_token_id=7)).pad_token_id == 7


def test_registrations():
    for preset in PRESETS:
        assert preset in MODELS
    assert get_model("llava-tiny", device="cpu", dtype="float32").preset == "llava-tiny"


def test_prompts_match_jax(tiny):
    jax_model, port, _ = tiny
    messages = [{"role": "user", "content": "hi"}, {"role": "assistant", "content": "hello"},
                {"role": "user", "content": "What is this?"}]
    assert port.apply_chat_template(messages) == jax_model.apply_chat_template(messages)
    assert port.chat_template == jax_model.chat_template == "vicuna_v1"
    for preset in ("llava-1.5-7b", "llava-next-mistral-7b"):
        for model in (jax_model, port):
            model.preset = preset
        try:
            for n in (0, 1, 2):
                assert port._build_prompt("Name it.", n) == jax_model._build_prompt("Name it.", n)
            assert port.tokenizer_name == jax_model.tokenizer_name == f"llava_{preset}"
        finally:
            for model in (jax_model, port):
                model.preset = "llava-tiny"
    port.preset = "llava-next-mistral-7b"
    assert port._build_prompt("Name it.", 1) == "[INST] <image>\nName it. [/INST]"
    port.preset = "llava-tiny"
    assert port._build_prompt("Name it.", 2) == "USER: <image>\n<image>\nName it. ASSISTANT:"


def test_fallback_tokenizer_ids_match_jax():
    ours, theirs = adapter._FallbackLlavaTokenizer(32000), jax_adapter._FallbackLlavaTokenizer(32000)
    for text in ["USER: <image>\nWhat is this? ASSISTANT:", "a<image>b", "", "  x  "]:
        for special in (True, False):
            assert ours.encode(text, special) == theirs.encode(text, special)
    assert ours.decode([1, 2, 3, 500]) == theirs.decode([1, 2, 3, 500])


def _jax_quantized_roles(tree) -> set[str]:
    out = set()
    for path, _ in jax.tree_util.tree_leaves_with_path(tree):
        keys = [getattr(k, "key", None) for k in path]
        for marker in ("w_q8", "w_q4"):
            if marker in keys:
                out.add("/".join(k for k in keys[: keys.index(marker)] if k not in ("attn", "mlp")))
    return out


def _port_quantized_roles(model) -> set[str]:
    out = set()
    for name, mod in model.named_modules():
        if isinstance(mod, (Int8Linear, Int4Linear)):
            out.add("/".join(p for p in name.split(".") if not p.isdigit()))
    return out


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_leaf_sets_match_jax(tiny_next, bits):
    _, port, tree = tiny_next
    jax_q = (jax_quant.quantize_params_int8 if bits == 8 else jax_quant.quantize_params_int4)(
        jax.tree_util.tree_map(jnp.asarray, tree))
    model = llava.llava_params_from_jax(tree, port.config)
    (quant.quantize_params_int8 if bits == 8 else quant.quantize_params_int4)(model)
    want = _jax_quantized_roles(jax_q)
    assert _port_quantized_roles(model) == want
    assert {"text/layers/q", "text/layers/down", "vision/layers/q", "vision/layers/fc2", "projector/fc1"} <= want
    assert not any("patch_embed" in r for r in want)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_generate_matches_jax(tiny, monkeypatch, bits):
    """The JAX package's quantized tree served by both adapters: the same tokens."""
    jax_model, _, tree = tiny
    qtree = (jax_quant.quantize_params_int8 if bits == 8 else jax_quant.quantize_params_int4)(
        jax.tree_util.tree_map(jnp.asarray, tree))
    port = adapter.LlavaHf(preset="llava-tiny", batch_size=4, dtype="float32", device="cpu",
                           jax_params=jax.tree_util.tree_map(np.asarray, qtree))
    port.task_dict["smoke"] = jax_model.task_dict["smoke"]
    assert _port_quantized_roles(port.model) == _jax_quantized_roles(qtree)
    monkeypatch.setattr(jax_model, "params", qtree)
    want, got, want_tokens, got_tokens = _generate_both(monkeypatch, (jax_model, port, None), _gen_requests()[:4])
    assert got == want
    for a, b in zip(got_tokens, want_tokens):
        np.testing.assert_array_equal(a, b)


def test_random_init_quantized_on_the_device():
    model = get_model("llava-tiny", device="cpu", dtype="float32", load_in_8bit=True)
    roles = _port_quantized_roles(model.model)
    assert "vision/layers/q" in roles and "projector/fc2" in roles and "text/layers/gate" in roles
    out = model.generate_until([_Req(("hi", GEN, None, 0, "smoke", "test"))])
    assert len(out) == 1 and isinstance(out[0], str)


def test_entry_points_run_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_model("llava-tiny")


# ----------------------------------------------------------------- checkpoint


def _write_llava_checkpoint(path: Path) -> Path:
    """A tiny HF LlavaForConditionalGeneration at vocabulary 32064 with the
    specials at their published ids, weights re-drawn large enough that
    greedy tokens vary, and the Llama-2-form tokenizer."""
    from transformers import LlavaConfig, LlavaForConditionalGeneration

    torch.manual_seed(0)
    config = LlavaConfig(
        vision_config=dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
                           image_size=28, patch_size=14),
        text_config=dict(model_type="llama", vocab_size=32064, hidden_size=64, intermediate_size=128,
                         num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2, rms_norm_eps=1e-5,
                         tie_word_embeddings=False),
        image_token_index=32000, pad_token_id=32001, eos_token_id=2,
    )
    model = LlavaForConditionalGeneration(config).eval()
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            noise = torch.randn(p.shape, generator=gen) * 0.1
            p.copy_(1.0 + noise if "norm" in name and name.endswith("weight") else noise)
    model.save_pretrained(str(path), safe_serialization=True)
    (path / "tokenizer.json").write_text(json.dumps(chip_smoke.llama2_tokenizer()))
    (path / "tokenizer_config.json").write_text(json.dumps(chip_smoke.LLAMA2_TOKENIZER_CONFIG))
    return path


@pytest.fixture(scope="module")
def llava_checkpoint(tmp_path_factory) -> Path:
    return _write_llava_checkpoint(tmp_path_factory.mktemp("tiny_llava_32064"))


def test_checkpoint_loads_alike_in_both_packages(llava_checkpoint, monkeypatch):
    from lmms_owc_tpu.models import get_model as jax_get_model
    from lmms_owc_tpu_torch.nn.loader import load_safetensors_state

    jax_model = jax_get_model("llava-1.5-7b", pretrained=str(llava_checkpoint), batch_size=4, dtype="float32")
    port = get_model("llava-1.5-7b", pretrained=str(llava_checkpoint), batch_size=4, dtype="float32", device="cpu")
    assert port.config.text.vocab_size == 32064 and port.config.pad_token_id == 32001
    assert port.eos_token_ids == jax_model.eos_token_ids == [2]
    state = load_safetensors_state(llava_checkpoint)
    # transformers writes the released checkpoints' layout.
    for name, tensor in [("text.layers.1.q.weight", "language_model.model.layers.1.self_attn.q_proj.weight"),
                         ("vision.layers.0.fc1.bias", "vision_tower.vision_model.encoder.layers.0.mlp.fc1.bias"),
                         ("projector.fc2.weight", "multi_modal_projector.linear_2.weight"),
                         ("text.lm_head.weight", "language_model.lm_head.weight")]:
        assert torch.equal(port.model.get_parameter(name), state[tensor])
    docs = _docs(6)
    for m in (jax_model, port):
        m.task_dict["smoke"] = _Task(docs)
    want, got, want_tokens, got_tokens = _generate_both(monkeypatch, (jax_model, port, None), _gen_requests())
    assert got == want
    for a, b in zip(got_tokens, want_tokens):
        np.testing.assert_array_equal(a, b)
    assert len(set(np.concatenate(got_tokens).ravel())) > 2
    ll_want, ll_got = jax_model.loglikelihood(_ll_requests()), port.loglikelihood(_ll_requests())
    np.testing.assert_allclose([g[0] for g in ll_got], [w[0] for w in ll_want], rtol=0, atol=LOSS_TOL)


def test_checkpoint_quantized_load_matches_quantizing_the_float_model(llava_checkpoint):
    float_model = get_model("llava-tiny", pretrained=str(llava_checkpoint), dtype="float32", device="cpu")
    q8 = get_model("llava-tiny", pretrained=str(llava_checkpoint), dtype="float32", device="cpu", load_in_8bit=True)
    ref = quant.quantize_params_int8(float_model.model)
    for name, mod in q8.model.named_modules():
        if isinstance(mod, Int8Linear):
            torch.testing.assert_close(mod.q, ref.get_submodule(name).q, rtol=0, atol=0)
    assert _port_quantized_roles(q8.model) == _port_quantized_roles(ref)


def test_checkpoint_pad_outside_the_vocabulary_is_refused(tmp_path):
    path = _write_llava_checkpoint(tmp_path)
    cfg = json.loads((path / "config.json").read_text())
    cfg["pad_token_id"] = 0  # becomes 32001; at vocabulary 32000 it lies outside
    cfg["text_config"]["vocab_size"] = 32000
    (path / "config.json").write_text(json.dumps(cfg))
    with pytest.raises(ValueError, match="pad_token_id 32001 lies outside"):
        get_model("llava-1.5-7b", pretrained=str(path), dtype="float32", device="cpu")


# --------------------------------------------------------------------- anyres


PINPOINTS = [[336, 672], [672, 336], [672, 672], [1008, 336], [336, 1008]]
ORIG_SIZES = [(336, 336), (480, 640), (640, 480), (1000, 200), (200, 1000), (672, 672), (333, 1001), (17, 23)]


def test_grid_pinpoints_and_selection_match_jax():
    for tile, max_tiles in [(336, 6), (384, 3), (28, 2)]:
        assert anyres.default_grid_pinpoints(tile, max_tiles) == jax_anyres.default_grid_pinpoints(tile, max_tiles)
    for pins in (PINPOINTS, jax_anyres.default_grid_pinpoints(384, 3)):
        for hw in ORIG_SIZES:
            assert anyres.select_best_resolution(hw, pins) == jax_anyres.select_best_resolution(hw, pins)
            assert anyres.anyres_grid_shape(hw, pins, 336) == jax_anyres.anyres_grid_shape(hw, pins, 336)


def test_resize_pad_and_tiles_match_jax():
    rng = np.random.RandomState(8)
    for h, w in [(97, 211), (211, 97), (50, 50)]:
        image = Image.fromarray(rng.randint(0, 255, (h, w, 3), dtype=np.uint8))
        for target in [(56, 112), (112, 56), (84, 84)]:
            got, want = anyres.resize_and_pad(image, target), jax_anyres.resize_and_pad(image, target)
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
            tiles, want_tiles = anyres.divide_to_patches(got, 28), jax_anyres.divide_to_patches(want, 28)
            assert len(tiles) == len(want_tiles) == (target[0] // 28) * (target[1] // 28)
            for a, b in zip(tiles, want_tiles):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("orig_hw", [(480, 640), (640, 480), (600, 200), (200, 600), (300, 301)])
def test_unpad_feature_matches_jax(orig_hw):
    feature = np.random.RandomState(9).randn(5, 48, 48).astype(np.float32)
    want = jax_anyres.unpad_feature(feature, orig_hw)
    got = anyres.unpad_feature(torch.from_numpy(feature), orig_hw)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("max_patches", [None, 9, 2, 1])
@pytest.mark.parametrize("newline", [True, False])
@pytest.mark.parametrize("orig_hw", [(480, 640), (300, 900), (1000, 300), (336, 336)])
def test_pack_anyres_features_matches_jax(max_patches, newline, orig_hw):
    """Packing, including ``max_patches``'s antialiased bilinear downscale
    (``jax.image.resize``), within 1e-5."""
    tile, patch = 336, 14
    side = tile // patch
    n_h, n_w = jax_anyres.anyres_grid_shape(orig_hw, PINPOINTS, tile)
    rng = np.random.RandomState(10)
    tiles = rng.randn(1 + n_h * n_w, side * side, 8).astype(np.float32)
    nl = rng.randn(8).astype(np.float32) if newline else None
    want = jax_anyres.pack_anyres_features(tiles, orig_hw, PINPOINTS, tile, patch, nl, max_patches=max_patches)
    got = anyres.pack_anyres_features(torch.from_numpy(tiles), orig_hw, PINPOINTS, tile, patch,
                                      None if nl is None else torch.from_numpy(nl), max_patches=max_patches)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("in_hw, out_hw", [((48, 72), (20, 31)), ((30, 30), (7, 11)), ((10, 12), (25, 30))])
def test_bilinear_resize_matches_jax_image_resize(in_hw, out_hw):
    x = np.random.RandomState(11).randn(3, *in_hw).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (3, *out_hw), method="bilinear"))
    got = anyres.resize_bilinear_antialiased(torch.from_numpy(x), out_hw)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
