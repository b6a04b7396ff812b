"""The port's LLaVA-OneVision adapter (``models/llava_onevision.py``) against the JAX package.

The JAX adapter ``llava-onevision-tiny`` (float32, random init) has its tree
re-drawn from a numpy seed (weights large enough that greedy tokens vary)
and carried into the port with ``jax_params``; on the same requests, one
batch mixing 0-, 1- and 2-image requests of several aspects (anyres tiles,
unpadding and the ``anyres_max_9`` downscale), ``generate_until`` gives the
same tokens and strings, and ``loglikelihood`` the same greedy flags and
losses within ``LOSS_TOL`` = 1e-4 (as ``tests/test_torch_llava.py``). One
image's packed features agree within 1e-5. The tiny HF checkpoint of
``tests/test_checkpoint_matrix.py`` loads in both packages and gives the same
tokens and losses.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from lmms_owc_tpu.models import llava_onevision as jax_adapter
from lmms_owc_tpu_torch import no_tf32
from lmms_owc_tpu_torch.models import MODELS, get_model
from lmms_owc_tpu_torch.models import llava_onevision as adapter
from lmms_owc_tpu_torch.nn.layers import Int4Linear, Int8Linear
from tests.test_checkpoint_matrix import _build_llava_onevision
from tests.test_torch_siglip import redraw

LOSS_TOL = 1e-4
GEN = {"max_new_tokens": 8, "do_sample": False, "until": None}
PRESETS = ("llava-onevision-qwen2-7b-ov", "llava-onevision-qwen2-7b-si", "llava-onevision-qwen2-0.5b-ov",
           "llava-onevision-qwen2-0.5b-si", "llava-onevision-tiny")


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
    counts = [2, 0, 1, 1, 2, 1]
    prompts = ["What is this?", "Describe the weather.", "Name the object.", "Colour?", "Compare them.", "Is it red?"]
    return [_Req((p, GEN, _visuals(n), i % 4, "smoke", "test")) for i, (p, n) in enumerate(zip(prompts, counts))]


def _ll_requests():
    return [_Req(("What is this?", " a cat", _visuals(n), i, "smoke", "test")) for i, n in enumerate([2, 0, 1, 1])] + [
        _Req(("hello", " world"))]


def _attach(models, docs):
    for m in models:
        m.task_dict["smoke"] = _Task(docs)


@pytest.fixture(scope="module")
def tiny():
    jax_model = jax_adapter.LlavaOnevision(preset="llava-onevision-tiny", batch_size=4, random_init=True,
                                           dtype="float32")
    tree = redraw(jax.tree_util.tree_map(np.asarray, jax_model.params), np.random.default_rng(1))
    jax_model.params = jax.tree_util.tree_map(jnp.asarray, tree)
    port = adapter.LlavaOnevision(preset="llava-onevision-tiny", batch_size=4, dtype="float32", device="cpu",
                                  jax_params=tree)
    _attach((jax_model, port), _docs(1))
    return jax_model, port, tree


def _spy(monkeypatch, module, calls: list):
    real = module.greedy_generate

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append(np.asarray(out))
        return out

    monkeypatch.setattr(module, "greedy_generate", spy)


def generate_both(monkeypatch, jax_model, port, requests):
    """Both adapters' strings and the token arrays their decoders produced."""
    from lmms_owc_tpu.nn import llama as jax_llama
    from lmms_owc_tpu_torch.nn import qwen2_vl as port_decoder

    want_tokens, got_tokens = [], []
    _spy(monkeypatch, jax_llama, want_tokens)
    _spy(monkeypatch, port_decoder, got_tokens)
    return jax_model.generate_until(requests), port.generate_until(requests), want_tokens, got_tokens


def test_generate_until_identical(tiny, monkeypatch):
    jax_model, port, _ = tiny
    want, got, want_tokens, got_tokens = generate_both(monkeypatch, jax_model, port, _gen_requests())
    assert got == want and len(got) == 6
    assert len(got_tokens) == len(want_tokens) == 2
    for a, b in zip(got_tokens, want_tokens):
        np.testing.assert_array_equal(a, b)
    assert len(set(np.concatenate(got_tokens).ravel())) > 2  # the tokens vary


def test_loglikelihood_matches_jax(tiny):
    jax_model, port, _ = tiny
    want, got = jax_model.loglikelihood(_ll_requests()), port.loglikelihood(_ll_requests())
    assert len(got) == len(want) == 5
    np.testing.assert_allclose([g[0] for g in got], [w[0] for w in want], rtol=0, atol=LOSS_TOL)
    assert [g[1] for g in got] == [w[1] for w in want]


def test_packed_features_match_jax(tiny):
    """One image's anyres tiles through the tower, projector and packing
    (unpadding, the newline column, the anyres_max_9 downscale)."""
    jax_model, port, _ = tiny
    for image in _docs(4)[1]["images"] + _docs(4)[3]["images"] + [Image.new("RGB", (200, 90), (10, 200, 30))]:
        want = jax_model._encode_one_image(image)
        got = port._encode_one_image(image)
        assert tuple(got.shape) == want.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_prepared_ids_match_jax(tiny):
    jax_model, port, _ = tiny
    for req in _gen_requests():
        want_ids, want_feats = jax_model._prepare(req.args)
        got_ids, got_feats = port._prepare(req.args[0], *req.args[2:6])
        assert got_ids == want_ids and len(got_feats) == len(want_feats)


def test_configs_and_prompts_match_jax(tiny):
    jax_model, port, _ = tiny
    for preset in PRESETS:
        assert preset in MODELS
    for preset in ("llava-onevision-qwen2-7b-ov", "llava-onevision-qwen2-0.5b-ov", "llava-onevision-tiny"):
        assert adapter.PRESET_CONFIGS[preset] == jax_adapter.PRESET_CONFIGS[preset]
    assert dataclasses.asdict(port.vision_config) == dataclasses.asdict(jax_model.vision_config)
    assert dataclasses.asdict(port.text_config) == dataclasses.asdict(jax_model.text_config)
    assert (port.max_patches, port.grid_pinpoints, port.image_token_id, port.text_attn_bias) == (
        jax_model.max_patches, jax_model.grid_pinpoints, jax_model.image_token_id, jax_model.text_attn_bias)
    assert port.decoder_config.pad_token_id == jax_model.decoder_config.pad_token_id
    messages = [{"role": "user", "content": "hi"}, {"role": "assistant", "content": "hello"}]
    assert port.apply_chat_template(messages) == jax_model.apply_chat_template(messages)
    assert port.chat_template == jax_model.chat_template == "qwen_ov"
    assert port.tokenizer_name == jax_model.tokenizer_name
    assert port.eos_token_ids == jax_model.eos_token_ids
    for n in (0, 1, 2):
        assert port._build_prompt("Name it.", n) == jax_model._build_prompt("Name it.", n)
    ours, theirs = adapter._FallbackOVTokenizer(151646), jax_adapter._FallbackOVTokenizer(151646)
    for text in [port._build_prompt("What is this?", 2), "a<image>b", "", "  x  "]:
        assert ours.encode(text) == theirs.encode(text)
    assert ours.decode([1, 2, 500]) == theirs.decode([1, 2, 500])


@pytest.mark.parametrize("bits", [8, 4])
def test_random_init_quantized_on_the_device(bits):
    model = get_model("llava-onevision-tiny", device="cpu", dtype="float32",
                      **{"load_in_8bit" if bits == 8 else "load_in_4bit": True})
    cls = Int8Linear if bits == 8 else Int4Linear
    names = {n for n, m in model.model.named_modules() if isinstance(m, cls)}
    assert {"text.layers.0.q", "vision.layers.1.fc2", "projector.fc1"} <= names
    assert not any("patch_embed" in n for n in names)
    assert float(model.model.image_newline.abs().sum()) == 0.0
    model.task_dict["smoke"] = _Task(_docs(2))
    out = model.generate_until(_gen_requests()[:2])
    assert len(out) == 2 and all(isinstance(o, str) for o in out)


def test_entry_points_run_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_model("llava-onevision-tiny")


# ----------------------------------------------------------------- checkpoint


@pytest.fixture(scope="module")
def checkpoint_pair(tmp_path_factory):
    path = tmp_path_factory.mktemp("tiny_onevision")
    _build_llava_onevision(path)
    jax_model = jax_adapter.LlavaOnevision(pretrained=str(path), preset="llava-onevision-tiny", batch_size=4,
                                           dtype="float32")
    port = adapter.LlavaOnevision(pretrained=str(path), preset="llava-onevision-tiny", batch_size=4,
                                  dtype="float32", device="cpu")
    _attach((jax_model, port), _docs(3))
    return jax_model, port


def test_checkpoint_loads_alike_in_both_packages(checkpoint_pair, monkeypatch):
    jax_model, port = checkpoint_pair
    assert (port.max_patches, port.grid_pinpoints, port.image_token_id) == (4, [[56, 56], [56, 112], [112, 56],
                                                                             [112, 112]], 500)
    tree = jax.tree_util.tree_map(np.asarray, jax_model.params)
    np.testing.assert_array_equal(port.model.text.embed_tokens.numpy(), tree["text"]["embed_tokens"])
    np.testing.assert_array_equal(port.model.vision.layers[1].q.weight.numpy(),
                                  tree["vision"]["layers"]["attn"]["q"]["w"][1].T)
    np.testing.assert_array_equal(port.model.projector.fc2.bias.numpy(), tree["projector"]["fc2"]["b"])
    np.testing.assert_array_equal(port.model.image_newline.numpy(), tree["image_newline"])
    requests = _gen_requests()[:4]
    for req in requests:
        want_ids, _ = jax_model._prepare(req.args)
        assert port._prepare(req.args[0], *req.args[2:6])[0] == want_ids
    want, got, want_tokens, got_tokens = generate_both(monkeypatch, jax_model, port, requests)
    assert got == want
    for a, b in zip(got_tokens, want_tokens):
        np.testing.assert_array_equal(a, b)
    want_ll, got_ll = jax_model.loglikelihood(_ll_requests()), port.loglikelihood(_ll_requests())
    np.testing.assert_allclose([g[0] for g in got_ll], [w[0] for w in want_ll], rtol=0, atol=LOSS_TOL)
    assert [g[1] for g in got_ll] == [w[1] for w in want_ll]
