"""The port's Idefics2 adapter (``models/idefics2.py``) against the JAX package.

The JAX adapter ``idefics2-tiny`` (float32, random init) has its tree
re-drawn from a numpy seed and carried into the port with ``jax_params``. On
one batch mixing 0-, 1- and 2-image requests of several aspects (the HF
variable-aspect preprocessing pads them to one H x W, so the tower takes
patch masks), ``generate_until`` gives the same tokens and strings and
``loglikelihood`` the same greedy flags and losses within ``LOSS_TOL`` = 1e-4,
by default, with the fixed-square path and with 4-crop splitting. The
``_preprocess_hf`` pixels are within 1e-5 of the JAX adapter's (as
``tests/test_idefics2_parity.py`` holds JAX to HF). The tiny HF checkpoint
of ``tests/test_checkpoint_matrix.py`` loads in both packages and gives the
same tokens and losses.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from lmms_owc_tpu.models import idefics2 as jax_adapter
from lmms_owc_tpu_torch import no_tf32
from lmms_owc_tpu_torch.models import MODELS, get_model
from lmms_owc_tpu_torch.models import idefics2 as adapter
from lmms_owc_tpu_torch.nn.layers import Int4Linear, Int8Linear
from tests.test_checkpoint_matrix import _build_idefics2
from tests.test_torch_onevision import _Task, _docs, _gen_requests, _ll_requests, generate_both
from tests.test_torch_siglip import redraw

LOSS_TOL = 1e-4
PIXEL_TOL = 1e-5


@pytest.fixture(autouse=True)
def _full_f32():
    no_tf32()


def _pair(seed: int, **kw):
    jax_model = jax_adapter.Idefics2(preset="idefics2-tiny", batch_size=4, random_init=True, dtype="float32", **kw)
    tree = redraw(jax.tree_util.tree_map(np.asarray, jax_model.params), np.random.default_rng(seed))
    jax_model.params = jax.tree_util.tree_map(jnp.asarray, tree)
    port = adapter.Idefics2(preset="idefics2-tiny", batch_size=4, dtype="float32", device="cpu", jax_params=tree,
                            **kw)
    docs = _docs(seed)
    for m in (jax_model, port):
        m.task_dict["smoke"] = _Task(docs)
    return jax_model, port, tree


@pytest.fixture(scope="module")
def tiny():
    return _pair(1)


@pytest.mark.parametrize("mode", ["hf_preprocess", "fixed_square", "splitting"])
def test_generate_until_identical(request, monkeypatch, mode):
    kw = {"fixed_square": {"image_size": 28}, "splitting": {"do_image_splitting": True}}.get(mode, {})
    jax_model, port, _ = request.getfixturevalue("tiny") if mode == "hf_preprocess" else _pair(2, **kw)
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


@pytest.mark.parametrize("size", [28, 980])
def test_preprocess_hf_matches_jax(tiny, monkeypatch, size):
    """Pixels within 1e-5, position ids and patch masks equal, at the tiny
    tower's 28 px and at idefics2-8b's 980 px edge budget."""
    jax_model, port, _ = tiny
    for model in (jax_model, port):
        vision = dataclasses.replace(model.config.vision, image_size=size)
        monkeypatch.setattr(model, "config", dataclasses.replace(model.config, vision=vision))
    rng = np.random.RandomState(7)
    images = [Image.fromarray(rng.randint(0, 255, (h, w, 3), dtype=np.uint8))
              for h, w in [(40, 40), (33, 57), (61, 29), (28, 90), (300, 120), (1200, 800)]]
    want = jax_model._preprocess_hf(images)
    got = port._preprocess_hf(images)
    assert got[0].shape == want[0].shape
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=PIXEL_TOL)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert got[2].min() == 0  # the batch is padded: the tower's mask has gaps


def test_fixed_square_and_splitting_match_jax(tiny):
    jax_model, port, _ = tiny
    images = _docs(5)[1]["images"]
    np.testing.assert_array_equal(port._preprocess(images), jax_model._preprocess(images))
    for model in (jax_model, port):
        model.do_image_splitting = True
    try:
        got, want = port._expand_visuals(images), jax_model._expand_visuals(images)
        assert [im.size for im in got] == [im.size for im in want] and len(got) == 10
    finally:
        for model in (jax_model, port):
            model.do_image_splitting = False


def test_configs_and_prompts_match_jax(tiny):
    jax_model, port, _ = tiny
    assert "idefics2-8b" in MODELS and "idefics2-tiny" in MODELS
    for preset in ("idefics2-8b", "idefics2-tiny"):
        assert adapter.PRESET_CONFIGS[preset] == jax_adapter.PRESET_CONFIGS[preset]
    for part in ("text", "vision", "perceiver"):
        assert dataclasses.asdict(getattr(port.config, part)) == dataclasses.asdict(getattr(jax_model.config, part))
    assert port.image_size == jax_model.image_size and port.hf_preprocess == jax_model.hf_preprocess
    messages = [{"role": "user", "content": "hi"}, {"role": "assistant", "content": "hello"}]
    assert port.apply_chat_template(messages) == jax_model.apply_chat_template(messages)
    assert port.chat_template == jax_model.chat_template == "idefics2"
    assert port.tokenizer_name == jax_model.tokenizer_name and port.eos_token_ids == jax_model.eos_token_ids
    for n in (0, 1, 2):
        assert port._build_prompt("Name it.", n) == jax_model._build_prompt("Name it.", n)
    ours, theirs = adapter._FallbackIdeficsTokenizer(32001), jax_adapter._FallbackIdeficsTokenizer(32001)
    for text in [port._build_prompt("What is this?", 2), "a<image>b", "", "  x  "]:
        for special in (True, False):
            assert ours.encode(text, special) == theirs.encode(text, special)
    assert ours.decode([1, 2, 3, 500]) == theirs.decode([1, 2, 3, 500])
    assert adapter.Idefics2._hf_resize_dims(1200, 800, 378, 980) == jax_adapter.Idefics2._hf_resize_dims(
        1200, 800, 378, 980)


@pytest.mark.parametrize("bits", [8, 4])
def test_random_init_quantized_on_the_device(bits):
    model = get_model("idefics2-tiny", device="cpu", dtype="float32",
                      **{"load_in_8bit" if bits == 8 else "load_in_4bit": True})
    cls = Int8Linear if bits == 8 else Int4Linear
    names = {n for n, m in model.model.named_modules() if isinstance(m, cls)}
    assert {"text.layers.0.q", "vision.layers.1.fc1", "modality_projection.gate", "perceiver.layers.0.o",
            "perceiver.layers.0.mlp.down"} <= names
    assert not any("patch_embed" in n for n in names)
    model.task_dict["smoke"] = _Task(_docs(2))
    out = model.generate_until(_gen_requests()[:2])
    assert len(out) == 2 and all(isinstance(o, str) for o in out)


def test_entry_points_run_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_model("idefics2-tiny")


# ----------------------------------------------------------------- checkpoint


@pytest.fixture(scope="module")
def checkpoint_pair(tmp_path_factory):
    path = tmp_path_factory.mktemp("tiny_idefics2")
    _build_idefics2(path)
    jax_model = jax_adapter.Idefics2(pretrained=str(path), preset="idefics2-tiny", batch_size=4, dtype="float32")
    port = adapter.Idefics2(pretrained=str(path), preset="idefics2-tiny", batch_size=4, dtype="float32",
                            device="cpu")
    docs = _docs(3)
    for m in (jax_model, port):
        m.task_dict["smoke"] = _Task(docs)
    return jax_model, port


def test_checkpoint_loads_alike_in_both_packages(checkpoint_pair, monkeypatch):
    jax_model, port = checkpoint_pair
    tree = jax.tree_util.tree_map(np.asarray, jax_model.params)
    np.testing.assert_array_equal(port.model.text.embed_tokens.numpy(), tree["text"]["embed_tokens"])
    np.testing.assert_array_equal(port.model.vision.patch_embed.weight.numpy(), tree["vision"]["patch_embed"]["w"].T)
    np.testing.assert_array_equal(port.model.perceiver.latents.numpy(), tree["perceiver"]["latents"])
    np.testing.assert_array_equal(port.model.perceiver.layers[0].mlp.gate.weight.numpy(),
                                  tree["perceiver"]["layers"][0]["mlp"]["gate"]["w"].T)
    np.testing.assert_array_equal(port.model.modality_projection.up.weight.numpy(),
                                  tree["modality_projection"]["up"]["w"].T)
    prompt = port._build_prompt("What is this?", 1)
    assert port.tokenizer.encode(prompt) == jax_model.tokenizer.encode(prompt)
    requests = _gen_requests()[:4]
    want, got, want_tokens, got_tokens = generate_both(monkeypatch, jax_model, port, requests)
    assert got == want
    for a, b in zip(got_tokens, want_tokens):
        np.testing.assert_array_equal(a, b)
    want_ll, got_ll = jax_model.loglikelihood(_ll_requests()), port.loglikelihood(_ll_requests())
    np.testing.assert_allclose([g[0] for g in got_ll], [w[0] for w in want_ll], rtol=0, atol=LOSS_TOL)
    assert [g[1] for g in got_ll] == [w[1] for w in want_ll]
