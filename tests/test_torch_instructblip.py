"""The port's InstructBLIP (``nn/instructblip.py``, ``models/instructblip.py``) against the JAX package.

Modules: the JAX tree of ``init_instructblip_params`` (float32) is re-drawn
from a numpy seed and carried into the port with
``instructblip_params_from_jax``; on numpy pixels and instruction ids from a
seed the BLIP ViT, the Q-Former (padded instructions, cross-attention every
layer and every other layer) and ``encode_image_queries`` agree with the JAX
functions within ``TOL`` = 1e-4 (float32 in, float32 out: summation order
only), as ``tests/test_instructblip_parity.py`` holds JAX to HF. The
Q-Former's attention launches no kernel. Adapter: the JAX
``instructblip-tiny`` (float32, random init, re-drawn tree) and the port's
over the same tree give the same tokens and strings from ``generate_until``
(rows without an image, several images on one canvas), and
``loglikelihood`` the same greedy flags and losses within ``LOSS_TOL`` =
1e-4. The tiny HF checkpoint of ``tests/test_checkpoint_matrix.py`` (its
``qformer_tokenizer/`` read by the port's WordPiece tokenizer) loads in both
packages to the same weights, tokens and losses.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from lmms_owc_tpu.models import instructblip as jax_adapter
from lmms_owc_tpu.nn import instructblip as jib
from lmms_owc_tpu_torch import no_tf32
from lmms_owc_tpu_torch.models import MODELS, get_model
from lmms_owc_tpu_torch.models import instructblip as adapter
from lmms_owc_tpu_torch.nn import instructblip as ib
from lmms_owc_tpu_torch.nn.layers import Int4Linear, Int8Linear
from lmms_owc_tpu_torch.ops import attention as att
from tests.test_checkpoint_matrix import _build_instructblip
from tests.test_torch_onevision import _Task, _docs, _gen_requests, _ll_requests, generate_both
from tests.test_torch_siglip import redraw

TOL = 1e-4
LOSS_TOL = 1e-4
REGISTERED = ("instructblip-vicuna-7b", "instructblip-vicuna-13b", "instructblip-tiny")

HF_CONFIG = dict(
    vision_config=dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
                       image_size=28, patch_size=14),
    qformer_config=dict(hidden_size=24, num_hidden_layers=3, num_attention_heads=4, intermediate_size=48,
                        encoder_hidden_size=32, cross_attention_frequency=1, vocab_size=64),
    text_config=dict(model_type="llama", vocab_size=256, hidden_size=48, intermediate_size=96, num_hidden_layers=2,
                     num_attention_heads=4, num_key_value_heads=2, rope_theta=10000.0, rms_norm_eps=1e-6,
                     tie_word_embeddings=False),
    num_query_tokens=4,
)


@pytest.fixture(autouse=True)
def _full_f32():
    no_tf32()


@pytest.fixture(scope="module", params=[1, 2], ids=["cross_every_layer", "cross_every_other"])
def modules(request):
    hf = dict(HF_CONFIG, qformer_config=dict(HF_CONFIG["qformer_config"], cross_attention_frequency=request.param))
    cfg_j, cfg_t = jib.instructblip_config_from_hf(hf), ib.instructblip_config_from_hf(hf)
    tree = jib.init_instructblip_params(jax.random.PRNGKey(0), cfg_j, jnp.float32)
    tree = redraw(jax.tree_util.tree_map(np.asarray, tree), np.random.default_rng(request.param))
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    return cfg_j, cfg_t, params, ib.instructblip_params_from_jax(tree, cfg_t), tree


def _inputs(seed: int, n: int = 3):
    rng = np.random.RandomState(seed)
    pixels = rng.randn(n, 3, 28, 28).astype(np.float32)
    ids = rng.randint(0, 64, (n, 9)).astype(np.int64)
    mask = np.ones_like(ids)
    for row, length in enumerate([9, 5, 2][:n]):  # right-padded instructions
        mask[row, length:] = 0
        ids[row, length:] = 0
    return pixels, ids, mask


def test_configs_match_jax(modules):
    cfg_j, cfg_t, *_ = modules
    for part in ("vision", "qformer", "text"):
        assert dataclasses.asdict(getattr(cfg_t, part)) == dataclasses.asdict(getattr(cfg_j, part))
    assert cfg_t.num_query_tokens == cfg_j.num_query_tokens == 4


def test_blip_vision_matches_jax(modules):
    cfg_j, cfg_t, params, model, _ = modules
    pixels, _, _ = _inputs(0)
    want = jib.blip_vision_forward(params["vision"], jnp.asarray(pixels), cfg_j.vision)
    got = ib.blip_vision_forward(model.vision, torch.from_numpy(pixels), cfg_t.vision)
    assert got.shape == (3, 5, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_qformer_matches_jax_and_launches_nothing(modules):
    cfg_j, cfg_t, params, model, _ = modules
    pixels, ids, mask = _inputs(1)
    vision = np.random.RandomState(2).randn(3, 5, 32).astype(np.float32)
    want = jib.qformer_forward(params["qformer"], jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(vision),
                               cfg_j.qformer, num_query_tokens=4)
    att.reset_launch_counts()
    got = ib.qformer_forward(model.qformer, torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(vision),
                             cfg_t.qformer, num_query_tokens=4)
    assert not any(att.launch_counts.values())
    assert got.shape == (3, 4, 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_encode_image_queries_matches_jax(modules):
    cfg_j, cfg_t, params, model, _ = modules
    pixels, ids, mask = _inputs(3)
    want = jib.encode_image_queries(params, jnp.asarray(pixels), jnp.asarray(ids), jnp.asarray(mask), cfg_j)
    got = ib.encode_image_queries(model, torch.from_numpy(pixels), torch.from_numpy(ids), torch.from_numpy(mask),
                                  cfg_t)
    assert got.shape == (3, 4, 48)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_params_from_jax_copies_every_leaf(modules):
    _, cfg_t, _, model, tree = modules
    vt, qt = tree["vision"], tree["qformer"]
    np.testing.assert_array_equal(model.vision.patch_embed.weight.numpy(), vt["patch_embed"]["w"].T)
    np.testing.assert_array_equal(model.vision.class_embedding.numpy(), vt["class_embedding"])
    np.testing.assert_array_equal(model.vision.layers[1].qkv.weight.numpy(), vt["layers"]["qkv"]["w"][1].T)
    np.testing.assert_array_equal(model.qformer.query_tokens.numpy(), qt["query_tokens"])
    np.testing.assert_array_equal(model.qformer.word_embeddings.numpy(), qt["word_embeddings"])
    np.testing.assert_array_equal(model.qformer.layers[0].cross_attn.k.weight.numpy(),
                                  qt["layers"][0]["cross_attn"]["k"]["w"].T)
    np.testing.assert_array_equal(model.qformer.layers[2].output_query_ln.bias.numpy(),
                                  qt["layers"][2]["output_query_ln"]["bias"])
    np.testing.assert_array_equal(model.language_projection.weight.numpy(), tree["language_projection"]["w"].T)
    assert [layer.cross_attn is not None for layer in model.qformer.layers] == [
        "cross_attn" in layer for layer in qt["layers"]]
    n_params = sum(np.size(leaf) for leaf in jax.tree_util.tree_leaves(tree))
    assert sum(p.numel() for p in model.parameters()) == n_params


# -------------------------------------------------------------------- adapter


def _pair(seed: int):
    jax_model = jax_adapter.InstructBlip(preset="instructblip-tiny", batch_size=4, random_init=True, dtype="float32")
    tree = redraw(jax.tree_util.tree_map(np.asarray, jax_model.params), np.random.default_rng(seed))
    jax_model.params = jax.tree_util.tree_map(jnp.asarray, tree)
    port = adapter.InstructBlip(preset="instructblip-tiny", batch_size=4, dtype="float32", device="cpu",
                                jax_params=tree)
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


def test_loglikelihood_matches_jax(tiny):
    jax_model, port, _ = tiny
    want, got = jax_model.loglikelihood(_ll_requests()), port.loglikelihood(_ll_requests())
    assert len(got) == len(want) == 5
    np.testing.assert_allclose([g[0] for g in got], [w[0] for w in want], rtol=0, atol=LOSS_TOL)
    assert [g[1] for g in got] == [w[1] for w in want]


def test_preprocess_and_canvas_match_jax(tiny):
    jax_model, port, _ = tiny
    images = _docs(5)[1]["images"]
    for visuals in (images[:1], images):
        np.testing.assert_array_equal(port._preprocess(visuals), jax_model._preprocess(visuals))
    assert port._preprocess([]) is None and jax_model._preprocess([]) is None
    imgs = [Image.new("RGB", (32, 32), (255, 0, 0)), Image.new("RGB", (48, 40), (0, 255, 0))]
    got, want = adapter.concatenate_images_with_labels(imgs), jax_adapter.concatenate_images_with_labels(imgs)
    assert got.size == want.size == (32 + 48 + 8, 40)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_configs_and_tokenizers_match_jax(tiny):
    jax_model, port, _ = tiny
    from lmms_owc_tpu.models import MODELS as JAX_MODELS

    for name in REGISTERED:
        assert name in MODELS and name in JAX_MODELS
    assert adapter.PRESET_CONFIGS == jax_adapter.PRESET_CONFIGS
    for part in ("vision", "qformer", "text"):
        assert dataclasses.asdict(getattr(port.config, part)) == dataclasses.asdict(getattr(jax_model.config, part))
    assert port.pad_token_id == jax_model.decoder_config.pad_token_id
    messages = [{"role": "user", "content": "hi"}, {"role": "assistant", "content": "hello"}]
    assert port.apply_chat_template(messages) == jax_model.apply_chat_template(messages)
    assert port.tokenizer_name == jax_model.tokenizer_name and port.eos_token_ids == jax_model.eos_token_ids
    for text in ["What is this?", "", "  a  b c ", "Describe the weather in detail please."]:
        assert port._qformer_encode(text) == jax_model._qformer_encode(text)
        for special in (True, False):
            assert port.tokenizer.encode(text, special) == jax_model.tokenizer.encode(text, special)
    assert port.tokenizer.decode([1, 2, 3, 500]) == jax_model.tokenizer.decode([1, 2, 3, 500])


def test_registrations_build_their_presets(monkeypatch):
    built = []
    monkeypatch.setattr(adapter, "InstructBlip", lambda **kw: built.append(kw["preset"]))
    for name in REGISTERED:
        get_model(name)
    assert built == ["instructblip-vicuna-7b", "instructblip-vicuna-7b", "instructblip-tiny"]
    cfg = ib.instructblip_config_from_hf(adapter.PRESET_CONFIGS["instructblip-vicuna-7b"])
    assert (cfg.vision.num_layers, cfg.vision.num_heads, cfg.vision.hidden_size // cfg.vision.num_heads) == (39, 16, 88)
    assert (cfg.text.num_heads, cfg.text.num_kv_heads) == (32, 32) and cfg.num_query_tokens == 32


@pytest.mark.parametrize("bits", [8, 4])
def test_random_init_quantized_on_the_device(bits):
    model = get_model("instructblip-tiny", device="cpu", dtype="float32",
                      **{"load_in_8bit" if bits == 8 else "load_in_4bit": True})
    cls = Int8Linear if bits == 8 else Int4Linear
    names = {n for n, m in model.model.named_modules() if isinstance(m, cls)}
    assert {"text.layers.0.q", "vision.layers.1.qkv", "qformer.layers.0.cross_attn.q", "language_projection"} <= names
    assert not any("patch_embed" in n for n in names)
    model.task_dict["smoke"] = _Task(_docs(2))
    out = model.generate_until(_gen_requests()[:2])
    assert len(out) == 2 and all(isinstance(o, str) for o in out)


def test_entry_points_run_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_model("instructblip-tiny")


# ----------------------------------------------------------------- checkpoint


@pytest.fixture(scope="module")
def checkpoint_pair(tmp_path_factory):
    path = tmp_path_factory.mktemp("tiny_instructblip")
    _build_instructblip(path)
    jax_model = jax_adapter.InstructBlip(pretrained=str(path), preset="instructblip-tiny", batch_size=4,
                                         dtype="float32")
    port = adapter.InstructBlip(pretrained=str(path), preset="instructblip-tiny", batch_size=4, dtype="float32",
                                device="cpu")
    docs = _docs(3)
    for m in (jax_model, port):
        m.task_dict["smoke"] = _Task(docs)
    return jax_model, port


def test_checkpoint_loads_alike_in_both_packages(checkpoint_pair, monkeypatch):
    jax_model, port = checkpoint_pair
    tree = jax.tree_util.tree_map(np.asarray, jax_model.params)
    np.testing.assert_array_equal(port.model.text.embed_tokens.numpy(), tree["text"]["embed_tokens"])
    np.testing.assert_array_equal(port.model.vision.layers[0].qkv.bias.numpy(), tree["vision"]["layers"]["qkv"]["b"][0])
    np.testing.assert_array_equal(port.model.vision.position_embedding.numpy(), tree["vision"]["position_embedding"])
    np.testing.assert_array_equal(port.model.qformer.query_tokens.numpy(), tree["qformer"]["query_tokens"])
    np.testing.assert_array_equal(port.model.qformer.layers[1].self_attn.v.weight.numpy(),
                                  tree["qformer"]["layers"][1]["self_attn"]["v"]["w"].T)
    assert port.qformer_tokenizer is not None and jax_model.qformer_tokenizer is not None
    for text in ["What is this?", "tok3 tok7 unknownword", "x " * 700]:  # the last is cut to 512 ids
        assert port._qformer_encode(text) == jax_model._qformer_encode(text)
        assert port.tokenizer.encode(text) == jax_model.tokenizer.encode(text)
    assert (port.pad_token_id, port.tokenizer.eos_token_id) == (0, 2)  # inside the 512-token vocabulary
    requests = _gen_requests()[:4]
    want, got, want_tokens, got_tokens = generate_both(monkeypatch, jax_model, port, requests)
    assert got == want
    for a, b in zip(got_tokens, want_tokens):
        np.testing.assert_array_equal(a, b)
    want_ll, got_ll = jax_model.loglikelihood(_ll_requests()), port.loglikelihood(_ll_requests())
    assert np.isfinite([w[0] for w in want_ll]).all()
    np.testing.assert_allclose([g[0] for g in got_ll], [w[0] for w in want_ll], rtol=0, atol=LOSS_TOL)
    assert [g[1] for g in got_ll] == [w[1] for w in want_ll]
