"""The port's CLIP (towers, scorer, image pipeline, image processor) against
the JAX package and ``transformers``.

A tiny random HF CLIP checkpoint, written as
``tests/test_pretrained_converters.py`` writes it (character-level BPE in
``vocab.json`` + ``merges.txt``, ``preprocessor_config.json`` at 28 px), goes
through ``ClipScorer.from_pretrained`` and ``pipelines.image.encode_clip``
of both packages: the logits agree within 1e-4 (f32 on both sides, TF32
off; the text heads are 6 wide, so the plain attention runs on both). The
towers carried across from JAX trees with ``clip_params_from_jax`` give the
JAX ``clip_vision_forward`` (pooled and at ``feature_layer=-2``) and
``clip_text_encode`` within 1e-5. The port's ``CLIPImageProcessor`` gives
``transformers``' pixels exactly on odd landscape and portrait sizes.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from lmms_owc_tpu.nn import clip as jax_clip
from lmms_owc_tpu_torch import no_tf32
from lmms_owc_tpu_torch.nn import clip
from lmms_owc_tpu_torch.ops.image import ClipImageProcessor

TEXTS = ["cat", "a dog ran", "The  QUICK brown fox!", "x"]
# Odd sizes, landscape and portrait, smaller and larger than the crop.
IMAGE_SIZES = [(40, 40), (33, 57), (61, 29), (13, 20), (301, 97)]
VISION = jax_clip.ClipVisionConfig(hidden_size=128, num_layers=3, num_heads=2, intermediate_size=256,
                                   image_size=56, patch_size=14, projection_dim=32)
TEXT = jax_clip.ClipTextConfig(vocab_size=60, hidden_size=128, num_layers=2, num_heads=2, intermediate_size=256,
                               max_position_embeddings=16, projection_dim=32, eos_token_id=1)


@pytest.fixture(autouse=True)
def _full_f32():
    no_tf32()


def _images(sizes, seed=0):
    rng = np.random.RandomState(seed)
    return [Image.fromarray(rng.randint(0, 255, (h, w, 3), dtype=np.uint8)) for h, w in sizes]


@pytest.fixture(scope="module")
def clip_checkpoint(tmp_path_factory) -> Path:
    """Tiny random HF CLIP checkpoint + character-level BPE tokenizer + processor
    (the JAX suite's recipe, with two merges so that BPE merges run)."""
    from transformers import CLIPConfig, CLIPImageProcessor, CLIPModel, CLIPProcessor, CLIPTokenizer

    path = tmp_path_factory.mktemp("tiny_clip")
    letters = list("abcdefghijklmnopqrstuvwxyz")
    tokens = ["<|startoftext|>", "<|endoftext|>"] + letters + [c + "</w>" for c in letters] + ["ca", "cat</w>"]
    (path / "vocab.json").write_text(json.dumps({t: i for i, t in enumerate(tokens)}))
    (path / "merges.txt").write_text("#version: 0.2\nc a\nca t</w>\n")
    tokenizer = CLIPTokenizer(str(path / "vocab.json"), str(path / "merges.txt"))
    image_processor = CLIPImageProcessor(size={"shortest_edge": 28}, crop_size={"height": 28, "width": 28})
    CLIPProcessor(image_processor=image_processor, tokenizer=tokenizer).save_pretrained(str(path))
    torch.manual_seed(2)
    config = CLIPConfig(
        vision_config=dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
                           image_size=28, patch_size=14),
        text_config=dict(vocab_size=len(tokens), hidden_size=24, num_hidden_layers=2, num_attention_heads=4,
                         intermediate_size=48, max_position_embeddings=32, bos_token_id=0, eos_token_id=1),
        projection_dim=20,
    )
    CLIPModel(config).eval().save_pretrained(str(path), safe_serialization=True)
    return path


def test_scorer_matches_jax(clip_checkpoint):
    images = _images(IMAGE_SIZES)
    want = jax_clip.ClipScorer.from_pretrained(str(clip_checkpoint)).score(images, TEXTS)
    scorer = clip.ClipScorer.from_pretrained(str(clip_checkpoint), device="cpu")
    got = scorer.score(images, TEXTS)
    assert got.dtype == np.float32 and got.shape == (len(images), len(TEXTS))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_scorer_inputs_match_the_auto_processor(clip_checkpoint):
    """Pixels and padded ids equal what ``AutoProcessor`` gives the JAX scorer."""
    from transformers import AutoProcessor

    images = _images(IMAGE_SIZES)
    hf = AutoProcessor.from_pretrained(str(clip_checkpoint))(images=images, text=TEXTS, return_tensors="np",
                                                              padding=True)
    scorer = clip.ClipScorer.from_pretrained(str(clip_checkpoint), device="cpu")
    np.testing.assert_array_equal(scorer.processor(images), hf["pixel_values"])
    np.testing.assert_array_equal(scorer.tokenizer(TEXTS)["input_ids"], hf["input_ids"])


def test_encode_clip_matches_jax(clip_checkpoint, monkeypatch):
    from lmms_owc_tpu.pipelines import image as jax_image
    from lmms_owc_tpu_torch.pipelines import image

    monkeypatch.setenv("LMMS_OWC_CLIP_PATH", str(clip_checkpoint))
    monkeypatch.setenv("LMMS_OWC_SCORING_DEVICE", "cpu")
    monkeypatch.setattr(image, "_clip", None)
    monkeypatch.setattr(jax_image, "_clip", None)
    images = _images(IMAGE_SIZES[:3], seed=1)
    got = image.encode_clip(images, TEXTS[:2])
    assert got.shape == (3, 2)
    np.testing.assert_allclose(got, jax_image.encode_clip(images, TEXTS[:2]), rtol=0, atol=1e-4)
    assert image._clip.device.type == "cpu"


def test_encode_clip_without_weights_raises(monkeypatch, tmp_path):
    from lmms_owc_tpu_torch.pipelines import image

    monkeypatch.setenv("LMMS_OWC_CLIP_PATH", str(tmp_path / "absent"))
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    monkeypatch.setattr(image, "_clip", None)
    with pytest.raises(RuntimeError, match="CLIP weights not found"):
        image.encode_clip(_images([(28, 28)]), ["cat"])


def test_entry_points_run_on_the_card_unless_asked(clip_checkpoint):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        clip.ClipScorer.from_pretrained(str(clip_checkpoint))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def vision_tree():
    return _np_tree(jax_clip.init_clip_vision_params(jax.random.PRNGKey(3), VISION))


def _config(cfg, cls):
    return cls(**vars(cfg))


@pytest.mark.parametrize("feature_layer", [None, -2, -1])
def test_vision_forward_matches_jax(vision_tree, feature_layer):
    pixels = np.random.RandomState(4).randn(3, 3, 56, 56).astype(np.float32)
    want = np.asarray(jax_clip.clip_vision_forward(
        jax.tree_util.tree_map(jnp.asarray, vision_tree), jnp.asarray(pixels), VISION, feature_layer=feature_layer))
    tower = clip.clip_params_from_jax(vision_tree, _config(VISION, clip.ClipVisionConfig))["vision"]
    got = clip.clip_vision_forward(tower, torch.from_numpy(pixels), tower.config, feature_layer=feature_layer)
    expected_shape = (3, 32) if feature_layer is None else (3, 17, 128)
    assert tuple(got.shape) == want.shape == expected_shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_text_encode_matches_jax():
    """The JAX text tree from its HF converter (no JAX text init exists)."""
    from transformers import CLIPConfig, CLIPModel

    torch.manual_seed(5)
    config = CLIPConfig(
        vision_config=dict(hidden_size=32, num_hidden_layers=1, num_attention_heads=2, intermediate_size=64,
                           image_size=28, patch_size=14),
        text_config=dict(vocab_size=TEXT.vocab_size, hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
                         intermediate_size=256, max_position_embeddings=16, eos_token_id=1),
        projection_dim=32,
    )
    state = {k: v.numpy() for k, v in CLIPModel(config).eval().state_dict().items()}
    vcfg = jax_clip.ClipVisionConfig(hidden_size=32, num_layers=1, num_heads=2, intermediate_size=64,
                                     image_size=28, patch_size=14, projection_dim=32)
    tree = jax_clip.convert_hf_clip_weights(state, vcfg, TEXT)
    ids = np.random.RandomState(6).randint(2, TEXT.vocab_size, (4, 11))
    ids[0, 3], ids[1, 10], ids[2, 5:] = 1, 1, 1  # first EOS at 3, at the end, then padding
    want = np.asarray(jax_clip.clip_text_encode(tree["text"], jnp.asarray(ids), TEXT))
    text = clip.clip_params_from_jax(None, text_tree=_np_tree(tree["text"]),
                                     text_config=_config(TEXT, clip.ClipTextConfig))["text"]
    got = clip.clip_text_encode(text, torch.from_numpy(ids), text.config)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    # The HF converter of the port fills the same modules from the same tensors.
    ported = clip.convert_hf_clip_weights({k: torch.from_numpy(v) for k, v in state.items()},
                                          _config(vcfg, clip.ClipVisionConfig), text.config)
    np.testing.assert_allclose(clip.clip_text_encode(ported["text"], torch.from_numpy(ids), text.config).numpy(),
                               want, rtol=0, atol=1e-5)


def test_init_params_distribution():
    gen = torch.Generator().manual_seed(0)
    tower = clip.init_clip_vision_params(_config(VISION, clip.ClipVisionConfig), gen)
    assert torch.all(tower.pre_ln.weight == 1) and torch.all(tower.layers[0].q.bias == 0)
    assert 0.015 < float(tower.layers[1].fc1.weight.std()) < 0.025
    assert 0.015 < float(tower.position_embedding.std()) < 0.025


@pytest.mark.parametrize("shortest_edge, crop", [(28, 28), (224, 224), (336, 336), (64, 48)])
def test_image_processor_matches_transformers(tmp_path, shortest_edge, crop):
    from transformers import CLIPImageProcessor

    CLIPImageProcessor(size={"shortest_edge": shortest_edge},
                       crop_size={"height": crop, "width": crop}).save_pretrained(str(tmp_path))
    ours = ClipImageProcessor.from_pretrained(tmp_path)
    hf = CLIPImageProcessor.from_pretrained(str(tmp_path))
    images = _images(IMAGE_SIZES + [(crop, crop), (500, 333)], seed=7)
    want = hf(images=images, return_tensors="np")["pixel_values"]
    got = ours(images)
    assert got.dtype == np.float32 and got.shape == want.shape == (len(images), 3, crop, crop)
    np.testing.assert_array_equal(got, want)
