"""The port's sentence encoder (MiniLM/BERT) and WordPiece tokenizer against
the JAX package and ``transformers``.

A tiny HF BERT checkpoint, written as ``tests/test_pretrained_converters.py``
writes it (``vocab.txt`` and ``tokenizer_config.json``, no ``tokenizer.json``),
goes through ``SentenceEncoder.from_pretrained`` of both packages; the
embeddings agree within 1e-5 (f32 on both sides, TF32 off). The port's
WordPiece gives ``BertTokenizer``'s and ``BertTokenizerFast``'s ids on
sentences with punctuation, accents, CJK characters, unknown words and
truncation, from ``vocab.txt`` and from ``tokenizer.json``. The JAX
parameter tree carried across with ``sbert_params_from_jax`` encodes as the
JAX ``sbert_encode`` does, and the new layers (``mlp_gelu``,
``multi_head_attention``) equal the JAX ones.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmms_owc_tpu.nn import layers as jax_layers
from lmms_owc_tpu.nn import sbert as jax_sbert
from lmms_owc_tpu_torch import no_tf32
from lmms_owc_tpu_torch.nn import layers
from lmms_owc_tpu_torch.nn import sbert
from lmms_owc_tpu_torch.tokenizer import WordPieceTokenizer

BERT_VOCAB = (
    ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    + ["the", "cat", "sat", "on", "a", "mat", "dog", "ran", "fast", "bird", "flew"]
    + ["##s", "##ing", "blue", "red", "sky", "grass", "over", "jumped", "lazy", "quick"]
)
SENTENCES = [
    "the cat sat on a mat",
    "a quick dog jumped over the lazy dog",
    "red sky",
    "birds flew fast over blue grass",
    "zebra!! cat, dog.",
]
# WordPiece cases: punctuation, accents, CJK characters, unknown words, runs of
# spaces and tabs, a special token in the text, and (with max_length) truncation.
TOKENIZER_VOCAB = BERT_VOCAB + [
    ".", ",", "!", "?", "(", ")", "'", "-", "cafe", "naive", "中", "文", "un", "##known", "12", "##3", "don", "t",
    "s", "resume",
]
TOKENIZER_TEXTS = [
    "The cats sat on a mat.", "Café, CAFÉ! naïve? résumés", "中文 and 中X文", "unknown unknowns (123)",
    "Don't stop-the-cat", "  spaced\tout\n text ", "[MASK] the cat", "the " * 40, "", "a" * 120 + " cat",
]


@pytest.fixture(autouse=True)
def _full_f32():
    no_tf32()


def write_bert_checkpoint(path: Path, fast: bool = False) -> Path:
    """Tiny random HF BERT checkpoint (the JAX suite's recipe); with ``fast``
    the tokenizer is saved as a ``tokenizer.json``."""
    from transformers import BertConfig, BertModel, BertTokenizer, BertTokenizerFast

    (path / "vocab.txt").write_text("\n".join(BERT_VOCAB) + "\n")
    (BertTokenizerFast if fast else BertTokenizer)(str(path / "vocab.txt")).save_pretrained(str(path))
    torch.manual_seed(0)
    config = BertConfig(vocab_size=len(BERT_VOCAB), hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                        intermediate_size=64, max_position_embeddings=64, type_vocab_size=2, layer_norm_eps=1e-12)
    BertModel(config).eval().save_pretrained(str(path), safe_serialization=True)
    return path


@pytest.fixture(scope="module")
def bert_checkpoint(tmp_path_factory) -> Path:
    return write_bert_checkpoint(tmp_path_factory.mktemp("tiny_bert"))


@pytest.mark.parametrize("fast", [False, True])
def test_from_pretrained_matches_jax(tmp_path, fast):
    path = write_bert_checkpoint(tmp_path, fast)
    assert (path / "tokenizer.json").exists() == fast
    want = jax_sbert.SentenceEncoder.from_pretrained(str(path)).encode(SENTENCES)
    enc = sbert.SentenceEncoder.from_pretrained(str(path), device="cpu")
    hf = json.loads((path / "config.json").read_text())
    assert enc.config == sbert.SbertConfig(**vars(jax_sbert.sbert_config_from_hf(hf)))
    got = enc.encode(SENTENCES)
    assert got.dtype == np.float32 and got.shape == (len(SENTENCES), 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def test_batch_and_length_invariance(bert_checkpoint):
    """Batched (one length bucket for all rows) equals one sentence at a time."""
    enc = sbert.SentenceEncoder.from_pretrained(str(bert_checkpoint), device="cpu")
    batched = enc.encode(SENTENCES, batch_size=2)
    singles = np.concatenate([enc.encode([s]) for s in SENTENCES])
    np.testing.assert_allclose(batched, singles, rtol=0, atol=1e-5)


def test_entry_points_run_on_the_card_unless_asked(bert_checkpoint):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sbert.SentenceEncoder.from_pretrained(str(bert_checkpoint))


@pytest.mark.parametrize("form", ["vocab.txt", "tokenizer.json"])
@pytest.mark.parametrize("max_length", [512, 9])
def test_wordpiece_matches_transformers(tmp_path, form, max_length):
    from transformers import BertTokenizer, BertTokenizerFast

    (tmp_path / "vocab.txt").write_text("\n".join(TOKENIZER_VOCAB) + "\n")
    cls = BertTokenizer if form == "vocab.txt" else BertTokenizerFast
    cls(str(tmp_path / "vocab.txt")).save_pretrained(str(tmp_path / "tok"))
    ours = WordPieceTokenizer.from_pretrained(tmp_path / "tok")
    slow = BertTokenizer(str(tmp_path / "vocab.txt"))
    fast = BertTokenizerFast(str(tmp_path / "vocab.txt"))
    for text in TOKENIZER_TEXTS:
        want = slow(text, truncation=True, max_length=max_length)["input_ids"]
        assert fast(text, truncation=True, max_length=max_length)["input_ids"] == want
        assert ours.encode(text, max_length=max_length) == want, text
    enc = ours(TOKENIZER_TEXTS, max_length=max_length)
    ref = fast(TOKENIZER_TEXTS, padding=True, truncation=True, max_length=max_length, return_tensors="np")
    np.testing.assert_array_equal(enc["input_ids"], ref["input_ids"])
    np.testing.assert_array_equal(enc["attention_mask"], ref["attention_mask"])


def test_wordpiece_cased_and_unimplemented(tmp_path):
    """``do_lower_case`` false keeps case and accents; a non-WordPiece
    ``tokenizer.json`` is refused."""
    from transformers import BertTokenizer

    (tmp_path / "vocab.txt").write_text("\n".join(TOKENIZER_VOCAB + ["Café", "The"]) + "\n")
    BertTokenizer(str(tmp_path / "vocab.txt"), do_lower_case=False).save_pretrained(str(tmp_path / "tok"))
    ours = WordPieceTokenizer.from_pretrained(tmp_path / "tok")
    slow = BertTokenizer.from_pretrained(str(tmp_path / "tok"))
    for text in ("The Café", "the cafe", "CAT"):
        assert ours.encode(text) == slow(text)["input_ids"]
    with pytest.raises(ValueError, match="WordPiece"):
        WordPieceTokenizer.from_spec({"model": {"type": "BPE"}})


def _jax_tree(seed: int, config) -> dict:
    tree = jax_sbert.init_sbert_params(jax.random.PRNGKey(seed), config)
    # Non-trivial norms and biases, so that a misplaced leaf shows.
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda a: np.asarray(a) + rng.standard_normal(a.shape).astype(np.float32) * 0.01,
                                  tree)


def test_params_from_jax_encode_like_jax():
    config = jax_sbert.SbertConfig(vocab_size=300, hidden_size=48, num_layers=2, num_heads=4,
                                   intermediate_size=96, max_position_embeddings=64)
    tree = _jax_tree(3, config)
    rng = np.random.default_rng(0)
    lengths = np.array([16, 3, 9, 1])
    mask = (np.arange(16)[None, :] < lengths[:, None]).astype(np.int32)
    ids = rng.integers(0, 300, size=(4, 16)).astype(np.int32) * mask
    want = np.asarray(jax_sbert.sbert_encode(jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(ids),
                                             jnp.asarray(mask), config))
    model = sbert.sbert_params_from_jax(sbert.SbertModel(sbert.SbertConfig(**vars(config))), tree)
    got = sbert.sbert_encode(model, torch.from_numpy(ids.astype(np.int64)), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_random_init_matches_jax_tokens_and_shapes():
    """``random_init`` uses the JAX package's hash tokenizer (same ids) and the
    JAX initialisation's distribution."""
    enc = sbert.SentenceEncoder.random_init(seed=0, device="cpu")
    ref = jax_sbert._WhitespaceTokenizer(enc.config.vocab_size)
    texts = ["a red panda", "the BLUE jay sat on a tree near the water", "x"]
    got, want = enc.tokenizer(texts, max_length=512), ref(texts)
    np.testing.assert_array_equal(got["input_ids"], want["input_ids"])
    np.testing.assert_array_equal(got["attention_mask"], want["attention_mask"])
    assert abs(float(enc.model.word.std()) - 0.02) < 1e-3
    assert float(enc.model.layers[0].attn_ln.weight.min()) == 1.0 == float(enc.model.layers[0].attn_ln.weight.max())
    out = enc.encode(texts)
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, atol=1e-5)


def test_layers_match_jax():
    """``mlp_gelu`` and ``multi_head_attention`` (GQA, masked, with rope) against
    the JAX layers on the same weights."""
    rng = np.random.default_rng(1)
    b, l, h, nh, kvh = 2, 10, 32, 4, 2
    hd = h // nh
    x = rng.standard_normal((b, l, h)).astype(np.float32)

    def lin(din, dout):
        return rng.standard_normal((din, dout)).astype(np.float32) * 0.1, rng.standard_normal(dout).astype(np.float32)

    def module(w, bias):
        m = layers.Linear(w.shape[0], w.shape[1], True, torch.float32, "cpu")
        m.weight.data.copy_(torch.from_numpy(w.T.copy()))
        m.bias.data.copy_(torch.from_numpy(bias))
        return m

    up, down = lin(h, 64), lin(64, h)
    want = jax_layers.mlp_gelu({"up": {"w": up[0], "b": up[1]}, "down": {"w": down[0], "b": down[1]}}, jnp.asarray(x))
    got = layers.mlp_gelu(torch.from_numpy(x), module(*up), module(*down))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)

    q, k, v, o = lin(h, nh * hd), lin(h, kvh * hd), lin(h, kvh * hd), lin(nh * hd, h)
    mask = np.ones((b, l), np.int32)
    mask[1, 7:] = 0
    ang = rng.standard_normal((b, l, hd // 2)).astype(np.float32)
    params = {name: {"w": w, "b": bias} for name, (w, bias) in zip("qkvo", (q, k, v, o))}
    for rope in (False, True):
        kw = dict(rope_cos=np.cos(ang), rope_sin=np.sin(ang)) if rope else {}
        want = jax_layers.multi_head_attention(params, jnp.asarray(x), num_heads=nh, num_kv_heads=kvh,
                                               kv_mask=jnp.asarray(mask), **{k_: jnp.asarray(v_) for k_, v_ in kw.items()})
        got = layers.multi_head_attention(
            torch.from_numpy(x), *(module(*p) for p in (q, k, v, o)), num_heads=nh, num_kv_heads=kvh,
            kv_mask=torch.from_numpy(mask), kv_mask_contiguous=True,
            **{k_: torch.from_numpy(v_) for k_, v_ in kw.items()},
        )
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_resolve_weights_reads_the_env_path(tmp_path, monkeypatch):
    monkeypatch.setenv("LMMS_OWC_SBERT_PATH", str(tmp_path))
    assert sbert.resolve_sbert_weights() == str(tmp_path) == jax_sbert.resolve_sbert_weights()
