"""The port's Llama-3.2 judge, its Llama decoder view and its tokenizers
against the JAX package and ``transformers``.

On a tiny Llama checkpoint written as ``tests/test_pretrained_converters.py``
writes it (a word-level ``tokenizer.json`` with a chat template), with llama3
rope scaling and an untied head, ``JudgeModel.score_pairs`` gives the JAX
judge's strings in f32 and with ``load_in_8bit``; pooled decoding
(``LMMS_OWC_JUDGE_DECODE_POOL``) gives the unpooled strings with and without
the int8 KV cache; the JAX Llama tree carried across with
``llama_params_from_jax`` gives the JAX decoder's logits and tokens; the
llama3-scaled rope equals JAX's within 1e-6. The tokenizer parts the judge
needs (the Llama-3 split pattern, ``TemplateProcessing``, word-level models,
chat templates) equal ``tokenizers``/``transformers``.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import chip_smoke
from lmms_owc_tpu.nn import judge as jax_judge
from lmms_owc_tpu.nn import llama as jax_llama
from lmms_owc_tpu.nn import qwen2_vl as jax_qvl
from lmms_owc_tpu_torch import no_tf32
from lmms_owc_tpu_torch.nn import judge, llama
from lmms_owc_tpu_torch.nn import qwen2_vl as qvl
from lmms_owc_tpu_torch.tokenizer import LLAMA3_PATTERN, Tokenizer

# The JAX suite's tiny judge template and vocabulary (plus the verdict digits).
JUDGE_CHAT_TEMPLATE = (
    "{% for message in messages %}<|{{ message['role'] }}|>\n"
    "{{ message['content'] }}\n<|eot_id|>\n{% endfor %}"
    "{% if add_generation_prompt %}<|assistant|>\n{% endif %}"
)
JUDGE_WORDS = [
    "<unk>", "<s>", "</s>", "<|eot_id|>", "<|user|>", "<|assistant|>",
    "yes", "no", "correct", "incorrect", "answer:", "prediction:", "reference:",
    "is", "the", "a", "b", "judge", "better", "worse", "tie", "score", "0", "1",
] + [f"w{i}" for i in range(40)]
LLAMA3_SCALING = {"rope_type": "llama3", "factor": 32.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                  "original_max_position_embeddings": 8192}
PROMPTS = [
    "is the prediction: w3 w7 correct answer: w3 w7",
    "judge a better b worse reference: w12 w1 w9 w22 w30 score",
    "yes no tie",
    "judge " + " ".join(f"w{i % 40}" for i in range(150)) + " score",  # past the 128 bucket
] + [" ".join(f"w{(i * 7 + j) % 40}" for j in range(i + 3)) for i in range(6)]


@pytest.fixture(autouse=True)
def _full_f32():
    no_tf32()


def write_llama_checkpoint(path: Path) -> Path:
    """Tiny random HF Llama checkpoint (the JAX suite's recipe, with llama3 rope
    scaling) and a word-level fast tokenizer with the judge's chat template."""
    from tokenizers import Tokenizer as HfTokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import WhitespaceSplit
    from transformers import LlamaConfig, LlamaForCausalLM, PreTrainedTokenizerFast

    tok = HfTokenizer(WordLevel({w: i for i, w in enumerate(JUDGE_WORDS)}, unk_token="<unk>"))
    tok.pre_tokenizer = WhitespaceSplit()
    tokenizer = PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="<unk>", bos_token="<s>", eos_token="</s>",
                                        pad_token="<unk>")
    tokenizer.chat_template = JUDGE_CHAT_TEMPLATE
    tokenizer.save_pretrained(str(path))
    torch.manual_seed(1)
    config = LlamaConfig(
        vocab_size=len(JUDGE_WORDS), hidden_size=48, intermediate_size=96, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=512, rope_theta=500000.0,
        rms_norm_eps=1e-5, tie_word_embeddings=False, pad_token_id=0, bos_token_id=1, eos_token_id=2,
        rope_scaling=dict(LLAMA3_SCALING),
    )
    LlamaForCausalLM(config).eval().save_pretrained(str(path), safe_serialization=True)
    return path


@pytest.fixture(scope="module")
def llama_checkpoint(tmp_path_factory) -> Path:
    return write_llama_checkpoint(tmp_path_factory.mktemp("tiny_llama"))


# ----------------------------------------------------------------- tokenizers


DIGIT_TEXTS = ["12345", "x 1 22 333 4444 55555", "abc1234567def", "٣٤٥٦٧ ١２３４", "3.14159 and 2024-10-17", "'S 12'll"]


@pytest.fixture(scope="module")
def llama3_tokenizers(tmp_path_factory):
    """The smoke's Llama-3-form tokenizer (specials at 128000-128255), as the
    port and as ``transformers`` read it."""
    from transformers import AutoTokenizer

    path = tmp_path_factory.mktemp("llama3_tok")
    (path / "tokenizer.json").write_text(json.dumps(chip_smoke.llama3_tokenizer()))
    (path / "tokenizer_config.json").write_text(json.dumps({
        "bos_token": "<|begin_of_text|>", "eos_token": "<|eot_id|>", "clean_up_tokenization_spaces": True,
        "chat_template": chip_smoke.LLAMA3_CHAT_TEMPLATE}))
    return Tokenizer.from_pretrained(path), AutoTokenizer.from_pretrained(str(path))


def test_llama3_tokenizer_matches_transformers(llama3_tokenizers):
    ours, hf = llama3_tokenizers
    for text in DIGIT_TEXTS + ["<|start_header_id|>user<|end_header_id|>\n\nis 12345 a cat?<|eot_id|>"]:
        for special in (True, False):
            assert ours.encode(text, add_special_tokens=special) == hf.encode(text, add_special_tokens=special), text
    assert ours.encode("12345")[0] == chip_smoke.LLAMA3_SPECIAL_IDS["<|begin_of_text|>"] == 128000
    for token, idx in (("<|eot_id|>", 128009), ("<|finetune_right_pad_id|>", 128004), ("<|reserved_special_token_247|>", 128255)):
        assert ours.convert_tokens_to_ids(token) == hf.convert_tokens_to_ids(token) == idx
    assert ours.eos_token_id == hf.eos_token_id == 128009
    ids = ours.encode("a cat, 12345!") + [128009, 128004, 128255]
    for skip in (False, True):
        assert ours.decode(ids, skip_special_tokens=skip) == hf.decode(ids, skip_special_tokens=skip)
    messages = [{"role": "user", "content": "  is 12 a cat? "}]
    for gen in (True, False):
        assert ours.apply_chat_template(messages, add_generation_prompt=gen) == hf.apply_chat_template(
            messages, tokenize=False, add_generation_prompt=gen)


@settings(max_examples=300, deadline=None)
@given(text=st.lists(st.sampled_from(list("0123456789٣٤１２ ab'sS\n\t.,!") + ["12", "345", " 9"]), max_size=16).map("".join))
def test_llama3_scanner_matches_the_regex_engine(text):
    """The Llama-3 scanner splits as ``tokenizers``' Oniguruma ``Split`` does (digit runs of at most three)."""
    from tokenizers import Regex, pre_tokenizers

    from lmms_owc_tpu_torch import tokenizer as tk

    split = pre_tokenizers.Split(Regex(LLAMA3_PATTERN), behavior="isolated")
    want = [piece for piece, _ in split.pre_tokenize_str(text)]
    assert tk._split(text, lambda t, i: tk._qwen2_end(t, i, digits=3)) == want


def test_word_level_tokenizer_and_chat_template_match_transformers(llama_checkpoint):
    from transformers import AutoTokenizer

    ours, hf = Tokenizer.from_pretrained(llama_checkpoint), AutoTokenizer.from_pretrained(str(llama_checkpoint))
    for text in PROMPTS + ["  yes\tzzz <s> no </s>", "<|eot_id|> 1 0", ""]:
        assert ours.encode(text) == hf.encode(text)
        assert ours.encode(text, add_special_tokens=False) == hf.encode(text, add_special_tokens=False)
    for ids in ([0, 1, 2, 3, 4, 5, 22, 23], [6, 2, 7], []):
        for skip in (False, True):
            assert ours.decode(ids, skip_special_tokens=skip) == hf.decode(ids, skip_special_tokens=skip)
    for prompt in PROMPTS[:3]:
        messages = [{"role": "user", "content": prompt}]
        assert ours.apply_chat_template(messages, add_generation_prompt=True) == hf.apply_chat_template(
            messages, tokenize=False, add_generation_prompt=True)
    assert (ours.eos_token_id, ours.pad_token_id) == (hf.eos_token_id, hf.pad_token_id)


# ------------------------------------------------------------------- decoder


def test_llama3_rope_matches_jax():
    """llama3-scaled rope tables (all three wavelength bands) within 1e-6."""
    cfg = dict(chip_smoke.judge_checkpoint_config())
    lc_port, lc_jax = llama.llama_config_from_hf(cfg), jax_llama.llama_config_from_hf(cfg)
    dc_port, dc_jax = lc_port.to_decoder_config(), lc_jax.to_decoder_config()
    assert dc_port.rope_llama3 == dc_jax.rope_llama3 == (32.0, 1.0, 4.0, 8192)
    assert (dc_port.mrope_section, dc_port.head_dim, lc_port.attn_bias) == (dc_jax.mrope_section, 128, False)
    pos = np.broadcast_to(np.array([[0, 1, 7, 100, 2047, 8191, 9000, 65535]])[None], (3, 1, 8)).copy()
    want = jax_qvl.mrope_cos_sin(jnp.asarray(pos), dc_jax)
    got = qvl.mrope_cos_sin(torch.from_numpy(pos), dc_port)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
    plain = qvl.mrope_cos_sin(torch.from_numpy(pos), qvl.Qwen2VLConfig(**{**vars(dc_port), "rope_llama3": None}))
    assert not torch.allclose(plain[0], got[0])  # the scaling changes the low frequencies


def test_judge_config_matches_jax():
    assert judge.LLAMA32_3B_CONFIG == jax_judge.LLAMA32_3B_CONFIG
    port = llama.llama_config_from_hf(dict(judge.LLAMA32_3B_CONFIG)).to_decoder_config()
    ref = jax_llama.llama_config_from_hf(dict(jax_judge.LLAMA32_3B_CONFIG)).to_decoder_config()
    for name in ("vocab_size", "hidden_size", "num_layers", "num_heads", "num_kv_heads", "intermediate_size",
                 "rms_norm_eps", "rope_theta", "tie_word_embeddings", "mrope_section", "eos_token_id",
                 "pad_token_id", "rope_llama3"):
        assert getattr(port, name) == getattr(ref, name), name
    model = llama.build_llama(llama.llama_config_from_hf(dict(judge.LLAMA32_3B_CONFIG)), device="meta")
    assert model.vision is None and model.layers[0].q.bias is None
    assert sum(p.numel() for p in model.parameters()) == 3_212_749_824  # Llama-3.2-3B's parameter count


def _tiny_jax_tree(config, seed: int) -> dict:
    tree = jax_llama.init_llama_params(jax.random.PRNGKey(seed), config, jnp.float32)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda a: np.asarray(a) + rng.standard_normal(a.shape).astype(np.float32) * 0.01,
                                  tree)


def test_llama_params_from_jax_match_jax_decoder():
    """The JAX tree carried across: last-position prefill logits within 1e-4
    and the greedy tokens equal, on left-padded rows."""
    hf = dict(judge.LLAMA32_3B_CONFIG, vocab_size=300, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, intermediate_size=96)
    jcfg, pcfg = jax_llama.llama_config_from_hf(hf), llama.llama_config_from_hf(hf)
    tree = _tiny_jax_tree(jcfg, 5)
    model = llama.llama_params_from_jax(tree, pcfg)
    rng = np.random.default_rng(2)
    mask = np.ones((3, 20), np.int64)
    mask[1, :6] = 0
    mask[2, :15] = 0
    ids = rng.integers(0, 300, size=(3, 20)) * mask
    pos, next_pos = llama.llama_positions(mask)
    jpos, jnext = jax_llama.llama_positions(mask)
    np.testing.assert_array_equal(pos, jpos)
    np.testing.assert_array_equal(next_pos, jnext)
    dcfg = jcfg.to_decoder_config()
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    embeds = jnp.take(jtree["embed_tokens"], jnp.asarray(ids), axis=0)
    want = jax_qvl.greedy_generate(jtree, embeds, jnp.asarray(pos), jnp.asarray(mask.astype(np.int32)),
                                   jnp.asarray(next_pos.astype(np.int32)), dcfg, max_new_tokens=8, cache_len=64,
                                   eos_ids=jnp.asarray([1], jnp.int32))
    pembeds = torch.nn.functional.embedding(torch.from_numpy(ids), model.embed_tokens)
    got = qvl.greedy_generate(model, pembeds, torch.from_numpy(pos), torch.from_numpy(mask.astype(np.int32)),
                              torch.from_numpy(next_pos), max_new_tokens=8, cache_len=64,
                              eos_ids=torch.tensor([1]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jlogits, _ = jax_qvl.prefill(jtree, embeds, jnp.asarray(pos), jnp.asarray(mask.astype(np.int32)), dcfg, 32)
    plogits, _ = qvl.prefill(model, pembeds, torch.from_numpy(pos), torch.from_numpy(mask.astype(np.int32)), 32)
    np.testing.assert_allclose(plogits.numpy(), np.asarray(jlogits), rtol=0, atol=1e-4)


# --------------------------------------------------------------------- judge


@pytest.mark.parametrize("form", ["f32", "int8"])
def test_score_pairs_match_jax(llama_checkpoint, form):
    int8 = form == "int8"
    ref = jax_judge.JudgeModel.from_pretrained(str(llama_checkpoint), dtype=jnp.float32, load_in_8bit=int8)
    ours = judge.JudgeModel.from_pretrained(str(llama_checkpoint), dtype=torch.float32, load_in_8bit=int8,
                                            device="cpu")
    want = ref.score_pairs(PROMPTS, None, None)
    assert ours.score_pairs(PROMPTS, None, None) == want
    assert len(set(want)) > 1  # the prompts do not all give one answer
    assert ours._eos_and_stop() == ref._eos_and_stop() == ([2, 3], {0, 2, 3})  # eos, <|eot_id|>, the pad id


@pytest.mark.parametrize("kv_int8", [False, True])
def test_pooled_equals_unpooled(llama_checkpoint, monkeypatch, kv_int8):
    """Chunks of 3 in two length buckets (128 and 192), pools of 2 and of 4."""
    ours = judge.JudgeModel.from_pretrained(str(llama_checkpoint), dtype=torch.float32, device="cpu")
    ours.batch_size = 3
    if kv_int8:
        monkeypatch.setenv("LMMS_OWC_KV_INT8", "force")
    monkeypatch.delenv("LMMS_OWC_JUDGE_DECODE_POOL", raising=False)
    base = ours.score_pairs(PROMPTS, None, None)
    for pool in ("2", "4"):
        monkeypatch.setenv("LMMS_OWC_JUDGE_DECODE_POOL", pool)
        assert ours.score_pairs(PROMPTS, None, None) == base, pool


def test_random_init_matches_jax_tokens(monkeypatch):
    """``random_init`` keeps the JAX package's fallback tokenizer (same ids and
    chat text) and draws int8 layers in place of bf16 ones."""
    from lmms_owc_tpu_torch.nn.layers import Int8Linear

    tiny = dict(judge.LLAMA32_3B_CONFIG, vocab_size=128256, hidden_size=32, num_hidden_layers=1,
                num_attention_heads=4, num_key_value_heads=2, intermediate_size=64)
    monkeypatch.setattr(judge, "LLAMA32_3B_CONFIG", tiny)
    for int8 in (False, True):
        ours = judge.JudgeModel.random_init(seed=0, load_in_8bit=int8, device="cpu")
        assert isinstance(ours.model.layers[0].q, Int8Linear) == int8
        assert ours.model.embed_tokens.dtype == torch.bfloat16
    ref = jax_judge._FallbackJudgeTokenizer()
    msgs = [{"role": "user", "content": "is a cat a dog?"}]
    text = ours.tokenizer.apply_chat_template(msgs, tokenize=False, add_generation_prompt=True)
    assert text == ref.apply_chat_template(msgs, tokenize=False, add_generation_prompt=True)
    assert ours.tokenizer.encode(text) == ref.encode(text)
    assert ours.tokenizer.decode([5, 7]) == ref.decode([5, 7])
    out = ours.score_pairs(["is a cat a dog?", "yes"], None, None)
    assert len(out) == 2 and all(isinstance(o, str) for o in out)


def test_entry_points_run_on_the_card_unless_asked(llama_checkpoint):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        judge.JudgeModel.from_pretrained(str(llama_checkpoint))


@pytest.mark.parametrize("rows", [4, 16])
def test_decode_row_blocks(rows):
    """``decode_step`` with ``rows`` (one block of 16, or two blocks of 4 with
    the last padded) gives the plain step's logits, and a row's logits do not
    depend on the rows decoded beside it (every product has one shape)."""
    hf = dict(judge.LLAMA32_3B_CONFIG, vocab_size=300, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, intermediate_size=96)
    model = llama.init_llama_params(llama.llama_config_from_hf(hf), torch.Generator().manual_seed(0), torch.float32)
    c = model.config
    rng = np.random.default_rng(4)

    def step(b, rows):
        shape = (c.num_layers, b, c.num_kv_heads, 8, c.head_dim)
        cache = tuple(torch.from_numpy(rng_cache[i][:, :b].copy()) for i in range(2))
        assert cache[0].shape == shape
        mask = torch.ones((b, 8), dtype=torch.int32)
        pos = torch.full((3, b, 1), 7)
        return qvl.decode_step(model, torch.from_numpy(tokens[:b]), pos, cache, 7, mask, rows)

    tokens = rng.integers(0, 300, size=6)
    rng_cache = [rng.standard_normal((c.num_layers, 6, c.num_kv_heads, 8, c.head_dim)).astype(np.float32)
                 for _ in range(2)]
    plain = step(6, None)
    blocked = step(6, rows)
    np.testing.assert_allclose(blocked.numpy(), plain.numpy(), rtol=0, atol=1e-5)
    assert torch.equal(step(2, rows), blocked[:2])


def test_judge_row_blocks_pool_invariant(llama_checkpoint, monkeypatch):
    """With ``decode_rows`` (the card's setting) pooled answers equal unpooled
    ones and the JAX judge's."""
    ours = judge.JudgeModel.from_pretrained(str(llama_checkpoint), dtype=torch.float32, device="cpu")
    assert ours.decode_rows is None  # the CPU keeps the JAX shapes
    ours.decode_rows, ours.batch_size = judge.DECODE_ROWS, 3
    monkeypatch.delenv("LMMS_OWC_JUDGE_DECODE_POOL", raising=False)
    base = ours.score_pairs(PROMPTS, None, None)
    monkeypatch.setenv("LMMS_OWC_JUDGE_DECODE_POOL", "2")
    assert ours.score_pairs(PROMPTS, None, None) == base
    ref = jax_judge.JudgeModel.from_pretrained(str(llama_checkpoint), dtype=jnp.float32)
    assert base == ref.score_pairs(PROMPTS, None, None)
