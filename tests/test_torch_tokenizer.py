"""The port's byte-level BPE tokenizer against ``transformers``' fast tokenizer.

Three ``tokenizer.json`` forms over the vendored fixture's vocabulary and
merges: the fixture itself (``ByteLevel`` with GPT-2's pattern), the fixture
with the Qwen2 specials pinned at their published ids (``chip_smoke.py``'s
``pinned_tokenizer``, the form of the test checkpoints), and the published
Qwen2 form (NFC, then ``Split`` on the Qwen2 pattern, then ``ByteLevel``
without its regex). ``hypothesis`` draws texts from several scripts, digits,
contractions in mixed case, runs of spaces, tabs and ``\\r\\n`` and embedded
special tokens; ``encode`` must give the same ids and ``decode`` (with and
without ``skip_special_tokens``) the same text.
"""

import copy
import json
from pathlib import Path

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import chip_smoke
from lmms_owc_tpu_torch.tokenizer import QWEN2_PATTERN, Tokenizer

FIXTURE = Path(__file__).parent / "fixtures" / "tokenizer" / "tokenizer.json"
EXAMPLES = settings(max_examples=120, deadline=None, suppress_health_check=[HealthCheck.function_scoped_fixture])

SNIPPETS = [
    "'s", "'S", "'t", "'T", "'re", "'RE", "'Re", "'ve", "'VE", "'m", "'M", "'ll", "'LL", "'lL", "'d", "'D", "'x",
    " ", "  ", "   ", "\t", "\t\t", "\n", "\r\n", "\r\n\r\n", " \n ", "　", "\xa0", " ",
    "<|im_start|>", "<|im_end|>", "<|image_pad|>", "<|vision_start|>", "<|endoftext|>",
    "paris", " paris", "What type of object is in this photo?", "photo", "Photo", "cat's", "DON'T",
    "12345", "٣٤٥", "１２", "3.14", "$", "!!", "?!", "...", "—", "…", "😀", "👍🏽",
    "日本語", "中文", "Привет", "мир", "Ελληνικά", "مرحبا", "नमस्ते", "한국어", "café", "café", "ß", "Ǆ",
]
LETTERS = "abcXYZéüñøÅßçαβγΩжщЯあアカ漢字한글ابتअआ"
OTHERS = "0123456789٠١²½.,;:!?'\"()[]{}-_/\\@#$%^&*+=<>|~`€£¥©®°±×÷•…—–"


def _text():
    piece = st.one_of(st.sampled_from(SNIPPETS), st.text(alphabet=LETTERS + OTHERS + " \t\n\r", max_size=6))
    return st.lists(piece, max_size=12).map("".join)


def _hf(path: Path):
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(str(path))


def _save(tmp: Path, blob: dict) -> Path:
    """A tokenizer directory as ``save_pretrained`` writes it (tokenizer_config.json
    and special_tokens_map.json beside tokenizer.json)."""
    from transformers import PreTrainedTokenizerFast

    tmp.mkdir(parents=True, exist_ok=True)
    (tmp / "tokenizer.json").write_text(json.dumps(blob))
    PreTrainedTokenizerFast(
        tokenizer_file=str(tmp / "tokenizer.json"), eos_token="<|im_end|>", pad_token="<|endoftext|>"
    ).save_pretrained(str(tmp))
    return tmp


def _qwen2_form(blob: dict) -> dict:
    blob = copy.deepcopy(blob)
    blob["normalizer"] = {"type": "NFC"}
    blob["pre_tokenizer"] = {
        "type": "Sequence",
        "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": QWEN2_PATTERN}, "behavior": "Isolated", "invert": False},
            {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": False, "use_regex": False},
        ],
    }
    blob["post_processor"] = {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": False,
                              "use_regex": False}
    return blob


@pytest.fixture(scope="module", params=["fixture", "pinned", "qwen2-form"])
def pair(request, tmp_path_factory):
    blob = json.loads(FIXTURE.read_text())
    if request.param == "pinned":
        blob = chip_smoke.pinned_tokenizer(blob, chip_smoke.QWEN2_SPECIAL_IDS)
    elif request.param == "qwen2-form":
        blob = _qwen2_form(blob)
    path = _save(tmp_path_factory.mktemp(request.param.replace("-", "_")), blob)
    return request.param, Tokenizer.from_pretrained(path), _hf(path)


@EXAMPLES
@given(text=_text())
def test_encode_matches_transformers(pair, text):
    _, ours, hf = pair
    want = hf.encode(text, add_special_tokens=False)
    assert ours.encode(text, add_special_tokens=False) == want
    assert ours.encode(text) == hf.encode(text) == want


@EXAMPLES
@given(data=st.data())
def test_decode_matches_transformers(pair, data):
    name, ours, hf = pair
    ids = list(range(0, 440)) + ([] if name != "pinned" else list(range(151630, 151660)))
    seq = data.draw(st.lists(st.sampled_from(ids), max_size=16))
    for skip in (False, True):
        assert ours.decode(seq, skip_special_tokens=skip) == hf.decode(seq, skip_special_tokens=skip)


@EXAMPLES
@given(text=_text())
def test_round_trip_through_decode(pair, text):
    _, ours, hf = pair
    ids = ours.encode(text)
    assert ours.decode(ids) == hf.decode(ids)


def test_special_ids_and_settings(pair):
    name, ours, hf = pair
    assert ours.eos_token_id == hf.eos_token_id and ours.pad_token_id == hf.pad_token_id
    assert ours.clean_up_tokenization_spaces == bool(hf.clean_up_tokenization_spaces)
    if name == "pinned":
        for content, idx in chip_smoke.QWEN2_SPECIAL_IDS.items():
            assert ours.convert_tokens_to_ids(content) == hf.convert_tokens_to_ids(content) == idx
        assert ours.eos_token_id == 151645 and ours.pad_token_id == 151643


def test_golden_prompt_ids():
    """The golden ids of ``tests/test_real_tokenizer.py`` through the port's
    adapter prompt and tokenizer."""
    from lmms_owc_tpu_torch.models import get_model

    model = get_model("qwen2-vl-tiny", batch_size=1, dtype="float32", device="cpu")
    model.tokenizer = Tokenizer(json.loads(FIXTURE.read_text()), eos_token="<|im_end|>", pad_token="<|endoftext|>")
    prompt = model._build_prompt("What type of object is in this photo?", 0)
    ids = model._tokenize_with_images(prompt, [])
    assert ids == [
        1, 414, 204, 323, 90, 377, 262, 416, 320, 19, 2, 204,
        1, 90, 357, 204, 408, 385, 310, 319, 301, 280, 384, 284, 36, 2, 204,
        1, 70, 295, 308, 89, 204,
    ]
    assert model.tokenizer.decode(ids) == prompt
    assert model._encode_continuation(" paris") == model.tokenizer.encode(" paris") == [424]


def test_qwen2_pattern_cases():
    """Hand-checked splits of the Qwen2 scanner (the Oniguruma results)."""
    blob = _qwen2_form(json.loads(FIXTURE.read_text()))
    tok = Tokenizer(blob)
    split = tok._pre_tokenize
    assert split("I'M here") == ["I", "'M", " here"]
    assert split("a  b") == ["a", " ", " b"]
    assert split("x!!\r\n\r\ny") == ["x", "!!\r\n\r\n", "y"]
    assert split("12 34") == ["1", "2", " ", "3", "4"]
    assert split("  \n  z") == ["  \n", " ", " z"]
    assert split("end   ") == ["end", "   "]


@pytest.mark.parametrize(
    "change, match",
    [
        (lambda b: b.update(normalizer={"type": "NFKC"}), "normalizer"),
        (lambda b: b.update(pre_tokenizer={"type": "Metaspace"}), "pre_tokenizer"),
        (lambda b: b["pre_tokenizer"].update(add_prefix_space=True), "pre_tokenizer"),
        (lambda b: b.update(post_processor={"type": "TemplateProcessing"}), "post_processor"),
        (lambda b: b.update(decoder={"type": "WordPiece"}), "decoder"),
        (lambda b: b["model"].update(type="WordPiece"), "model"),
        (lambda b: b["model"].update(byte_fallback=True), "byte_fallback"),
        (lambda b: b["model"].update(unk_token="<unk>"), "unk_token"),
        (lambda b: b["added_tokens"][0].update(lstrip=True), "lstrip"),
        (lambda b: b.update(truncation={"max_length": 8}), "truncation"),
        (lambda b: _split_with(b, r"\s+"), "pre_tokenizer"),
    ],
)
def test_unimplemented_components_raise(change, match):
    blob = json.loads(FIXTURE.read_text())
    change(blob)
    with pytest.raises(ValueError, match=match):
        Tokenizer(blob)


def _split_with(blob: dict, pattern: str) -> None:
    blob.update(_qwen2_form(blob))
    blob["pre_tokenizer"]["pretokenizers"][0]["pattern"] = {"Regex": pattern}


SCANNER_CHARS = [chr(c) for c in (
    *range(0x20, 0x7F), 0x09, 0x0A, 0x0B, 0x0C, 0x0D, 0x1C, 0x1F, 0x85, 0xA0, 0x1680, 0x2000, 0x2028, 0x202F,
    0x3000, 0x200B, 0x17F, 0x212A, 0xE9, 0x301, 0x3B1, 0x416, 0x4E2D, 0x660, 0xFF11, 0x1F600,
)]


@settings(max_examples=400, deadline=None)
@given(text=st.lists(st.sampled_from(SCANNER_CHARS), max_size=16).map("".join))
def test_scanners_match_the_regex_engine(text):
    """Both hand-written scanners split as ``tokenizers``' Oniguruma ``Split``
    does, on characters where ``\\s``, case folding and categories differ
    (U+001C-1F are no White_Space, U+017F folds to s, U+0085 is)."""
    from tokenizers import Regex, pre_tokenizers

    from lmms_owc_tpu_torch import tokenizer as tk

    for pattern, end in ((tk.QWEN2_PATTERN, tk._qwen2_end), (tk.GPT2_PATTERN, tk._gpt2_end)):
        split = pre_tokenizers.Split(Regex(pattern), behavior="isolated", invert=False)
        assert tk._split(text, end) == [piece for piece, _ in split.pre_tokenize_str(text)]


# ------------------------------------------------------------------ CLIP BPE


def _clip_vocab_and_merges() -> tuple[dict, list[str]]:
    """Every byte character, alone and with ``</w>``, plus merges that build
    a few words (the layout of CLIP's ``vocab.json`` + ``merges.txt``)."""
    from lmms_owc_tpu_torch.tokenizer import _BYTE_TO_CHAR

    chars = [_BYTE_TO_CHAR[b] for b in range(256)]
    tokens = chars + [c + "</w>" for c in chars]
    merges = []
    for word in ("photo", "cat", "the", "dog", "of", "a", "it's", "blue", "sky"):
        piece = word[0]
        for k, c in enumerate(word[1:], 1):
            c = c + "</w>" if k == len(word) - 1 else c
            merges.append(f"{piece} {c}")
            tokens.append(piece + c)
            piece += c
    vocab = {}
    for t in tokens + ["<|startoftext|>", "<|endoftext|>"]:
        vocab.setdefault(t, len(vocab))
    return vocab, list(dict.fromkeys(merges))


@pytest.fixture(scope="module", params=["clip-vocab-merges", "clip-tokenizer-json"])
def clip_pair(request, tmp_path_factory):
    """CLIP's slow files (``vocab.json`` + ``merges.txt``, as ``CLIPTokenizer``
    saves them) or the fast ``tokenizer.json``; both against the fast
    tokenizer that ``AutoTokenizer`` / ``AutoProcessor`` build."""
    from transformers import CLIPTokenizer, CLIPTokenizerFast

    path = tmp_path_factory.mktemp(request.param.replace("-", "_"))
    vocab, merges = _clip_vocab_and_merges()
    (path / "vocab.json").write_text(json.dumps(vocab))
    (path / "merges.txt").write_text("#version: 0.2\n" + "\n".join(merges) + "\n")
    cls = CLIPTokenizer if request.param == "clip-vocab-merges" else CLIPTokenizerFast
    cls(str(path / "vocab.json"), str(path / "merges.txt")).save_pretrained(str(path))
    assert (path / "tokenizer.json").exists() == (request.param == "clip-tokenizer-json")
    hf = _hf(path)
    assert type(hf).__name__ == "CLIPTokenizerFast"
    return request.param, Tokenizer.from_pretrained(path), hf


CLIP_SNIPPETS = ["a photo of the cat", "A PHOTO OF THE CAT", "it's", "IT'S", "'s", "  blue\t\tsky \n", "123",
                 "café", "日本語", "<|endoftext|>", "<|startoftext|>", "<|ENDOFTEXT|>", "!!?", "x'y", "😀"]


def _clip_text():
    piece = st.one_of(st.sampled_from(CLIP_SNIPPETS), st.text(alphabet=LETTERS + OTHERS + " \t\n", max_size=6))
    return st.lists(piece, max_size=10).map("".join)


@EXAMPLES
@given(text=_clip_text())
def test_clip_encode_matches_transformers(clip_pair, text):
    _, ours, hf = clip_pair
    assert ours.encode(text) == hf.encode(text)
    assert ours.encode(text, add_special_tokens=False) == hf.encode(text, add_special_tokens=False)


@EXAMPLES
@given(data=st.data())
def test_clip_decode_matches_transformers(clip_pair, data):
    _, ours, hf = clip_pair
    seq = data.draw(st.lists(st.integers(0, hf.vocab_size - 1), max_size=16))
    for skip in (False, True):
        assert ours.decode(seq, skip_special_tokens=skip) == hf.decode(seq, skip_special_tokens=skip)


def test_clip_specials_and_padding(clip_pair):
    _, ours, hf = clip_pair
    assert ours.eos_token_id == ours.pad_token_id == hf.pad_token_id == hf.eos_token_id
    texts = ["a photo of the cat", "dog", "", "the blue sky of it's"]
    np.testing.assert_array_equal(ours(texts)["input_ids"], hf(texts, padding=True, return_tensors="np")["input_ids"])
    np.testing.assert_array_equal(ours(texts)["attention_mask"],
                                  hf(texts, padding=True, return_tensors="np")["attention_mask"])


def test_clip_follows_the_fast_tokenizer_where_the_slow_one_differs(tmp_path):
    """Without ``ftfy`` the slow ``CLIPTokenizer`` cleans text with BERT's basic
    tokenizer: CJK ideographs become one pre-token each and control
    characters vanish. The port gives the fast tokenizer's ids."""
    from transformers import CLIPTokenizer

    vocab, merges = _clip_vocab_and_merges()
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text("#version: 0.2\n" + "\n".join(merges) + "\n")
    slow = CLIPTokenizer(str(tmp_path / "vocab.json"), str(tmp_path / "merges.txt"))
    slow.save_pretrained(str(tmp_path))
    ours, fast = Tokenizer.from_pretrained(tmp_path), _hf(tmp_path)
    for text in ("日本語", "a\x07b"):
        assert ours.encode(text) == fast.encode(text) != slow.encode(text)


def test_clip_merges_read_as_the_slow_tokenizer_reads_them(tmp_path):
    """Only the first ``CLIP_MERGES`` merges after the version line count."""
    from lmms_owc_tpu_torch.tokenizer import CLIP_MERGES

    vocab, merges = _clip_vocab_and_merges()
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text("#version: 0.2\n" + "\n".join(merges) + "\n")
    (tmp_path / "tokenizer_config.json").write_text(json.dumps({"tokenizer_class": "CLIPTokenizer"}))
    spec = Tokenizer._clip_spec(tmp_path, {"tokenizer_class": "CLIPTokenizer"})
    assert spec["model"]["merges"] == merges and CLIP_MERGES == 48894
    (tmp_path / "merges.txt").write_text("#version: 0.2\n" + "\n".join(merges * 6000) + "\n")
    assert len(Tokenizer._clip_spec(tmp_path, {"tokenizer_class": "CLIPTokenizer"})["model"]["merges"]) == CLIP_MERGES


# --------------------------------------------------- Llama-2 / Vicuna / Mistral


def _llama_form(form: str) -> dict:
    """``chip_smoke.llama2_tokenizer`` (the legacy ``Prepend`` + ``Replace``
    normalizer), its ``Metaspace`` form, or the legacy form without the upper
    128 byte tokens (so unknown characters fall to a fused ``<unk>``)."""
    blob = chip_smoke.llama2_tokenizer(words=("hello", "world", "cat's", "image"))
    if form == "metaspace":
        blob["normalizer"] = None
        blob["pre_tokenizer"] = {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "first",
                                 "split": False}
    elif form == "partial-bytes":  # the ids stay dense: the tokens are renamed
        vocab = blob["model"]["vocab"]
        for b in range(0x80, 0x100):
            vocab[f"\u2581nobyte{b}"] = vocab.pop(f"<0x{b:02X}>")
    return blob


@pytest.fixture(scope="module", params=["legacy", "metaspace", "partial-bytes"])
def llama_pair(request, tmp_path_factory):
    path = tmp_path_factory.mktemp(request.param.replace("-", "_"))
    (path / "tokenizer.json").write_text(json.dumps(_llama_form(request.param)))
    config = dict(chip_smoke.LLAMA2_TOKENIZER_CONFIG, legacy=request.param != "metaspace")
    (path / "tokenizer_config.json").write_text(json.dumps(config))
    hf = _hf(path)
    assert type(hf).__name__ == "LlamaTokenizerFast"
    return request.param, Tokenizer.from_pretrained(path), hf


LLAMA_SNIPPETS = ["USER: ", "<image>", "\n", "<s>", "</s>", "<pad>", "<unk>", " ASSISTANT:", "[INST] ", " [/INST]",
                  "hello world", "  ", "cat's", "café", "日本語", "😀", "\t", "What type of object is in this photo?"]


def _llama_text():
    piece = st.one_of(st.sampled_from(LLAMA_SNIPPETS), st.text(alphabet=LETTERS + OTHERS + " \t\n", max_size=6))
    return st.lists(piece, max_size=10).map("".join)


@EXAMPLES
@given(text=_llama_text())
def test_llama_encode_matches_transformers(llama_pair, text):
    _, ours, hf = llama_pair
    assert ours.encode(text) == hf.encode(text)
    assert ours.encode(text, add_special_tokens=False) == hf.encode(text, add_special_tokens=False)


@EXAMPLES
@given(data=st.data())
def test_llama_decode_matches_transformers(llama_pair, data):
    _, ours, hf = llama_pair
    ids = list(range(0, 420)) + list(range(31990, 32002))
    seq = data.draw(st.lists(st.sampled_from(ids), max_size=16))
    for skip in (False, True):
        assert ours.decode(seq, skip_special_tokens=skip) == hf.decode(seq, skip_special_tokens=skip)


def test_llama_specials_and_prompt(llama_pair):
    name, ours, hf = llama_pair
    assert (ours.eos_token_id, ours.pad_token_id) == (hf.eos_token_id, hf.pad_token_id) == (2, 32001)
    for content, idx in (("<unk>", 0), ("<s>", 1), ("</s>", 2), ("<image>", 32000), ("<pad>", 32001)):
        assert ours.convert_tokens_to_ids(content) == hf.convert_tokens_to_ids(content) == idx
    prompt = "USER: <image>\nWhat type of object is in this photo? ASSISTANT:"
    ids = ours.encode(prompt)
    assert ids == hf.encode(prompt) and ids[0] == 1 and ids.count(32000) == 1
    assert ours.decode(ids, skip_special_tokens=True) == hf.decode(ids, skip_special_tokens=True)
    if name == "partial-bytes":
        assert ours.encode("é😀x", add_special_tokens=False).count(0) == 1  # one fused <unk>
