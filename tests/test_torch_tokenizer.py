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
