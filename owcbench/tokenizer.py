"""The benchmark's tokenizer: the checkpoint directory's files and a plain encoder.

``assets/base_tokenizer.json`` is a frozen copy of the test fixture
``tests/fixtures/tokenizer/tokenizer.json`` (a byte-level BPE of 434 tokens
and 172 merges). :func:`pinned_tokenizer` is a frozen copy of
``chip_smoke.py``'s ``pinned_tokenizer`` (lines 2652-2678), and the special
ids are ``chip_smoke.py``'s ``QWEN2_SPECIAL_IDS`` (lines 531-534): the
published Qwen2 ids, so the prompt template's specials, EOS and padding sit
where a released checkpoint has them. :func:`write_checkpoint_dir` writes
``config.json`` and the tokenizer as ``chip_smoke.py``'s ``write_checkpoint``
does (lines 2753-2770), without the weights.

:class:`ByteLevelBPE` is the reference's own encoder of that tokenizer (the
byte-level alphabet, the GPT-2 pre-split for ASCII text, merges by rank); it
shares no code with the port's tokenizer.
"""

from __future__ import annotations

import copy
import json
import re
from pathlib import Path

BASE_TOKENIZER = Path(__file__).resolve().parent / "assets" / "base_tokenizer.json"
QWEN2_SPECIAL_IDS = {
    "<|endoftext|>": 151643, "<|im_start|>": 151644, "<|im_end|>": 151645, "<|vision_start|>": 151652,
    "<|vision_end|>": 151653, "<|image_pad|>": 151655, "<|video_pad|>": 151656,
}


def pinned_tokenizer(blob: dict, pinned: dict[str, int]) -> dict:
    """The fixture tokenizer with each token of ``pinned`` at its id. An added
    token of the same content gives up its old id to a placeholder; the ids
    below the pinned block become vocabulary fillers and the free ids inside it
    added fillers, so that every id up to the block exists."""
    blob = copy.deepcopy(blob)
    vocab = blob["model"]["vocab"]
    for tok in blob["added_tokens"]:
        if tok["content"] in pinned:
            placeholder = f"<|fixture_{tok['id']}|>"
            if vocab.get(tok["content"]) == tok["id"]:
                vocab[placeholder] = vocab.pop(tok["content"])
            tok["content"] = placeholder
    taken = set(vocab.values()) | {t["id"] for t in blob["added_tokens"]} | set(pinned.values())
    lo, hi = min(pinned.values()), max(pinned.values())
    to_add = dict(pinned)
    for idx in range(hi):
        if idx not in taken:
            if idx < lo:
                vocab[f"�filler{idx}�"] = idx
            else:
                to_add[f"�addfill{idx}�"] = idx
    for content, idx in sorted(to_add.items(), key=lambda kv: kv[1]):
        blob["added_tokens"].append({"id": idx, "content": content, "single_word": False, "lstrip": False,
                                     "rstrip": False, "normalized": False, "special": True})
    return blob


def tokenizer_spec() -> dict:
    """The pinned tokenizer both sides read."""
    return pinned_tokenizer(json.loads(BASE_TOKENIZER.read_text()), QWEN2_SPECIAL_IDS)


def write_checkpoint_dir(path: Path, hf_config: dict) -> None:
    """``config.json`` and the pinned tokenizer: everything of a checkpoint but its tensors."""
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(hf_config))
    (path / "tokenizer.json").write_text(json.dumps(tokenizer_spec()))
    (path / "tokenizer_config.json").write_text(json.dumps(
        {"eos_token": "<|im_end|>", "pad_token": "<|endoftext|>", "clean_up_tokenization_spaces": False}))


def _bytes_to_unicode() -> dict[int, str]:
    """GPT-2's reversible map of the 256 bytes to printable characters."""
    keep = list(range(ord("!"), ord("~") + 1)) + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100))
    chars = list(keep)
    extra = 0
    for b in range(256):
        if b not in keep:
            keep.append(b)
            chars.append(256 + extra)
            extra += 1
    return {b: chr(c) for b, c in zip(keep, chars)}


# GPT-2's pre-split, for ASCII text (letters and digits are the ASCII classes).
_SPLIT = re.compile(r"'s|'t|'re|'ve|'m|'ll|'d| ?[A-Za-z]+| ?[0-9]+| ?[^\sA-Za-z0-9]+|\s+(?!\S)|\s+")


class ByteLevelBPE:
    """Encoder of a byte-level BPE ``tokenizer.json`` for ASCII text: added
    tokens split out first, then the pre-split, the byte alphabet, and merges
    applied lowest rank first."""

    def __init__(self, spec: dict) -> None:
        model = spec["model"]
        self.vocab: dict[str, int] = model["vocab"]
        merges = [tuple(m.split(" ")) if isinstance(m, str) else tuple(m) for m in model["merges"]]
        self.ranks = {pair: rank for rank, pair in enumerate(merges)}
        self.added = {t["content"]: t["id"] for t in spec["added_tokens"] if not t["content"].startswith("�")}
        self.byte_map = _bytes_to_unicode()
        self._added_split = re.compile("(" + "|".join(re.escape(a) for a in sorted(self.added, key=len,
                                                                                    reverse=True)) + ")")

    def _bpe(self, word: str) -> list[str]:
        parts = list(word)
        while len(parts) > 1:
            pairs = [(self.ranks.get((a, b), 1 << 30), i) for i, (a, b) in enumerate(zip(parts, parts[1:]))]
            rank, i = min(pairs)
            if rank == 1 << 30:
                break
            parts[i : i + 2] = [parts[i] + parts[i + 1]]
        return parts

    def encode(self, text: str) -> list[int]:
        if not text.isascii():
            raise ValueError("the reference encoder takes ASCII text")
        ids: list[int] = []
        for piece in self._added_split.split(text):
            if not piece:
                continue
            if piece in self.added:
                ids.append(self.added[piece])
                continue
            for word in _SPLIT.findall(piece):
                mapped = "".join(self.byte_map[b] for b in word.encode())
                ids.extend(self.vocab[p] for p in self._bpe(mapped))
        return ids
