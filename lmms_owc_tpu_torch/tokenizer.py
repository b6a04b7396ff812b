"""Byte-level BPE tokenizer of the port, read from a checkpoint's ``tokenizer.json``.

Counterpart of the HF fast tokenizer that the JAX adapter loads with
``transformers.AutoTokenizer`` (the port's machine has neither
``transformers`` nor ``tokenizers``). The pipeline is the fast tokenizer's:

1. added tokens (the chat and vision specials) are split out of the raw text,
   longest match first;
2. each piece between them is normalized (NFC when the file names it);
3. pre-tokenized by one of two patterns: GPT-2's (``ByteLevel`` with
   ``use_regex``) or Qwen2's (``Split`` on :data:`QWEN2_PATTERN`, then
   ``ByteLevel`` without its regex). Python's ``re`` has no ``\\p{L}``, so
   both patterns are hand-written scanners over ``unicodedata.category``
   that follow the regex engine's leftmost-first alternation and
   backtracking; ``\\s`` is Unicode White_Space, as in Oniguruma;
4. each pre-token's UTF-8 bytes are mapped to GPT-2's byte alphabet and
   merged by BPE, lowest merge rank first.

Decoding maps tokens back to bytes (a token with a character outside the
byte alphabet, such as an added token, contributes its own UTF-8 bytes) and
decodes them with replacement, skipping special added tokens on request.
Any part of ``tokenizer.json`` that this module does not implement raises at
load, so a checkpoint is never tokenized differently in silence.
"""

from __future__ import annotations

import json
import re
import unicodedata
from pathlib import Path

__all__ = ["GPT2_PATTERN", "QWEN2_PATTERN", "Tokenizer"]

GPT2_PATTERN = r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"
QWEN2_PATTERN = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n]*"
    r"|\s*[\r\n]+|\s+(?!\S)|\s+"
)

# Unicode White_Space: Oniguruma's \s (Cc 0009-000D, 0085, and Zs, Zl, Zp).
_WHITESPACE = frozenset(
    chr(c) for c in (*range(0x09, 0x0E), 0x20, 0x85, 0xA0, 0x1680, *range(0x2000, 0x200B),
                     0x2028, 0x2029, 0x202F, 0x205F, 0x3000)
)
_NEWLINES = "\r\n"


def _is_ws(c: str) -> bool:
    return c in _WHITESPACE


def _is_letter(c: str) -> bool:
    return unicodedata.category(c)[0] == "L"


def _is_number(c: str) -> bool:
    return unicodedata.category(c)[0] == "N"


def _is_other(c: str) -> bool:
    """``[^\\s\\p{L}\\p{N}]``."""
    return not (c in _WHITESPACE or _is_letter(c) or _is_number(c))


def _run(text: str, i: int, pred) -> int:
    """End of the run of characters from ``i`` on that satisfy ``pred``."""
    n = len(text)
    while i < n and pred(text[i]):
        i += 1
    return i


def _contraction(text: str, i: int, fold: bool) -> int:
    """Length of ``'s|'t|'re|'ve|'m|'ll|'d`` at ``i`` (0 for none); ``fold``
    compares by simple case folding, as ``(?i:...)``."""
    if text[i] != "'":
        return 0

    def at(k: int) -> str:
        if k >= len(text):
            return ""
        c = text[k]
        if fold:
            f = c.casefold()
            return f if len(f) == 1 else c
        return c

    if at(i + 1) in ("s", "t", "m", "d"):
        return 2
    if at(i + 1) + at(i + 2) in ("re", "ve", "ll"):
        return 3
    return 0


def _whitespace_end(text: str, i: int) -> int:
    """``\\s+(?!\\S)|\\s+`` at a whitespace character ``i``: the run, less its
    last character when that one is followed by a non-space and the run is
    longer than one."""
    j = _run(text, i, _is_ws)
    if j == len(text) or j - i < 2:
        return j
    return j - 1


def _gpt2_end(text: str, i: int) -> int:
    """End of the GPT-2 pattern's match at ``i``."""
    k = _contraction(text, i, fold=False)
    if k:
        return i + k
    c = text[i]
    nxt = text[i + 1] if i + 1 < len(text) else ""
    for pred in (_is_letter, _is_number, _is_other):  # ` ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+`
        if pred(c):
            return _run(text, i, pred)
        if c == " " and nxt and pred(nxt):
            return _run(text, i + 1, pred)
    return _whitespace_end(text, i)


def _qwen2_end(text: str, i: int) -> int:
    """End of :data:`QWEN2_PATTERN`'s match at ``i``."""
    k = _contraction(text, i, fold=True)
    if k:
        return i + k
    c = text[i]
    nxt = text[i + 1] if i + 1 < len(text) else ""
    if _is_letter(c):  # [^\r\n\p{L}\p{N}]?\p{L}+
        return _run(text, i, _is_letter)
    if c not in _NEWLINES and not _is_number(c) and nxt and _is_letter(nxt):
        return _run(text, i + 1, _is_letter)
    if _is_number(c):  # \p{N}
        return i + 1
    start = i + 1 if c == " " and nxt and _is_other(nxt) else i  # ` ?[^\s\p{L}\p{N}]+[\r\n]*`
    if _is_other(text[start]):
        return _run(text, _run(text, start, _is_other), lambda ch: ch in _NEWLINES)
    j = _run(text, i, _is_ws)  # \s*[\r\n]+: through the run's last newline
    last = max(text.rfind("\r", i, j), text.rfind("\n", i, j))
    if last >= 0:
        return last + 1
    return _whitespace_end(text, i)


def _split(text: str, end_at) -> list[str]:
    pieces, i = [], 0
    while i < len(text):
        j = end_at(text, i)
        pieces.append(text[i:j])
        i = j
    return pieces


def _byte_alphabet() -> dict[int, str]:
    """GPT-2's reversible byte -> printable character map."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + list(range(ord("®"), ord("ÿ") + 1))
    cs = list(bs)
    extra = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + extra)
            extra += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


_BYTE_TO_CHAR = _byte_alphabet()
_CHAR_TO_BYTE = {c: b for b, c in _BYTE_TO_CHAR.items()}


def _clean_up_tokenization(text: str) -> str:
    """``transformers``' ``clean_up_tokenization``."""
    for a, b in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"), (" n't", "n't"),
                 (" 'm", "'m"), (" 's", "'s"), (" 've", "'ve"), (" 're", "'re")):
        text = text.replace(a, b)
    return text


def _token_name(value) -> str | None:
    """A special token given as a string or as an ``AddedToken`` dict."""
    if isinstance(value, dict):
        return value.get("content")
    return value


class Tokenizer:
    """Byte-level BPE over a ``tokenizer.json`` specification (see the module doc).

    ``eos_token``/``pad_token`` name the end and padding tokens; their ids are
    :attr:`eos_token_id` and :attr:`pad_token_id` (None when unnamed).
    """

    def __init__(
        self,
        spec: dict,
        eos_token: str | None = None,
        pad_token: str | None = None,
        clean_up_tokenization_spaces: bool = False,
    ) -> None:
        for key in ("truncation", "padding"):
            if spec.get(key) is not None:
                raise ValueError(f"tokenizer.json: {key} is set; this tokenizer does not implement it")
        self._normalize = self._parse_normalizer(spec.get("normalizer"))
        self._pre_tokenize = self._parse_pre_tokenizer(spec.get("pre_tokenizer"))
        post = spec.get("post_processor")
        if post is not None and post.get("type") != "ByteLevel":  # ByteLevel only trims offsets
            raise ValueError(f"tokenizer.json: post_processor {post.get('type')!r} is not implemented")
        decoder = spec.get("decoder")
        if decoder is None or decoder.get("type") != "ByteLevel":
            raise ValueError(f"tokenizer.json: decoder {decoder and decoder.get('type')!r} is not implemented")
        self._parse_model(spec["model"])
        self._parse_added_tokens(spec.get("added_tokens") or [])
        self.clean_up_tokenization_spaces = bool(clean_up_tokenization_spaces)
        self.eos_token_id = self.convert_tokens_to_ids(eos_token) if eos_token else None
        self.pad_token_id = self.convert_tokens_to_ids(pad_token) if pad_token else None
        self._cache: dict[str, list[int]] = {}

    # ------------------------------------------------------------------ load

    @classmethod
    def from_pretrained(cls, path: str | Path) -> "Tokenizer":
        """Read ``tokenizer.json`` and the special tokens of ``tokenizer_config.json``
        and ``special_tokens_map.json`` (the latter wins, as in ``transformers``)."""
        path = Path(path)
        settings: dict = {}
        for name in ("tokenizer_config.json", "special_tokens_map.json"):
            if (path / name).exists():
                cfg = json.loads((path / name).read_text())
                for key in ("eos_token", "pad_token"):
                    if _token_name(cfg.get(key)):
                        settings[key] = _token_name(cfg[key])
                if "clean_up_tokenization_spaces" in cfg:
                    settings["clean_up_tokenization_spaces"] = cfg["clean_up_tokenization_spaces"]
        return cls(json.loads((path / "tokenizer.json").read_text()), **settings)

    @staticmethod
    def _parse_normalizer(norm):
        if norm is None:
            return lambda text: text
        if norm.get("type") == "NFC":
            return lambda text: unicodedata.normalize("NFC", text)
        raise ValueError(f"tokenizer.json: normalizer {norm.get('type')!r} is not implemented")

    @staticmethod
    def _parse_pre_tokenizer(pre):
        def byte_level(p: dict, use_regex: bool) -> bool:
            return (p.get("type") == "ByteLevel" and not p.get("add_prefix_space", True)
                    and bool(p.get("use_regex", True)) == use_regex)

        if pre is not None and byte_level(pre, True):
            return lambda text: _split(text, _gpt2_end)
        if pre is not None and pre.get("type") == "Sequence" and len(pre.get("pretokenizers", [])) == 2:
            split, last = pre["pretokenizers"]
            if (split.get("type") == "Split" and split.get("pattern") == {"Regex": QWEN2_PATTERN}
                    and split.get("behavior") == "Isolated" and not split.get("invert")
                    and byte_level(last, False)):
                return lambda text: _split(text, _qwen2_end)
        raise ValueError(
            f"tokenizer.json: pre_tokenizer {json.dumps(pre)[:300]} is not implemented (supported: ByteLevel "
            "with use_regex and no prefix space, and Sequence[Split(Qwen2 pattern, Isolated), ByteLevel(no regex)])"
        )

    def _parse_model(self, model: dict) -> None:
        if model.get("type") != "BPE":
            raise ValueError(f"tokenizer.json: model {model.get('type')!r} is not implemented")
        for key in ("dropout", "unk_token", "continuing_subword_prefix", "end_of_word_suffix"):
            if model.get(key):
                raise ValueError(f"tokenizer.json: BPE {key}={model[key]!r} is not implemented")
        if model.get("byte_fallback"):
            raise ValueError("tokenizer.json: BPE byte_fallback is not implemented")
        self._ignore_merges = bool(model.get("ignore_merges", False))
        self._vocab: dict[str, int] = dict(model["vocab"])
        self._ranks: dict[tuple[str, str], int] = {}
        for rank, merge in enumerate(model.get("merges", [])):
            a, b = merge.split(" ", 1) if isinstance(merge, str) else merge
            if a + b not in self._vocab:
                raise ValueError(f"tokenizer.json: merge {a!r} + {b!r} makes a token outside the vocabulary")
            self._ranks.setdefault((a, b), rank)

    def _parse_added_tokens(self, added: list[dict]) -> None:
        self._added: dict[str, int] = {}
        self._special: set[int] = set()
        for tok in added:
            for flag in ("single_word", "lstrip", "rstrip", "normalized"):
                if tok.get(flag):
                    raise ValueError(f"tokenizer.json: added token {tok['content']!r} sets {flag}, not implemented")
            self._added[tok["content"]] = int(tok["id"])
            if tok.get("special"):
                self._special.add(int(tok["id"]))
        self._id_to_token = {i: t for t, i in self._vocab.items()}
        self._id_to_token.update({i: t for t, i in self._added.items()})
        contents = sorted(self._added, key=len, reverse=True)  # leftmost, then longest
        self._added_pattern = re.compile("|".join(map(re.escape, contents))) if contents else None

    # --------------------------------------------------------------- encode

    def convert_tokens_to_ids(self, token: str) -> int | None:
        if token in self._added:
            return self._added[token]
        return self._vocab.get(token)

    def _bpe(self, word: str) -> list[int]:
        """Ids of one pre-token (already in the byte alphabet)."""
        if word in self._cache:
            return self._cache[word]
        if self._ignore_merges and word in self._vocab:
            ids = [self._vocab[word]]
        else:
            parts = [c for c in word if c in self._vocab]  # no unknown token: others are dropped
            ranks = self._ranks
            while len(parts) > 1:
                pairs = [(ranks.get((a, b)), k) for k, (a, b) in enumerate(zip(parts, parts[1:]))]
                ranked = [p for p in pairs if p[0] is not None]
                if not ranked:
                    break
                _, k = min(ranked)
                best = (parts[k], parts[k + 1])
                merged, k = [], 0
                while k < len(parts):
                    if k + 1 < len(parts) and (parts[k], parts[k + 1]) == best:
                        merged.append(parts[k] + parts[k + 1])
                        k += 2
                    else:
                        merged.append(parts[k])
                        k += 1
                parts = merged
            ids = [self._vocab[p] for p in parts]
        self._cache[word] = ids
        return ids

    def _encode_plain(self, text: str) -> list[int]:
        ids: list[int] = []
        for piece in self._pre_tokenize(self._normalize(text)):
            ids.extend(self._bpe("".join(_BYTE_TO_CHAR[b] for b in piece.encode("utf-8"))))
        return ids

    def encode(self, text: str, add_special_tokens: bool = True) -> list[int]:
        """Token ids of ``text``; no post-processor adds tokens here, so
        ``add_special_tokens`` changes nothing (it is accepted for the
        ``transformers`` signature)."""
        ids: list[int] = []
        pos = 0
        if self._added_pattern is not None:
            for match in self._added_pattern.finditer(text):
                ids.extend(self._encode_plain(text[pos : match.start()]))
                ids.append(self._added[match.group()])
                pos = match.end()
        ids.extend(self._encode_plain(text[pos:]))
        return ids

    # --------------------------------------------------------------- decode

    @staticmethod
    def _decode_tokens(tokens: list[str]) -> str:
        raw = bytearray()
        for tok in tokens:
            if all(c in _CHAR_TO_BYTE for c in tok):
                raw.extend(_CHAR_TO_BYTE[c] for c in tok)
            else:
                raw.extend(tok.encode("utf-8"))
        return raw.decode("utf-8", errors="replace")

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        """Text of ``ids``: ids outside the vocabulary are dropped, special added
        tokens too under ``skip_special_tokens``; each run of ordinary tokens
        is decoded on its own and added tokens are kept verbatim."""
        out, run = [], []
        for i in ids:
            i = int(i)
            tok = self._id_to_token.get(i)
            if tok is None:
                continue
            if tok in self._added and self._added[tok] == i:
                if skip_special_tokens and i in self._special:
                    continue
                out.append(self._decode_tokens(run))
                out.append(tok)
                run = []
            else:
                run.append(tok)
        out.append(self._decode_tokens(run))
        text = "".join(out)
        return _clean_up_tokenization(text) if self.clean_up_tokenization_spaces else text
