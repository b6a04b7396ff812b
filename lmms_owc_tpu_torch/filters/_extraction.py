"""Extraction filters: regex, multi_choice_regex, remove_whitespace.

Behavior parity with reference src/data/filters/_extraction.py:18-238 — regex findall
with group_select + "[invalid]" fallback; the multiple-choice filter's three-stage
fallback (raw regex -> normalized choice-text match mapped to "(A)" labels ->
":  A"-style bare-letter match).
"""

from __future__ import annotations

import re
import sys
import unicodedata

from lmms_owc_tpu_torch.filters._api import Filter, register_filter

__all__ = ["RegexFilter", "MultiChoiceRegexFilter", "WhitespaceFilter"]

_PUNCT_TABLE = dict.fromkeys(
    i for i in range(sys.maxunicode) if unicodedata.category(chr(i)).startswith("P")
)


@register_filter("regex")
class RegexFilter(Filter):
    """Extract a regex pattern from each model response."""

    def __init__(
        self,
        regex_pattern: str = r"#### (\-?[0-9\.\,]+)",
        group_select: int = 0,
        fallback: str = "[invalid]",
    ) -> None:
        self.regex_pattern = regex_pattern
        self.regex = re.compile(regex_pattern)
        self.group_select = group_select
        self.fallback = fallback

    def _extract(self, resp: str) -> str:
        matches = self.regex.findall(resp)
        if not matches:
            return self.fallback
        match = matches[self.group_select]
        if isinstance(match, tuple):
            match = next(m for m in match if m)
        return match.strip()

    def apply(self, responses: list, docs: list | None = None) -> list:
        return [[self._extract(resp) for resp in inst] for inst in responses]


@register_filter("multi_choice_regex")
class MultiChoiceRegexFilter(RegexFilter):
    """Extract a multiple-choice answer label, with choice-text fallbacks.

    Assumes each doc has a ``choices`` list and labels of the form (A), (B), ...
    """

    def __init__(
        self,
        regex_pattern: str = r"#### (\-?[0-9\.\,]+)",
        group_select: int = 0,
        fallback: str = "[invalid]",
        ignore_case: bool = False,
        ignore_punctuation: bool = False,
        regexes_to_ignore: list | None = None,
    ) -> None:
        super().__init__(regex_pattern, group_select, fallback)
        self.ignore_case = ignore_case
        self.ignore_punctuation = ignore_punctuation
        self.regexes_to_ignore = regexes_to_ignore

    def _normalize(self, text: str) -> str:
        if self.regexes_to_ignore:
            for pattern in self.regexes_to_ignore:
                text = re.sub(pattern, "", text)
        if self.ignore_case:
            text = text.lower()
        if self.ignore_punctuation:
            text = text.translate(_PUNCT_TABLE)
        return text

    @staticmethod
    def _find(regex: re.Pattern, resp: str, group_select: int, convert: dict) -> str | None:
        matches = regex.findall(resp)
        if not matches:
            return None
        match = matches[group_select]
        if isinstance(match, tuple):
            match = next(m for m in match if m)
        match = match.strip()
        return convert.get(match, match) if match else None

    def apply(self, responses: list, docs: list | None = None) -> list:
        if docs is None:
            raise ValueError("multi_choice_regex requires docs with a 'choices' field")
        out = []
        for inst, doc in zip(responses, docs):
            choice_patterns: list[str] = []
            choice_to_label: dict[str, str] = {}
            bare_letters: list[str] = []
            bare_to_label: dict[str, str] = {}
            for i, choice in enumerate(doc["choices"]):
                label = chr(ord("A") + i)
                normalized = self._normalize(choice.strip())
                choice_patterns.append(re.escape(normalized))
                choice_to_label[normalized] = f"({label})"
                bare_letters.append(label)
                bare_to_label[label] = f"({label})"
            choice_regex = re.compile("|".join(choice_patterns))
            bare_regex = re.compile(f":[\\s]*({'|'.join(bare_letters)})")

            filtered = []
            for resp in inst:
                match = self._find(self.regex, resp, self.group_select, {})
                if not match:
                    match = self._find(choice_regex, self._normalize(resp), self.group_select, choice_to_label)
                if not match:
                    match = self._find(bare_regex, resp, self.group_select, bare_to_label)
                filtered.append(match or self.fallback)
            out.append(filtered)
        return out


@register_filter("remove_whitespace")
class WhitespaceFilter(Filter):
    """Strip a single leading space from model responses."""

    def apply(self, responses: list, docs: list | None = None) -> list:
        return [
            [resp[1:] if resp.startswith(" ") else resp for resp in inst]
            for inst in responses
        ]
