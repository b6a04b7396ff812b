"""AI2D task hooks (parity: reference src/data/tasks/_examples/ai2d/_ai2d_utils.py).

Multiple-choice diagram QA evaluated through generate_until: the prompt enumerates
lettered options; the filter extracts a leading "X." option letter from the response.
"""

from __future__ import annotations

import re

from lmms_owc_tpu_torch.filters._extraction import MultiChoiceRegexFilter

__all__ = ["CustomMultiChoiceRegexFilter", "doc_to_text", "doc_to_visual", "doc_to_target"]

_OPTION_LETTER = re.compile(r"^\s*([A-Z])\.")


class CustomMultiChoiceRegexFilter(MultiChoiceRegexFilter):
    """Extract a leading option letter ("B." -> "B"); fall back to the raw response."""

    def apply(self, resps: list, docs: list) -> list:
        out = []
        for inst in resps:
            filtered = []
            for resp in inst:
                match = _OPTION_LETTER.match(resp)
                filtered.append(match.group(1) if match else resp)
            out.append(filtered[0])
        return out


def doc_to_text(doc: dict, model_specific_kwargs: dict) -> str:
    question, choices = doc["question"], doc["options"]
    pre = model_specific_kwargs["pre_prompt"]
    post = model_specific_kwargs["post_prompt"]
    fmt = model_specific_kwargs["prompt_format"]
    letters = [chr(ord("A") + i) for i in range(len(choices))]
    if fmt == "mcq":
        choices_str = "\n".join(f"{letter}. {choice}" for letter, choice in zip(letters, choices))
        return f"{pre}{question}\n{choices_str}{post}"
    if fmt == "qa":
        return f"{pre}{question}{chr(10).join(choices)}{post}"
    if fmt == "mcq_xcomposer":
        choices_str = " ".join(f"{letter}. {choice}" for letter, choice in zip(letters, choices))
        return f"{pre}{question}\nContext: N/A\n{choices_str}{post}"
    raise ValueError(f"unknown prompt format: {fmt}")


def doc_to_visual(doc: dict) -> list:
    return [doc["image"].convert("RGB")]


def doc_to_target(doc: dict, model_specific_target_kwargs: str) -> str:
    if model_specific_target_kwargs == "mcq":
        return chr(ord("A") + int(doc["answer"]))
    if model_specific_target_kwargs == "qa":
        return doc["options"][int(doc["answer"])]
    raise ValueError("unknown target kwargs for ai2d task")
