"""Selection filters: majority_vote, take_first, take_first_k.

Behavior parity with reference src/data/filters/_selection.py:11-79. ``take_first`` is
the default ensemble applied when a task declares no filter_list.
"""

from __future__ import annotations

from collections import Counter

from lmms_owc_tpu_torch.filters._api import Filter, register_filter

__all__ = ["MajorityVoteFilter", "TakeFirstFilter", "TakeKFilter"]


@register_filter("majority_vote")
class MajorityVoteFilter(Filter):
    """Select the most frequent response among repeats."""

    def apply(self, responses: list, docs: list | None = None) -> list:
        return [[Counter(inst).most_common(1)[0][0]] for inst in responses]


@register_filter("take_first")
class TakeFirstFilter(Filter):
    """Select the first response (unwraps the repeat list to a scalar)."""

    def apply(self, responses: list, docs: list | None = None) -> list:
        return [inst[0] for inst in responses]


@register_filter("take_first_k")
class TakeKFilter(Filter):
    """Select the first k responses."""

    def __init__(self, *args, **kwargs) -> None:
        self.k = kwargs.pop("k")
        super().__init__(*args, **kwargs)

    def apply(self, responses: list, docs: list | None = None) -> list:
        if responses and len(responses[0]) < self.k:
            raise ValueError(
                f"need at least {self.k} responses per doc (TaskConfig.repeats), got {len(responses[0])}"
            )
        return [inst[: self.k] for inst in responses]
