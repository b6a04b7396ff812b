"""Request collation of the port (the JAX package's ``utils._collation``).

The adapter's chunk order and length buckets, on which token identity with the
JAX adapter depends, come from :class:`Collator` and :func:`pad_to_bucket` as
they are there.
"""

from __future__ import annotations

from collections.abc import Callable, Iterator
from typing import Any

__all__ = ["Collator", "pad_to_bucket", "DEFAULT_LENGTH_BUCKETS"]

# Sequence-length buckets, multiples of 64 below 512 and coarser above, as in
# the JAX package (each bucket there is one compiled program; here they bound
# padding and keep prompt shapes, and so tokens, identical to the reference).
DEFAULT_LENGTH_BUCKETS = (
    128, 192, 256, 288, 320, 352, 384, 448, 512, 640, 768,
    1024, 1536, 2048, 3072, 4096, 6144, 8192,
)


def pad_to_bucket(length: int, buckets: tuple[int, ...] = DEFAULT_LENGTH_BUCKETS) -> int:
    """Smallest bucket >= length (last bucket if none fits)."""
    for b in buckets:
        if length <= b:
            return b
    return buckets[-1]


class Collator:
    """Sort, group, and batch requests; restore original order afterwards.

    Args:
        arr: list of request payloads.
        sort_fn: key for length-descending sort (e.g. ``lambda x: -len(toks(x))``).
        group_fn: key for grouping (e.g. generation kwargs repr); requests are only
            batched within a group.
        group_by: "gen_kwargs", "contexts", or None.
    """

    def __init__(
        self,
        arr: list,
        sort_fn: Callable[[Any], Any] = lambda x: 0,
        group_fn: Callable[[Any], Any] = lambda x: x[1],
        group_by: str | None = None,
    ) -> None:
        self._group_by = group_by
        self._arr_with_indices: list[tuple[int, Any]] = list(enumerate(arr))
        self._sort_fn = lambda item: sort_fn(item[1])
        self._group_fn = lambda item: group_fn(item[1])
        self._reorder_indices: list[int] = []
        self._size = len(arr)

    def __len__(self) -> int:
        return self._size

    def _grouped(self) -> dict[Any, list[tuple[int, Any]]]:
        if self._group_by is None:
            return {None: self._arr_with_indices}
        groups: dict[Any, list[tuple[int, Any]]] = {}
        for item in self._arr_with_indices:
            key = self._group_fn(item)
            try:
                hash(key)
            except TypeError:
                key = repr(key)
            groups.setdefault(key, []).append(item)
        return groups

    def get_batched(self, n: int = 1, batch_fn: Callable[[int, Any], int] | None = None) -> Iterator[list]:
        """Yield batches of at most ``n`` requests (0 = single batch per group),
        sorted within each group, recording order for :meth:`get_original`."""
        for _, group in self._grouped().items():
            ordered = sorted(group, key=self._sort_fn)
            batch: list[tuple[int, Any]] = []
            for item in ordered:
                max_n = batch_fn(len(self._reorder_indices), item[1]) if batch_fn else n
                batch.append(item)
                if max_n and len(batch) >= max_n:
                    self._reorder_indices.extend(idx for idx, _ in batch)
                    yield [payload for _, payload in batch]
                    batch = []
            if batch:
                self._reorder_indices.extend(idx for idx, _ in batch)
                yield [payload for _, payload in batch]

    def get_original(self, newarr: list) -> list:
        """Undo the sort/group permutation over the processed results."""
        res = [None] * self._size
        covered = [False] * self._size
        for idx, value in zip(self._reorder_indices, newarr):
            res[idx] = value
            covered[idx] = True
        assert all(covered), "some requests were not processed"
        return res
