"""Weights drawn on the card from the seed, in the released checkpoint layout.

Every tensor of the configuration's layout (its reference's ``hf_layout``)
is a view of one flat buffer in the served dtype, drawn by a ``torch.Generator``
on the device in a few large calls and then scaled in place by kind. The
same seed gives the same tensors, so the reference draws them again after
the window instead of keeping a copy beside the program's.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

_CHUNK = 1 << 30  # elements drawn per call
_STD = 0.02  # linear weights and biases
_NORM_STD = 0.1  # norm scales: 1 + N(0, 0.1)


class DeviceState(Mapping):
    """name -> device tensor, the Mapping a checkpoint reader returns."""

    def __init__(self, tensors: dict[str, torch.Tensor]) -> None:
        self._tensors = tensors

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._tensors[name]

    def __iter__(self):
        return iter(self._tensors)

    def __len__(self) -> int:
        return len(self._tensors)


def weight_seed(seed: int) -> int:
    """The generator seed of a run's weights (a stream of its seed apart from the traffic's)."""
    return int(np.random.SeedSequence([int(seed) % (1 << 64), 1 << 20]).generate_state(1, np.uint64)[0])


@torch.no_grad()
def draw(layout: list[tuple[str, tuple, str]], seed: int, dtype=torch.bfloat16, device="cuda") -> DeviceState:
    """Draw every tensor of ``layout`` ((name, shape, kind)) from ``seed``."""
    sizes = [int(np.prod(shape)) for _, shape, _ in layout]
    flat = torch.empty(sum(sizes), dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(weight_seed(seed))
    for start in range(0, flat.numel(), _CHUNK):
        flat[start : start + _CHUNK].normal_(0.0, 1.0, generator=gen)
    tensors, offset = {}, 0
    for (name, shape, kind), n in zip(layout, sizes):
        t = flat[offset : offset + n].view(shape)
        if kind == "norm":
            t.mul_(_NORM_STD).add_(1.0)
        else:
            t.mul_(_STD)
        tensors[name] = t
        offset += n
    return DeviceState(tensors)
