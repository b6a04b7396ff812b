"""The general traffic generator: a mix file of ``traffic/`` -> the requests of a run.

A mix file (JSON) gives the prompt and ``generation_kwargs`` of the task
config it stands for, the requests of one call (``requests_per_call``), and
the image populations with their shares (``datasets``: a name, a ``weight``
and the ranges of ``width`` and ``height`` in pixels). The set of sizes of a
call is fixed by the file alone: each population gets its share of the call
by largest remainders, and its sizes are drawn from its ranges by
``size_seed``. So every ``--seed`` serves the same set of sizes, the same
work; the seed orders the requests and draws their pixels.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Request:
    """One generation request: its image, prompt and generation kwargs."""

    width: int
    height: int
    image: object  # PIL.Image.Image
    prompt: str
    generation_kwargs: dict


def _shares(weights: list[float], total: int) -> list[int]:
    """``total`` split in proportion to ``weights`` by largest remainders."""
    exact = [w * total / sum(weights) for w in weights]
    counts = [int(e) for e in exact]
    for i in sorted(range(len(exact)), key=lambda i: counts[i] - exact[i])[: total - sum(counts)]:
        counts[i] += 1
    return counts


def call_sizes(mix: dict) -> list[tuple[str, int, int]]:
    """(dataset, width, height) of every request of a call, by the file alone."""
    rng = np.random.default_rng(int(mix["size_seed"]))
    datasets = mix["datasets"]
    sizes = []
    for ds, n in zip(datasets, _shares([float(d["weight"]) for d in datasets], int(mix["requests_per_call"]))):
        (w0, w1), (h0, h1) = ds["width"], ds["height"]
        for _ in range(n):
            sizes.append((ds["name"], int(rng.integers(w0, w1 + 1)), int(rng.integers(h0, h1 + 1))))
    return sizes


def seed_sequence(seed: int, stream: int) -> np.random.SeedSequence:
    """An independent stream of the run's seed (any whole number, negative too)."""
    return np.random.SeedSequence([int(seed) % (1 << 64), stream])


def make_requests(mix: dict, seed: int, stream: int = 0) -> list[Request]:
    """A call's requests: the file's sizes in an order drawn from ``seed``,
    each image's pixels drawn from it too (uniform random RGB)."""
    from PIL import Image

    rng = np.random.default_rng(seed_sequence(seed, stream))
    sizes = call_sizes(mix)
    order = rng.permutation(len(sizes))
    requests = []
    for k in order:
        _, width, height = sizes[k]
        pixels = rng.integers(0, 256, (height, width, 3), dtype=np.uint8)
        requests.append(Request(width, height, Image.fromarray(pixels), mix["prompt"],
                                dict(mix["generation_kwargs"])))
    return requests
