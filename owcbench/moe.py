"""Bounds of the routed expert products: the yardstick of ``moe_roofline``.

A mixture-of-experts layer's routed product (Kimi-VL's
``nn/kimi_vl.py routed_experts``: every (row, chosen expert) pair sorted by
expert, then grouped products of gate and up, and of down) reads the
weights of each expert that some row chose, once, and its rows once in and
once out. Its bound is the larger of its operations at the bf16 peak and
those bytes at the memory rate (:func:`owcbench.roofline.bound`). The
program tallies, per routed-row count of a call, how many calls touched
each number of experts (``moe_tallies``), so the window's bound is summed
call by call from them.
"""

from __future__ import annotations

from owcbench import roofline

# The routed product's kernels in the device trace: the CUTLASS grouped GEMM
# that ``torch._grouped_mm`` launches on sm_90 (its problem shape is a
# ``GroupProblemShape``) and the kernel that prepares its per-group
# arguments; no other product of a cell launches either.
SYMBOLS = ("GroupProblemShape", "prepare_grouped_gemm_data")


def call_bound(routed_rows: int, touched: int, hidden: int, inter: int, elt: int = 2) -> dict:
    """Bound of one routed product of ``routed_rows`` (row, expert) pairs over
    ``touched`` experts: 2 x 3 x hidden x inter operations a pair (gate, up,
    down); each touched expert's three matrices, the pairs' rows in and
    their rows out, in ``elt`` bytes an element."""
    flops = 2.0 * 3 * hidden * inter * routed_rows
    nbytes = elt * (touched * 3.0 * hidden * inter + 2.0 * routed_rows * hidden)
    return roofline.bound(flops, nbytes)


def window_bound_s(tallies: list[dict], hidden: int, inter: int) -> float:
    """The summed bound seconds of every call the tallies count."""
    total = 0.0
    for t in tallies:
        for touched, calls in enumerate(t["touched"]):
            if calls:
                total += calls * call_bound(t["routed_rows"], touched, hidden, inter)["bound_s"]
    return total


def load_balance(tallies: list[dict]) -> float | None:
    """Over every call, the mean rows per touched expert over the busiest
    expert's rows (sums over the calls, so a call weighs by its size)."""
    busiest = sum(t["busiest_rows"] for t in tallies)
    return sum(t["mean_rows"] for t in tallies) / busiest if busiest > 0 else None
