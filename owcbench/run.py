#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port on NVIDIA GPUs: one run of one cell.

Run from the root of a checkout::

    python3 owcbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It draws the cell's weights and requests from the seed, loads the port,
warms it up on one call of the cell's own mix, then serves calls of the mix
back to back until ``--seconds`` have passed, and checks the window's answers
against the plain reference. With ``--trace 0`` it reports the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics from a traced
window. The last line of standard output is the result, one JSON object; the
last lines of standard error are the numbers compared, each beside its limit.
It exits non-zero with no result where there is no CUDA device or fewer than
the cell asks for, where the checkout lacks the port, or where JAX or the
JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _fail(message: str, code: int = 2) -> int:
    print(f"owcbench: {message}", file=sys.stderr, flush=True)
    return code


def result_line(cell, out: dict, traced: bool, kind: str) -> dict:
    """The result: ``correct``, ``attempted``, ``failed``, the metrics of the
    run's kind, the device, the breakdown of a traced run, and the numbers
    compared beside their limits (last)."""
    from owcbench import harness

    rec, check = out["record"], out["check"]
    limits = cell.limits or {}
    checks = {name: {"value": check[name], "limit": spec["limit"]} for name, spec in limits.items()}
    correct = bool(checks) and out["failed"] == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    if traced:
        metrics = {}
        for m in cell.per_layer:
            value = harness.reader(m["name"])(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {"images_per_s": rec.images / rec.window_s, "peak_mem_gb": rec.peak_bytes / 1e9,
                  "setup_s": rec.setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}
    device = {"platform": "gpu", "kind": kind, "count": 1, "memory_peak_bytes": rec.peak_bytes}
    line = {"correct": correct, "attempted": rec.images, "failed": out["failed"], "metrics": metrics,
            "device": device}
    if traced and rec.timeline is not None:
        device.update(busy_s=rec.timeline.busy_s, window_s=rec.timeline.window_s)
        line["breakdown"] = rec.timeline.breakdown
    line["window"] = {"calls": rec.calls, "call_s": rec.call_s, "seconds": rec.window_s, "images": rec.images,
                      "images_per_s": rec.images / rec.window_s, "setup_s": rec.setup_s,
                      "peak_gb": rec.peak_bytes / 1e9,
                      "served_tokens_checked": check["tokens"], "gap_per_request": check["per_request"],
                      "top1_miss_share": check["top1_miss_share"]}
    if not checks:
        checks = {"max_logit_gap": {"value": check["max_logit_gap"], "limit": None}}
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    try:
        from owcbench import harness

        cell = harness.cell(args.workload)
    except (ImportError, OSError, ValueError, KeyError, RuntimeError) as err:
        return _fail(f"cannot read the cell {args.workload!r}: {err}")
    import torch

    chips = int(cell.workload.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        return _fail(f"the cell needs {chips} CUDA device(s); {n} available")
    harness.set_caches()
    kind = torch.cuda.get_device_name(0)
    print("owcbench card: " + json.dumps({"name": kind, **harness.card()}), flush=True)
    try:
        out = harness.run(cell, args.seed, args.seconds, bool(args.trace), T0)
    except harness.HarnessError as err:
        return _fail(str(err))
    loaded = harness.excluded_modules()
    if loaded:
        return _fail(f"modules that must not load in a measured process were loaded: {loaded}", 3)
    line = result_line(cell, out, bool(args.trace), kind)
    for name, c in line["checks"].items():
        print(f"owcbench check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
