#!/usr/bin/env python3
"""Readings that set a cell's limits: the program's and the control's, seed by seed.

Run from the root of a checkout on the card::

    python3 owcbench/calibrate.py --workload <cell> --seeds 1,2,3 --control-seeds 1,2,3 --out <file.jsonl>

For each seed: the weights and the requests of that seed, the port loaded
and one call of the cell's mix served at the cell's own sizes (the timed
path; no window), then the check's comparison of a sample of its answers
with the reference (``harness.gap_numbers``). For each control seed also
each of the configuration's ``controls``: the reference computed in that
precision (the first is the control, the nearest precision below the one
served), whose gaps are those of the tokens its logits put first at each
position of the same prompts and served tokens. One JSON line per seed goes
to standard output and to ``--out``. The benchmark's runs do not run this.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--out", required=True)
    args = parser.parse_args(argv)

    from owcbench import harness, traffic

    cell = harness.cell(args.workload)
    harness.set_caches()
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        reqs = traffic.make_requests(cell.traffic, seed, stream=0)
        program = harness.Program(cell, seed)
        arch = program.arch
        t_load = time.perf_counter()
        served = program.serve(program.requests(reqs, "owcbench_calibrate"))
        t_call = time.perf_counter()
        program.close()
        del program
        idx = harness.sample(reqs, served, seed, int(cell.config["check"]["requests"]), arch, cell.config)
        row = {"workload": cell.name, "seed": seed, "load_s": t_load - t, "call_s": t_call - t_load,
               "failed": sum(1 for s in served if not s)}
        row["program"] = harness.compare(cell, seed, reqs, served, idx,
                                         cell.config["controls"] if seed in controls else None)
        row["check_s"] = time.perf_counter() - t_call
        row["excluded_modules"] = harness.excluded_modules()
        line = json.dumps(row)
        print(line, flush=True)
        with out.open("a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
