"""The readings that a cell's limits are set from: the numbers its check
compares, for sound runs of the program on many seeds and for the cell's
control (the mix's ``control``) on a few, all in one process.

    python3 benchmark/tools/readings.py --workload c5.cgls --seeds 12 \\
        --control-seeds 3 --first-seed 5000 [--out readings.jsonl]

Each run is the cell's own set-up, a window that closes as soon as the
check has what it needs, and the check, with every number the driver
computes (its ``NUMBERS``) read and none held to a limit. One JSON line per run; then per
number the largest sound reading and the smallest control reading.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[0] = str(ROOT)
    import torch

    from benchmark import harness

    cell = harness.resolve_cell(harness.load_spec(), args.workload)
    # read every number the check computes, none held to a limit
    cell.mix["limits"] = {k: float("inf")
                          for k in harness.driver_of(cell).NUMBERS}
    dev = torch.device(args.device)
    rows = []
    plan = ([(None, args.first_seed + i) for i in range(args.seeds)]
            + [("control", args.first_seed + 1000 + i)
               for i in range(args.control_seeds)])
    for variant, seed in plan:
        t = time.perf_counter()
        r = harness.run_cell(cell, seed, 0.0, False, dev, t, variant)
        row = {"variant": variant or "sound", "seed": seed,
               "wall_s": time.perf_counter() - t,
               "checks": {k: float(c["value"]) for k, c in r["checks"].items()}}
        rows.append(row)
        print(json.dumps(row), flush=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    names = list(rows[0]["checks"])
    summary = {k: {"sound_max": max(r["checks"][k] for r in rows
                                    if r["variant"] == "sound"),
                   "control_min": min((r["checks"][k] for r in rows
                                       if r["variant"] == "control"),
                                      default=None)}
               for k in names}
    print(json.dumps({"workload": args.workload, "summary": summary}),
          flush=True)
    if args.out:
        with open(args.out, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
            f.write(json.dumps({"summary": summary}) + "\n")


if __name__ == "__main__":
    main()
