#!/usr/bin/env python3
"""Readings that the mapping cell's limits are set from: the cell run on
many seeds in one process, as the program ships (sound runs) or with a
control of benchmark/faults_map.py planted, each printing the numbers
compared. Not part of a benchmark run.

    python3 benchmark/calibrate_map.py --seeds 11 12 13 --seconds 5 \\
        [--control sums_unordered|sums_bf16] [--out path.jsonl]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from benchmark import faults_map, run  # noqa: E402

CELL = "map24_480p"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", choices=sorted(faults_map.CONTROLS))
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    rows = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        with (faults_map.planted(args.control) if args.control
              else contextlib.nullcontext()):
            out = run.run_cell(CELL, seed, args.seconds, False)
        row = {"workload": CELL, "control": args.control, "seed": seed,
               "correct": out["correct"], "attempted": out["attempted"],
               "seconds": time.perf_counter() - t0,
               "numbers": {k: v["value"] for k, v in out["checked"].items()},
               "notes": out["_notes"]}
        rows.append(row)
        print(json.dumps({k: v for k, v in row.items() if k != "notes"}),
              flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
