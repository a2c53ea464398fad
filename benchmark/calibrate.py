#!/usr/bin/env python3
"""Readings that the limits of `correct` are set from: one cell run on
many seeds in one process, as the program ships (sound runs), with its
lower-precision descriptor arm switched on (the control,
descr_rc_bf16), or with a fault of benchmark/faults.py planted, each
printing the numbers compared. Not part of a benchmark run.

    python3 benchmark/calibrate.py --workload <cell> --seeds 11 12 13 \\
        --seconds 5 [--control | --fault <name>] [--out path.jsonl]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from benchmark import faults, run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", choices=sorted(faults.FAULTS))
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    over = {"program_sift": {"descr_rc_bf16": True}} if args.control else {}
    rows = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        with (faults.planted(args.fault) if args.fault
              else contextlib.nullcontext()):
            out = run.run_cell(args.workload, seed, args.seconds, False,
                               overrides=over)
        row = {"workload": args.workload, "control": args.control,
               "fault": args.fault,
               "seed": seed, "correct": out["correct"],
               "attempted": out["attempted"],
               "seconds": time.perf_counter() - t0,
               "numbers": {k: v["value"] for k, v in out["checked"].items()},
               "notes": out["_notes"]}
        rows.append(row)
        print(json.dumps({k: v for k, v in row.items() if k != "notes"}),
              flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
