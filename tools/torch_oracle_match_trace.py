#!/usr/bin/env python3
"""Trace the oracle matches that chip_smoke.py's phase 8c finds on one
device and not on the other: the port's card path against its CPU path.

    python3 tools/torch_oracle_match_trace.py [--tree DIR]
                                              [--out build/match_trace.json]

Runs phase 8c as chip_smoke.py does (the 288x384 crop of phase 8b's
480x640 frame matched against the frame, ORACLE_OUT_CAPS, ratio 0.86),
with the kernels of the checkout DIR (default this one; its
sift_tpu_torch/ is imported in place of this checkout's), on the card
and on the CPU (plain versions), and the NumPy oracle's good matches on
the host. For every oracle good match that one device reproduces and
the other does not (both endpoints within 0.5 px, chip_smoke's
oracle_match_recall), it prints, for the query keypoint on each device:
the best and second-best train rows, d1, d2 and d1 / d2 as K4 (or its
plain version) computes them, and again in float64 from that device's
descriptors; the L1 between the card's and the CPU's descriptor rows of
the query and of both train rows (keypoints paired by position and
angle); and the margin of the ratio test, d1 - 0.86 d2. Needs one card.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
RATIO = 0.86


def _near(kp, x, y, angle, tol):
    """Row of the valid keypoint within 0.5 px of (x, y) and tol degrees
    of angle (a location may hold several orientations), or -1."""
    kx, ky = kp.x.cpu().numpy(), kp.y.cpu().numpy()
    da = np.abs(kp.angle.cpu().numpy() - angle) % 360.0
    ok = (kp.valid.cpu().numpy() & (np.abs(kx - x) < .5)
          & (np.abs(ky - y) < .5) & (np.minimum(da, 360.0 - da) < tol))
    hit = np.flatnonzero(ok)
    return int(hit[0]) if len(hit) else -1


def _same(kp_a, a, kp_b):
    """Row of kp_b holding kp_a's keypoint a (position and angle)."""
    return _near(kp_b, float(kp_a.x[a]), float(kp_a.y[a]),
                 float(kp_a.angle[a]), 1e-2)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--out", default=str(ROOT / "build" / "match_trace.json"))
    args = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(args.tree).resolve()))
    spec = importlib.util.spec_from_file_location("trace_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch
    if not torch.cuda.is_available():
        print("torch_oracle_match_trace: CUDA is not available",
              file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from sift_tpu_torch import sift
    from sift_tpu_torch.config import DEFAULT_CONFIG
    from sift_tpu_torch.ops.match import knn2_l1, match_ratio
    from sift_tpu_torch.oracle import cpu_sift as oracle

    raised = dataclasses.replace(DEFAULT_CONFIG, out_caps=cs.ORACLE_OUT_CAPS)
    scene_np = cs.oracle_frame()
    obj_np = np.ascontiguousarray(scene_np[cs.ORACLE_CROP])
    ks_ref, ds_ref = oracle.sift_ncl(scene_np, raised)
    ko_ref, do_ref = oracle.sift_ncl(obj_np, raised)
    ref = oracle.match_l1_ratio(do_ref, ds_ref, ratio=RATIO)

    runs = {}
    for dev in ("cuda", "cpu"):
        kps, ds = sift.detect_and_compute(
            torch.from_numpy(scene_np).to(dev), raised)
        kpo, do = sift.detect_and_compute(
            torch.from_numpy(obj_np).to(dev), raised)
        m = match_ratio(do, ds, q_valid=kpo.valid, t_valid=kps.valid,
                        ratio=RATIO)
        r = knn2_l1(do, ds, kps.valid)
        hits = []
        for qi, tj, _ in ref:
            hits.append(cs.oracle_match_recall([(qi, tj, 0.0)], ko_ref,
                                               ks_ref, kpo, kps, m) > 0)
        runs[dev] = dict(kps=kps, kpo=kpo, ds=ds.cpu().numpy(),
                         do=do.cpu().numpy(), good=m.good.cpu().numpy(),
                         idx=r.idx.cpu().numpy(), d1=r.d1.cpu().numpy(),
                         d2=r.d2.cpu().numpy(), hits=np.array(hits))
    card, cpu = runs["cuda"], runs["cpu"]
    print(f"oracle good {len(ref)}; reproduced on the card "
          f"{int(card['hits'].sum())}, on the CPU {int(cpu['hits'].sum())}; "
          f"port good on the card {int(card['good'].sum())}, on the CPU "
          f"{int(cpu['good'].sum())}")
    traced = []
    for k in np.flatnonzero(card["hits"] != cpu["hits"]):
        qi, tj, dist = ref[k]
        row = {"oracle_query": int(qi), "oracle_train": int(tj),
               "oracle_d1": dist, "card_hit": bool(card["hits"][k]),
               "cpu_hit": bool(cpu["hits"][k])}
        q = {dev: _near(runs[dev]["kpo"], ko_ref[qi]["x"], ko_ref[qi]["y"],
                        ko_ref[qi]["angle"], 1.0) for dev in runs}
        for dev, run in runs.items():
            if q[dev] < 0:
                row[dev] = "no port keypoint at the oracle's query"
                continue
            i, d1, d2 = (int(run["idx"][q[dev]]), float(run["d1"][q[dev]]),
                         float(run["d2"][q[dev]]))
            l1 = np.abs(run["ds"].astype(np.float64)
                        - run["do"][q[dev]].astype(np.float64)).sum(axis=1)
            l1[~run["kps"].valid.cpu().numpy()] = np.inf
            order = np.argsort(l1, kind="stable")[:2]
            row[dev] = {"query_row": q[dev], "good": bool(run["good"][q[dev]]),
                        "best": i, "d1": d1, "d2": d2,
                        "ratio": d1 / d2 if d2 else None,
                        "margin": d1 - RATIO * d2,
                        "f64_best": [int(j) for j in order],
                        "f64_d1": float(l1[order[0]]),
                        "f64_d2": float(l1[order[1]]),
                        "f64_ratio": (float(l1[order[0]] / l1[order[1]])
                                      if l1[order[1]] else None)}
        if q["cuda"] >= 0 and q["cpu"] >= 0:
            row["query_row_l1_card_cpu"] = float(np.abs(
                card["do"][q["cuda"]].astype(np.float64)
                - cpu["do"][q["cpu"]]).sum())
            for which in ("best", "f64_best"):
                for j in (row["cuda"][which] if which == "f64_best"
                          else [row["cuda"][which]]):
                    t = _same(card["kps"], j, cpu["kps"])
                    if t >= 0:
                        row[f"train_row_{j}_l1_card_cpu"] = float(np.abs(
                            card["ds"][j].astype(np.float64)
                            - cpu["ds"][t]).sum())
        traced.append(row)
        print(json.dumps(row))
    both = []
    for a in np.flatnonzero(card["kpo"].valid.cpu().numpy()):
        b = _same(card["kpo"], a, cpu["kpo"])
        if b >= 0:
            both.append(float(np.abs(card["do"][a].astype(np.float64)
                                     - cpu["do"][b]).sum()))
    summary = {"oracle_good": len(ref),
               "card_reproduced": int(card["hits"].sum()),
               "cpu_reproduced": int(cpu["hits"].sum()),
               "query_rows_l1_card_cpu_max": max(both),
               "query_rows_l1_card_cpu_median": float(np.median(both)),
               "traced": traced}
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(summary, indent=1))
    print(json.dumps({k: v for k, v in summary.items() if k != "traced"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
