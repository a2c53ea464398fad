"""The port's oracle repeatability comparison: the counterpart of
tools/oracle_repeatability.py for sift_tpu_torch.

Runs eval_repeatability's warp battery (the same WARPS, rng seed 7,
images scaled to --max-side, 220 by default) through the port's
quirk-exact NumPy oracle (sift_tpu_torch/oracle/cpu_sift.py, on the
host) and through the port's pipeline (sift.detect_and_compute on
--device), and writes ORACLE_REPEAT.json's layout with
"pipeline": "sift_tpu_torch". By default it writes
ORACLE_REPEAT_TORCH.json at the repository root, which
sift_tpu_torch.eval.attach_oracle then attaches in place of sift_tpu's
ORACLE_REPEAT.json.

Needs the corpus images of sift_tpu_torch.eval.WARP_IMAGES in --data
and exits nonzero when none is there; needs cv2 for the warps (and for
the resize of an image larger than --max-side), as the JAX tool does.

    python3 tools/torch_oracle_repeatability.py --data CORPUS_DIR
        [--device cuda] [--out ORACLE_REPEAT_TORCH.json] [--max-side 220]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from sift_tpu_torch.eval import (  # noqa: E402
    ORACLE_REPEAT_TORCH, WARP_IMAGES, _extract, _load_gray, _warp)
from sift_tpu_torch.oracle import cpu_sift as oracle  # noqa: E402
from sift_tpu_torch.utils.metrics import keypoint_repeatability  # noqa: E402

# the same warp battery as eval_repeatability (sift_tpu_torch/eval.py)
WARPS = [(15, 1.0, 0.0), (45, 0.9, 0.0), (0, 0.7, 0.0), (10, 1.0, 0.15)]


def _oracle_xy(gray: np.ndarray) -> np.ndarray:
    gpyr = oracle.build_gaussian_pyramid(gray)
    dog = oracle.build_dog_pyramid(gpyr)
    kpts = oracle.find_scale_space_extrema(gpyr, dog)
    if not kpts:
        return np.zeros((0, 2), np.float32)
    return np.array([[k["x"], k["y"]] for k in kpts], np.float32)


def _mean(rows, key):
    return round(float(np.mean([r[key] for r in rows])), 4) if rows else None


def repeatability_rows(data_dir: str, max_side: int, device) -> list:
    """One row per (image, warp): the oracle's and the pipeline's
    repeatability and keypoint counts."""
    rng = np.random.default_rng(7)
    rows = []
    for name in WARP_IMAGES:
        path = os.path.join(data_dir, name)
        if not os.path.exists(path):
            continue
        gray = _load_gray(path, max_side)
        t0 = time.time()
        xy0_o = _oracle_xy(gray)
        xy0_p = _extract(gray, device)[2]
        for (ang, sc, pp) in WARPS:
            warped, hm = _warp(gray, ang, sc, pp, rng)
            rep_o = keypoint_repeatability(
                xy0_o, _oracle_xy(warped), hm, tol=3.0)
            rep_p = keypoint_repeatability(
                xy0_p, _extract(warped, device)[2], hm, tol=3.0)
            rows.append({
                "image": name, "angle": ang, "scale": sc, "persp": pp,
                "oracle_repeatability": round(float(rep_o), 4),
                "pipeline_repeatability": round(float(rep_p), 4),
                "kpts_oracle": int(len(xy0_o)),
                "kpts_pipeline": int(len(xy0_p)),
            })
            print(json.dumps(rows[-1]), flush=True)
        print(f"# {name}: {time.time() - t0:.0f}s", file=sys.stderr)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="torch_oracle_repeatability")
    ap.add_argument("--data", required=True,
                    help="directory of the corpus images (WARP_IMAGES)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the pipeline (default cuda)")
    ap.add_argument("--out", default=ORACLE_REPEAT_TORCH)
    ap.add_argument("--max-side", type=int, default=220)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("CUDA is not available; pass --device cpu for a CPU run")
    present = [n for n in WARP_IMAGES
               if os.path.exists(os.path.join(args.data, n))]
    if not present:
        print(f"torch_oracle_repeatability: none of {WARP_IMAGES} in "
              f"{args.data}", file=sys.stderr)
        return 1

    rows = repeatability_rows(args.data, args.max_side, device)
    s07 = [r for r in rows if r["scale"] == 0.7]
    other = [r for r in rows if r["scale"] != 0.7]
    out = {
        "max_side": args.max_side,
        "pipeline": "sift_tpu_torch",
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "note": ("same warp battery as eval_repeatability, at reduced "
                 "resolution, through sift_tpu_torch's pipeline; oracle = "
                 "quirk-exact NumPy twin of the reference "
                 "(nOctaveLayers=2, no initial 2x upsample). If oracle "
                 "scale-0.7 repeatability is comparably low, the weak "
                 "scale invariance is the reference algorithm's, not a "
                 "pipeline regression."),
        "rows": rows,
        "summary": {
            "scale07_oracle_mean": _mean(s07, "oracle_repeatability"),
            "scale07_pipeline_mean": _mean(s07, "pipeline_repeatability"),
            "other_oracle_mean": _mean(other, "oracle_repeatability"),
            "other_pipeline_mean": _mean(other, "pipeline_repeatability"),
        },
    }
    gap = (out["summary"]["scale07_oracle_mean"] or 0) \
        - (out["summary"]["scale07_pipeline_mean"] or 0)
    out["summary"]["scale07_pipeline_minus_oracle"] = round(-gap, 4)
    out["summary"]["inherited_from_reference_algorithm"] = bool(
        abs(gap) < 0.10)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out["summary"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
