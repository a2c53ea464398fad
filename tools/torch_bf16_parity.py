#!/usr/bin/env python3
"""How far sift_tpu's default descriptor arm (descr_rc_bf16=True) moves
descriptors, in sift_tpu and in the port, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/torch_bf16_parity.py [--frames pair,1080p]

For each frame -- chip_smoke.py's synthetic 480x640 pair (scene and
object) and its 1080p scene -- both packages run detect_and_compute
under sift_tpu's DEFAULT_CONFIG (dynamic_slice gathers) with the arm on
and off. Prints one JSON line a frame:
  - each package's arm-on against arm-off descriptors, per valid row
    L1 (max, 99th percentile, median, rows above 2e-2): the keypoints
    are the same under both arms, so this is the arm's own deviation;
  - the port against sift_tpu under the arm, on keypoints paired by
    (octave, layer, r, c) and angle within 1e-2 deg: the largest element
    difference, the rows whose largest difference passes 1e-3, and the
    largest row L1.
The 1080p frame takes a few minutes of CPU time.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

KEY = ("octave", "layer", "r", "c")


def _spread(a: np.ndarray, b: np.ndarray, valid: np.ndarray) -> dict:
    l1 = np.abs(a - b).sum(axis=1)[valid]
    return {"rows": int(valid.sum()), "l1_max": float(l1.max()),
            "l1_p99": float(np.percentile(l1, 99)),
            "l1_median": float(np.median(l1)),
            "rows_above_2e-2": int((l1 > 2e-2).sum())}


def _rows(kp, desc):
    a = {f: np.asarray(getattr(kp, f)) for f in KEY + ("angle", "valid")}
    return [(tuple(int(a[f][i]) for f in KEY), float(a["angle"][i]),
             np.asarray(desc)[i]) for i in np.nonzero(a["valid"])[0]]


def _paired(want, got) -> dict:
    free = list(got)
    diffs = []
    for key, ang, d in want:
        for j, (k2, a2, d2) in enumerate(free):
            da = abs(ang - a2) % 360.0
            if k2 == key and min(da, 360.0 - da) < 1e-2:
                diffs.append(np.abs(d - d2))
                free.pop(j)
                break
    diffs = np.stack(diffs)
    return {"paired": len(diffs), "unpaired": len(want) - len(diffs),
            "elem_max": float(diffs.max()),
            "rows_above_1e-3": int((diffs.max(axis=1) > 1e-3).sum()),
            "l1_max": float(diffs.sum(axis=1).max())}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", default="pair,1080p")
    args = ap.parse_args()

    import jax.numpy as jnp
    import torch
    import chip_smoke as cs
    from sift_tpu import sift as jsift
    from sift_tpu.config import DEFAULT_CONFIG as JAX_DEFAULT
    from sift_tpu_torch import sift as tsift
    from sift_tpu_torch.config import from_jax_config

    j16 = dataclasses.replace(JAX_DEFAULT, ori_gather_impl="dynamic_slice",
                              descr_gather_impl="dynamic_slice")
    j32 = dataclasses.replace(j16, descr_rc_bf16=False)
    t16 = from_jax_config(dataclasses.asdict(j16))
    t32 = from_jax_config(dataclasses.asdict(j32))
    assert t16.descr_rc_bf16 and not t32.descr_rc_bf16

    frames = {}
    want = args.frames.split(",")
    if "pair" in want:
        scene, obj = cs.pair_inputs()
        frames["pair scene 480x640"] = scene
        frames["pair object 480x640"] = obj
    if "1080p" in want:
        frames["scene 1080x1920"] = cs.full_size_inputs()[0]
    for name, img in frames.items():
        out = {"frame": name}
        jk16, jd16 = jsift.detect_and_compute(jnp.asarray(img), j16)
        jk32, jd32 = jsift.detect_and_compute(jnp.asarray(img), j32)
        tk16, td16 = tsift.detect_and_compute(torch.from_numpy(img), t16)
        tk32, td32 = tsift.detect_and_compute(torch.from_numpy(img), t32)
        out["sift_tpu_arm_vs_f32"] = _spread(
            np.asarray(jd16), np.asarray(jd32), np.asarray(jk16.valid))
        out["port_arm_vs_f32"] = _spread(td16.numpy(), td32.numpy(),
                                         tk16.valid.numpy())
        out["port_vs_sift_tpu_under_arm"] = _paired(_rows(jk16, jd16),
                                                    _rows(tk16, td16))
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
