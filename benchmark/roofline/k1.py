"""K1 and K1-batch (csrc/blur.cu `blur_kernel`): the separable
truncated Gaussian blur of B frames into S planes each.

A launch reads its (B, H, W) frames once and writes S planes of each;
it needs two passes of one multiply and one add per nonzero tap and
output pixel (chip_smoke.blur_bound, frozen at commit e1604af). The
count assumes S output planes a launch: a change that fuses the DoG
into K1 changes what a launch must write, and this count with it.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import sift_plain
from benchmark.roofline.bound import bound_s as _bound

KERNELS = ("blur_kernel",)


def launches(sift: dict, shapes: dict) -> list:
    """One request's K1 launches: for each batch of images, the base
    blur at the initial sigma, then one launch of the octave's scales a
    level, at that level's size (shapes: run.Trace's `shapes`)."""
    cfg = sift_plain.ref_config(sift)
    s_base = sift_plain.stack_kernels((cfg.init_blur_sigma,))
    s_oct = sift_plain.stack_kernels(cfg.scale_sigmas()[1:])
    out = []
    for frames, h, w in shapes["images"]:
        out.append({"frames": frames, "h": h, "w": w, "taps": s_base})
        for _ in range(cfg.n_octaves):
            out.append({"frames": frames, "h": h, "w": w, "taps": s_oct})
            h, w = h // 2, w // 2
    return out


def bound_s(launch: dict) -> float:
    """launch: frames, h, w and taps, the (S, K) taps matrix."""
    pix = float(launch["frames"]) * launch["h"] * launch["w"]
    taps = np.asarray(launch["taps"])
    s = taps.shape[0]
    return _bound(4.0 * pix * (1 + s),
                  2.0 * pix * 2.0 * float(np.count_nonzero(taps)))
