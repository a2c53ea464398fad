"""K4 (csrc/knn2.cu `knn2_split_kernel` and `knn2_merge_kernel`): the
top-2 L1 matcher over G pairs of (N, D) query and (M, D) train
descriptors.

A launch reads both descriptor sets once and writes an index and two
distances a query row; it needs a subtraction and an add of an absolute
value for each of N x M x D elements, which have no FMA form and issue
at f32_issue_per_s (chip_smoke.py's K4 bound, frozen at commit
e1604af).
"""

from __future__ import annotations

from benchmark.reference import sift_plain
from benchmark.roofline.bound import bound_s as _bound

KERNELS = ("knn2_split_kernel", "knn2_merge_kernel")


def launches(sift: dict, shapes: dict) -> list:
    """One request's K4 launch: all its matched pairs of frames at once,
    each side padded to the configuration's slots a frame."""
    cfg = sift_plain.ref_config(sift)
    n = sum(cfg.out_caps)
    if not shapes["match_pairs"]:
        return []
    return [{"pairs": shapes["match_pairs"], "n": n, "m": n,
             "d": cfg.descr_size}]


def bound_s(launch: dict) -> float:
    """launch: pairs, n, m, d."""
    g, n, m, d = (float(launch[k]) for k in ("pairs", "n", "m", "d"))
    return _bound(g * (4.0 * (n + m) * d + 12.0 * n), g * 2.0 * n * m * d,
                  "f32_issue_per_s")
