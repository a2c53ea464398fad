"""The fixed-order segment sum (csrc/segsum.cu `segsum_kernel` and
`segsum_short_kernel`): out[s] += x[i] for the rows i of each segment s.

A launch reads its rows of x and the permutation once and reads and
writes its outputs once; each row costs one add a column, which has no
FMA form and issues at f32_issue_per_s. The launches are counted from
the work, whatever implements it: each LM iteration of a bundle
adjustment makes the 66 sums of its Schur/CG step (sfm/ba.py: widths 36
and 6 over the cameras, 9 and 3 over the points for the normal
equations and the right-hand side, 6 over the cameras for the reduced
right-hand side, then 3 over the points and 6 over the cameras in each
CG iteration, then 3 over the points for the back-substitution); each
Gauss-Newton iteration of a pose graph makes 6 (sfm/posegraph.py: four
sums of the edges' 6x6 blocks into the flat (6V)^2 normal matrix, two
of their 6-vectors into the right-hand side). The shapes are the tables
of one request, read by the traffic driver's shapes() from the
program's `sfm.ba` and `sfm.posegraph` spans. A BA's sums read the
table's unmasked rows (`obs_used`; the padded `obs` where the span has
no such attribute) and write every camera's or point's row of the
padded table.
"""

from __future__ import annotations

from benchmark.roofline.bound import bound_s as _bound

KERNELS = ("segsum_kernel", "segsum_short_kernel")


def _sum(rows: int, segments: int, width: int) -> dict:
    return {"rows": rows, "segments": segments, "width": width}


def launches(sift: dict, shapes: dict) -> list:
    """One request's segment sums, from its BA and pose-graph shapes."""
    out = []
    for ba in shapes.get("ba", []):
        o, p, c = ba.get("obs_used", ba["obs"]), ba["points"], ba["cams"]
        step = [_sum(o, c, 36), _sum(o, p, 9), _sum(o, c, 6), _sum(o, p, 3),
                _sum(o, c, 6)]
        step += [_sum(o, p, 3), _sum(o, c, 6)] * ba["cg_iters"]
        step += [_sum(o, p, 3)]
        out += step * ba["iters"]
    for g in shapes.get("posegraph", []):
        v, e = g["poses"], g["edges"]
        step = [_sum(36 * e, 36 * v * v, 1)] * 4 + [_sum(e, v, 6)] * 2
        out += step * g["iters"]
    return out


def bound_s(launch: dict) -> float:
    """launch: rows, segments, width."""
    o, s, w = (float(launch[k]) for k in ("rows", "segments", "width"))
    return _bound(4.0 * (o * w + o + 2.0 * s * w), o * w, "f32_issue_per_s")
