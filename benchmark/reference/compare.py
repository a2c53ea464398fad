"""The numbers that decide `correct`: how far the program's features,
matches and corners lie from the reference's.

Keypoints are paired by what locates them, not by slot: the same
octave, layer and integer extremum (r, c), with x and y within
POS_TOL_PX and the angle within ANGLE_TOL_DEG. Matches are paired by
the keypoints they join. A keypoint or a match on one side without a
partner on the other is counted on its own, exactly: one such is a
different answer. The gaps of paired keypoints and matches are read at
a high quantile of a frame or a pair, so that the few keypoints whose
descriptor rounds a uchar count the other way (src/sift.cpp:709-713)
stay below it, while a lower precision, which moves every descriptor,
does not.

Such a rounding moves the distances that the ratio test weighs, so a
query whose test the reference passes or fails by less than the
measured descriptor gaps of the three keypoints it weighs can shift it
(`ratio_undecided`) may come out the other way in a sound program: a
match that only one side makes for such a query is counted apart, as
undecided, and not as one-sided.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

POS_TOL_PX = 1e-2
ANGLE_TOL_DEG = 1e-1
# the share of a frame's keypoints whose gap may exceed the reported one
GAP_QUANTILE = 0.99


def _fields(kp, b: Optional[int]) -> Dict[str, torch.Tensor]:
    """Frame b's valid keypoints as flat tensors, with their slots."""
    names = ("x", "y", "angle", "octave", "layer", "r", "c", "valid")
    f = {n: getattr(kp, n) for n in names}
    if b is not None:
        f = {n: v[b] for n, v in f.items()}
    slots = f["valid"].nonzero()[:, 0]
    return {**{n: v[slots] for n, v in f.items() if n != "valid"},
            "slot": slots}


def pair_keypoints(prog, ref) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ref_to_prog, prog_to_ref): for each valid keypoint of one side,
    the index of its partner among the other side's valid keypoints, or
    -1. Each side's keypoints are dicts from `_fields`."""
    same = torch.ones((ref["x"].shape[0], prog["x"].shape[0]),
                      dtype=torch.bool, device=ref["x"].device)
    for n in ("octave", "layer", "r", "c"):
        same &= ref[n][:, None] == prog[n][None, :]
    same &= (ref["x"][:, None] - prog["x"][None, :]).abs() <= POS_TOL_PX
    same &= (ref["y"][:, None] - prog["y"][None, :]).abs() <= POS_TOL_PX
    da = (ref["angle"][:, None] - prog["angle"][None, :]).abs() % 360.0
    da = torch.minimum(da, 360.0 - da)
    same &= da <= ANGLE_TOL_DEG
    r2p = [-1] * same.shape[0]
    p2r = [-1] * same.shape[1]
    # each reference keypoint, in slot order, takes the closest free
    # candidate; identical keypoints (two candidates refined to one
    # point) pair off in slot order
    i, j = (t.tolist() for t in same.nonzero(as_tuple=True))
    cost = da[same].tolist()
    for _, a, b in sorted(zip(cost, i, j), key=lambda t: (t[1], t[0], t[2])):
        if r2p[a] < 0 and p2r[b] < 0:
            r2p[a], p2r[b] = b, a
    dev = same.device
    return (torch.tensor(r2p, dtype=torch.long, device=dev),
            torch.tensor(p2r, dtype=torch.long, device=dev))


def _quantile(gaps: torch.Tensor) -> float:
    return float(torch.quantile(gaps, GAP_QUANTILE)) if gaps.numel() else 0.0


def frame_gap(prog_kp, prog_desc, ref_kp, ref_desc, b: Optional[int],
              ref_b: Optional[int]) -> Tuple[float, dict, tuple]:
    """(gap, counts, pairing) of one frame: the GAP_QUANTILE quantile,
    over the paired keypoints, of the descriptor's L1 distance from its
    partner's relative to the partner's L1 norm; counts["unpaired"] is
    the number of valid keypoints, of either side, without a partner.
    b (ref_b) selects frame b of the program's (the reference's) (B, N)
    fields; None takes (N,) fields whole."""
    p, r = _fields(prog_kp, b), _fields(ref_kp, ref_b)
    pd = prog_desc if b is None else prog_desc[b]
    rd = ref_desc if ref_b is None else ref_desc[ref_b]
    r2p, p2r = pair_keypoints(p, r)
    paired = r2p >= 0
    d_ref = rd[r["slot"][paired]].to(torch.float64)
    d_prog = pd[p["slot"][r2p[paired]]].to(torch.float64)
    rel = ((d_prog - d_ref).abs().sum(1)
           / d_ref.abs().sum(1).clamp(min=1e-30))
    n_lone = int((~paired).sum()) + int((p2r < 0).sum())
    gap = _quantile(rel)
    # each reference keypoint's descriptor gap (L1), inf where unpaired
    dl1 = torch.full((paired.shape[0],), float("inf"), dtype=torch.float64,
                     device=paired.device)
    dl1[paired] = (d_prog - d_ref).abs().sum(1)
    counts = {"prog": int(p["x"].shape[0]), "ref": int(r["x"].shape[0]),
              "unpaired": n_lone,
              "gap_max": float(rel.max()) if rel.numel() else 0.0}
    return gap, counts, (p, r, r2p, p2r, dl1)


def ratio_undecided(a: int, ref_query_desc, ref_train_desc, q_pair,
                    t_pair, ratio: float) -> Optional[Tuple[float, float]]:
    """(margin, shift) of the reference's ratio test of query a (an
    index among its valid query keypoints), each relative to the query
    descriptor's L1 norm, where the margin lies within the shift, else
    None. The margin is ratio * d2 - d1 over the reference's own
    descriptors (float64); the shift, the most that the program's
    descriptor gaps of the query and of the reference's best and
    second-best train keypoints can move it: (1 + ratio) gap(query) +
    gap(best) + ratio gap(second). None where any of the three has no
    partner."""
    _, qr, _, _, q_dl1 = q_pair
    _, tr, _, _, t_dl1 = t_pair
    if tr["slot"].shape[0] < 2:
        return None
    q = ref_query_desc[qr["slot"][a]].to(torch.float64)
    t = ref_train_desc[tr["slot"]].to(torch.float64)
    (d1, d2), (j1, j2) = torch.topk((q[None] - t).abs().sum(1), 2,
                                    largest=False)
    norm = max(float(q.abs().sum()), 1e-30)
    margin = float(ratio * d2 - d1) / norm
    shift = float((1.0 + ratio) * q_dl1[a] + t_dl1[j1]
                  + ratio * t_dl1[j2]) / norm
    return (margin, shift) if abs(margin) <= shift else None


def match_gap(prog, ref, ref_query_desc, q_pair, t_pair,
              ratio: Optional[float] = None, ref_train_desc=None,
              undecided: Sequence[int] = ()) -> Tuple[float, dict]:
    """(gap, counts) of one pair's matches: the GAP_QUANTILE quantile,
    over the matches both sides make, of the gap between the program's
    and the reference's best distance (d1) relative to the L1 norm of
    the reference's query descriptor; counts["one_sided"] is the number
    of matches that only one side makes, but for those of undecided
    queries, which counts["undecided"] lists (query index, margin,
    shift). prog and ref are (selected (N,) bool, train index (N,),
    d1 (N,)) over query slots; matches are compared in the reference's
    keypoints, a program match through the pairings of its query and
    train frames (q_pair, t_pair from `frame_gap`). With `ratio` and
    the reference's train descriptors the selection is the ratio test,
    and a query is undecided by `ratio_undecided`; else the queries
    listed in `undecided` are (those whose ratio test, which chose the
    matches selected among, was undecided)."""
    qp, qr, _, q_p2r, _ = q_pair
    tp, tr, _, t_p2r, _ = t_pair

    def slot_to_index(side):
        n = int(side["slot"].max()) + 1 if side["slot"].numel() else 1
        lut = torch.full((n,), -1, dtype=torch.long,
                         device=side["slot"].device)
        lut[side["slot"]] = torch.arange(side["slot"].shape[0],
                                         device=lut.device)
        return lut

    def keyed(sel, tidx, d1, qside, tside, q_map, t_map) -> dict:
        qs = sel.nonzero()[:, 0]
        if not qs.numel():
            return {}
        qi = slot_to_index(qside)[qs]
        ti = slot_to_index(tside)[tidx.long()[qs]]
        if q_map is not None:
            qi = torch.where(qi >= 0, q_map[qi.clamp(min=0)], -1)
            ti = torch.where(ti >= 0, t_map[ti.clamp(min=0)], -1)
        out = {}
        for n, (a, b, d, s) in enumerate(zip(qi.tolist(), ti.tolist(),
                                             d1[qs].tolist(), qs.tolist())):
            # a match whose keypoints have no partner stays one-sided
            key = (a, b) if a >= 0 and b >= 0 else ("lone", n)
            out[key] = (d, s)
        return out

    r = keyed(*ref, qr, tr, None, None)
    p = keyed(*prog, qp, tp, q_p2r, t_p2r)
    norm = ref_query_desc.abs().sum(-1).tolist()
    both = [k for k in r if k in p]
    gaps = [abs(p[k][0] - r[k][0]) / max(norm[r[k][1]], 1e-30)
            for k in both]
    lone = ([k for k in r if k not in p] + [k for k in p if k not in r])
    queries = sorted({k[0] for k in lone if k[0] != "lone"})
    if ratio is not None:
        moved = {a: ratio_undecided(a, ref_query_desc, ref_train_desc,
                                    q_pair, t_pair, ratio) for a in queries}
        excused = [[a, *m] for a, m in moved.items() if m is not None]
    else:
        excused = [[a] for a in queries if a in set(undecided)]
    excused_q = {e[0] for e in excused}
    counts = {"prog": len(p), "ref": len(r),
              "one_sided": sum(k[0] not in excused_q for k in lone),
              "undecided": excused}
    return _quantile(torch.tensor(gaps, dtype=torch.float64)), counts


def corner_gap(prog_corners: torch.Tensor, ref_corners: torch.Tensor
               ) -> float:
    """The widest distance, in pixels, between the program's and the
    reference's projected object corners; inf where either is not
    finite."""
    d = (prog_corners.double() - ref_corners.double()).norm(dim=-1)
    return float(d.max()) if bool(torch.isfinite(d).all()) else float("inf")


def worst(values: Sequence[float]) -> float:
    return max(values) if values else 0.0


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, dict]]:
    """(correct, checked): every number against its limit; a number
    without a limit, a limit without a number, or a number that is not
    finite fails."""
    ok, checked = set(numbers) >= set(limits), {}
    for name, value in numbers.items():
        lim = limits.get(name)
        ok &= lim is not None and value == value and value <= lim
        checked[name] = {"value": value, "limit": lim}
    return ok, checked
