"""The numbers that decide `correct` in the mapping cell: how far the
program's front end lies from the plain SIFT, how far its map lies from
the frozen back end fed the same front end, and how far its trajectory
lies from the scene's ground truth.

Front end, as the video cell holds its frames (compare.frame_gap and
compare.match_gap): `feat_gap`, `match_gap`, `kp_unpaired`,
`match_one_sided` over a run of consecutive frames and the sequential
pairs among them.

Back end, against mapping_plain.run_back_end on the request's own front
end output, on the same device (a map moves with the smallest change
of its inputs, so the reference takes the program's, bit for bit):
- exact: `registered_differs` (frames registered on one side only),
  `closures_differ` (closure pairs found on one side only, and common
  pairs whose matches differ), `points_differ` (tracks with a point on
  one side only);
- gaps, relative to the extent of the reference's trajectory (the
  diagonal of its camera centres' bounding box): `cam_gap`, the largest
  distance between the two sides' camera centres, over the pose graph's
  and the final trajectory; `rot_gap_deg`, the largest angle between
  the two sides' rotations, over both; `point_gap`, the GAP_QUANTILE
  quantile of the distance between the points both sides have;
  `rmse_gap`, the final reprojection RMSEs' difference over the
  reference's.

Ground truth: `ate_final`, the final trajectory's absolute trajectory
error (similarity-aligned RMSE of the registered camera centres) against
the renderer's poses.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark.reference import compare, mapping_plain, sift_plain

GAP_QUANTILE = compare.GAP_QUANTILE
COUNTS = ("kp_unpaired", "match_one_sided", "registered_differs",
          "closures_differ", "points_differ")


def front_end_numbers(front, frames: torch.Tensor, start: int,
                      ref_cfg, pair_window: int) -> Tuple[dict, List[str]]:
    """Frames start, start + 1, ... of the program's front end (`front`,
    MappingResult.front_end) against sift_plain on `frames`, the same
    frames (B, H, W) on the device; the pairs among them that the
    program matched (j - i <= pair_window)."""
    rk, rd = sift_plain.detect_and_compute(frames, ref_cfg)
    n = frames.shape[0]
    gaps, mgaps, pairing, notes = [], [], [], []
    lone_kp, lone_m = 0, 0
    for b in range(n):
        f = start + b
        g, counts, pr = compare.frame_gap(front.keypoints[f],
                                          front.descriptors[f], rk, rd,
                                          None, b)
        gaps.append(g)
        lone_kp += counts["unpaired"]
        pairing.append(pr)
        notes.append(f"frame {f}: feat_gap {g!r} {counts}")
    for a in range(n):
        for b in range(a + 1, min(a + 1 + pair_window, n)):
            m = front.pair_matches[(start + a, start + b)]
            ti, good, d1 = sift_plain.match_ratio(
                rd[a], rd[b], rk.valid[a], rk.valid[b], ref_cfg.match_ratio)
            g, counts = compare.match_gap(
                (m.good, m.train_idx, m.distance), (good, ti, d1), rd[a],
                pairing[a], pairing[b], ratio=ref_cfg.match_ratio,
                ref_train_desc=rd[b])
            mgaps.append(g)
            lone_m += counts["one_sided"]
            notes.append(f"pair {start + a}-{start + b}: match_gap {g!r} "
                         f"{counts}")
    return {"feat_gap": compare.worst(gaps),
            "match_gap": compare.worst(mgaps),
            "kp_unpaired": float(lone_kp),
            "match_one_sided": float(lone_m)}, notes


def _rotations(cams: np.ndarray) -> np.ndarray:
    return mapping_plain.so3_exp(torch.as_tensor(
        np.asarray(cams)[:, :3], dtype=torch.float64)).numpy()


def _angle_deg(ra: np.ndarray, rb: np.ndarray) -> np.ndarray:
    """Angles (degrees) between rotations ra and rb, (F, 3, 3) each, from
    their chordal distance |ra - rb|_F = 2 sqrt(2) sin(angle / 2): exactly
    0 for equal matrices, and well conditioned near 0."""
    chord = np.linalg.norm(ra - rb, axis=(1, 2)) / (2.0 * np.sqrt(2.0))
    return np.degrees(2.0 * np.arcsin(np.clip(chord, 0.0, 1.0)))


def map_numbers(prog, ref) -> Tuple[dict, List[str]]:
    """The back end's numbers of two maps (MappingResult, BackEnd)."""
    both = prog.registered & ref.registered
    registered_differs = int((prog.registered != ref.registered).sum())
    pairs_p = {(c.i, c.j): c.matches for c in prog.closures}
    pairs_r = {(c.i, c.j): c.matches for c in ref.closures}
    common = set(pairs_p) & set(pairs_r)
    closures_differ = (len(set(pairs_p) ^ set(pairs_r))
                       + sum(not np.array_equal(pairs_p[c], pairs_r[c])
                             for c in common))
    if prog.has_point.shape == ref.has_point.shape:
        points_differ = int((prog.has_point != ref.has_point).sum())
        shared = prog.has_point & ref.has_point
    else:
        points_differ = abs(prog.has_point.shape[0] - ref.has_point.shape[0])
        shared = np.zeros(0, bool)
    centres_r = mapping_plain.camera_centers(
        np.asarray(ref.cameras_final)[ref.registered])
    extent = (float(np.linalg.norm(centres_r.max(0) - centres_r.min(0)))
              if len(centres_r) else 0.0)
    extent = max(extent, 1e-30)
    cam, rot = 0.0, 0.0
    for name in ("cameras_pg", "cameras_final"):
        a = np.asarray(getattr(prog, name))[both]
        b = np.asarray(getattr(ref, name))[both]
        if not len(a):
            continue
        d = np.linalg.norm(mapping_plain.camera_centers(a)
                           - mapping_plain.camera_centers(b), axis=1)
        cam = max(cam, float(d.max()) / extent)
        rot = max(rot, float(_angle_deg(_rotations(a), _rotations(b)).max()))
    if shared.any():
        dp = np.linalg.norm(np.asarray(prog.points_final)[shared]
                            - np.asarray(ref.points_final)[shared], axis=1)
        point = float(np.quantile(dp, GAP_QUANTILE)) / extent
    else:
        point = 0.0
    rmse = abs(prog.reproj_rmse - ref.reproj_rmse) / max(
        abs(ref.reproj_rmse), 1e-30)
    notes = [f"registered {int(prog.registered.sum())} / "
             f"{int(ref.registered.sum())}, closures {len(pairs_p)} / "
             f"{len(pairs_r)}, points {int(prog.has_point.sum())} / "
             f"{int(ref.has_point.sum())}, rmse {prog.reproj_rmse!r} / "
             f"{ref.reproj_rmse!r}, extent {extent!r}"]
    return {"registered_differs": float(registered_differs),
            "closures_differ": float(closures_differ),
            "points_differ": float(points_differ),
            "cam_gap": cam, "rot_gap_deg": rot, "point_gap": point,
            "rmse_gap": rmse}, notes


def ate(cameras: np.ndarray, registered: np.ndarray, truth: np.ndarray
        ) -> float:
    """Similarity-aligned RMSE of the registered camera centres."""
    if registered.sum() < 3:
        return float("inf")
    return mapping_plain.ate_rmse(
        mapping_plain.camera_centers(np.asarray(cameras)[registered]),
        mapping_plain.camera_centers(np.asarray(truth)[registered]))


def back_end_numbers(prog, k: np.ndarray, truth: np.ndarray, back: dict,
                     device) -> Tuple[dict, List[str]]:
    """The program's map (MappingResult) against run_back_end on its own
    front end, with the configuration's back-end settings, and its final
    trajectory against the ground truth."""
    front = prog.front_end
    ref = mapping_plain.run_back_end(
        front.xy, front.descriptors, [kp.valid for kp in front.keypoints],
        front.matches, k, ratio=back["ratio"], min_gap=back["min_gap"],
        closure_candidates=back["closure_candidates"],
        ransac_threshold=back["ransac_threshold"],
        ba_window=back["ba_window"], device=device)
    numbers, notes = map_numbers(prog, ref)
    numbers["ate_final"] = ate(prog.cameras_final, prog.registered, truth)
    notes.append(f"ate_final {numbers['ate_final']!r}; reference "
                 f"{ate(ref.cameras_final, ref.registered, truth)!r}")
    return numbers, notes


def worst_of(rows: List[Dict[str, float]]) -> Dict[str, float]:
    """The counts summed and every other number's largest, over the
    checked requests."""
    out: Dict[str, float] = {}
    for row in rows:
        for name, v in row.items():
            if name in COUNTS:
                out[name] = out.get(name, 0.0) + v
            else:
                out[name] = max(out.get(name, v), v)
    return out
