"""Evaluation metrics: match recall, repeatability, trajectory ATE
(twin of sift_tpu/utils/metrics.py, in NumPy as there, so results equal
the JAX package's).

These are the acceptance gates from BASELINE.json (>=0.95 recall vs CPU
SIFT, ATE within the reference-correspondence bound).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def match_recall(pred_pairs, ref_pairs) -> float:
    """Fraction of reference match pairs reproduced. Pairs are
    iterables of (query_idx, train_idx)."""
    ref = set(map(tuple, ref_pairs))
    if not ref:
        return 1.0
    got = set(map(tuple, pred_pairs))
    return len(ref & got) / len(ref)


def keypoint_recall(ref_xy: np.ndarray, pred_xy: np.ndarray,
                    tol: float = 2.0) -> float:
    """Fraction of reference keypoints with a predicted keypoint
    within tol px (position-based: indices don't transfer between
    implementations). The >=0.95 gate of BASELINE.json is measured
    with this against the compiled reference's keypoints."""
    ref = np.asarray(ref_xy, np.float32)
    pred = np.asarray(pred_xy, np.float32)
    if len(ref) == 0:
        return 1.0
    if len(pred) == 0:
        return 0.0
    d = np.linalg.norm(ref[:, None, :] - pred[None, :, :], axis=-1)
    return float((d.min(axis=1) <= tol).mean())


def correspondence_recall(ref_src: np.ndarray, ref_dst: np.ndarray,
                          pred_src: np.ndarray, pred_dst: np.ndarray,
                          tol: float = 2.0) -> float:
    """Fraction of reference correspondences (src_i -> dst_i)
    reproduced by some predicted correspondence with BOTH endpoints
    within tol px. Match-recall gate vs the reference demo's
    ratio-tested matches (src/main.cpp:25-40)."""
    rs = np.asarray(ref_src, np.float32)
    rd = np.asarray(ref_dst, np.float32)
    if len(rs) == 0:
        return 1.0
    if len(pred_src) == 0:
        return 0.0
    ps = np.asarray(pred_src, np.float32)
    pd = np.asarray(pred_dst, np.float32)
    near_s = (np.linalg.norm(rs[:, None] - ps[None], axis=-1) <= tol)
    near_d = (np.linalg.norm(rd[:, None] - pd[None], axis=-1) <= tol)
    return float((near_s & near_d).any(axis=1).mean())


def keypoint_repeatability(xy0: np.ndarray, xy1: np.ndarray,
                           h_0to1: np.ndarray, tol: float = 3.0
                           ) -> float:
    """Fraction of keypoints in view 0 with a keypoint in view 1
    within tol px of their homography-mapped location."""
    if len(xy0) == 0 or len(xy1) == 0:
        return 0.0
    ones = np.ones((len(xy0), 1))
    p = np.concatenate([xy0, ones], 1) @ h_0to1.T
    p = p[:, :2] / p[:, 2:3]
    d = np.linalg.norm(p[:, None, :] - xy1[None, :, :], axis=-1)
    return float((d.min(axis=1) < tol).mean())


def umeyama_alignment(src: np.ndarray, dst: np.ndarray,
                      with_scale: bool = True
                      ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Similarity transform (R, t, s) minimizing ||s R src + t - dst||.

    src, dst: (N, 3). Standard Umeyama 1991 closed form.
    """
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    u, d, vt = np.linalg.svd(cov)
    s = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s[2, 2] = -1
    r = u @ s @ vt
    if with_scale:
        var = (xs ** 2).sum() / len(src)
        scale = np.trace(np.diag(d) @ s) / var
    else:
        scale = 1.0
    t = mu_d - scale * r @ mu_s
    return r, t, float(scale)


def ate_rmse(est_positions: np.ndarray, gt_positions: np.ndarray,
             align: bool = True) -> float:
    """Absolute trajectory error (RMSE of camera centers) after
    similarity alignment (monocular SfM has gauge/scale freedom)."""
    est = np.asarray(est_positions, np.float64)
    gt = np.asarray(gt_positions, np.float64)
    if align:
        r, t, s = umeyama_alignment(est, gt)
        est = (s * (est @ r.T)) + t
    return float(np.sqrt(((est - gt) ** 2).sum(axis=1).mean()))


def camera_centers(cams: np.ndarray) -> np.ndarray:
    """(C, 6) [w|t] world->cam poses -> (C, 3) camera centers -R^T t,
    with R from the float32 so3_exp on the CPU, as sift_tpu's."""
    from sift_tpu_torch.geometry import lie
    cams = np.asarray(cams)
    r = lie.so3_exp(torch.as_tensor(cams[:, :3], dtype=torch.float32)).numpy()
    return -np.einsum("cji,cj->ci", r, cams[:, 3:])
