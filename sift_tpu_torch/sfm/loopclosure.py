"""Loop-closure detection from descriptor retrieval (twin of
sift_tpu/sfm/loopclosure.py).

Two-level retrieval:

  1. frame-level candidate selection: each frame gets a compact
     signature -- the mean of its descriptors projected through the
     cascade matcher's random matrix. Cosine similarity over signatures
     ranks candidate pairs; only temporally distant frames (>= min_gap)
     qualify, so odometry neighbors don't masquerade as closures.
  2. pair-level verification: candidate pairs run the cascade
     descriptor matcher + essential-matrix RANSAC; a closure is
     accepted only with enough geometric inliers.

One (128, 16) projection serves both levels, as in sift_tpu, where both
draw it from seed 7: `proj=` takes it (pass sift_tpu's to reproduce its
results); None draws ops.match_cascade.projection(128, 16, 7). The
essential RANSAC's samples come from `sampler` (sfm/incremental.py).

Accepted closures are returned as a matches dict fragment compatible
with sfm.incremental.reconstruct and as relative-pose edges for
sfm.posegraph.PoseGraph.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from sift_tpu_torch.geometry.epipolar import find_essential_ransac
from sift_tpu_torch.ops.match_cascade import match_ratio_cascade, projection
from sift_tpu_torch.sfm.incremental import (Sampler, _pad2, draw,
                                            resolve_device, so3_log_f32)
from sift_tpu_torch.utils.caps import pow2_cap

_D_PROJ = 16
_PROJ_SEED = 7


class LoopClosure(NamedTuple):
    i: int
    j: int
    matches: np.ndarray      # (M, 2) keypoint index pairs (i, j)
    n_inliers: int
    rel_pose: np.ndarray     # (6,) [w|t] frame i -> frame j (unit t)


def _projection(d: int, proj) -> torch.Tensor:
    if proj is None:
        return projection(d, _D_PROJ, _PROJ_SEED)
    if isinstance(proj, torch.Tensor):
        return proj.to(torch.float32)
    return torch.from_numpy(np.array(proj, np.float32))


def frame_signatures(descriptors: Sequence, valids: Sequence,
                     proj=None) -> np.ndarray:
    """(F, d') L2-normalized retrieval signatures; descriptors and
    valids are (N, D) / (N,) arrays or tensors, computed on their
    device."""
    sigs = []
    for d, v in zip(descriptors, valids):
        d = torch.as_tensor(d, dtype=torch.float32)
        pm = _projection(d.shape[1], proj).to(d.device)
        dv = d[torch.as_tensor(v, device=d.device)]
        s = ((dv @ pm).mean(0) if len(dv)
             else torch.zeros(pm.shape[1], device=d.device))
        sigs.append((s / torch.clamp(torch.linalg.vector_norm(s),
                                     min=1e-12)).cpu().numpy())
    return np.stack(sigs).astype(np.float32)


def find_loop_closures(descriptors: Sequence,
                       valids: Sequence,
                       kp_xy: Sequence[np.ndarray],
                       min_gap: int = 5,
                       candidates_per_frame: int = 2,
                       min_sim: float = 0.6,
                       min_matches: int = 24,
                       min_inliers: int = 16,
                       ransac_threshold: float = 2e-3,
                       ratio: float = 0.86,
                       proj=None,
                       sampler: Optional[Sampler] = None,
                       device=None) -> List[LoopClosure]:
    """Detect and geometrically verify loop closures on `device`
    (default CUDA).

    kp_xy must be NORMALIZED (calibrated) coordinates, matching
    sfm.incremental.reconstruct's convention.
    """
    dev = resolve_device(device)
    descriptors = [torch.as_tensor(d, dtype=torch.float32, device=dev)
                   for d in descriptors]
    valids = [torch.as_tensor(v, device=dev) for v in valids]
    pm = _projection(descriptors[0].shape[1], proj)
    n_frames = len(descriptors)
    sigs = frame_signatures(descriptors, valids, pm)
    sim = sigs @ sigs.T

    pairs = []
    for j in range(n_frames):
        cand = [i for i in range(n_frames)
                if abs(j - i) >= min_gap and sim[i, j] >= min_sim]
        cand.sort(key=lambda i: -sim[i, j])
        for i in cand[:candidates_per_frame]:
            pairs.append((min(i, j), max(i, j)))
    pairs = sorted(set(pairs))

    closures: List[LoopClosure] = []
    for i, j in pairs:
        m = match_ratio_cascade(descriptors[j], descriptors[i],
                                q_valid=valids[j], t_valid=valids[i],
                                ratio=ratio, proj=pm)
        good = m.good.cpu().numpy()
        if good.sum() < min_matches:
            continue
        qi = np.where(good)[0]
        ti = m.train_idx.cpu().numpy()[qi].astype(np.int64)
        p_i = kp_xy[i][ti]
        p_j = kp_xy[j][qi]
        cap = pow2_cap(len(p_i), lo=16)
        p_i_p, valid = _pad2(p_i, cap)
        p_j_p, _ = _pad2(p_j, cap)
        valid = torch.as_tensor(valid, device=dev)
        res = find_essential_ransac(
            torch.as_tensor(p_i_p, device=dev),
            torch.as_tensor(p_j_p, device=dev), valid=valid,
            threshold=ransac_threshold,
            samples=draw(sampler, "essential", valid))
        n_inl = int(res.n_inliers)
        if not bool(res.ok) or n_inl < min_inliers:
            continue
        rel = np.concatenate([so3_log_f32(res.R), res.t.cpu().numpy()]
                             ).astype(np.float64)
        closures.append(LoopClosure(
            i=i, j=j, matches=np.stack([ti, qi], axis=1),
            n_inliers=n_inl, rel_pose=rel))
    return closures


def closures_as_matches(closures: Sequence[LoopClosure]
                        ) -> Dict[Tuple[int, int], np.ndarray]:
    """Matches-dict fragment for sfm.incremental.reconstruct."""
    return {(c.i, c.j): c.matches for c in closures}
