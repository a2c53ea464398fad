"""The frozen back end: bundle adjustment, the pose graph, incremental
SfM, the cascade matcher and loop closure.

Frozen copies, made at commit e6556db, of sift_tpu_torch/sfm/ba.py,
posegraph.py and loopclosure.py, ops/match_cascade.py (with
ops/match.py's masking and ops/extrema.py's stable top-k) and
utils/caps.py, and of sfm/incremental.py as the change that added this
copy left it (its two-view initialization kept only where the map
explains the next view), the expressions kept as they were, but for the
segment sums: each is index_add_ on host copies (`host_index_add`), a
sequential loop over all the rows in ascending order, whose bits the
program's fixed-order sum gives on every device. The program's counter
of BA shapes is left out. Imports nothing of the program.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from benchmark.reference.geometry_plain import (
    N_HYPOTHESES, PNP_HYPOTHESES, SAMPLE_SIZE, find_essential_ransac,
    pnp_ransac, sample_shape, so3_exp, so3_exp_jac, so3_log, triangulate)


def host_index_add(out: torch.Tensor, index: torch.Tensor, x: torch.Tensor
                   ) -> torch.Tensor:
    """out.index_add_(0, index, x) computed on host copies and moved back
    to out's device: the CPU's sequential order on every device."""
    got = out.cpu().index_add_(0, index.cpu(), x.cpu())
    return got.to(out.device)


def pow2_cap(n: int, lo: int = 16) -> int:
    """Smallest power of two >= max(n, 2), floored at `lo`."""
    return max(1 << int(np.ceil(np.log2(max(n, 2)))), lo)


class BAProblem(NamedTuple):
    """Static-shape bundle adjustment problem.

    cameras: (C, 6)  [w | t], world->camera, normalized coords
    points:  (P, 3)  world points
    cam_idx: (O,) int64 observation camera indices
    pt_idx:  (O,) int64 observation point indices
    uv:      (O, 2) observed normalized image coords
    mask:    (O,) bool valid-observation mask
    fixed_cams: (C,) bool -- cameras excluded from the update (gauge)
    """
    cameras: torch.Tensor
    points: torch.Tensor
    cam_idx: torch.Tensor
    pt_idx: torch.Tensor
    uv: torch.Tensor
    mask: torch.Tensor
    fixed_cams: torch.Tensor


def _residuals(prob: BAProblem) -> torch.Tensor:
    """(O, 2) normalized-coordinate reprojection residuals."""
    cams_o = prob.cameras[prob.cam_idx]
    xc = (so3_exp(cams_o[:, :3]) @ prob.points[prob.pt_idx][:, :, None]
          )[:, :, 0] + cams_o[:, 3:]
    z = torch.where(xc[:, 2].abs() > 1e-9, xc[:, 2], 1e-9)
    return xc[:, :2] / z[:, None] - prob.uv


def _robust_weight(r2: torch.Tensor, delta: float, loss: str
                   ) -> torch.Tensor:
    """IRLS weight on squared residual norms.

    huber: constant gradient beyond delta (Ceres default shape);
    cauchy: redescending -- gross outliers' influence -> 0.
    """
    if loss == "none":
        return torch.ones_like(r2)
    if loss == "cauchy":
        return 1.0 / (1.0 + r2 / (delta * delta))
    rn = torch.sqrt(r2 + 1e-20)
    return torch.where(rn <= delta, 1.0, delta / rn)


def _inv3x3_sym(h: torch.Tensor) -> torch.Tensor:
    """Batched closed-form inverse of symmetric PD (..., 3, 3)."""
    a, b, c = h[..., 0, 0], h[..., 0, 1], h[..., 0, 2]
    d, e, f = h[..., 1, 1], h[..., 1, 2], h[..., 2, 2]
    c00 = d * f - e * e
    c01 = c * e - b * f
    c02 = b * e - c * d
    c11 = a * f - c * c
    c12 = b * c - a * e
    c22 = a * d - b * b
    det = a * c00 + b * c01 + c * c02
    inv_det = 1.0 / torch.where(det.abs() > 1e-20, det, 1e-20)
    row0 = torch.stack([c00, c01, c02], dim=-1)
    row1 = torch.stack([c01, c11, c12], dim=-1)
    row2 = torch.stack([c02, c12, c22], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2) * inv_det[..., None, None]


def _build_system(prob: BAProblem, huber_delta: float, loss: str):
    """Per-observation Jacobian blocks and robust weights.

    Returns (jc (O,2,6), jp (O,2,3), res (O,2), w (O,)).
    """
    cams_o = prob.cameras[prob.cam_idx]
    x = prob.points[prob.pt_idx]
    r, dr = so3_exp_jac(cams_o[:, :3])                  # (O,3,3), (O,3,3,3)
    xc = (r @ x[:, :, None])[:, :, 0] + cams_o[:, 3:]
    front = xc[:, 2].abs() > 1e-9
    z = torch.where(front, xc[:, 2], 1e-9)
    res = xc[:, :2] / z[:, None] - prob.uv
    # d(xc[:2] / z) / d xc; a clamped depth has no slope
    inv_z = 1.0 / z
    zero = torch.zeros_like(z)
    dz = torch.where(front, -inv_z * inv_z, 0.0)
    dproj = torch.stack([torch.stack([inv_z, zero, xc[:, 0] * dz], -1),
                         torch.stack([zero, inv_z, xc[:, 1] * dz], -1)],
                        dim=1)                           # (O, 2, 3)
    dxc_dw = torch.einsum("oabi,ob->oai", dr, x)         # (O, 3, 3)
    jc = torch.cat([dproj @ dxc_dw, dproj], dim=2)       # (O, 2, 6)
    jp = dproj @ r                                       # (O, 2, 3)
    w = _robust_weight((res * res).sum(-1), huber_delta, loss)
    w = w * prob.mask.to(torch.float32)
    return jc, jp, res, w


def _cost(prob: BAProblem, huber_delta: float, loss: str,
          psum=None) -> torch.Tensor:
    res = _residuals(prob)
    r2 = (res * res).sum(-1)
    d2 = huber_delta * huber_delta
    if loss == "none":
        rho = 0.5 * r2
    elif loss == "cauchy":
        rho = 0.5 * d2 * torch.log1p(r2 / d2)
    else:
        rn = torch.sqrt(r2 + 1e-20)
        rho = torch.where(rn <= huber_delta, 0.5 * r2,
                          huber_delta * (rn - 0.5 * huber_delta))
    total = (rho * prob.mask.to(torch.float32)).sum()
    return psum(total) if psum is not None else total


_SAME = object()


def _lm_step(prob: BAProblem, lam: torch.Tensor, huber_delta: float,
             loss: str, cg_iters: int, psum=None, psum_pt=_SAME):
    """One damped Schur/CG step. Returns (dcams (C,6), dpts (P,3)).

    `psum` optionally reduces observation-sharded segment sums across
    devices (a sharded adjuster passes an all-reduce); None on one card.
    `psum_pt` separately controls the POINT-side reductions: for
    observation sharding it equals `psum` (points replicated); for
    point sharding it is None -- each device owns its point block and
    only camera-side reductions cross devices.
    """
    if psum_pt is _SAME:
        psum_pt = psum
    c = prob.cameras.shape[0]
    p = prob.points.shape[0]
    jc, jp, res, w = _build_system(prob, huber_delta, loss)
    wc = w[:, None, None]

    def seg_cam(x):  # (O, ...) -> (C, ...)
        out = host_index_add(x.new_zeros((c,) + x.shape[1:]), prob.cam_idx,
                             x)
        return psum(out) if psum is not None else out

    def seg_pt(x):   # (O, ...) -> (P, ...)
        out = host_index_add(x.new_zeros((p,) + x.shape[1:]), prob.pt_idx,
                             x)
        return psum_pt(out) if psum_pt is not None else out

    # normal-equation blocks
    rw = res * w[:, None]
    hcc = seg_cam(wc * jc.mT @ jc)                         # (C, 6, 6)
    hpp = seg_pt(wc * jp.mT @ jp)                          # (P, 3, 3)
    bc = -seg_cam((jc.mT @ rw[:, :, None])[:, :, 0])
    bp = -seg_pt((jp.mT @ rw[:, :, None])[:, :, 0])
    wcp = wc * jc.mT @ jp                                  # (O, 6, 3)

    # damping (LM, multiplicative on block diagonals)
    dev = prob.cameras.device
    eye6 = torch.eye(6, device=dev)
    eye3 = torch.eye(3, device=dev)
    hcc_d = hcc + lam * eye6 * torch.clamp(
        torch.diagonal(hcc, dim1=-2, dim2=-1), min=1e-6)[:, :, None]
    hpp_d = hpp + lam * eye3 * torch.clamp(
        torch.diagonal(hpp, dim1=-2, dim2=-1), min=1e-6)[:, :, None]
    hpp_inv = _inv3x3_sym(hpp_d)
    free = (~prob.fixed_cams).to(torch.float32)[:, None]

    def schur_apply(xc):
        """S xc = Hcc xc - Hcp Hpp^-1 Hpc xc, xc: (C, 6)."""
        xc = xc * free
        y = (xc[prob.cam_idx][:, None, :] @ wcp)[:, 0]     # (O, 3)
        u = (hpp_inv @ seg_pt(y)[:, :, None])[:, :, 0]     # (P, 3)
        v = (wcp @ u[prob.pt_idx][:, :, None])[:, :, 0]    # (O, 6)
        out = (hcc_d @ xc[:, :, None])[:, :, 0] - seg_cam(v)
        return out * free

    # Schur RHS: bc - Hcp Hpp^-1 bp
    u0 = (hpp_inv @ bp[:, :, None])[:, :, 0]
    rhs = (bc - seg_cam((wcp @ u0[prob.pt_idx][:, :, None])[:, :, 0])) * free

    # CG on the reduced camera system (fixed iterations, masked dofs)
    x = torch.zeros_like(rhs)
    r = rhs
    pdir = rhs
    rs = (r * r).sum()
    for _ in range(cg_iters):
        ap = schur_apply(pdir)
        denom = (pdir * ap).sum()
        alpha = torch.where(denom.abs() > 1e-20, rs / denom, 0.0)
        x = x + alpha * pdir
        r = r - alpha * ap
        rs_new = (r * r).sum()
        beta = torch.where(rs > 1e-20, rs_new / rs, 0.0)
        pdir = r + beta * pdir
        rs = rs_new
    dc = x * free

    # back-substitute points: dp = Hpp^-1 (bp - Hpc dc)
    y = (dc[prob.cam_idx][:, None, :] @ wcp)[:, 0]
    dp = (hpp_inv @ (bp - seg_pt(y))[:, :, None])[:, :, 0]
    return dc, dp


def bundle_adjust_loop(prob: BAProblem, iters: int, cg_iters: int,
                       huber_delta: float, loss: str, lam0: float,
                       psum=None, psum_pt=_SAME) -> BAProblem:
    """LM loop shared by the single-card and (future) sharded adjusters.

    With `psum`, the observation table is assumed sharded over devices:
    every cross-observation reduction -- normal-equation blocks,
    Schur/CG matvecs, costs -- is all-reduced, so each device computes
    the identical update. With `psum_pt=None` on top, points (and their
    observations) are device-local map blocks: point-side reductions
    stay on-device and only the camera system crosses devices.
    """
    lam = torch.tensor(lam0, dtype=torch.float32, device=prob.cameras.device)
    for _ in range(iters):
        dc, dp = _lm_step(prob, lam, huber_delta, loss, cg_iters,
                          psum=psum, psum_pt=psum_pt)
        cand = prob._replace(cameras=prob.cameras + dc,
                             points=prob.points + dp)
        c0 = _cost(prob, huber_delta, loss, psum=psum)
        c1 = _cost(cand, huber_delta, loss, psum=psum)
        accept = (c1 < c0) & c1.isfinite()
        prob = prob._replace(
            cameras=torch.where(accept, cand.cameras, prob.cameras),
            points=torch.where(accept, cand.points, prob.points))
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-9),
                          torch.clamp(lam * 4.0, max=1e3))
    return prob


def bundle_adjust(prob: BAProblem, iters: int = 20, cg_iters: int = 30,
                  huber_delta: float = 3e-3, loss: str = "huber",
                  lam0: float = 1e-3) -> BAProblem:
    """Run LM bundle adjustment; returns the problem with updated
    cameras/points. Fixed iteration count, accept/reject by cost, on
    the device of prob's tensors."""
    return bundle_adjust_loop(prob, iters, cg_iters, huber_delta, loss,
                              lam0)


def reproj_rmse(prob: BAProblem) -> torch.Tensor:
    """Masked RMS reprojection error (normalized coords)."""
    res = _residuals(prob)
    m = prob.mask.to(torch.float32)
    se = ((res * res).sum(-1) * m).sum()
    return torch.sqrt(se / torch.clamp(m.sum(), min=1.0))


class PoseGraph(NamedTuple):
    """poses: (V, 6) [w|t] world->frame transforms.
    edges_i/j: (E,) int64; rel: (E, 6) measured T_i->T_j as [w|t];
    weight: (E,) edge information weight; mask: (E,) bool;
    fixed: (V,) bool gauge mask."""
    poses: torch.Tensor
    edges_i: torch.Tensor
    edges_j: torch.Tensor
    rel: torch.Tensor
    weight: torch.Tensor
    mask: torch.Tensor
    fixed: torch.Tensor


def _edge_residual(pose_i, pose_j, rel6):
    """6-vector residuals of edges, (..., 6) each."""
    ra = so3_exp(pose_i[..., :3])
    rb = so3_exp(pose_j[..., :3])
    # predicted relative: T_i^-1 T_j
    r_pred = ra.mT @ rb
    t_pred = (ra.mT @ (pose_j[..., 3:] - pose_i[..., 3:])[..., None])[..., 0]
    r_meas = so3_exp(rel6[..., :3])
    dr = r_meas.mT @ r_pred
    dt = (r_meas.mT @ (t_pred - rel6[..., 3:])[..., None])[..., 0]
    return torch.cat([so3_log(dr), dt], dim=-1)


# per-edge (6, 6) residual Jacobians wrt each endpoint
_edge_jacobians = torch.func.vmap(torch.func.jacfwd(_edge_residual,
                                                    argnums=(0, 1)))


def _flat_block_index(a: torch.Tensor, b: torch.Tensor, v: int
                      ) -> torch.Tensor:
    """(E, 6, 6) flat indices of the 6x6 blocks (a_e, b_e) of a
    (6V x 6V) row-major matrix."""
    k = torch.arange(6, device=a.device)
    rows = (6 * a)[:, None, None] + k[None, :, None]
    cols = (6 * b)[:, None, None] + k[None, None, :]
    return rows * (6 * v) + cols


def optimize_pose_graph(g: PoseGraph, iters: int = 15,
                        lam0: float = 1e-4) -> PoseGraph:
    """Damped Gauss-Newton with accept/reject on the total cost, on the
    device of g's tensors; no host synchronisation inside the loop."""
    v = g.poses.shape[0]
    dev = g.poses.device
    ei, ej = g.edges_i.long(), g.edges_j.long()
    wm = g.weight * g.mask.to(torch.float32)
    sqw = torch.sqrt(wm)
    freev = (~g.fixed).to(torch.float32)
    free_flat = freev.repeat_interleave(6)
    fixed_flat = 1.0 - free_flat
    idx_ii = _flat_block_index(ei, ei, v).reshape(-1)
    idx_jj = _flat_block_index(ej, ej, v).reshape(-1)
    idx_ij = _flat_block_index(ei, ej, v).reshape(-1)
    idx_ji = _flat_block_index(ej, ei, v).reshape(-1)

    def cost(poses):
        res = _edge_residual(poses[ei], poses[ej], g.rel)
        return (res * res * wm[:, None]).sum()

    poses = g.poses.to(torch.float32)
    lam = torch.tensor(lam0, dtype=torch.float32, device=dev)
    for _ in range(iters):
        pi, pj = poses[ei], poses[ej]
        r = _edge_residual(pi, pj, g.rel)                  # (E, 6)
        ji, jj = _edge_jacobians(pi, pj, g.rel)            # (E, 6, 6)
        # weight + gauge: fixed endpoints contribute no columns
        ji = ji * (sqw * freev[ei])[:, None, None]
        jj = jj * (sqw * freev[ej])[:, None, None]
        rw = r * sqw[:, None]
        hij = ji.mT @ jj
        h = torch.zeros(36 * v * v, dtype=torch.float32, device=dev)
        h = host_index_add(h, idx_ii, (ji.mT @ ji).reshape(-1))
        h = host_index_add(h, idx_jj, (jj.mT @ jj).reshape(-1))
        h = host_index_add(h, idx_ij, hij.reshape(-1))
        h = host_index_add(h, idx_ji, hij.mT.reshape(-1))
        b = torch.zeros((v, 6), dtype=torch.float32, device=dev)
        b = host_index_add(b, ei, (ji.mT @ rw[:, :, None])[:, :, 0])
        b = host_index_add(b, ej, (jj.mT @ rw[:, :, None])[:, :, 0])
        hd = h.reshape(6 * v, 6 * v)
        damped = hd + torch.diag(
            lam * torch.clamp(torch.diagonal(hd), min=1e-8) + fixed_flat)
        delta, info = torch.linalg.solve_ex(damped, b.reshape(-1, 1))
        delta = torch.where(info == 0, delta[:, 0], torch.nan) * free_flat
        cand = poses - delta.reshape(v, 6)
        accept = (cost(cand) < cost(poses)) & cand.isfinite().all()
        poses = torch.where(accept, cand, poses)
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-9),
                          torch.clamp(lam * 4.0, max=1e3))
    return g._replace(poses=poses)


_SENTINEL = 1.0e6  # masked train descriptor value; L1 dist >= 1e8


def mask_train(train: torch.Tensor, t_valid: Optional[torch.Tensor]
               ) -> torch.Tensor:
    """Overwrite invalid train rows with a sentinel so they never match."""
    if t_valid is None:
        return train
    return torch.where(t_valid[..., None], train, _SENTINEL)


class Matches(NamedTuple):
    """Ratio-test-filtered matches, padded to query capacity.

    good[i] is True iff query i is valid, its best train match is
    valid, and d1 <= ratio * d2 (src/main.cpp:38).
    """
    query_idx: torch.Tensor  # (N,) int32 (= arange), or (G, N)
    train_idx: torch.Tensor  # (N,) or (G, N) int32
    distance: torch.Tensor   # float32
    good: torch.Tensor       # bool


def stable_top_k(x: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last dim, ties to the lower index (jax.lax.top_k's
    order): (values, int64 indices)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def projection(d: int, d_proj: int, seed: int) -> torch.Tensor:
    """(d, d_proj) Gaussian random projection with scale 1/sqrt(d), drawn
    from a torch.Generator seeded with `seed`. The JAX package draws its
    projection with jax.random, so the same seed gives a different
    matrix there; pass that matrix as `proj` to reproduce its results."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((d, d_proj), generator=gen,
                       dtype=torch.float32) / (d ** 0.5)


def match_ratio_cascade(query: torch.Tensor, train: torch.Tensor,
                        q_valid: Optional[torch.Tensor] = None,
                        t_valid: Optional[torch.Tensor] = None,
                        ratio: float = 0.86,
                        n_candidates: int = 64,
                        d_proj: int = 16,
                        proj: Optional[torch.Tensor] = None,
                        seed: int = 7,
                        tile: int = 512,
                        downstream_verified: bool = True) -> Matches:
    """Cascade kNN + Lowe ratio test: (N, D) x (M, D) -> Matches.

    proj: the (D, d_proj) projection; None draws `projection(D, d_proj,
    seed)`, which differs from the JAX package's draw for that seed.
    Queries are processed `tile` rows at a time, so the coarse distance
    matrix is at most (tile, M).

    downstream_verified: keep True only when the matches feed geometric
    verification (RANSAC), which absorbs the measured ~1-2 %
    hallucination rate on match-free queries. With False the candidate
    depth is raised to at least 128.
    """
    if not downstream_verified:
        n_candidates = max(n_candidates, 128)
    n, d = query.shape
    m = train.shape[0]
    dev = query.device
    if n == 0:
        return Matches(torch.zeros((0,), dtype=torch.int32, device=dev),
                       torch.zeros((0,), dtype=torch.int32, device=dev),
                       torch.zeros((0,), dtype=torch.float32, device=dev),
                       torch.zeros((0,), dtype=torch.bool, device=dev))
    if m < 2:
        # BFMatcher k=2 needs two train rows: nothing can be a good match
        return Matches(torch.arange(n, dtype=torch.int32, device=dev),
                       torch.zeros((n,), dtype=torch.int32, device=dev),
                       torch.full((n,), _SENTINEL, dtype=torch.float32,
                                  device=dev),
                       torch.zeros((n,), dtype=torch.bool, device=dev))
    c = min(n_candidates, m)
    if proj is None:
        proj = projection(d, d_proj, seed)
    proj = proj.to(device=dev, dtype=torch.float32)
    q32 = query.to(torch.float32)
    t32 = mask_train(train.to(torch.float32), t_valid)

    qp = q32 @ proj                                   # (N, d')
    tp = t32 @ proj                                   # (M, d')
    t_sq = (tp * tp).sum(dim=1)                       # (M,)

    idx, d1, d2 = [], [], []
    tile_n = min(tile, n)
    for s in range(0, n, tile_n):
        q_c = q32[s:s + tile_n]
        coarse = t_sq[None, :] - 2.0 * (qp[s:s + tile_n] @ tp.T)
        _, cand = stable_top_k(-coarse, c)            # (tile, C)
        dist = (q_c[:, None, :] - t32[cand]).abs().sum(dim=-1)
        neg, idx2 = stable_top_k(-dist, 2)
        idx.append(torch.gather(cand, 1, idx2[:, :1])[:, 0])
        d1.append(-neg[:, 0])
        d2.append(-neg[:, 1])
    idx, d1, d2 = torch.cat(idx), torch.cat(d1), torch.cat(d2)

    good = (d1 <= ratio * d2) & (d1 < _SENTINEL) & (d2 < _SENTINEL)
    if q_valid is not None:
        good = good & q_valid
    return Matches(torch.arange(n, dtype=torch.int32, device=dev),
                   idx.to(torch.int32), d1, good)


Sampler = Callable[[str, torch.Tensor, int, int, int], object]


# a two-view initialization is kept when PnP against its points keeps
# at least INIT_VIEW_INLIER_SHARE of the correspondences of each of the
# INIT_CHECK_VIEWS views that see most of them: the wrong one of a near
# planar pair's two essential matrices keeps 2-24 % in views a few
# frames from the pair; a sound pair whose baseline is short may keep
# less than half in its farthest views, and the next pair is then tried
INIT_VIEW_INLIER_SHARE = 0.5
INIT_CHECK_VIEWS = 6


def resolve_device(device=None) -> torch.device:
    """The SfM path's device: `device` if given, else CUDA."""
    return torch.device("cuda" if device is None else device)


def draw(sampler: Optional[Sampler], kind: str, valid: torch.Tensor,
         seed: int = 0):
    """The `samples=` of one default-sized RANSAC call of `kind`
    ("essential": the 5-point solver's, "pnp"): sampler's draw, or None
    (the call then draws its own)."""
    if sampler is None:
        return None
    n, k = (sample_shape(N_HYPOTHESES, "5pt")
            if kind == "essential" else (PNP_HYPOTHESES, SAMPLE_SIZE))
    return sampler(kind, valid, n, k, seed)


class _UnionFind:
    def __init__(self):
        self.parent: Dict = {}

    def find(self, a):
        p = self.parent.setdefault(a, a)
        while p != self.parent.setdefault(p, p):
            self.parent[a] = self.parent[p]
            a, p = p, self.parent[p]
        return p

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[ra] = rb


def build_tracks(n_frames: int,
                 matches: Dict[Tuple[int, int], np.ndarray]
                 ) -> List[Dict[int, int]]:
    """Union-find feature tracks.

    matches[(i, j)] is an (M, 2) int array of (kpt_i, kpt_j) pairs.
    Returns a list of tracks, each {frame: kpt_index}; tracks with
    conflicting observations (two kpts of one frame) are dropped.
    """
    uf = _UnionFind()
    for (i, j), m in matches.items():
        for a, b in np.asarray(m):
            uf.union((i, int(a)), (j, int(b)))
    groups: Dict = {}
    for node in list(uf.parent):
        groups.setdefault(uf.find(node), []).append(node)
    tracks = []
    for nodes in groups.values():
        if len(nodes) < 2:
            continue
        track: Dict[int, int] = {}
        ok = True
        for f, k in nodes:
            if f in track and track[f] != k:
                ok = False      # merged-track conflict: discard
                break
            track[f] = k
        if ok and len(track) >= 2:
            tracks.append(track)
    return tracks


class _ObsTable:
    """Flat observation table: one row per (track, frame) observation,
    sorted by key = track * n_frames + frame so any batch of
    (track, frame) lookups is a vectorized searchsorted. Pruning flips
    `alive` -- rows are never deleted, keeping the sort key valid for
    the whole reconstruction."""

    def __init__(self, tracks: List[Dict[int, int]],
                 kp_xy: Sequence[np.ndarray], n_frames: int):
        trk, frm, kpt = [], [], []
        for ti, tr in enumerate(tracks):
            for f, k in tr.items():
                trk.append(ti)
                frm.append(f)
                kpt.append(k)
        trk = np.asarray(trk, np.int64)
        frm = np.asarray(frm, np.int64)
        kpt = np.asarray(kpt, np.int64)
        order = np.argsort(trk * n_frames + frm)
        self.n_frames = n_frames
        self.n_tracks = len(tracks)
        self.track = trk[order].astype(np.int32)
        self.frame = frm[order].astype(np.int32)
        self.kpt = kpt[order].astype(np.int32)
        self.key = (self.track.astype(np.int64) * n_frames
                    + self.frame)
        self.uv = np.zeros((len(self.frame), 2), np.float32)
        for f in np.unique(self.frame):          # O(F) vectorized gathers
            rows = self.frame == f
            self.uv[rows] = np.asarray(kp_xy[f],
                                       np.float32)[self.kpt[rows]]
        self.alive = np.ones(len(self.track), bool)

    def lookup(self, t: np.ndarray, f) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized (track, frame) -> (row index, found & alive)."""
        q = np.asarray(t, np.int64) * self.n_frames + np.asarray(f)
        pos = np.searchsorted(self.key, q)
        pos = np.minimum(pos, max(len(self.key) - 1, 0))
        ok = (self.key[pos] == q) & self.alive[pos] \
            if len(self.key) else np.zeros(len(q), bool)
        return pos, ok

    def tracks_as_dicts(self) -> List[Dict[int, int]]:
        """Alive observations back as {frame: kpt} dicts (export /
        compatibility view; O(O) once at the end)."""
        out: List[Dict[int, int]] = [dict() for _ in range(self.n_tracks)]
        for t, f, k in zip(self.track[self.alive],
                           self.frame[self.alive],
                           self.kpt[self.alive]):
            out[t][int(f)] = int(k)
        return out


def _so3_exp_np(w: np.ndarray) -> np.ndarray:
    """Batched NumPy Rodrigues in float64: (F, 3) -> (F, 3, 3), for the
    host loop's bulk bookkeeping passes (pruning, retriangulation)."""
    w = np.asarray(w, np.float64)
    theta2 = np.einsum("fi,fi->f", w, w)
    theta = np.sqrt(theta2 + 1e-16)
    t2s = np.maximum(theta2, 1e-16)
    a = np.where(theta2 > 1e-16, np.sin(theta) / theta,
                 1.0 - theta2 / 6.0)
    b = np.where(theta2 > 1e-16, (1.0 - np.cos(theta)) / t2s,
                 0.5 - theta2 / 24.0)
    z = np.zeros_like(w[:, 0])
    k = np.stack([
        np.stack([z, -w[:, 2], w[:, 1]], -1),
        np.stack([w[:, 2], z, -w[:, 0]], -1),
        np.stack([-w[:, 1], w[:, 0], z], -1),
    ], 1)
    kk = np.einsum("fij,fjk->fik", k, k)
    return (np.eye(3)[None] + a[:, None, None] * k
            + b[:, None, None] * kk)


def so3_exp_f32(w: np.ndarray) -> np.ndarray:
    """lie.so3_exp of (..., 3) axis-angles in float32 on the CPU, as a
    NumPy array (the host loop's small conversions: the same numbers on
    every device)."""
    return so3_exp(torch.as_tensor(np.asarray(w), dtype=torch.float32)
                       ).numpy()


def so3_log_f32(r) -> np.ndarray:
    """lie.so3_log in float32 on the CPU of a (3, 3) array or tensor."""
    return so3_log(torch.as_tensor(r, dtype=torch.float32).cpu()
                       ).numpy()


@dataclasses.dataclass
class Reconstruction:
    """Result of incremental SfM (NumPy, host-side)."""
    cameras: np.ndarray          # (F, 6) [w|t], world->cam
    registered: np.ndarray       # (F,) bool
    points: np.ndarray           # (T, 3) one slot per track
    has_point: np.ndarray        # (T,) bool
    tracks: List[Dict[int, int]]
    reproj_rmse: float


def _ba_tables(table: _ObsTable, cameras, registered, points, has_point,
               obs_cap: Optional[int] = None,
               anchor_frame: Optional[int] = None,
               free_frames: Optional[np.ndarray] = None,
               device=None):
    """Flatten the current map into a static BAProblem on `device` (one
    vectorized pass over the observation table).

    Only observations of registered cameras with finite parameters are
    included (a camera whose registration failed must not contribute
    NaN residuals). ``anchor_frame`` is additionally marked fixed to
    pin the 6-dof gauge; without it no registered camera is fixed and
    only LM damping regularizes the singular Schur system.

    ``free_frames`` (bool (F,)) restricts the problem to a LOCAL
    window: only cameras in the window move, and only tracks observed
    by a window camera enter the table (other cameras observing those
    tracks stay as fixed anchors) -- incremental cost stays bounded
    by the window, not the map.

    Capacities (observation count, live-point count) are padded to
    powers of two, as in the program, so that both solve the same
    padded system.
    Observation-less padded points receive bp=0 and dp=0 in the LM step
    and are returned untouched.
    """
    dev = resolve_device(device)
    finite_cam = np.isfinite(cameras).all(axis=1)
    usable = registered & finite_cam
    obs_ok = table.alive & usable[table.frame] & has_point[table.track]
    if free_frames is not None:
        touched = np.zeros(table.n_tracks, bool)
        touched[table.track[obs_ok & free_frames[table.frame]]] = True
        live_mask = has_point & touched
    else:
        live_mask = has_point
    sel = obs_ok & live_mask[table.track]
    live = np.where(live_mask)[0]
    remap = np.zeros(table.n_tracks, np.int64)
    remap[live] = np.arange(len(live))
    cam_idx = table.frame[sel].astype(np.int64)
    pt_idx = remap[table.track[sel]]
    uv = table.uv[sel]

    o = len(cam_idx)
    cap = obs_cap or pow2_cap(o, lo=64)
    pad = cap - o
    mask = np.zeros(cap, bool)
    mask[:o] = True
    fixed = ~usable
    if free_frames is not None:
        fixed = fixed | ~free_frames
    if anchor_frame is not None:
        fixed = fixed.copy()
        fixed[anchor_frame] = True
    # non-finite (failed) cameras are fixed + observation-free, but
    # zero their params so fixed-slot arithmetic stays NaN-free
    safe_cameras = np.where(finite_cam[:, None], cameras, 0.0)
    pt_cap = pow2_cap(len(live), lo=32)
    pts = np.zeros((pt_cap, 3), points.dtype)
    pts[:len(live)] = points[live]

    def on(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    prob = BAProblem(
        cameras=on(safe_cameras, torch.float32),
        points=on(pts, torch.float32),
        cam_idx=on(np.concatenate([cam_idx, np.zeros(pad, np.int64)]),
                   torch.long),
        pt_idx=on(np.concatenate([pt_idx, np.zeros(pad, np.int64)]),
                  torch.long),
        uv=on(np.concatenate([uv, np.zeros((pad, 2), np.float32)]),
              torch.float32),
        mask=on(mask, torch.bool),
        fixed_cams=on(fixed, torch.bool))
    return prob, live


def _pose_rt(cam6):
    return so3_exp_f32(cam6[:3]), np.asarray(cam6[3:], np.float64)


def _pad2(a: np.ndarray, cap: int):
    """(cap, D) float32 zero-padded copy of a and its (cap,) mask."""
    out = np.zeros((cap, a.shape[1]), np.float32)
    out[:len(a)] = a
    m = np.zeros(cap, bool)
    m[:len(a)] = True
    return out, m


def reconstruct(kp_xy: Sequence[np.ndarray],
                matches: Dict[Tuple[int, int], np.ndarray],
                init_pair: Optional[Tuple[int, int]] = None,
                ransac_threshold: float = 2e-3,
                ba_every: int = 3,
                ba_iters: int = 12,
                min_pnp_points: int = 12,
                ba_window: Optional[int] = 8,
                retriangulate_every: int = 2,
                prune_factor: float = 4.0,
                sampler: Optional[Sampler] = None,
                device=None) -> Reconstruction:
    """Run incremental SfM; the solvers run on `device` (default CUDA).

    kp_xy: per-frame (N_f, 2) NORMALIZED keypoint coordinates.
    matches: {(i, j): (M, 2) keypoint index pairs}, i < j.
    ba_window: periodic BA optimizes only the last `ba_window`
        registered frames (plus their tracks) -- bounded incremental
        cost; None = global. The final BA is always global.
    retriangulate_every: refresh live points from all their registered
        rays (multi-view midpoint) every N-th periodic BA (0 disables).
    prune_factor: after each BA, drop observations with reprojection
        error > prune_factor * ransac_threshold (COLMAP-style track
        filtering; 0 disables).
    sampler: the RANSAC calls' minimal samples (module docstring).
    """
    dev = resolve_device(device)
    n_frames = len(kp_xy)
    tracks = build_tracks(n_frames, matches)
    table = _ObsTable(tracks, kp_xy, n_frames)
    n_tracks = table.n_tracks
    cameras = np.zeros((n_frames, 6), np.float64)
    registered = np.zeros(n_frames, bool)
    failed = np.zeros(n_frames, bool)   # PnP-rejected views: never BA'd
    points = np.zeros((n_tracks, 3), np.float64)
    has_point = np.zeros(n_tracks, bool)

    def usable_frames():
        return registered & np.isfinite(cameras).all(axis=1)

    def on(a):
        return torch.as_tensor(a, device=dev)

    def adjust(prob, live, iters):
        out = bundle_adjust(prob, iters=iters, loss="cauchy",
                            huber_delta=ransac_threshold)
        cameras[registered] = out.cameras.cpu().numpy()[registered]
        points[live] = out.points.cpu().numpy()[:len(live)]
        return out

    # triangulate tracks between two registered frames; returns the
    # number of accepted (cheirality-positive, finite) points
    def tri_tracks(track_ids, fa, fb) -> int:
        track_ids = np.asarray(track_ids, np.int64)
        ra, ta = _pose_rt(cameras[fa])
        rb, tb = _pose_rt(cameras[fb])
        ia, oka = table.lookup(track_ids, fa)
        ib, okb = table.lookup(track_ids, fb)
        keep = oka & okb
        track_ids, ia, ib = track_ids[keep], ia[keep], ib[keep]
        if not len(track_ids):
            return 0
        x = triangulate(on(ra), on(ta.astype(np.float32)),
                        on(rb), on(tb.astype(np.float32)),
                        on(table.uv[ia]), on(table.uv[ib])).cpu().numpy()
        za = (x @ ra.T + ta)[:, 2]
        zb = (x @ rb.T + tb)[:, 2]
        good = (za > 1e-3) & (zb > 1e-3) & np.isfinite(x).all(axis=1)
        points[track_ids[good]] = x[good]
        has_point[track_ids[good]] = True
        return int(good.sum())

    def retriangulate():
        """Refresh every live point from ALL its registered rays in one
        vectorized multi-view midpoint pass: per observation the ray
        (camera center, world direction), per track the 3x3 normal
        system sum_o (I - d d^T) x = sum_o (I - d d^T) c accumulated
        with bincount segment sums."""
        usable = usable_frames()
        sel = table.alive & usable[table.frame] & has_point[table.track]
        idx = np.where(sel)[0]
        if not len(idx):
            return
        f = table.frame[idx].astype(np.int64)
        t = table.track[idx].astype(np.int64)
        rw = _so3_exp_np(cameras[:, :3])          # (F, 3, 3)
        centers = -np.einsum("fij,fi->fj", rw, cameras[:, 3:])
        d_cam = np.concatenate(
            [table.uv[idx].astype(np.float64),
             np.ones((len(idx), 1))], 1)
        d_cam /= np.linalg.norm(d_cam, axis=1, keepdims=True)
        d = np.einsum("oij,oi->oj", rw[f], d_cam)  # world directions
        m = np.eye(3)[None] - d[:, :, None] * d[:, None, :]  # (O,3,3)
        mc = np.einsum("oij,oj->oi", m, centers[f])
        a9 = np.stack(
            [np.bincount(t, weights=m[:, i, j], minlength=n_tracks)
             for i in range(3) for j in range(3)], 1)
        b3 = np.stack(
            [np.bincount(t, weights=mc[:, i], minlength=n_tracks)
             for i in range(3)], 1)
        cnt = np.bincount(t, minlength=n_tracks)
        live = np.where((cnt >= 2) & has_point)[0]
        if not len(live):
            return
        a = a9[live].reshape(-1, 3, 3)
        det = np.linalg.det(a)
        solvable = np.abs(det) > 1e-9
        x = np.zeros((len(live), 3))
        if solvable.any():
            x[solvable] = np.linalg.solve(
                a[solvable], b3[live][solvable][:, :, None])[:, :, 0]
        # cheirality over every contributing ray: a track is refreshed
        # only if ALL its registered observations see the new point in
        # front of the camera
        remap = np.full(n_tracks, -1, np.int64)
        remap[live] = np.arange(len(live))
        z = (np.einsum("oij,oj->oi", rw[f], x[remap[t]])
             + cameras[f, 3:])[:, 2]
        n_behind = np.bincount(t, weights=(z <= 1e-3).astype(np.float64),
                               minlength=n_tracks)[live]
        ok = solvable & (n_behind == 0) & np.isfinite(x).all(axis=1)
        points[live[ok]] = x[ok]

    def prune_observations(max_err: float) -> int:
        """COLMAP-style track filtering: drop observations whose
        reprojection error exceeds max_err; tracks left with <2
        registered views lose their point. Returns the number of
        observations removed."""
        usable = usable_frames()
        sel = table.alive & usable[table.frame] & has_point[table.track]
        idx = np.where(sel)[0]
        if not len(idx):
            return 0
        f = table.frame[idx].astype(np.int64)
        t = table.track[idx].astype(np.int64)
        rw = _so3_exp_np(cameras[:, :3])
        xc = (np.einsum("oij,oj->oi", rw[f], points[t])
              + cameras[f, 3:])
        z = xc[:, 2]
        err = np.linalg.norm(
            xc[:, :2] / np.maximum(z, 1e-12)[:, None]
            - table.uv[idx], axis=1)
        bad = (z <= 1e-6) | (err > max_err)
        table.alive[idx[bad]] = False
        alive_reg = table.alive & registered[table.frame]
        cnt_reg = np.bincount(table.track[alive_reg],
                              minlength=n_tracks)
        cnt_all = np.bincount(table.track[table.alive],
                              minlength=n_tracks)
        has_point[(cnt_all < 2) | (cnt_reg < 2)] = False
        return int(bad.sum())

    def overlaps():
        """The observations of points in unregistered views, and each
        view's count of them (one bincount)."""
        cand = (table.alive & has_point[table.track]
                & ~registered[table.frame] & ~failed[table.frame])
        return cand, np.bincount(table.frame[cand], minlength=n_frames)

    def next_view():
        """The unregistered view with the largest 2D-3D overlap and that
        overlap."""
        cand, counts = overlaps()
        best_f = int(counts.argmax())
        return cand, best_f, int(counts[best_f])

    def view_pnp(cand, best_f):
        """PnP RANSAC of view best_f against the points it observes:
        (result, its valid correspondences)."""
        rows = cand & (table.frame == best_f)
        ts = table.track[rows].astype(np.int64)
        cap = pow2_cap(len(ts), lo=16) * 2
        x3p, maskp = _pad2(points[ts], cap)
        p2p, _ = _pad2(table.uv[rows], cap)
        valid = on(maskp)
        pres = pnp_ransac(on(x3p), on(p2p), valid=valid,
                          threshold=ransac_threshold,
                          samples=draw(sampler, "pnp", valid))
        return pres, len(ts)

    def init_pair_map(i0, j0) -> bool:
        """Register frames i0, j0 from their essential matrix and
        triangulate their shared tracks; True with at least
        min_pnp_points points, else everything rolled back."""
        m0 = np.asarray(matches[(i0, j0)])
        if len(m0) < 16:
            return False
        cap = pow2_cap(len(m0), lo=16) * 2
        p0, mask0 = _pad2(kp_xy[i0][m0[:, 0]], cap)
        p1, _ = _pad2(kp_xy[j0][m0[:, 1]], cap)
        valid = on(mask0)
        res = find_essential_ransac(on(p0), on(p1), valid=valid,
                                    threshold=ransac_threshold,
                                    samples=draw(sampler, "essential",
                                                 valid))
        if not bool(res.ok):
            return False
        cameras[j0, :3] = so3_log_f32(res.R)
        cameras[j0, 3:] = res.t.cpu().numpy()
        registered[i0] = registered[j0] = True
        # tracks observed in BOTH init frames (vectorized lookups)
        all_t = np.arange(n_tracks, dtype=np.int64)
        _, in_i0 = table.lookup(all_t, i0)
        _, in_j0 = table.lookup(all_t, j0)
        init_tracks = all_t[in_i0 & in_j0]
        n_ok = tri_tracks(init_tracks, i0, j0) if len(init_tracks) else 0
        if n_ok >= min_pnp_points:
            return True
        # degenerate baseline: roll back
        registered[i0] = registered[j0] = False
        cameras[j0] = 0.0
        points[:] = 0.0
        has_point[:] = False
        return False

    def explains_next_views() -> bool:
        """Whether the two-view map explains the views that see most of
        it: a pair seen (near-)planar gives two essential matrices that
        fit it alike, and the wrong one's points put the views beyond
        the pair off most of their correspondences (the nearest view
        may still fit). True where no view overlaps enough to tell."""
        cand, counts = overlaps()
        views = np.argsort(-counts, kind="stable")[:INIT_CHECK_VIEWS]
        for f in views[counts[views] >= min_pnp_points]:
            pres, n_valid = view_pnp(cand, int(f))
            if not (bool(pres.ok) and int(pres.n_inliers)
                    >= INIT_VIEW_INLIER_SHARE * n_valid):
                return False
        return True

    # --- initialization: try pairs by match count until one yields a
    # well-conditioned baseline (near-pure-rotation pairs triangulate
    # nothing and are rejected by cheirality) whose map explains the
    # views that see most of it; if none does, the first pair with a
    # baseline ---
    candidates = ([init_pair] if init_pair is not None else
                  sorted(matches, key=lambda k: -len(matches[k])))
    init_done = False
    first = None
    for (i0, j0) in candidates:
        if not init_pair_map(i0, j0):
            continue
        if explains_next_views():
            init_done = True
            break
        first = first or (i0, j0)
        registered[i0] = registered[j0] = False
        cameras[j0] = 0.0
        points[:] = 0.0
        has_point[:] = False
    if not init_done and first is not None:
        i0, j0 = first
        init_done = init_pair_map(i0, j0)
    if not init_done:
        raise RuntimeError(
            "two-view initialization failed: no pair with a usable "
            "baseline (all candidate pairs near-degenerate, e.g. pure "
            "rotation, or too few matches)")

    # --- incremental registration ---
    n_since_ba = 0
    n_bas = 0
    reg_order: List[int] = [i0, j0]
    while True:
        cand, best_f, best_overlap = next_view()
        if best_overlap < min_pnp_points:
            break

        pres, _ = view_pnp(cand, best_f)
        if not bool(pres.ok) or int(pres.n_inliers) < min_pnp_points // 2:
            # cannot register this view; blacklist it (NOT registered,
            # so its observations never enter BA) to avoid re-trying
            failed[best_f] = True
            continue
        registered[best_f] = True
        reg_order.append(best_f)
        cameras[best_f, :3] = so3_log_f32(pres.R)
        cameras[best_f, 3:] = pres.t.cpu().numpy()

        # triangulate new tracks now visible from >= 2 registered
        # views: per-track first/last registered frame via segment
        # min/max over the table, grouped by frame pair
        usable = usable_frames()
        reg_obs = table.alive & usable[table.frame]
        cnt = np.bincount(table.track[reg_obs], minlength=n_tracks)
        new_mask = ~has_point & (cnt >= 2)
        sel = reg_obs & new_mask[table.track]
        if sel.any():
            tsel = table.track[sel].astype(np.int64)
            fsel = table.frame[sel].astype(np.int64)
            fa = np.full(n_tracks, n_frames, np.int64)
            fb = np.full(n_tracks, -1, np.int64)
            np.minimum.at(fa, tsel, fsel)
            np.maximum.at(fb, tsel, fsel)
            new_t = np.where(new_mask)[0]
            pair_key = fa[new_t] * n_frames + fb[new_t]
            for key in np.unique(pair_key):
                grp = new_t[pair_key == key]
                tri_tracks(grp, int(key // n_frames),
                           int(key % n_frames))

        n_since_ba += 1
        if n_since_ba >= ba_every and has_point.any():
            n_since_ba = 0
            n_bas += 1
            if retriangulate_every and n_bas % retriangulate_every == 0:
                retriangulate()
            free = None
            if ba_window is not None:
                free = np.zeros(n_frames, bool)
                free[reg_order[-ba_window:]] = True
            adjust(*_ba_tables(table, cameras, registered, points,
                               has_point, anchor_frame=i0,
                               free_frames=free, device=dev), ba_iters)
            if prune_factor:
                prune_observations(prune_factor * ransac_threshold)

    # --- final BA (always global) ---
    if not has_point.any():
        raise RuntimeError("reconstruction has no 3-D points")
    if retriangulate_every:
        retriangulate()
    out = adjust(*_ba_tables(table, cameras, registered, points, has_point,
                             anchor_frame=i0, device=dev), ba_iters * 2)
    if prune_factor and prune_observations(
            prune_factor * ransac_threshold) and has_point.any():
        # contaminated observations left the table: one more clean BA
        out = adjust(*_ba_tables(table, cameras, registered, points,
                                 has_point, anchor_frame=i0, device=dev),
                     ba_iters)
    rmse = float(reproj_rmse(out))

    cameras[failed] = np.nan        # mark unregisterable views clearly
    return Reconstruction(cameras=cameras, registered=registered,
                          points=points, has_point=has_point,
                          tracks=table.tracks_as_dicts(),
                          reproj_rmse=rmse)


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
