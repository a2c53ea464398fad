"""Perspective-n-Point: camera pose from 2D-3D correspondences.

Twin of sift_tpu/geometry/pnp.py, used by incremental SfM to register
new views against the map: a fixed seeded batch of 6-point minimal
samples (Gumbel top-k, or injected through `samples=`), each solved at
once by the weighted DLT and by the planar homography decomposition
(IPPE-style), whichever explains more points; a locally-optimized refit
with both solvers, then Gauss-Newton on the inlier reprojection error
over the 6-dof pose. On the card the Gauss-Newton polish (`_polish`)
replays as a CUDA graph (geometry/graphs.py); the DLT, planar and LO
solvers' eigh and SVD wait for the card and stay eager.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from sift_tpu_torch.geometry import graphs
from sift_tpu_torch.geometry.homography import draw_samples
from sift_tpu_torch.geometry.lie import so3_exp, so3_log
from sift_tpu_torch.geometry.linalg import smallest_eigvec
from sift_tpu_torch.utils.profiling import span

SAMPLE_SIZE = 6
N_HYPOTHESES = 512


class PnPResult(NamedTuple):
    R: torch.Tensor          # (3, 3) world->camera
    t: torch.Tensor          # (3,)
    inliers: torch.Tensor    # (N,) bool
    n_inliers: torch.Tensor  # () int32
    ok: torch.Tensor         # () bool


def _orthonormalize(m: torch.Tensor):
    """Nearest rotation to (..., 3, 3) m by SVD, det forced to +1;
    returns (R, the singular values with the last one's sign fixed)."""
    uu, ss, vt = torch.linalg.svd(m)
    d = torch.sign(torch.linalg.det(uu @ vt))
    flip = torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1)
    return (uu * flip[..., None, :]) @ vt, ss * flip


def _dlt_pnp(x: torch.Tensor, p: torch.Tensor, w: torch.Tensor):
    """Weighted DLT pose: world points x (..., N, 3), normalized obs p
    (..., N, 2), weights w (..., N). Returns (R (..., 3, 3), t (..., 3))
    with R orthogonalized by SVD.

    3-D points are centroid/scale-normalized before the solve (without
    it the 12x12 system is badly conditioned for deep scenes) and the
    projection matrix denormalized after.
    """
    cw = torch.clamp(w.sum(-1), min=1e-9)[..., None]
    cen = (x * w[..., None]).sum(-2) / cw                   # (..., 3)
    spread = (torch.linalg.vector_norm(x - cen[..., None, :], dim=-1)
              * w).sum(-1, keepdim=True) / cw
    s = torch.clamp(spread, min=1e-9) / math.sqrt(3.0)       # (..., 1)
    xn = (x - cen[..., None, :]) / s[..., None]
    zeros = torch.zeros_like(xn[..., :1])
    ones = torch.ones_like(zeros)
    u, v = p[..., 0:1], p[..., 1:2]
    # rows for u: [X 1 0 -uX -u], layout P = [p11..p14; p21..p24; p31..p34]
    row_u = torch.cat([xn, ones, torch.zeros_like(xn), zeros,
                       -u * xn, -u], dim=-1)
    row_v = torch.cat([torch.zeros_like(xn), zeros, xn, ones,
                       -v * xn, -v], dim=-1)
    a = torch.cat([row_u * w[..., None], row_v * w[..., None]], dim=-2)
    pm = smallest_eigvec(a.mT @ a).reshape(*a.shape[:-2], 3, 4)
    # denormalize: P acts on original coords via x' = (x - cen)/s
    m3 = pm[..., :3] / s[..., None]
    pm = torch.cat([m3, (pm[..., 3] - (m3 @ cen[..., :, None])[..., 0])
                    [..., None]], dim=-1)
    # fix sign: points must be in front (positive depth for the
    # weighted centroid)
    depth = (pm[..., 2, :3] * cen).sum(-1) + pm[..., 2, 3]
    pm = pm * torch.where(depth < 0, -1.0, 1.0)[..., None, None]
    # orthogonalize: R = U V^T, scale = mean singular value
    r, ss = _orthonormalize(pm[..., :3])
    scale = ss.mean(-1)
    t = pm[..., 3] / torch.where(scale.abs() > 1e-12, scale,
                                 1e-12)[..., None]
    return r, t


def _planar_pnp(x: torch.Tensor, p: torch.Tensor, w: torch.Tensor):
    """Weighted pose for (near-)coplanar points, shapes as _dlt_pnp: the
    6-point DLT's 12x12 system drops rank when the sample lies on one
    plane (walls, floors, facades), so RANSAC scores this
    homography-decomposition pose alongside it.

    Fit the best plane (weighted covariance eigenbasis), DLT the
    plane->image homography, factor H = [h1 h2 h3] into
    [r1 r2 t] / lambda with lambda = 2 / (|h1| + |h2|), orthonormalize
    [r1 r2 r1xr2] by SVD projection, then map back from plane
    coordinates to world: R = R_plane @ [b1 b2 n]^T, t = t_p - R cen.
    """
    cw = torch.clamp(w.sum(-1), min=1e-9)[..., None]
    cen = (x * w[..., None]).sum(-2) / cw
    xc = x - cen[..., None, :]
    cov = (xc * w[..., None]).mT @ xc / cw[..., None]
    _, evecs = torch.linalg.eigh(cov)           # ascending eigenvalues
    normal = evecs[..., 0]
    b = evecs[..., 1:]                          # (..., 3, 2) plane basis
    # right-handed plane frame [b1 b2 n]
    normal = normal * torch.sign(torch.linalg.det(
        torch.cat([b, normal[..., None]], dim=-1)))[..., None]
    m_w2p = torch.cat([b, normal[..., None]], dim=-1).mT      # (..., 3, 3)
    q = xc @ b                                  # (..., N, 2) plane coords
    scale = torch.clamp((torch.linalg.vector_norm(q, dim=-1) * w).sum(
        -1, keepdim=True) / cw, min=1e-9)       # (..., 1)
    q = q / scale[..., None]
    u, v = p[..., 0], p[..., 1]
    ones = torch.ones_like(u)
    zeros = torch.zeros_like(u)
    rows_u = torch.stack([q[..., 0], q[..., 1], ones,
                          zeros, zeros, zeros,
                          -u * q[..., 0], -u * q[..., 1], -u], dim=-1)
    rows_v = torch.stack([zeros, zeros, zeros,
                          q[..., 0], q[..., 1], ones,
                          -v * q[..., 0], -v * q[..., 1], -v], dim=-1)
    a = torch.cat([rows_u * w[..., None], rows_v * w[..., None]], dim=-2)
    h = smallest_eigvec(a.mT @ a).reshape(*a.shape[:-2], 3, 3)
    h = torch.cat([h[..., :2] / scale[..., None], h[..., 2:]], dim=-1)
    # cheirality: the plane centroid projects to h3 -- positive depth
    h = h * torch.where(h[..., 2, 2] < 0, -1.0, 1.0)[..., None, None]
    n1 = torch.linalg.vector_norm(h[..., 0], dim=-1)
    n2 = torch.linalg.vector_norm(h[..., 1], dim=-1)
    lam = 2.0 / torch.clamp(n1 + n2, min=1e-12)
    r12 = h[..., :2] * lam[..., None, None]
    r3 = torch.linalg.cross(r12[..., 0], r12[..., 1], dim=-1)
    r_plane, _ = _orthonormalize(torch.cat([r12, r3[..., None]], dim=-1))
    t_p = h[..., 2] * lam[..., None]
    r = r_plane @ m_w2p
    return r, t_p - (r @ cen[..., :, None])[..., 0]


def _reproj_sq(r, t, x, p):
    """Squared reprojection errors of poses (..., 3, 3), (..., 3) over
    (N, 3) points -> (..., N); behind the camera or non-finite: inf."""
    xc = x @ r.mT + t[..., None, :]
    z = xc[..., 2]
    proj = xc[..., :2] / torch.where(z.abs() > 1e-9, z, 1e-9)[..., None]
    err = ((proj - p) ** 2).sum(-1)
    err = torch.where(z > 1e-6, err, torch.inf)   # behind camera = outlier
    return torch.where(err.isfinite(), err, torch.inf)


def _polish(params: torch.Tensor, x: torch.Tensor, p: torch.Tensor,
            wmask: torch.Tensor) -> torch.Tensor:
    """Five Gauss-Newton steps on the weighted reprojection residuals of
    world points x (N, 3) against observations p (N, 2): params (w, t)
    in, params out."""

    def residuals(q):
        xc = x @ so3_exp(q[:3]).T + q[3:]
        z = torch.where(xc[:, 2].abs() > 1e-9, xc[:, 2], 1e-9)
        proj = xc[:, :2] / z[:, None]
        return ((proj - p) * wmask[:, None]).reshape(-1)

    eye6 = torch.eye(6, device=params.device)
    for _ in range(5):
        res = residuals(params)
        j = torch.func.jacfwd(residuals)(params)
        jtj = j.T @ j + 1e-9 * eye6
        delta, info = torch.linalg.solve_ex(jtj, (j.T @ res)[:, None])
        cand = torch.where(info == 0, params - delta[:, 0], torch.nan)
        params = torch.where(cand.isfinite().all(), cand, params)
    return params


def pnp_ransac(x: torch.Tensor, p: torch.Tensor,
               valid: Optional[torch.Tensor] = None,
               threshold: float = 2e-3,
               n_hypotheses: int = N_HYPOTHESES,
               seed: int = 0,
               samples: Optional[torch.Tensor] = None) -> PnPResult:
    """RANSAC PnP: world points x (N, 3), normalized obs p (N, 2).
    samples: optional (n_hypotheses, SAMPLE_SIZE) indices that replace
    the drawn ones. Runs on x's device. Span `geometry.pnp`: n (the
    padded N) and graph_hit (the polish replayed a graph)."""
    n = x.shape[0]
    with span("geometry.pnp", n=n, graph_hit=False) as sp:
        hits = graphs.CACHE.hits
        x = x.to(torch.float32)
        p = p.to(torch.float32)
        dev = x.device
        if valid is None:
            valid = torch.ones((n,), dtype=torch.bool, device=dev)
        thr2 = threshold * threshold
        idx = draw_samples(valid, n_hypotheses, SAMPLE_SIZE, seed, samples)

        # score both the general DLT pose and the planar-decomposition pose:
        # whichever explains more points wins -- mixed scenes use DLT,
        # single-plane samples (where DLT drops rank) use planar
        ones = torch.ones(idx.shape, device=dev)
        rd, td = _dlt_pnp(x[idx], p[idx], ones)
        rp, tp = _planar_pnp(x[idx], p[idx], ones)
        nd = ((_reproj_sq(rd, td, x, p) < thr2) & valid).sum(
            -1, dtype=torch.int32)
        np_ = ((_reproj_sq(rp, tp, x, p) < thr2) & valid).sum(
            -1, dtype=torch.int32)
        use_p = np_ > nd
        counts = torch.maximum(nd, np_)
        rs = torch.where(use_p[:, None, None], rp, rd)
        ts = torch.where(use_p[:, None], tp, td)
        best = torch.argmax(counts)
        r_best, t_best = rs[best], ts[best]
        inliers = (_reproj_sq(r_best, t_best, x, p) < thr2) & valid
        ok = counts[best] >= SAMPLE_SIZE

        # locally-optimized refit + GN polish (both solvers -- an all-inlier
        # refit on a planar map degenerates the DLT exactly like a minimal
        # sample does)
        for _ in range(2):
            for solver in (_dlt_pnp, _planar_pnp):
                r_ref, t_ref = solver(x, p, inliers.to(torch.float32))
                inl_ref = (_reproj_sq(r_ref, t_ref, x, p) < thr2) & valid
                better = inl_ref.sum() >= inliers.sum()
                r_best = torch.where(better, r_ref, r_best)
                t_best = torch.where(better, t_ref, t_best)
                inliers = torch.where(better, inl_ref, inliers)

        wmask = inliers.to(torch.float32)
        params = torch.cat([so3_log(r_best), t_best])
        params = graphs.CACHE.run("pnp.polish", _polish, (params, x, p, wmask))
        r_gn = so3_exp(params[:3])
        t_gn = params[3:]
        inl_gn = (_reproj_sq(r_gn, t_gn, x, p) < thr2) & valid
        better = inl_gn.sum() >= inliers.sum()
        r_best = torch.where(better, r_gn, r_best)
        t_best = torch.where(better, t_gn, t_best)
        inliers = torch.where(better, inl_gn, inliers)

        sp.set(graph_hit=graphs.CACHE.hits - hits == 1)
        return PnPResult(r_best, t_best, inliers & ok,
                         inliers.sum(dtype=torch.int32) * ok.to(torch.int32),
                         ok)
