"""Two-view epipolar geometry: essential matrix RANSAC + pose recovery.

Twin of sift_tpu/geometry/epipolar.py, in the shape of
geometry/homography.py: a fixed, seeded batch of minimal samples (a
Gumbel top-k over the validity mask from a torch.Generator, or injected
through `samples=`), all solved and scored at once, then a
locally-optimized refit, a Gauss-Newton polish of the 5-dof pose and
the cheirality pick among the four decompositions.

Two minimal solvers:
  * "5pt" (default): Nistér's 5-point (geometry/fivepoint.py), up to 10
    candidates per sample, so n_hypotheses // 8 samples (at least 32);
  * "8pt": the normalized linear 8-point (one candidate per sample).

On the card two stretches of a call replay as CUDA graphs
(geometry/graphs.py): the 5-point solve and scoring after the nullspace
SVD (`_score_5pt`) and the Gauss-Newton polish (`_polish`). The SVDs,
the LO refits' eigh and `_decompose` wait for the card and stay eager.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from sift_tpu_torch.geometry import graphs
from sift_tpu_torch.geometry.fivepoint import (candidates_from_basis,
                                               nullspace_basis)
from sift_tpu_torch.geometry.homography import draw_samples
from sift_tpu_torch.geometry.lie import hat, so3_exp, so3_log
from sift_tpu_torch.geometry.linalg import smallest_eigvec
from sift_tpu_torch.geometry.triangulation import triangulate
from sift_tpu_torch.utils.profiling import span


N_HYPOTHESES = 1024


class EssentialResult(NamedTuple):
    E: torch.Tensor          # (3, 3)
    R: torch.Tensor          # (3, 3) pose of cam1 w.r.t. cam0
    t: torch.Tensor          # (3,) unit translation
    inliers: torch.Tensor    # (N,) bool
    n_inliers: torch.Tensor  # () int32
    ok: torch.Tensor         # () bool


def sample_shape(n_hypotheses: int, solver: str) -> Tuple[int, int]:
    """(samples, points per sample) of one find_essential_ransac call:
    the 5-point solver emits up to 10 candidates per sample, so fewer
    samples reach the same model count."""
    if solver == "5pt":
        return max(n_hypotheses // 8, 32), 5
    return n_hypotheses, 8


def _epipolar_rows(p0: torch.Tensor, p1: torch.Tensor) -> torch.Tensor:
    """(..., N, 9) rows of the linear system p1^T E p0 = 0."""
    x0, y0 = p0[..., 0], p0[..., 1]
    x1, y1 = p1[..., 0], p1[..., 1]
    o = torch.ones_like(x0)
    return torch.stack([x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1,
                        x0, y0, o], dim=-1)


def _project_essential(e: torch.Tensor) -> torch.Tensor:
    """Nearest essential matrix: two equal singular values, third 0."""
    u, s, vt = torch.linalg.svd(e)
    sm = (s[..., 0] + s[..., 1]) * 0.5
    scale = torch.stack([sm, sm, torch.zeros_like(sm)], dim=-1)
    return (u * scale[..., None, :]) @ vt


def _eight_point(p0: torch.Tensor, p1: torch.Tensor) -> torch.Tensor:
    """Essential matrices from 8 normalized correspondences, (..., 8, 2)
    each: linear 8-point + projection onto the essential manifold."""
    a = _epipolar_rows(p0, p1)
    e = smallest_eigvec(a.mT @ a).reshape(*a.shape[:-2], 3, 3)
    return _project_essential(e)


def _sampson_sq(e: torch.Tensor, p0: torch.Tensor, p1: torch.Tensor
                ) -> torch.Tensor:
    """Squared Sampson distances in normalized coords: E (..., 3, 3),
    points (N, 2) -> (..., N)."""
    p0h = torch.cat([p0, torch.ones_like(p0[:, :1])], dim=1)
    p1h = torch.cat([p1, torch.ones_like(p1[:, :1])], dim=1)
    ep0 = p0h @ e.mT                                        # (..., N, 3)
    etp1 = p1h @ e                                          # (..., N, 3)
    num = (p1h * ep0).sum(-1) ** 2
    den = ep0[..., 0] ** 2 + ep0[..., 1] ** 2 \
        + etp1[..., 0] ** 2 + etp1[..., 1] ** 2
    err = num / torch.clamp(den, min=1e-12)
    return torch.where(err.isfinite(), err, torch.inf)


def _decompose(e: torch.Tensor, p0: torch.Tensor, p1: torch.Tensor,
               mask: torch.Tensor):
    """Pick the (R, t) among the 4 decompositions with the most
    points in front of both cameras (cv::recoverPose semantics)."""
    u, _, vt = torch.linalg.svd(e)
    # enforce proper rotations
    u = u * torch.sign(torch.linalg.det(u))
    vt = vt * torch.sign(torch.linalg.det(vt))
    dev = e.device
    w = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     device=dev)
    r1 = u @ w @ vt
    r2 = u @ w.T @ vt
    tt = u[:, 2]
    eye = torch.eye(3, device=dev)
    zero = torch.zeros(3, device=dev)

    def cheirality(r, t):
        x = triangulate(eye, zero, r, t, p0, p1)
        z1 = (x @ r.T + t)[:, 2]
        good = (x[:, 2] > 0) & (z1 > 0) & mask
        return good.sum(dtype=torch.int32)

    cands = ((r1, tt), (r1, -tt), (r2, tt), (r2, -tt))
    counts = torch.stack([cheirality(r, t) for r, t in cands])
    best = torch.argmax(counts)
    rs = torch.stack([c[0] for c in cands])
    ts = torch.stack([c[1] for c in cands])
    return rs[best], ts[best], counts[best]


def _score_5pt(basis: torch.Tensor, p0: torch.Tensor, p1: torch.Tensor,
               valid: torch.Tensor, thr2: float):
    """The 5-point stretch: each sample's candidates from its nullspace
    basis, scored by Sampson distance over all N points; (S,) inlier
    counts and (S, 3, 3) matrices of each sample's best candidate."""
    cand, cvalid = candidates_from_basis(basis)
    inl = (_sampson_sq(cand, p0, p1) < thr2) & valid         # (S, 10, N)
    cnt = inl.sum(-1, dtype=torch.int32) * cvalid.to(torch.int32)
    kbest = torch.argmax(cnt, dim=1)
    rows = torch.arange(cnt.shape[0], device=cnt.device)
    return cnt[rows, kbest], cand[rows, kbest]


def _pose_e(params: torch.Tensor) -> torch.Tensor:
    """E(w, t) = [t/|t|]_x exp(w) of the 5-dof pose params (w, t)."""
    tv = params[3:]
    tv = tv / torch.clamp(torch.linalg.vector_norm(tv, dim=-1, keepdim=True),
                          min=1e-12)
    return hat(tv) @ so3_exp(params[:3])


def _polish(params: torch.Tensor, p0h: torch.Tensor, p1h: torch.Tensor,
            wmask: torch.Tensor) -> torch.Tensor:
    """Five Gauss-Newton steps on the weighted Sampson residuals of the
    homogeneous points p0h, p1h (N, 3): params in, params out."""

    def residuals(q):
        e = _pose_e(q)
        ep0 = p0h @ e.T
        etp1 = p1h @ e
        num = (p1h * ep0).sum(1)
        den = torch.sqrt(ep0[:, 0] ** 2 + ep0[:, 1] ** 2
                         + etp1[:, 0] ** 2 + etp1[:, 1] ** 2 + 1e-12)
        return (num / den) * wmask

    eye6 = torch.eye(6, device=params.device)
    for _ in range(5):
        res = residuals(params)
        j = torch.func.jacfwd(residuals)(params)           # (N, 6)
        jtj = j.T @ j + 1e-8 * eye6
        delta, info = torch.linalg.solve_ex(jtj, (j.T @ res)[:, None])
        cand_p = torch.where(info == 0, params - delta[:, 0], torch.nan)
        params = torch.where(cand_p.isfinite().all(), cand_p, params)
    return params


def find_essential_ransac(p0: torch.Tensor, p1: torch.Tensor,
                          valid: Optional[torch.Tensor] = None,
                          threshold: float = 1e-3,
                          n_hypotheses: int = N_HYPOTHESES,
                          seed: int = 0,
                          solver: str = "5pt",
                          samples: Optional[torch.Tensor] = None
                          ) -> EssentialResult:
    """RANSAC essential matrix from normalized image coords (N, 2) x2.

    threshold is on Sampson distance in normalized coordinates
    (~pixel_thresh / focal_length). solver: "5pt" (Nistér minimal, up
    to 10 candidates per sample) or "8pt" (linear fallback). samples:
    optional sample_shape(n_hypotheses, solver) indices that replace
    the drawn ones. Runs on p0's device. Span `geometry.essential`: n
    (the padded N) and graph_hit (every stretch replayed a graph).
    """
    n = p0.shape[0]
    with span("geometry.essential", n=n, graph_hit=False) as sp:
        hits = graphs.CACHE.hits
        p0 = p0.to(torch.float32)
        p1 = p1.to(torch.float32)
        dev = p0.device
        if valid is None:
            valid = torch.ones((n,), dtype=torch.bool, device=dev)
        thr2 = threshold * threshold
        n_samples, k = sample_shape(n_hypotheses, solver)
        idx = draw_samples(valid, n_samples, k, seed, samples)

        if solver == "5pt":
            basis = nullspace_basis(p0[idx], p1[idx])
            counts, es = graphs.CACHE.run(
                "essential.score_5pt", _score_5pt, (basis, p0, p1, valid),
                (thr2,))
        else:
            es = _eight_point(p0[idx], p1[idx])
            inl = (_sampson_sq(es, p0, p1) < thr2) & valid        # (S, N)
            counts = inl.sum(-1, dtype=torch.int32)
        best = torch.argmax(counts)
        e_best = es[best]
        inliers = (_sampson_sq(e_best, p0, p1) < thr2) & valid
        ok = counts[best] >= 8

        # locally-optimized RANSAC: iterate (masked least-squares refit on
        # the inlier set -> recompute inliers), keeping the best model
        a_full = _epipolar_rows(p0, p1)

        def refit(mask):
            a = a_full * mask[:, None].to(torch.float32)
            return _project_essential(smallest_eigvec(a.T @ a).reshape(3, 3))

        for _ in range(3):
            e_ref = refit(inliers)
            inl_ref = (_sampson_sq(e_ref, p0, p1) < thr2) & valid
            better = inl_ref.sum() >= inliers.sum()
            e_best = torch.where(better, e_ref, e_best)
            inliers = torch.where(better, inl_ref, inliers)

        r, t, _ = _decompose(e_best, p0, p1, inliers)

        # Gauss-Newton polish on the 5-dof pose (the linear refit's
        # algebraic cost is biased; GN on the Sampson error reaches the
        # noise floor). Parameterized as E(w, t) = [t/|t|]_x exp(w).
        p0h = torch.cat([p0, torch.ones_like(p0[:, :1])], dim=1)
        p1h = torch.cat([p1, torch.ones_like(p1[:, :1])], dim=1)
        wmask = inliers.to(torch.float32)
        params = torch.cat([so3_log(r), t])
        params = graphs.CACHE.run("essential.polish", _polish,
                                  (params, p0h, p1h, wmask))
        e_gn = _pose_e(params)
        inl_gn = (_sampson_sq(e_gn, p0, p1) < thr2) & valid
        better = inl_gn.sum() >= inliers.sum()
        e_best = torch.where(better, e_gn, e_best)
        inliers = torch.where(better, inl_gn, inliers)
        r2, t2, _ = _decompose(e_best, p0, p1, inliers)

        sp.set(graph_hit=graphs.CACHE.hits - hits
               == (2 if solver == "5pt" else 1))
        return EssentialResult(e_best, r2, t2, inliers & ok,
                               inliers.sum(dtype=torch.int32)
                               * ok.to(torch.int32), ok)
