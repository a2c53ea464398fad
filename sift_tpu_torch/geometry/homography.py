"""RANSAC homography estimation (reference C12).

Twin of sift_tpu/geometry/homography.py, which stands in for
cv::findHomography(obj, scene, RANSAC) (src/main.cpp:54) and
cv::perspectiveTransform (src/main.cpp:62):

  * a fixed batch of minimal 4-point samples, drawn by a Gumbel-top-4
    over the validity mask from an explicit torch.Generator seeded with
    `seed` (or injected through `samples=`), each solved by a batched
    8x8 DLT, all inlier counts computed at once; the first hypothesis
    with the most inliers wins;
  * the winner refined by a masked normalised DLT over its inliers
    (smallest eigenvector of the 9x9 A^T A), then polished by
    Gauss-Newton on the reprojection error with an analytic Jacobian.

Inlier test: squared forward-transfer error < threshold^2 (default
3.0 px, as cv::findHomography).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from sift_tpu_torch.geometry.linalg import smallest_eigvec
from sift_tpu_torch.utils.profiling import span


class HomographyResult(NamedTuple):
    H: torch.Tensor           # (3, 3) float32, H[2,2] == 1
    inliers: torch.Tensor     # (N,) bool
    n_inliers: torch.Tensor   # () int32
    ok: torch.Tensor          # () bool: a non-degenerate model was found


def perspective_transform(pts: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    """cv::perspectiveTransform twin: (..., 2) points through (..., 3, 3)
    H (leading dims broadcast)."""
    x, y = pts[..., 0], pts[..., 1]
    h = H[..., None, :, :] if H.dim() > 2 else H

    def e(i, j):
        return h[..., i, j]

    w = e(2, 0) * x + e(2, 1) * y + e(2, 2)
    w = torch.where(w.abs() > 1e-12, w, math.inf)
    u = (e(0, 0) * x + e(0, 1) * y + e(0, 2)) / w
    v = (e(1, 0) * x + e(1, 1) * y + e(1, 2)) / w
    return torch.stack([u, v], dim=-1)


def _dlt4(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Exact homographies from 4 correspondences: solve the 8x8 systems
    A h = b with h9 = 1. src/dst: (B, 4, 2). Returns (B, 3, 3); a
    singular system gives non-finite entries."""
    x, y = src[..., 0], src[..., 1]
    u, v = dst[..., 0], dst[..., 1]
    z = torch.zeros_like(x)
    o = torch.ones_like(x)
    rows_u = torch.stack([x, y, o, z, z, z, -u * x, -u * y], dim=-1)
    rows_v = torch.stack([z, z, z, x, y, o, -v * x, -v * y], dim=-1)
    a = torch.cat([rows_u, rows_v], dim=-2)                 # (B, 8, 8)
    b = torch.cat([u, v], dim=-1)                           # (B, 8)
    h, info = torch.linalg.solve_ex(a, b[..., None])
    h = torch.where((info == 0)[:, None, None], h, math.nan)[..., 0]
    return torch.cat([h, torch.ones_like(h[..., :1])], dim=-1).reshape(
        -1, 3, 3)


def _sq_transfer_err(H: torch.Tensor, src: torch.Tensor, dst: torch.Tensor
                     ) -> torch.Tensor:
    """Squared forward-transfer error per correspondence: (..., N)."""
    d = perspective_transform(src, H) - dst
    err = (d * d).sum(-1)
    return torch.where(err.isfinite(), err, math.inf)


def _normalization(pts: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Hartley normalization transform over masked points: (3, 3)."""
    w = mask.to(torch.float32)
    n = torch.clamp(w.sum(), min=1.0)
    mean = (pts * w[:, None]).sum(0) / n
    d = torch.sqrt(((pts - mean) ** 2).sum(-1)) * w
    scale = math.sqrt(2.0) / torch.clamp(d.sum() / n, min=1e-12)
    zero, one = torch.zeros_like(scale), torch.ones_like(scale)
    t = torch.stack([torch.stack([one, zero, -mean[0]]),
                     torch.stack([zero, one, -mean[1]]),
                     torch.stack([zero, zero, one])])
    return t * torch.stack([scale, scale, one])[:, None]


def _dlt_masked(src: torch.Tensor, dst: torch.Tensor, mask: torch.Tensor
                ) -> torch.Tensor:
    """Least-squares normalised DLT over all masked correspondences."""
    ts = _normalization(src, mask)
    td = _normalization(dst, mask)
    sh = perspective_transform(src, ts)
    dh = perspective_transform(dst, td)
    x, y = sh[:, 0], sh[:, 1]
    u, v = dh[:, 0], dh[:, 1]
    z = torch.zeros_like(x)
    o = torch.ones_like(x)
    rows_u = torch.stack([x, y, o, z, z, z, -u * x, -u * y, -u], dim=1)
    rows_v = torch.stack([z, z, z, x, y, o, -v * x, -v * y, -v], dim=1)
    mf = mask[:, None].to(x.dtype)
    a = torch.cat([rows_u * mf, rows_v * mf], dim=0)
    ata = a.T @ a                                           # (9, 9)
    hn = smallest_eigvec(ata).reshape(3, 3)
    h = torch.linalg.solve_ex(td, hn @ ts)[0]               # denormalize
    return h / torch.where(h[2, 2].abs() > 1e-12, h[2, 2], 1.0)


def _gauss_newton(H: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                  mask: torch.Tensor, iters: int = 5) -> torch.Tensor:
    """Polish H by Gauss-Newton on the masked reprojection error
    (counterpart of OpenCV's LM refinement in findHomography). The
    Jacobian of (p0, p1) = ((h0 x + h1 y + h2) / d, (h3 x + h4 y + h5) / d),
    d = h6 x + h7 y + 1, is written out analytically."""
    w = mask.to(torch.float32)
    x, y = src[:, 0], src[:, 1]
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    eye = torch.eye(8, dtype=torch.float32, device=H.device)
    h8 = torch.cat([H[0], H[1], H[2, :2]]) / H[2, 2]
    for _ in range(iters):
        a0 = h8[0] * x + h8[1] * y + h8[2]
        a1 = h8[3] * x + h8[4] * y + h8[5]
        d = h8[6] * x + h8[7] * y + 1.0
        p0, p1 = a0 / d, a1 / d
        r = torch.stack([p0 - dst[:, 0], p1 - dst[:, 1]], dim=1)  # (N, 2)
        j0 = torch.stack([x / d, y / d, one / d, zero, zero, zero,
                          -x * a0 / (d * d), -y * a0 / (d * d)], dim=1)
        j1 = torch.stack([zero, zero, zero, x / d, y / d, one / d,
                          -x * a1 / (d * d), -y * a1 / (d * d)], dim=1)
        j = torch.stack([j0, j1], dim=1)                          # (N, 2, 8)
        jw = j * w[:, None, None]
        jtj = torch.einsum("nri,nrj->ij", jw, j)
        jtr = torch.einsum("nri,nr->i", jw, r)
        delta = torch.linalg.solve_ex(jtj + 1e-8 * eye, jtr[:, None])[0][:, 0]
        out = h8 - delta
        h8 = torch.where(out.isfinite().all(), out, h8)
    return torch.cat([h8, torch.ones_like(h8[:1])]).reshape(3, 3)


def gumbel_top_k(valid: torch.Tensor, n_samples: int, k: int,
                 generator: torch.Generator) -> torch.Tensor:
    """(n_samples, k) int64 minimal samples: per row, k distinct valid
    indices, uniform (the Gumbel-top-k trick over the validity mask),
    drawn on valid's device. Ties keep the lower index first, as
    jax.lax.top_k."""
    n = valid.shape[0]
    u = torch.rand((n_samples, n), generator=generator, device=valid.device)
    tiny = torch.finfo(torch.float32).tiny
    g = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
    g = torch.where(valid[None, :], g, -math.inf)
    return torch.sort(g, dim=1, descending=True, stable=True)[1][:, :k]


def draw_samples(valid: torch.Tensor, n_samples: int, k: int, seed: int,
                 samples: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A RANSAC call's (n_samples, k) minimal samples on valid's device:
    `samples` when given (an injected draw), else gumbel_top_k from a
    torch.Generator on that device seeded with `seed`."""
    if samples is None:
        gen = torch.Generator(device=valid.device).manual_seed(seed)
        samples = gumbel_top_k(valid, n_samples, k, gen)
    return torch.as_tensor(samples, device=valid.device).to(torch.long)


def find_homography_ransac(src: torch.Tensor, dst: torch.Tensor,
                           valid: Optional[torch.Tensor] = None,
                           threshold: float = 3.0,
                           n_hypotheses: int = 1024,
                           seed: int = 0,
                           refine: bool = True,
                           samples: Optional[torch.Tensor] = None
                           ) -> HomographyResult:
    """cv::findHomography(src, dst, RANSAC) twin, batched-hypothesis.

    src, dst: (N, 2) padded correspondences; valid: (N,) mask.
    Deterministic for a given seed and device. samples: optional
    (n_hypotheses, 4) indices that replace the drawn ones.
    """
    with span("geometry.ransac"):
        n = src.shape[0]
        src = src.to(torch.float32)
        dst = dst.to(torch.float32)
        if valid is None:
            valid = torch.ones((n,), dtype=torch.bool, device=src.device)
        samples = draw_samples(valid, n_hypotheses, 4, seed, samples)
        thr2 = threshold * threshold

        hs = _dlt4(src[samples], dst[samples])                  # (B, 3, 3)
        inl = (_sq_transfer_err(hs, src, dst) < thr2) & valid   # (B, N)
        finite = hs.isfinite().flatten(1).all(1)
        counts = torch.where(finite, inl.sum(1, dtype=torch.int32), 0)
        best = torch.argmax(counts)                             # first max
        h_best = hs[best]
        ok = counts[best] >= 4

        inliers = (_sq_transfer_err(h_best, src, dst) < thr2) & valid
        if refine:
            h_ref = _dlt_masked(src, dst, inliers)
            h_ref = _gauss_newton(h_ref, src, dst, inliers)
            # accept the refinement only if it keeps at least as many inliers
            inl_ref = (_sq_transfer_err(h_ref, src, dst) < thr2) & valid
            better = (inl_ref.sum() >= inliers.sum()) & h_ref.isfinite().all()
            h_best = torch.where(better, h_ref, h_best)
            inliers = torch.where(better, inl_ref, inliers)

        eye = torch.eye(3, dtype=torch.float32, device=src.device)
        h_best = torch.where(ok, h_best, eye)
        return HomographyResult(h_best, inliers & ok,
                                inliers.sum(dtype=torch.int32) * ok, ok)
