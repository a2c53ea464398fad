"""Linear (DLT) triangulation (twin of sift_tpu/geometry/triangulation.py).

Points are triangulated from two views via the homogeneous DLT system,
solved as the smallest eigenvector of a 4x4 A^T A per point: one batched
eigh over all correspondences at once.
"""

from __future__ import annotations

import torch

from sift_tpu_torch.geometry.linalg import smallest_eigvec


def _projection_matrix(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(3, 4) projection [R | t] in normalized camera coords."""
    return torch.cat([r, t[:, None]], dim=1)


def triangulate(r0: torch.Tensor, t0: torch.Tensor,
                r1: torch.Tensor, t1: torch.Tensor,
                p0: torch.Tensor, p1: torch.Tensor) -> torch.Tensor:
    """Triangulate (N, 2) normalized coords from two posed views.

    Returns (N, 3) points in the world (camera-0 if r0=I,t0=0) frame.
    """
    m0 = _projection_matrix(r0, t0)
    m1 = _projection_matrix(r1, t1)
    q0 = p0.to(torch.float32)
    q1 = p1.to(torch.float32)
    a = torch.stack([
        q0[:, 0:1] * m0[2] - m0[0],
        q0[:, 1:2] * m0[2] - m0[1],
        q1[:, 0:1] * m1[2] - m1[0],
        q1[:, 1:2] * m1[2] - m1[1],
    ], dim=1)                                            # (N, 4, 4)
    x = smallest_eigvec(a.mT @ a)
    w = torch.where(x[:, 3].abs() > 1e-12, x[:, 3], 1e-12)
    return x[:, :3] / w[:, None]


def reprojection_error(r: torch.Tensor, t: torch.Tensor,
                       x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Per-point normalized-coordinate reprojection error (N,)."""
    xc = x @ r.T + t
    z = torch.where(xc[:, 2].abs() > 1e-9, xc[:, 2], 1e-9)
    proj = xc[:, :2] / z[:, None]
    return torch.linalg.vector_norm(proj - p, dim=-1)
