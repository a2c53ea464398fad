"""Global rotation averaging, chordal/spectral relaxation (twin of
sift_tpu/sfm/rotation_avg.py).

Given relative rotations R_ij (frame i -> frame j), recover consistent
absolute rotations. The chordal L2 problem
    min_R  sum_e w_e || R_j - R_ij R_i ||_F^2 ,  R_i in SO(3)
relaxes to the three smallest eigenvectors of a (3N, 3N) symmetric block
Laplacian, assembled with one scatter-add and solved with one dense
`eigh`, followed by a per-block SVD projection onto SO(3). Optional
IRLS rounds reweight by the chordal residuals for robustness to outlier
edges. Plain PyTorch: no path of the package runs it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _block_laplacian(n: int, ei: torch.Tensor, ej: torch.Tensor,
                     rel: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(3N, 3N) chordal Laplacian: diagonal blocks deg_i I3, off-diagonal
    blocks -w_e R_ij^T / -w_e R_ij; one scatter-add."""
    rw = rel * w[:, None, None]                               # (E, 3, 3)
    eye_w = torch.eye(3, device=rel.device)[None] * w[:, None, None]
    # four 3x3 blocks per edge: (i,j) -R^T, (j,i) -R, (i,i) +wI, (j,j) +wI
    blocks = torch.cat([-rw.mT, -rw, eye_w, eye_w])
    bi = torch.cat([ei, ej, ei, ej])                          # block row
    bj = torch.cat([ej, ei, ei, ej])                          # block col
    off = torch.arange(3, device=rel.device)
    rows = (3 * bi)[:, None, None] + off[None, :, None]       # (4E, 3, 3)
    cols = (3 * bj)[:, None, None] + off[None, None, :]
    mat = torch.zeros((3 * n, 3 * n), dtype=rel.dtype, device=rel.device)
    return mat.index_put_((rows, cols), blocks, accumulate=True)


def _project_so3(m: torch.Tensor) -> torch.Tensor:
    """Nearest rotation to each (..., 3, 3) block (SVD with a
    determinant correction). For blocks R U with a shared U the
    correction is the same for every block, so the shared gauge survives
    and the anchor alignment removes it."""
    u, _, vt = torch.linalg.svd(m)
    d = torch.sign(torch.linalg.det(u @ vt))
    ones = torch.ones_like(d)
    return u @ torch.diag_embed(torch.stack([ones, ones, d], -1)) @ vt


def _solve(ei, ej, rel, w, n_frames: int, anchor: int) -> torch.Tensor:
    lap = _block_laplacian(n_frames, ei, ej, rel, w)
    _, vecs = torch.linalg.eigh(lap)
    basis = vecs[:, :3].reshape(n_frames, 3, 3)               # (N, 3, 3)
    # block i of the eigenbasis is R_i U for a shared gauge U; make U
    # proper first, or the per-block projection would flip a
    # noise-dependent axis per block
    flip = torch.where(torch.linalg.det(basis[anchor]) < 0, -1.0, 1.0)
    basis = torch.cat([basis[:, :, :1] * flip, basis[:, :, 1:]], dim=2)
    rots = _project_so3(basis)
    return torch.einsum("nij,kj->nik", rots, rots[anchor])


def _residuals(ei, ej, rel, rots) -> torch.Tensor:
    pred = torch.einsum("eij,ejk->eik", rel, rots[ei])
    return torch.sqrt(((rots[ej] - pred) ** 2).sum(dim=(1, 2)) + 1e-12)


def average_rotations(n_frames: int,
                      edges_i: np.ndarray, edges_j: np.ndarray,
                      rel_rot: np.ndarray,
                      weights: Optional[np.ndarray] = None,
                      anchor: int = 0,
                      irls_rounds: int = 2, device=None) -> np.ndarray:
    """Solve for (N, 3, 3) absolute rotations (world -> frame).

    rel_rot: (E, 3, 3) with R_j = rel_rot[e] @ R_i for edge (i, j).
    weights: (E,) edge confidences (e.g. inlier counts).
    irls_rounds: extra reweighted solves (w /= chordal residual) for
        robustness to outliers; 0 = one spectral solve.
    The gauge is fixed by anchoring frame `anchor` to identity. Runs on
    `device` (default CUDA; "cpu" on the host).
    """
    dev = torch.device("cuda" if device is None else device)
    ei = torch.as_tensor(np.asarray(edges_i), dtype=torch.int64, device=dev)
    ej = torch.as_tensor(np.asarray(edges_j), dtype=torch.int64, device=dev)
    rel = torch.as_tensor(np.asarray(rel_rot), dtype=torch.float32,
                          device=dev)
    w = (torch.ones(ei.shape[0], device=dev) if weights is None else
         torch.as_tensor(np.asarray(weights), dtype=torch.float32,
                         device=dev))
    w = w / torch.clamp(w.max(), min=1e-12)

    rots = _solve(ei, ej, rel, w, n_frames, anchor)
    for _ in range(irls_rounds):
        res = _residuals(ei, ej, rel, rots)
        med = torch.quantile(res, 0.5)          # jnp.median's midpoint
        w_new = w / torch.clamp(res / torch.clamp(med, min=1e-6), min=1.0)
        rots = _solve(ei, ej, rel, w_new, n_frames, anchor)
    return rots.cpu().numpy()
