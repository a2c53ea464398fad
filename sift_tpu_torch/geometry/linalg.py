"""Small-matrix linear algebra helpers for the geometry stack.

Mirror of sift_tpu/geometry/linalg.py: the smallest eigenvector of a
symmetric PSD matrix from eigh, polished by inverse-power iterations
(each a tiny dense solve) to a near-machine-precision nullspace.
"""

from __future__ import annotations

import torch


def smallest_eigvec(ata: torch.Tensor, iters: int = 3) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of symmetric PSD ata:
    eigh seed + `iters` inverse-power iterations on (ata + eps I)."""
    n = ata.shape[-1]
    _, vecs = torch.linalg.eigh(ata)
    v = vecs[..., :, 0]
    eps = 1e-7 * torch.diagonal(ata, dim1=-2, dim2=-1).sum(-1) / n + 1e-30
    a = ata + eps[..., None, None] * torch.eye(n, dtype=ata.dtype,
                                               device=ata.device)
    for _ in range(iters):
        v = torch.linalg.solve_ex(a, v[..., None])[0][..., 0]
        v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                            min=1e-30)
    return v
