"""SO(3)/SE(3) utilities for pose estimation, BA and pose graphs.

Twin of sift_tpu/geometry/lie.py. Every function takes leading batch
dimensions: hat, so3_exp and so3_log map (..., 3) <-> (..., 3, 3), and
se3_apply / project take one pose or a stack of them. The Taylor guards
near theta = 0 are the JAX package's, so the same float32 inputs give
the same branches.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (..., 3) -> (..., 3, 3) skew-symmetric."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], dim=-1),
        torch.stack([wz, z, -wx], dim=-1),
        torch.stack([-wy, wx, z], dim=-1),
    ], dim=-2)


def _rodrigues_coeffs(theta2: torch.Tensor):
    """sin(t)/t and (1 - cos t)/t^2 with the Taylor fallbacks."""
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    big = theta2 > _EPS
    a = torch.where(big, torch.sin(theta) / theta, 1.0 - theta2 / 6.0)
    b = torch.where(big, (1.0 - torch.cos(theta)) / theta2,
                    0.5 - theta2 / 24.0)
    return theta, big, a, b


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: axis-angle (..., 3) -> rotation matrices (..., 3, 3)."""
    if w.dim() == 1:
        # one pose goes through as a batch of one: forward-mode AD
        # (torch.func.jacfwd) gives a float64 tangent to a 0-d float32
        # tensor combined with a Python float
        return so3_exp(w[None])[0]
    _, _, a, b = _rodrigues_coeffs((w * w).sum(-1))
    k = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a[..., None, None] * k + b[..., None, None] * (k @ k)


def so3_exp_jac(w: torch.Tensor):
    """so3_exp and its derivative: (R (..., 3, 3), dR (..., 3, 3, 3)) with
    dR[..., i] = dR / dw_i, differentiating the same guarded expressions
    (the Taylor branch's slopes are -1/6 and -1/24)."""
    theta2 = (w * w).sum(-1)
    theta, big, a, b = _rodrigues_coeffs(theta2)
    s, c = torch.sin(theta), torch.cos(theta)
    # d/d(theta2) of each branch; d theta / d theta2 = 1 / (2 theta)
    da = torch.where(big, (theta * c - s) / (2.0 * theta ** 3),
                     -1.0 / 6.0)
    db = torch.where(big, s / (2.0 * theta * theta2)
                     - (1.0 - c) / (theta2 * theta2), -1.0 / 24.0)
    k = hat(w)
    kk = k @ k
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    r = eye + a[..., None, None] * k + b[..., None, None] * kk
    gens = hat(eye)                                   # (3, 3, 3): E_i
    e_k = gens @ k[..., None, :, :]                   # (..., 3, 3, 3)
    k_e = k[..., None, :, :] @ gens
    two_w = 2.0 * w[..., :, None, None]               # (..., 3, 1, 1)
    dr = (da[..., None, None, None] * two_w * k[..., None, :, :]
          + a[..., None, None, None] * gens
          + db[..., None, None, None] * two_w * kk[..., None, :, :]
          + b[..., None, None, None] * (e_k + k_e))   # (..., i, 3, 3)
    return r, dr.movedim(-3, -1)


def so3_log(r: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> axis-angle (..., 3)."""
    if r.dim() == 2:
        return so3_log(r[None])[0]       # as so3_exp: no 0-d intermediates
    tr = r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2]
    cos_t = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    w = torch.stack([r[..., 2, 1] - r[..., 1, 2], r[..., 0, 2] - r[..., 2, 0],
                     r[..., 1, 0] - r[..., 0, 1]], dim=-1) * 0.5
    scale = torch.where(theta > 1e-6, theta / torch.sin(theta + _EPS), 1.0)
    return w * scale[..., None]


def se3_apply(r: torch.Tensor, t: torch.Tensor, x: torch.Tensor
              ) -> torch.Tensor:
    """Apply (R, t) to points. One pose, r (3, 3) and t (3,): x (..., 3).
    A stack of poses, r (..., 3, 3) and t (..., 3): x (..., N, 3)."""
    if r.dim() == 2:
        return x @ r.T + t
    return x @ r.mT + t[..., None, :]


def project(r: torch.Tensor, t: torch.Tensor, k: torch.Tensor,
            x: torch.Tensor) -> torch.Tensor:
    """Pinhole projection of world points -> pixels (..., 2); poses and
    points as se3_apply takes them, k (3, 3)."""
    xc = se3_apply(r, t, x)
    z = torch.where(xc[..., 2].abs() > 1e-9, xc[..., 2], 1e-9)
    u = k[0, 0] * xc[..., 0] / z + k[0, 2]
    v = k[1, 1] * xc[..., 1] / z + k[1, 2]
    return torch.stack([u, v], dim=-1)
