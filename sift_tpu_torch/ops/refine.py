"""Batched subpixel refinement + contrast/edge filtering (reference C8b).

Twin of adjustLocalExtrema (src/sift.cpp:287-388) and of
sift_tpu/ops/refine.py: up to 5 Newton steps on the 3x3x3 DoG cube, the
quadratic-fit contrast test and the Hessian edge test, over a
fixed-capacity candidate batch with masked state. The ten derivative
fields a Newton step needs are computed densely over the octave once;
each step gathers one value per field per candidate. A singular system
gives a zero update, as OpenCV's Matx::solve(DECOMP_LU) does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from sift_tpu_torch.config import SIFTConfig, DEFAULT_CONFIG
from sift_tpu_torch.ops.mathutil import cv_round

_IMG_SCALE = 1.0 / 255.0       # src/sift.cpp:291
_DERIV_SCALE = _IMG_SCALE * 0.5
_SECOND_DERIV_SCALE = _IMG_SCALE
_CROSS_DERIV_SCALE = _IMG_SCALE * 0.25
_DIVERGE_LIMIT = float(2 ** 31) / 3.0   # src/sift.cpp:335-338


class Refined(NamedTuple):
    """Per-candidate refinement result (octave space)."""
    layer: torch.Tensor
    r: torch.Tensor
    c: torch.Tensor
    xi: torch.Tensor
    xr: torch.Tensor
    xc: torch.Tensor
    contr: torch.Tensor
    valid: torch.Tensor


def _solve3x3(h00, h01, h02, h11, h12, h22, b0, b1, b2):
    """Cramer solve of the symmetric 3x3 system H x = b; zeros where
    |det| ~ 0 (OpenCV's singular-LU behaviour)."""
    c00 = h11 * h22 - h12 * h12
    c01 = h02 * h12 - h01 * h22
    c02 = h01 * h12 - h02 * h11
    det = h00 * c00 + h01 * c01 + h02 * c02
    c11 = h00 * h22 - h02 * h02
    c12 = h01 * h02 - h00 * h12
    c22 = h00 * h11 - h01 * h01
    safe = det.abs() > 1e-30
    inv_det = torch.where(safe, 1.0 / torch.where(safe, det, 1.0), 0.0)
    x0 = (c00 * b0 + c01 * b1 + c02 * b2) * inv_det
    x1 = (c01 * b0 + c11 * b1 + c12 * b2) * inv_det
    x2 = (c02 * b0 + c12 * b1 + c22 * b2) * inv_det
    return x0, x1, x2


def derivative_fields(dog: torch.Tensor, n_layers: int | None = None):
    """Dense Newton-step inputs over DoG layers 1..L: a 10-tuple of flat
    (L*H*W,) tensors [d0 d1 d2 dxx dxy dxs dyy dys dss center], scaled
    per src/sift.cpp:291-295. Gather index for (lay, r, c):
    ((lay - 1) * H + r) * W + c."""
    d, h, w = dog.shape
    nl = d - 2 if n_layers is None else n_layers
    p = F.pad(dog, (1, 1, 1, 1, 1, 1))

    def val(dl, dr, dc):
        # layer window [1+dl, 1+dl+nl) of the original dog stack
        return p[2 + dl:2 + dl + nl, 1 + dr:1 + dr + h, 1 + dc:1 + dc + w]

    v2 = dog[1:1 + nl] * 2.0
    d0 = (val(0, 0, 1) - val(0, 0, -1)) * _DERIV_SCALE
    d1 = (val(0, 1, 0) - val(0, -1, 0)) * _DERIV_SCALE
    d2 = (val(1, 0, 0) - val(-1, 0, 0)) * _DERIV_SCALE
    dxx = (val(0, 0, 1) + val(0, 0, -1) - v2) * _SECOND_DERIV_SCALE
    dyy = (val(0, 1, 0) + val(0, -1, 0) - v2) * _SECOND_DERIV_SCALE
    dss = (val(1, 0, 0) + val(-1, 0, 0) - v2) * _SECOND_DERIV_SCALE
    dxy = (val(0, 1, 1) - val(0, 1, -1) - val(0, -1, 1)
           + val(0, -1, -1)) * _CROSS_DERIV_SCALE
    dxs = (val(1, 0, 1) - val(1, 0, -1) - val(-1, 0, 1)
           + val(-1, 0, -1)) * _CROSS_DERIV_SCALE
    dys = (val(1, 1, 0) - val(1, -1, 0) - val(-1, 1, 0)
           + val(-1, -1, 0)) * _CROSS_DERIV_SCALE
    return tuple(x.reshape(nl * h * w)
                 for x in (d0, d1, d2, dxx, dxy, dxs, dyy, dys, dss,
                           dog[1:1 + nl]))


def refine_candidates(dog: torch.Tensor,
                      layer: torch.Tensor, r: torch.Tensor, c: torch.Tensor,
                      valid: torch.Tensor,
                      cfg: SIFTConfig = DEFAULT_CONFIG) -> Refined:
    """Refine a batch of candidates on one octave's (D, H, W) DoG stack."""
    h, w = dog.shape[1], dog.shape[2]
    nl = cfg.n_octave_layers
    border = cfg.img_border
    fields = derivative_fields(dog, nl)

    def fetch(lay, rr, cc):
        """(N,) coords -> 10-tuple of per-candidate (N,) values; lay is
        always in [1, nl], the layers the fields cover."""
        idx = (((lay - 1) * h + rr) * w + cc).long()
        return tuple(f[idx] for f in fields)

    lay, rr, cc = layer, r, c
    xi = torch.zeros(layer.shape, dtype=torch.float32, device=dog.device)
    xr, xc = xi, xi
    converged = torch.zeros_like(valid)
    alive = valid

    # unrolled SIFT_MAX_INTERP_STEPS Newton steps (src/sift.cpp:300-348)
    for _ in range(cfg.max_interp_steps):
        active = alive & ~converged
        (d0, d1, d2, dxx, dxy, dxs, dyy, dys, dss,
         _center) = fetch(lay, rr, cc)
        x0, x1, x2 = _solve3x3(dxx, dxy, dxs, dyy, dys, dss, d0, d1, d2)
        nxi, nxr, nxc = -x2, -x1, -x0
        finite = nxi.isfinite() & nxr.isfinite() & nxc.isfinite()
        conv_now = ((nxi.abs() < 0.5) & (nxr.abs() < 0.5)
                    & (nxc.abs() < 0.5) & finite)
        diverged = ~finite | (nxi.abs() > _DIVERGE_LIMIT) | \
            (nxr.abs() > _DIVERGE_LIMIT) | (nxc.abs() > _DIVERGE_LIMIT)
        # stored offsets follow every step that ran
        xi = torch.where(active, nxi, xi)
        xr = torch.where(active, nxr, xr)
        xc = torch.where(active, nxc, xc)
        move = active & ~conv_now & ~diverged
        zero = torch.zeros_like(lay)
        nlay = lay + torch.where(move, cv_round(nxi), zero)
        nr = rr + torch.where(move, cv_round(nxr), zero)
        nc = cc + torch.where(move, cv_round(nxc), zero)
        oob = ((nlay < 1) | (nlay > nl)
               | (nc < border) | (nc >= w - border)
               | (nr < border) | (nr >= h - border))
        alive = alive & ~(active & (diverged | (move & oob)))
        converged = converged | (active & conv_now)
        step = move & ~oob
        lay = torch.where(step, nlay, lay)
        rr = torch.where(step, nr, rr)
        cc = torch.where(step, nc, cc)

    alive = alive & converged  # non-convergence rejects (sift.cpp:351)

    # final contrast + edge tests at the converged location
    (d0, d1, d2, dxx, dxy, _dxs, dyy, _dys, _dss,
     center) = fetch(lay, rr, cc)
    t = d0 * xc + d1 * xr + d2 * xi
    contr = center * _IMG_SCALE + t * 0.5
    alive = alive & (contr.abs() * nl >= cfg.contrast_threshold)
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    e = cfg.edge_threshold
    alive = alive & (det > 0) & (tr * tr * e < (e + 1) * (e + 1) * det)
    return Refined(lay, rr, cc, xi, xr, xc, contr, alive)
