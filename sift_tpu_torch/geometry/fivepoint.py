"""Batched Nistér 5-point minimal solver for the essential matrix.

Twin of sift_tpu/geometry/fivepoint.py, batched over the S minimal
samples of one RANSAC call: (S, 5, 2) x2 -> (S, 10, 3, 3) candidates and
an (S, 10) validity mask. The steps are the JAX solver's:

  1. 4-dim nullspace of each 5x9 epipolar system (batched SVD);
  2. the 10x20 cubic constraint matrix from products of coefficient
     tensors: each entry of E = xX + yY + zZ + W is a linear polynomial
     in (x, y, z) held as a (2, 2, 2) tensor, and a product of two such
     tensors is their full 3-D convolution. Here a convolution is a
     contraction with a fixed 0/1 map that sends each pair of input
     slots to the slot of their summed exponents, so det(E), E E^T and
     the nine trace cubics are each one batched einsum;
  3. Gauss-Jordan reduction as one batched 10x10 solve (solve_ex: a
     singular sample gives NaN, and so an invalid candidate);
  4. Nistér's 3x3 polynomial matrix -> a degree-10 polynomial in z;
  5. its 10 roots by 80 Durand-Kerner iterations in complex64, the
     coefficients rescaled by the Fujiwara bound with negative powers;
  6. x, y back-substitution per real root (2x2 solves).

The candidate set does not depend on the nullspace basis (up to order
and the sign of E); the basis does, and LAPACK and cuSOLVER may return
it rotated, so candidates compare between packages only as sets.
"""

from __future__ import annotations

import itertools
from typing import Dict, Tuple

import numpy as np
import torch

# monomial order of the 10x20 constraint matrix (Stewénius/Nistér):
# first 10 are eliminated, last 10 = [xz^2, xz, x, yz^2, yz, y,
# z^3, z^2, z, 1] stay as the polynomial part
_MON = [(3, 0, 0), (0, 3, 0), (2, 1, 0), (1, 2, 0), (2, 0, 1),
        (2, 0, 0), (0, 2, 1), (0, 2, 0), (1, 1, 1), (1, 1, 0),
        (1, 0, 2), (1, 0, 1), (1, 0, 0), (0, 1, 2), (0, 1, 1),
        (0, 1, 0), (0, 0, 3), (0, 0, 2), (0, 0, 1), (0, 0, 0)]
_MON_FLAT = [i * 16 + j * 4 + k for i, j, k in _MON]   # slots of (4, 4, 4)

_N_DEG = 10
_DK_ITERS = 80
_ROOTS0 = (0.4 + 0.9j) ** np.arange(_N_DEG)

_CONV_MAPS: Dict[Tuple, torch.Tensor] = {}
# the monomial slots and the Durand-Kerner start, by name (_const)
_HOST_CONSTS = {"mon_flat": (_MON_FLAT, torch.int64),
                "roots0": (_ROOTS0, torch.complex64)}
_CONSTS: Dict[Tuple, torch.Tensor] = {}


def _conv_map(sa: Tuple[int, ...], sb: Tuple[int, ...], device
              ) -> torch.Tensor:
    """(prod sa, prod sb, prod(sa + sb - 1)) 0/1 float32 map of a full
    N-D convolution: slot (a, b) -> the slot of a's and b's summed
    indices. Contracting two flattened coefficient tensors with it
    multiplies the polynomials they hold."""
    key = (sa, sb, str(device))
    if key not in _CONV_MAPS:
        so = tuple(x + y - 1 for x, y in zip(sa, sb))
        m = np.zeros((int(np.prod(sa)), int(np.prod(sb)), int(np.prod(so))),
                     np.float32)
        for ia, a in enumerate(itertools.product(*map(range, sa))):
            for ib, b in enumerate(itertools.product(*map(range, sb))):
                out = tuple(x + y for x, y in zip(a, b))
                m[ia, ib, np.ravel_multi_index(out, so)] = 1.0
        _CONV_MAPS[key] = torch.from_numpy(m).to(device)
    return _CONV_MAPS[key]


def _const(name: str, device) -> torch.Tensor:
    """A constant of the solver (_HOST_CONSTS) on `device`, copied from
    the host once a device."""
    key = (name, str(device))
    if key not in _CONSTS:
        value, dtype = _HOST_CONSTS[name]
        _CONSTS[key] = torch.as_tensor(value, dtype=dtype, device=device)
    return _CONSTS[key]


def _conv1(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched product of 1-D polynomials (ascending coefficients):
    (S, n) x (S, m) -> (S, n + m - 1)."""
    c = _conv_map((u.shape[-1],), (v.shape[-1],), u.device)
    return torch.einsum("sa,sb,abp->sp", u, v, c)


def _horner(coeffs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Evaluate polynomials with ascending coefficients (S, n) at points
    (S, k), highest degree first (jnp.polyval's order)."""
    y = coeffs[:, -1:].to(x.dtype).expand_as(x)
    for i in range(coeffs.shape[-1] - 2, -1, -1):
        y = y * x + coeffs[:, i:i + 1].to(x.dtype)
    return y


def essential_candidates_5pt(p0: torch.Tensor, p1: torch.Tensor):
    """S samples of 5 normalized correspondences, (S, 5, 2) x2 -> up to
    10 essential matrix candidates each.

    Returns (es (S, 10, 3, 3) unit-Frobenius, valid (S, 10) bool).
    Invalid slots (complex roots, degenerate samples) are masked:
    callers count inliers per candidate and the mask zeroes losers.
    """
    return candidates_from_basis(nullspace_basis(p0, p1))


def nullspace_basis(p0: torch.Tensor, p1: torch.Tensor) -> torch.Tensor:
    """Step 1: the (S, 4, 9) nullspace X, Y, Z, W of each sample's 5x9
    epipolar system, rows 5..8 of its SVD's V^T (a view). The SVD waits
    for the card; everything after it does not (candidates_from_basis)."""
    x0, y0 = p0[..., 0], p0[..., 1]
    x1, y1 = p1[..., 0], p1[..., 1]
    o = torch.ones_like(x0)
    a = torch.stack([x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1,
                     x0, y0, o], dim=-1)                 # (S, 5, 9)
    _, _, vt = torch.linalg.svd(a, full_matrices=True)
    return vt[:, 5:9]


def candidates_from_basis(basis: torch.Tensor):
    """Steps 2-6 from an (S, 4, 9) nullspace basis: es (S, 10, 3, 3) and
    valid (S, 10), as essential_candidates_5pt returns them. No host
    synchronisation and no copy from the host (constants come from
    _const), so the stretch can replay as a CUDA graph."""
    dev = basis.device

    # each entry of E as a flattened (2, 2, 2) tensor: slots 4, 2, 1, 0
    # hold the x, y, z and constant coefficients
    s = basis.shape[0]
    lin = torch.zeros((s, 9, 8), dtype=basis.dtype, device=dev)
    lin[:, :, 4] = basis[:, 0]
    lin[:, :, 2] = basis[:, 1]
    lin[:, :, 1] = basis[:, 2]
    lin[:, :, 0] = basis[:, 3]
    e = lin.reshape(s, 3, 3, 8)

    c22 = _conv_map((2, 2, 2), (2, 2, 2), dev)
    c23 = _conv_map((2, 2, 2), (3, 3, 3), dev)
    c32 = _conv_map((3, 3, 3), (2, 2, 2), dev)

    # det(E) by cofactors of row 0: p[a][b] = e[1][a] * e[2][b]
    p = torch.einsum("sax,sby,xyq->sabq", e[:, 1], e[:, 2], c22)
    cof = torch.stack([p[:, 1, 2] - p[:, 2, 1],
                       -(p[:, 0, 2] - p[:, 2, 0]),
                       p[:, 0, 1] - p[:, 1, 0]], dim=1)  # (S, 3, 27)
    det = torch.einsum("skx,sky,xyq->sq", e[:, 0], cof, c23)   # (S, 64)

    # 2 E E^T E - tr(E E^T) E = 0, row (i, j) of the nine cubics
    eet = torch.einsum("sikx,sjky,xyq->sijq", e, e, c22)       # (S,3,3,27)
    tr = eet[:, 0, 0] + eet[:, 1, 1] + eet[:, 2, 2]
    eye = torch.eye(3, dtype=e.dtype, device=dev)
    cmat = 2.0 * eet - tr[:, None, None, :] * eye[None, :, :, None]
    cubic = torch.einsum("sikx,skjy,xyq->sijq", cmat, e, c32)  # (S,3,3,64)
    rows = torch.cat([det[:, None], cubic.reshape(s, 9, 64)], dim=1)
    m = rows[:, :, _const("mon_flat", dev)]                     # (S, 10, 20)
    b, info = torch.linalg.solve_ex(m[:, :, :10], m[:, :, 10:])
    b = torch.where((info == 0)[:, None, None], b, torch.nan)   # (S, 10, 10)

    # Nistér row combinations: (row(x^2 z) - z row(x^2)) etc. group the
    # surviving monomials by {x, y, 1} into polynomials in z
    zero = torch.zeros_like(b[:, 0, :1])

    def zpolys(hi, lo):
        bh, bl = b[:, hi], b[:, lo]
        # columns 2..0, 5..3 and 9..6, reversed by flip (a list index
        # would copy it from the host)
        px = (torch.cat([bh[:, 0:3].flip(1), zero], 1)
              - torch.cat([zero, bl[:, 0:3].flip(1)], 1))
        py = (torch.cat([bh[:, 3:6].flip(1), zero], 1)
              - torch.cat([zero, bl[:, 3:6].flip(1)], 1))
        p1c = (torch.cat([bh[:, 6:10].flip(1), zero], 1)
               - torch.cat([zero, bl[:, 6:10].flip(1)], 1))
        return px, py, p1c

    krow = zpolys(4, 5)     # x^2 z, x^2
    lrow = zpolys(6, 7)     # y^2 z, y^2
    mrow = zpolys(8, 9)     # xyz, xy
    pm = _conv1
    d = pm(krow[0], pm(lrow[1], mrow[2]) - pm(lrow[2], mrow[1])) \
        - pm(krow[1], pm(lrow[0], mrow[2]) - pm(lrow[2], mrow[0])) \
        + pm(krow[2], pm(lrow[0], mrow[1]) - pm(lrow[1], mrow[0]))
    # d: (S, 11) degree-10 coefficients, ascending

    lead = d[:, -1:]
    dn = d / torch.where(lead.abs() > 1e-20, lead, 1.0)
    # Fujiwara root bound, rescaled with NEGATIVE powers only (r^10
    # itself can overflow f32)
    ks = torch.arange(_N_DEG, 0, -1, device=dev).to(torch.float32)
    r_bound = 2.0 * torch.amax(dn[:, :-1].abs() ** (1.0 / ks), dim=1)
    r_bound = torch.clamp(r_bound, min=1e-6)[:, None]            # (S, 1)
    expo = (torch.arange(_N_DEG + 1, device=dev) - _N_DEG).to(torch.float32)
    dn = dn * r_bound ** expo
    dn = dn / dn[:, -1:]
    coeffs = dn.to(torch.complex64)
    roots = _const("roots0", dev).expand(s, _N_DEG)
    ceye = torch.eye(_N_DEG, dtype=torch.complex64, device=dev)
    for _ in range(_DK_ITERS):
        pz = _horner(coeffs, roots)
        diff = roots[:, :, None] - roots[:, None, :] + ceye
        roots = roots - pz / torch.prod(diff, dim=2)
    roots = roots * r_bound
    realish = roots.imag.abs() < 1e-3 * (1.0 + roots.real.abs())
    z = roots.real                                               # (S, 10)

    a11, a12, b1 = _horner(krow[0], z), _horner(krow[1], z), -_horner(krow[2], z)
    a21, a22, b2 = _horner(lrow[0], z), _horner(lrow[1], z), -_horner(lrow[2], z)
    det2 = a11 * a22 - a12 * a21
    det2 = torch.where(det2.abs() > 1e-12, det2, 1e-12)
    xs = (b1 * a22 - b2 * a12) / det2
    ys = (a11 * b2 - a21 * b1) / det2
    es = (xs[..., None] * basis[:, None, 0] + ys[..., None] * basis[:, None, 1]
          + z[..., None] * basis[:, None, 2] + basis[:, None, 3])  # (S,10,9)
    nrm = torch.linalg.vector_norm(es, dim=-1)
    es = (es / torch.clamp(nrm, min=1e-12)[..., None]).reshape(s, _N_DEG, 3, 3)
    valid = realish & es.isfinite().flatten(2).all(2)
    return es, valid
