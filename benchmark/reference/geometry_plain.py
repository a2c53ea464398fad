"""The geometry the frozen back end solves with: Lie maps, the smallest
eigenvector, DLT triangulation, the RANSAC draws, Nister's 5-point
solver with the essential RANSAC, and PnP RANSAC.

Frozen copies, made at commit e6556db, of sift_tpu_torch/geometry/
(lie.py, linalg.py, triangulation.py, homography.py's draws,
fivepoint.py, epipolar.py, pnp.py), the expressions kept as they were
so that the same inputs on the same device give the same bits; the one
change is the 5-point solver's slot enumeration, np.ndindex in place of
itertools.product (the same C order). PnP's N_HYPOTHESES is
PNP_HYPOTHESES here. Imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
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
        for ia, a in enumerate(np.ndindex(*sa)):
            for ib, b in enumerate(np.ndindex(*sb)):
                out = tuple(x + y for x, y in zip(a, b))
                m[ia, ib, np.ravel_multi_index(out, so)] = 1.0
        _CONV_MAPS[key] = torch.from_numpy(m).to(device)
    return _CONV_MAPS[key]


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
    dev = p0.device
    x0, y0 = p0[..., 0], p0[..., 1]
    x1, y1 = p1[..., 0], p1[..., 1]
    o = torch.ones_like(x0)
    a = torch.stack([x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1,
                     x0, y0, o], dim=-1)                 # (S, 5, 9)
    _, _, vt = torch.linalg.svd(a, full_matrices=True)
    basis = vt[:, 5:9]                                   # (S, 4, 9) X,Y,Z,W

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
    m = rows[:, :, _MON_FLAT]                                   # (S, 10, 20)
    b, info = torch.linalg.solve_ex(m[:, :, :10], m[:, :, 10:])
    b = torch.where((info == 0)[:, None, None], b, torch.nan)   # (S, 10, 10)

    # Nistér row combinations: (row(x^2 z) - z row(x^2)) etc. group the
    # surviving monomials by {x, y, 1} into polynomials in z
    zero = torch.zeros_like(b[:, 0, :1])

    def zpolys(hi, lo):
        bh, bl = b[:, hi], b[:, lo]
        px = (torch.cat([bh[:, [2, 1, 0]], zero], 1)
              - torch.cat([zero, bl[:, [2, 1, 0]]], 1))
        py = (torch.cat([bh[:, [5, 4, 3]], zero], 1)
              - torch.cat([zero, bl[:, [5, 4, 3]]], 1))
        p1c = (torch.cat([bh[:, [9, 8, 7, 6]], zero], 1)
               - torch.cat([zero, bl[:, [9, 8, 7, 6]]], 1))
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
    roots = torch.as_tensor(_ROOTS0, dtype=torch.complex64,
                            device=dev).expand(s, _N_DEG)
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
    the drawn ones. Runs on p0's device.
    """
    n = p0.shape[0]
    p0 = p0.to(torch.float32)
    p1 = p1.to(torch.float32)
    dev = p0.device
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=dev)
    thr2 = threshold * threshold
    n_samples, k = sample_shape(n_hypotheses, solver)
    idx = draw_samples(valid, n_samples, k, seed, samples)

    if solver == "5pt":
        cand, cvalid = essential_candidates_5pt(p0[idx], p1[idx])
        inl = (_sampson_sq(cand, p0, p1) < thr2) & valid     # (S, 10, N)
        cnt = inl.sum(-1, dtype=torch.int32) * cvalid.to(torch.int32)
        kbest = torch.argmax(cnt, dim=1)
        rows = torch.arange(n_samples, device=dev)
        counts, es = cnt[rows, kbest], cand[rows, kbest]
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

    def pose_e(params):
        tv = params[3:]
        tv = tv / torch.clamp(torch.linalg.vector_norm(tv, dim=-1,
                                                       keepdim=True),
                              min=1e-12)
        return hat(tv) @ so3_exp(params[:3])

    def residuals(params):
        e = pose_e(params)
        ep0 = p0h @ e.T
        etp1 = p1h @ e
        num = (p1h * ep0).sum(1)
        den = torch.sqrt(ep0[:, 0] ** 2 + ep0[:, 1] ** 2
                         + etp1[:, 0] ** 2 + etp1[:, 1] ** 2 + 1e-12)
        return (num / den) * wmask

    eye6 = torch.eye(6, device=dev)
    params = torch.cat([so3_log(r), t])
    for _ in range(5):
        res = residuals(params)
        j = torch.func.jacfwd(residuals)(params)           # (N, 6)
        jtj = j.T @ j + 1e-8 * eye6
        delta, info = torch.linalg.solve_ex(jtj, (j.T @ res)[:, None])
        cand_p = torch.where(info == 0, params - delta[:, 0], torch.nan)
        params = torch.where(cand_p.isfinite().all(), cand_p, params)
    e_gn = pose_e(params)
    inl_gn = (_sampson_sq(e_gn, p0, p1) < thr2) & valid
    better = inl_gn.sum() >= inliers.sum()
    e_best = torch.where(better, e_gn, e_best)
    inliers = torch.where(better, inl_gn, inliers)
    r2, t2, _ = _decompose(e_best, p0, p1, inliers)

    return EssentialResult(e_best, r2, t2, inliers & ok,
                           inliers.sum(dtype=torch.int32)
                           * ok.to(torch.int32), ok)


SAMPLE_SIZE = 6
PNP_HYPOTHESES = 512


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


def pnp_ransac(x: torch.Tensor, p: torch.Tensor,
               valid: Optional[torch.Tensor] = None,
               threshold: float = 2e-3,
               n_hypotheses: int = PNP_HYPOTHESES,
               seed: int = 0,
               samples: Optional[torch.Tensor] = None) -> PnPResult:
    """RANSAC PnP: world points x (N, 3), normalized obs p (N, 2).
    samples: optional (n_hypotheses, SAMPLE_SIZE) indices that replace
    the drawn ones. Runs on x's device."""
    n = x.shape[0]
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
    nd = ((_reproj_sq(rd, td, x, p) < thr2) & valid).sum(-1, dtype=torch.int32)
    np_ = ((_reproj_sq(rp, tp, x, p) < thr2) & valid).sum(-1,
                                                          dtype=torch.int32)
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

    def residuals(params):
        xc = x @ so3_exp(params[:3]).T + params[3:]
        z = torch.where(xc[:, 2].abs() > 1e-9, xc[:, 2], 1e-9)
        proj = xc[:, :2] / z[:, None]
        return ((proj - p) * wmask[:, None]).reshape(-1)

    eye6 = torch.eye(6, device=dev)
    params = torch.cat([so3_log(r_best), t_best])
    for _ in range(5):
        res = residuals(params)
        j = torch.func.jacfwd(residuals)(params)
        jtj = j.T @ j + 1e-9 * eye6
        delta, info = torch.linalg.solve_ex(jtj, (j.T @ res)[:, None])
        cand = torch.where(info == 0, params - delta[:, 0], torch.nan)
        params = torch.where(cand.isfinite().all(), cand, params)
    r_gn = so3_exp(params[:3])
    t_gn = params[3:]
    inl_gn = (_reproj_sq(r_gn, t_gn, x, p) < thr2) & valid
    better = inl_gn.sum() >= inliers.sum()
    r_best = torch.where(better, r_gn, r_best)
    t_best = torch.where(better, t_gn, t_best)
    inliers = torch.where(better, inl_gn, inliers)

    return PnPResult(r_best, t_best, inliers & ok,
                     inliers.sum(dtype=torch.int32) * ok.to(torch.int32), ok)
