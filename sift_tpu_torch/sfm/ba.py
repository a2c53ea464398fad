"""Schur-complement bundle adjustment (twin of sift_tpu/sfm/ba.py).

Levenberg-Marquardt over cameras (axis-angle + translation, 6 dof) and
3-D points, minimizing masked robust reprojection error in normalized
image coordinates.

  * The point block Hpp is block-diagonal (3x3 per point), inverted in
    closed form, batched.
  * The reduced camera (Schur) system S dx_c = rhs is solved
    matrix-free with conjugate gradients: each application of S is two
    per-observation block matvecs, two segment sums and one batched 3x3
    product. No S matrix is ever materialized.
  * Every segment sum adds in one fixed order (ops/segsum.py: a plan
    per index vector, made once a call; csrc/segsum.cu on the card,
    index_add_ on the CPU), so a call gives the same bits on every run.
  * All shapes static: observations are a fixed-capacity masked table;
    LM runs a fixed iteration count and accepts or rejects each step
    with torch.where on the device, so the loop never waits on the host.
  * The per-observation Jacobians are written out analytically
    (lie.so3_exp_jac), where the JAX package takes jax.jacfwd.
  * On the card `bundle_adjust` replays each LM iteration (the
    Schur/CG step, both costs, the accept and the damping update:
    `_lm_iter`) as one CUDA graph cached by shape (geometry/graphs.py),
    one graph launch in place of ~1,340 ATen calls an iteration at 30 CG
    steps; the plans and the first damping value are made eagerly, once
    a call. The sharded loop (`bundle_adjust_loop` with a `psum`,
    parallel/ba.py) stays eager: its all-reduces are collectives outside
    any one card's graph.

Cameras can be frozen via `fixed_cams` (gauge fixing).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from sift_tpu_torch.geometry import graphs
from sift_tpu_torch.geometry.lie import so3_exp, so3_exp_jac
from sift_tpu_torch.ops import segsum
from sift_tpu_torch.utils.profiling import span


class BAProblem(NamedTuple):
    """Static-shape bundle adjustment problem.

    cameras: (C, 6)  [w | t], world->camera, normalized coords
    points:  (P, 3)  world points
    cam_idx: (O,) int64 observation camera indices
    pt_idx:  (O,) int64 observation point indices
    uv:      (O, 2) observed normalized image coords
    mask:    (O,) bool valid-observation mask
    fixed_cams: (C,) bool -- cameras excluded from the update (gauge)
    """
    cameras: torch.Tensor
    points: torch.Tensor
    cam_idx: torch.Tensor
    pt_idx: torch.Tensor
    uv: torch.Tensor
    mask: torch.Tensor
    fixed_cams: torch.Tensor


def _residuals(prob: BAProblem) -> torch.Tensor:
    """(O, 2) normalized-coordinate reprojection residuals."""
    cams_o = prob.cameras[prob.cam_idx]
    xc = (so3_exp(cams_o[:, :3]) @ prob.points[prob.pt_idx][:, :, None]
          )[:, :, 0] + cams_o[:, 3:]
    z = torch.where(xc[:, 2].abs() > 1e-9, xc[:, 2], 1e-9)
    return xc[:, :2] / z[:, None] - prob.uv


def _robust_weight(r2: torch.Tensor, delta: float, loss: str
                   ) -> torch.Tensor:
    """IRLS weight on squared residual norms.

    huber: constant gradient beyond delta (Ceres default shape);
    cauchy: redescending -- gross outliers' influence -> 0.
    """
    if loss == "none":
        return torch.ones_like(r2)
    if loss == "cauchy":
        return 1.0 / (1.0 + r2 / (delta * delta))
    rn = torch.sqrt(r2 + 1e-20)
    return torch.where(rn <= delta, 1.0, delta / rn)


def _inv3x3_sym(h: torch.Tensor) -> torch.Tensor:
    """Batched closed-form inverse of symmetric PD (..., 3, 3)."""
    a, b, c = h[..., 0, 0], h[..., 0, 1], h[..., 0, 2]
    d, e, f = h[..., 1, 1], h[..., 1, 2], h[..., 2, 2]
    c00 = d * f - e * e
    c01 = c * e - b * f
    c02 = b * e - c * d
    c11 = a * f - c * c
    c12 = b * c - a * e
    c22 = a * d - b * b
    det = a * c00 + b * c01 + c * c02
    inv_det = 1.0 / torch.where(det.abs() > 1e-20, det, 1e-20)
    row0 = torch.stack([c00, c01, c02], dim=-1)
    row1 = torch.stack([c01, c11, c12], dim=-1)
    row2 = torch.stack([c02, c12, c22], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2) * inv_det[..., None, None]


def _build_system(prob: BAProblem, huber_delta: float, loss: str):
    """Per-observation Jacobian blocks and robust weights.

    Returns (jc (O,2,6), jp (O,2,3), res (O,2), w (O,)).
    """
    cams_o = prob.cameras[prob.cam_idx]
    x = prob.points[prob.pt_idx]
    r, dr = so3_exp_jac(cams_o[:, :3])                  # (O,3,3), (O,3,3,3)
    xc = (r @ x[:, :, None])[:, :, 0] + cams_o[:, 3:]
    front = xc[:, 2].abs() > 1e-9
    z = torch.where(front, xc[:, 2], 1e-9)
    res = xc[:, :2] / z[:, None] - prob.uv
    # d(xc[:2] / z) / d xc; a clamped depth has no slope
    inv_z = 1.0 / z
    zero = torch.zeros_like(z)
    dz = torch.where(front, -inv_z * inv_z, 0.0)
    dproj = torch.stack([torch.stack([inv_z, zero, xc[:, 0] * dz], -1),
                         torch.stack([zero, inv_z, xc[:, 1] * dz], -1)],
                        dim=1)                           # (O, 2, 3)
    dxc_dw = torch.einsum("oabi,ob->oai", dr, x)         # (O, 3, 3)
    jc = torch.cat([dproj @ dxc_dw, dproj], dim=2)       # (O, 2, 6)
    jp = dproj @ r                                       # (O, 2, 3)
    w = _robust_weight((res * res).sum(-1), huber_delta, loss)
    w = w * prob.mask.to(torch.float32)
    return jc, jp, res, w


def _cost(prob: BAProblem, huber_delta: float, loss: str,
          psum=None) -> torch.Tensor:
    res = _residuals(prob)
    r2 = (res * res).sum(-1)
    d2 = huber_delta * huber_delta
    if loss == "none":
        rho = 0.5 * r2
    elif loss == "cauchy":
        rho = 0.5 * d2 * torch.log1p(r2 / d2)
    else:
        rn = torch.sqrt(r2 + 1e-20)
        rho = torch.where(rn <= huber_delta, 0.5 * r2,
                          huber_delta * (rn - 0.5 * huber_delta))
    total = (rho * prob.mask.to(torch.float32)).sum()
    return psum(total) if psum is not None else total


_SAME = object()


def _make_plans(prob: BAProblem):
    """(camera plan, point plan) of prob's segment sums (ops/segsum.py);
    the observation table does not change within a call. The masked
    rows are left out: every row summed is weighted by the mask, so
    theirs are zeros, and every sum starts from zeros."""
    return (segsum.make_plan(prob.cam_idx, prob.cameras.shape[0],
                             prob.mask),
            segsum.make_plan(prob.pt_idx, prob.points.shape[0], prob.mask))


def _lm_step(prob: BAProblem, lam: torch.Tensor, huber_delta: float,
             loss: str, cg_iters: int, plans, psum=None, psum_pt=_SAME):
    """One damped Schur/CG step. Returns (dcams (C,6), dpts (P,3)).

    `plans` are _make_plans(prob), the order of its segment sums.

    `psum` optionally reduces observation-sharded segment sums across
    devices (a sharded adjuster passes an all-reduce); None on one card.
    `psum_pt` separately controls the POINT-side reductions: for
    observation sharding it equals `psum` (points replicated); for
    point sharding it is None -- each device owns its point block and
    only camera-side reductions cross devices.
    """
    if psum_pt is _SAME:
        psum_pt = psum
    c = prob.cameras.shape[0]
    p = prob.points.shape[0]
    cam_plan, pt_plan = plans
    jc, jp, res, w = _build_system(prob, huber_delta, loss)
    wc = w[:, None, None]

    def seg_cam(x):  # (O, ...) -> (C, ...)
        out = segsum.segment_sum(x.new_zeros((c,) + x.shape[1:]), cam_plan,
                                 x)
        return psum(out) if psum is not None else out

    def seg_pt(x):   # (O, ...) -> (P, ...)
        out = segsum.segment_sum(x.new_zeros((p,) + x.shape[1:]), pt_plan,
                                 x)
        return psum_pt(out) if psum_pt is not None else out

    # normal-equation blocks
    rw = res * w[:, None]
    hcc = seg_cam(wc * jc.mT @ jc)                         # (C, 6, 6)
    hpp = seg_pt(wc * jp.mT @ jp)                          # (P, 3, 3)
    bc = -seg_cam((jc.mT @ rw[:, :, None])[:, :, 0])
    bp = -seg_pt((jp.mT @ rw[:, :, None])[:, :, 0])
    wcp = wc * jc.mT @ jp                                  # (O, 6, 3)

    # damping (LM, multiplicative on block diagonals)
    dev = prob.cameras.device
    eye6 = torch.eye(6, device=dev)
    eye3 = torch.eye(3, device=dev)
    hcc_d = hcc + lam * eye6 * torch.clamp(
        torch.diagonal(hcc, dim1=-2, dim2=-1), min=1e-6)[:, :, None]
    hpp_d = hpp + lam * eye3 * torch.clamp(
        torch.diagonal(hpp, dim1=-2, dim2=-1), min=1e-6)[:, :, None]
    hpp_inv = _inv3x3_sym(hpp_d)
    free = (~prob.fixed_cams).to(torch.float32)[:, None]

    def schur_apply(xc):
        """S xc = Hcc xc - Hcp Hpp^-1 Hpc xc, xc: (C, 6)."""
        xc = xc * free
        y = (xc[prob.cam_idx][:, None, :] @ wcp)[:, 0]     # (O, 3)
        u = (hpp_inv @ seg_pt(y)[:, :, None])[:, :, 0]     # (P, 3)
        v = (wcp @ u[prob.pt_idx][:, :, None])[:, :, 0]    # (O, 6)
        out = (hcc_d @ xc[:, :, None])[:, :, 0] - seg_cam(v)
        return out * free

    # Schur RHS: bc - Hcp Hpp^-1 bp
    u0 = (hpp_inv @ bp[:, :, None])[:, :, 0]
    rhs = (bc - seg_cam((wcp @ u0[prob.pt_idx][:, :, None])[:, :, 0])) * free

    # CG on the reduced camera system (fixed iterations, masked dofs)
    x = torch.zeros_like(rhs)
    r = rhs
    pdir = rhs
    rs = (r * r).sum()
    for _ in range(cg_iters):
        ap = schur_apply(pdir)
        denom = (pdir * ap).sum()
        alpha = torch.where(denom.abs() > 1e-20, rs / denom, 0.0)
        x = x + alpha * pdir
        r = r - alpha * ap
        rs_new = (r * r).sum()
        beta = torch.where(rs > 1e-20, rs_new / rs, 0.0)
        pdir = r + beta * pdir
        rs = rs_new
    dc = x * free

    # back-substitute points: dp = Hpp^-1 (bp - Hpc dc)
    y = (dc[prob.cam_idx][:, None, :] @ wcp)[:, 0]
    dp = (hpp_inv @ (bp - seg_pt(y))[:, :, None])[:, :, 0]
    return dc, dp


def _lm_iteration(prob: BAProblem, lam: torch.Tensor, huber_delta: float,
                  loss: str, cg_iters: int, plans, psum=None,
                  psum_pt=_SAME):
    """One LM iteration: the damped step, kept where it lowers the cost.
    Returns (prob with the kept cameras and points, the next lam)."""
    dc, dp = _lm_step(prob, lam, huber_delta, loss, cg_iters, plans,
                      psum=psum, psum_pt=psum_pt)
    cand = prob._replace(cameras=prob.cameras + dc,
                         points=prob.points + dp)
    c0 = _cost(prob, huber_delta, loss, psum=psum)
    c1 = _cost(cand, huber_delta, loss, psum=psum)
    accept = (c1 < c0) & c1.isfinite()
    prob = prob._replace(
        cameras=torch.where(accept, cand.cameras, prob.cameras),
        points=torch.where(accept, cand.points, prob.points))
    lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-9),
                      torch.clamp(lam * 4.0, max=1e3))
    return prob, lam


def _lm_iter(cameras, points, lam, cam_idx, pt_idx, uv, mask, fixed_cams,
             cam_perm, cam_offsets, pt_perm, pt_offsets, huber_delta: float,
             loss: str, cg_iters: int):
    """_lm_iteration on one card as a stretch of graphs.GraphCache: the
    state (cameras, points, lam), the call's table and the two plans'
    order in; the next (cameras, points, lam) out."""
    prob = BAProblem(cameras, points, cam_idx, pt_idx, uv, mask, fixed_cams)
    plans = (segsum.Plan(cam_idx, cameras.shape[0], mask, cam_perm,
                         cam_offsets),
             segsum.Plan(pt_idx, points.shape[0], mask, pt_perm, pt_offsets))
    prob, lam = _lm_iteration(prob, lam, huber_delta, loss, cg_iters, plans)
    return prob.cameras, prob.points, lam


def bundle_adjust_loop(prob: BAProblem, iters: int, cg_iters: int,
                       huber_delta: float, loss: str, lam0: float,
                       psum=None, psum_pt=_SAME) -> BAProblem:
    """The eager LM loop, shared by the CPU and the sharded adjusters.

    With `psum`, the observation table is assumed sharded over devices:
    every cross-observation reduction -- normal-equation blocks,
    Schur/CG matvecs, costs -- is all-reduced, so each device computes
    the identical update. With `psum_pt=None` on top, points (and their
    observations) are device-local map blocks: point-side reductions
    stay on-device and only the camera system crosses devices.
    """
    lam = torch.tensor(lam0, dtype=torch.float32, device=prob.cameras.device)
    plans = _make_plans(prob)
    for _ in range(iters):
        prob, lam = _lm_iteration(prob, lam, huber_delta, loss, cg_iters,
                                  plans, psum=psum, psum_pt=psum_pt)
    return prob


def bundle_adjust(prob: BAProblem, iters: int = 20, cg_iters: int = 30,
                  huber_delta: float = 3e-3, loss: str = "huber",
                  lam0: float = 1e-3, n_obs: Optional[int] = None
                  ) -> BAProblem:
    """Run LM bundle adjustment; returns the problem with updated
    cameras/points. Fixed iteration count, accept/reject by cost, on
    the device of prob's tensors; on the card each iteration goes
    through graphs.CACHE (`ba.lm_iter`), on the CPU the eager loop.
    Inside a span `sfm.ba` whose attributes are the padded table's
    shapes (obs, points, cams), the rows its segment sums read
    (obs_used: `n_obs`, the unmasked rows, where the caller knows it
    without reading the mask back, else obs), the loop's counts (iters,
    cg_iters) and graph_hit (every iteration replayed a graph)."""
    o = prob.cam_idx.shape[0]
    with span("sfm.ba", obs=o, obs_used=o if n_obs is None else n_obs,
              points=prob.points.shape[0], cams=prob.cameras.shape[0],
              iters=iters, cg_iters=cg_iters, graph_hit=False) as sp:
        plans = _make_plans(prob)
        lam = torch.tensor(lam0, dtype=torch.float32,
                           device=prob.cameras.device)
        cam_plan, pt_plan = plans
        if cam_plan.perm is None:       # CPU plans (index_add_): eagerly
            for _ in range(iters):
                prob, lam = _lm_iteration(prob, lam, huber_delta, loss,
                                          cg_iters, plans)
            return prob
        state = (prob.cameras, prob.points, lam)
        table = (prob.cam_idx, prob.pt_idx, prob.uv, prob.mask,
                 prob.fixed_cams, cam_plan.perm, cam_plan.offsets,
                 pt_plan.perm, pt_plan.offsets)
        hits = graphs.CACHE.hits
        for _ in range(iters):
            state = graphs.CACHE.run("ba.lm_iter", _lm_iter, state + table,
                                     (huber_delta, loss, cg_iters))
        sp.set(graph_hit=graphs.CACHE.hits - hits == iters)
        return prob._replace(cameras=state[0], points=state[1])


def reproj_rmse(prob: BAProblem) -> torch.Tensor:
    """Masked RMS reprojection error (normalized coords)."""
    res = _residuals(prob)
    m = prob.mask.to(torch.float32)
    se = ((res * res).sum(-1) * m).sum()
    return torch.sqrt(se / torch.clamp(m.sum(), min=1.0))
