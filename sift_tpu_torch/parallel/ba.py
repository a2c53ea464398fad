"""Distributed Schur-complement bundle adjustment (twin of
sift_tpu/parallel/ba.py).

`bundle_adjust_sharded` splits the observation table over the mesh's
first axis; cameras and points stay replicated. The single-card
adjuster (sfm/ba.py) is matrix-free -- every cross-observation reduction
is a segment sum -- so distribution is exactly: local segment sums over
the rank's observations, then psum (all_reduce) of the (C,6,6)/(P,3,3)/
(C,6)/(P,3) blocks. Every rank then computes the identical LM/CG update,
keeping the replicated state in lockstep with no further communication:
per LM iteration O(C*36 + P*9) floats times (2 + cg_iters) cross the
wire, independent of the observation count.

`bundle_adjust_point_sharded` splits the POINTS instead: each rank owns
a contiguous point block and exactly the observations of its points
(`point_sharded_inputs`, on the host), point-side blocks and updates
stay local, and only the (C,6,6)/(C,6) camera system crosses ranks per
CG step; one all_gather of the points ends it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from sift_tpu_torch.parallel.mesh import Mesh, all_gather, axis_index, \
    axis_size, psum
from sift_tpu_torch.sfm.ba import BAProblem, bundle_adjust_loop
from sift_tpu_torch.utils.caps import pow2_cap


def bundle_adjust_sharded(prob: BAProblem, mesh: Mesh,
                          iters: int = 20, cg_iters: int = 30,
                          huber_delta: float = 3e-3,
                          loss: str = "huber",
                          lam0: float = 1e-3) -> BAProblem:
    """Observation-sharded BA; prob is the same on every rank, and the
    observation count O must be divisible by the mesh's first axis (pad
    with mask=False). Returns prob with the solved cameras and points
    on every rank."""
    n = axis_size(mesh)
    o = prob.cam_idx.shape[0]
    if o % n:
        raise ValueError(f"{o} observations do not split over {n} ranks")
    rows = slice(axis_index(mesh) * (o // n), (axis_index(mesh) + 1) * (o // n))
    prob = BAProblem(*(t.to(mesh.device) for t in prob))
    local = prob._replace(cam_idx=prob.cam_idx[rows],
                          pt_idx=prob.pt_idx[rows], uv=prob.uv[rows],
                          mask=prob.mask[rows])
    out = bundle_adjust_loop(local, iters, cg_iters, huber_delta, loss,
                             lam0, psum=functools.partial(psum, mesh=mesh))
    return prob._replace(cameras=out.cameras, points=out.points)


def point_sharded_inputs(prob: BAProblem, n: int, device=None):
    """Host-side partition of a BAProblem into n contiguous point blocks,
    one per rank (a copy of sift_tpu's NumPy partitioner). Returns
    ((cameras, fixed_cams, points (n, pp, 3), cam_idx (n, ocap),
    local pt_idx (n, ocap), uv (n, ocap, 2), mask (n, ocap)), n_points)
    as tensors on `device` (default prob's)."""
    pt_idx = prob.pt_idx.cpu().numpy()
    cam_idx = prob.cam_idx.cpu().numpy()
    uv = prob.uv.cpu().numpy()
    mask = prob.mask.cpu().numpy()
    points = prob.points.cpu().numpy()
    p_total = points.shape[0]
    pp = -(-p_total // n)                     # points per block
    pts_pad = np.zeros((pp * n, 3), points.dtype)
    pts_pad[:p_total] = points
    block_of = np.minimum(pt_idx // pp, n - 1)
    counts = [(mask & (block_of == b)).sum() for b in range(n)]
    ocap = pow2_cap(max(counts), lo=64)
    l_cam = np.zeros((n, ocap), np.int64)
    l_pt = np.zeros((n, ocap), np.int64)
    l_uv = np.zeros((n, ocap, 2), np.float32)
    l_mask = np.zeros((n, ocap), bool)
    for b in range(n):
        sel = np.where(mask & (block_of == b))[0][:ocap]
        k = len(sel)
        l_cam[b, :k] = cam_idx[sel]
        l_pt[b, :k] = pt_idx[sel] - b * pp    # local point index
        l_uv[b, :k] = uv[sel]
        l_mask[b, :k] = True
    dev = prob.cameras.device if device is None else device
    inputs = (prob.cameras.to(dev), prob.fixed_cams.to(dev),
              torch.from_numpy(pts_pad.reshape(n, pp, 3)).to(dev),
              *(torch.from_numpy(a).to(dev)
                for a in (l_cam, l_pt, l_uv, l_mask)))
    return inputs, p_total


def bundle_adjust_point_sharded(prob: BAProblem, mesh: Mesh,
                                iters: int = 20, cg_iters: int = 30,
                                huber_delta: float = 3e-3,
                                loss: str = "huber",
                                lam0: float = 1e-3) -> BAProblem:
    """Map-block-sharded BA: points partitioned over the ranks; returns
    prob with the solved cameras and points (original order) on every
    rank."""
    (cameras, fixed, pts, cam_i, pt_i, uv_l, m_l), p_total = \
        point_sharded_inputs(prob, axis_size(mesh), mesh.device)
    b = axis_index(mesh)
    sub = BAProblem(cameras=cameras, points=pts[b], cam_idx=cam_i[b],
                    pt_idx=pt_i[b], uv=uv_l[b], mask=m_l[b],
                    fixed_cams=fixed)
    out = bundle_adjust_loop(sub, iters, cg_iters, huber_delta, loss, lam0,
                             psum=functools.partial(psum, mesh=mesh),
                             psum_pt=None)
    # one all_gather replicates the solved map: O(P) bytes once
    pts_all = all_gather(out.points, mesh)
    return BAProblem(*(t.to(mesh.device) for t in prob))._replace(
        cameras=out.cameras, points=pts_all[:p_total])
