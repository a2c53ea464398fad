"""Pose-graph optimization over SE(3) (twin of sift_tpu/sfm/posegraph.py).

Gauss-Newton on relative-pose constraints: given edges (i, j) with
measured relative transforms T_ij, minimize
  sum_e || log( T_ij^-1 · T_i^-1 · T_j ) ||^2_W
over absolute poses T_i (fixed poses hold the gauge). A static masked
edge table; per-edge 6x6 Jacobian blocks (torch.func.jacfwd under
torch.func.vmap) are scatter-added into the dense (6V x 6V) normal
equations with index_add_ on a flat view, which accumulates the blocks
of edges that share a vertex (an indexed += would keep only one). The
damped normal solve is dense (solve_ex: a singular system gives NaN and
the step is rejected).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sift_tpu_torch.geometry.lie import so3_exp, so3_log


class PoseGraph(NamedTuple):
    """poses: (V, 6) [w|t] world->frame transforms.
    edges_i/j: (E,) int64; rel: (E, 6) measured T_i->T_j as [w|t];
    weight: (E,) edge information weight; mask: (E,) bool;
    fixed: (V,) bool gauge mask."""
    poses: torch.Tensor
    edges_i: torch.Tensor
    edges_j: torch.Tensor
    rel: torch.Tensor
    weight: torch.Tensor
    mask: torch.Tensor
    fixed: torch.Tensor


def _edge_residual(pose_i, pose_j, rel6):
    """6-vector residuals of edges, (..., 6) each."""
    ra = so3_exp(pose_i[..., :3])
    rb = so3_exp(pose_j[..., :3])
    # predicted relative: T_i^-1 T_j
    r_pred = ra.mT @ rb
    t_pred = (ra.mT @ (pose_j[..., 3:] - pose_i[..., 3:])[..., None])[..., 0]
    r_meas = so3_exp(rel6[..., :3])
    dr = r_meas.mT @ r_pred
    dt = (r_meas.mT @ (t_pred - rel6[..., 3:])[..., None])[..., 0]
    return torch.cat([so3_log(dr), dt], dim=-1)


# per-edge (6, 6) residual Jacobians wrt each endpoint
_edge_jacobians = torch.func.vmap(torch.func.jacfwd(_edge_residual,
                                                    argnums=(0, 1)))


def _flat_block_index(a: torch.Tensor, b: torch.Tensor, v: int
                      ) -> torch.Tensor:
    """(E, 6, 6) flat indices of the 6x6 blocks (a_e, b_e) of a
    (6V x 6V) row-major matrix."""
    k = torch.arange(6, device=a.device)
    rows = (6 * a)[:, None, None] + k[None, :, None]
    cols = (6 * b)[:, None, None] + k[None, None, :]
    return rows * (6 * v) + cols


def optimize_pose_graph(g: PoseGraph, iters: int = 15,
                        lam0: float = 1e-4) -> PoseGraph:
    """Damped Gauss-Newton with accept/reject on the total cost, on the
    device of g's tensors; no host synchronisation inside the loop."""
    v = g.poses.shape[0]
    dev = g.poses.device
    ei, ej = g.edges_i.long(), g.edges_j.long()
    wm = g.weight * g.mask.to(torch.float32)
    sqw = torch.sqrt(wm)
    freev = (~g.fixed).to(torch.float32)
    free_flat = freev.repeat_interleave(6)
    fixed_flat = 1.0 - free_flat
    idx_ii = _flat_block_index(ei, ei, v).reshape(-1)
    idx_jj = _flat_block_index(ej, ej, v).reshape(-1)
    idx_ij = _flat_block_index(ei, ej, v).reshape(-1)
    idx_ji = _flat_block_index(ej, ei, v).reshape(-1)

    def cost(poses):
        res = _edge_residual(poses[ei], poses[ej], g.rel)
        return (res * res * wm[:, None]).sum()

    poses = g.poses.to(torch.float32)
    lam = torch.tensor(lam0, dtype=torch.float32, device=dev)
    for _ in range(iters):
        pi, pj = poses[ei], poses[ej]
        r = _edge_residual(pi, pj, g.rel)                  # (E, 6)
        ji, jj = _edge_jacobians(pi, pj, g.rel)            # (E, 6, 6)
        # weight + gauge: fixed endpoints contribute no columns
        ji = ji * (sqw * freev[ei])[:, None, None]
        jj = jj * (sqw * freev[ej])[:, None, None]
        rw = r * sqw[:, None]
        hij = ji.mT @ jj
        h = torch.zeros(36 * v * v, dtype=torch.float32, device=dev)
        h.index_add_(0, idx_ii, (ji.mT @ ji).reshape(-1))
        h.index_add_(0, idx_jj, (jj.mT @ jj).reshape(-1))
        h.index_add_(0, idx_ij, hij.reshape(-1))
        h.index_add_(0, idx_ji, hij.mT.reshape(-1))
        b = torch.zeros((v, 6), dtype=torch.float32, device=dev)
        b.index_add_(0, ei, (ji.mT @ rw[:, :, None])[:, :, 0])
        b.index_add_(0, ej, (jj.mT @ rw[:, :, None])[:, :, 0])
        hd = h.reshape(6 * v, 6 * v)
        damped = hd + torch.diag(
            lam * torch.clamp(torch.diagonal(hd), min=1e-8) + fixed_flat)
        delta, info = torch.linalg.solve_ex(damped, b.reshape(-1, 1))
        delta = torch.where(info == 0, delta[:, 0], torch.nan) * free_flat
        cand = poses - delta.reshape(v, 6)
        accept = (cost(cand) < cost(poses)) & cand.isfinite().all()
        poses = torch.where(accept, cand, poses)
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-9),
                          torch.clamp(lam * 4.0, max=1e3))
    return g._replace(poses=poses)


def pose_graph_cost(g: PoseGraph) -> torch.Tensor:
    res = _edge_residual(g.poses[g.edges_i.long()], g.poses[g.edges_j.long()],
                         g.rel)
    w = (g.weight * g.mask.to(torch.float32))[:, None]
    return (res * res * w).sum()
