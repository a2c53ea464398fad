"""Partitioned pose-graph optimization over the ranks (twin of
sift_tpu/sfm/posegraph_dist.py).

Poses are partitioned into contiguous keyframe blocks, one per rank.
Each round, the blocks of one colour run damped Gauss-Newton on their
LOCAL subgraph (their own poses free, halo poses -- the far endpoints of
boundary edges -- frozen at the current global estimate), then every
rank exchanges its owned poses with one psum: nonlinear block Jacobi
with a Gauss-Seidel colour schedule, O(V * 6) floats on the wire per
round whatever the edge count. It converges to the dense solver's
optimum on graphs whose coupling is mostly local (trajectory chains plus
sparse loop closures), the keyframe regime.

Partitioning runs on the host in NumPy (`partition_pose_graph`, a copy
of sift_tpu's); every block is padded to the same local vertex and edge
capacity.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sift_tpu_torch.geometry.lie import so3_exp, so3_log
from sift_tpu_torch.parallel.mesh import Mesh, axis_index, axis_size, psum
from sift_tpu_torch.sfm.posegraph import (PoseGraph, optimize_pose_graph,
                                          pose_graph_cost)


class PartitionedGraph(NamedTuple):
    """Per-block local subgraphs, all padded to common capacities.

    gidx: (B, Vl) global vertex index of each local slot
    own:  (B, Vl) True where this block owns the vertex (vs halo)
    vmask:(B, Vl) slot holds a real vertex
    edges_i/j: (B, El) LOCAL endpoint indices
    rel:  (B, El, 6); weight: (B, El); emask: (B, El)
    fixed:(B, Vl) gauge-fixed OR halo (frozen during local solves)
    color:(B,) schedule colour: blocks sharing an edge never update in
          the same round (greedy colouring of the block-coupling graph)
    """
    gidx: torch.Tensor
    own: torch.Tensor
    vmask: torch.Tensor
    edges_i: torch.Tensor
    edges_j: torch.Tensor
    rel: torch.Tensor
    weight: torch.Tensor
    emask: torch.Tensor
    fixed: torch.Tensor
    color: torch.Tensor


def partition_pose_graph(g: PoseGraph, n_blocks: int) -> PartitionedGraph:
    """Contiguous-range partition on the host (CPU tensors). Keyframe
    trajectories are index-ordered, so contiguous ranges cut few edges;
    loop-closure edges become boundary edges with halo vertices."""
    v = int(g.poses.shape[0])
    ei = g.edges_i.cpu().numpy()
    ej = g.edges_j.cpu().numpy()
    emask = g.mask.cpu().numpy()
    fixed = g.fixed.cpu().numpy()
    block_of = np.minimum(np.arange(v) * n_blocks // v, n_blocks - 1)

    locals_ = []
    for b in range(n_blocks):
        owned = np.where(block_of == b)[0]
        touching = [k for k in range(len(ei))
                    if emask[k] and (block_of[ei[k]] == b
                                     or block_of[ej[k]] == b)]
        halo = sorted((set(int(ei[k]) for k in touching)
                       | set(int(ej[k]) for k in touching))
                      - set(owned.tolist()))
        verts = np.concatenate([owned, np.array(halo, int)]) \
            if halo else owned
        locals_.append((owned, verts, touching))

    # greedy colouring of the block-coupling graph: blocks linked by any
    # edge (loop closures too) never update in the same round
    adj = {b: set() for b in range(n_blocks)}
    for k in range(len(ei)):
        if emask[k]:
            a, b = int(block_of[ei[k]]), int(block_of[ej[k]])
            if a != b:
                adj[a].add(b)
                adj[b].add(a)
    colors = np.zeros(n_blocks, np.int64)
    for b in range(n_blocks):
        used = {int(colors[nb]) for nb in adj[b] if nb < b}
        col = 0
        while col in used:
            col += 1
        colors[b] = col

    vl = max(len(vv) for _, vv, _ in locals_)
    el = max(max(len(tt) for _, _, tt in locals_), 1)

    def pad(a, n, fill=0):
        out = np.full((n,) + a.shape[1:], fill, a.dtype)
        out[:len(a)] = a
        return out

    gidx, own, vmask, lei, lej, rel, wgt, lem, lfix = \
        [], [], [], [], [], [], [], [], []
    rel_np = g.rel.cpu().numpy()
    w_np = g.weight.cpu().numpy()
    for owned, verts, touching in locals_:
        remap = {int(gv): i for i, gv in enumerate(verts)}
        nvert = len(verts)
        gidx.append(pad(verts.astype(np.int64), vl))
        own.append(pad(np.arange(nvert) < len(owned), vl, False))
        vmask.append(pad(np.ones(nvert, bool), vl, False))
        lei.append(pad(np.array([remap[int(ei[k])] for k in touching],
                                np.int64), el))
        lej.append(pad(np.array([remap[int(ej[k])] for k in touching],
                                np.int64), el))
        rel.append(pad(rel_np[touching].astype(np.float32), el))
        wgt.append(pad(w_np[touching].astype(np.float32), el))
        lem.append(pad(np.ones(len(touching), bool), el, False))
        # halo and padding slots are frozen; gauge-fixed stay fixed
        f = np.array([fixed[int(gv)] or i >= len(owned)
                      for i, gv in enumerate(verts)], bool)
        lfix.append(pad(f, vl, True))

    def stack(xs):
        return torch.from_numpy(np.stack(xs))
    return PartitionedGraph(
        gidx=stack(gidx), own=stack(own), vmask=stack(vmask),
        edges_i=stack(lei), edges_j=stack(lej), rel=stack(rel),
        weight=stack(wgt), emask=stack(lem), fixed=stack(lfix),
        color=torch.from_numpy(colors))


def optimize_pose_graph_partitioned(
        g: PoseGraph, mesh: Mesh, rounds: int | None = None,
        inner_iters: int = 6, lam0: float = 1e-4) -> PoseGraph:
    """Block-Jacobi pose-graph refinement over the ranks (see the module
    docstring); g is the same on every rank, and every rank returns the
    refined graph. Rank b runs block b's local Gauss-Newton per round,
    then one psum exchanges the owned poses.

    `rounds` defaults to 3 * n_blocks * n_colours: corrections travel
    about one block per colour cycle, so the rounds must comfortably
    exceed the block count."""
    n_blocks = axis_size(mesh)
    part = partition_pose_graph(g, n_blocks)
    n_colors = int(part.color.max()) + 1
    if rounds is None:
        rounds = max(6, 3 * n_blocks * n_colors)
    v = g.poses.shape[0]
    dev = mesh.device
    pt = PartitionedGraph(*(x[axis_index(mesh)].to(dev) for x in part))
    ownf = (pt.own & pt.vmask).to(torch.float32)[:, None]
    poses = g.poses.to(device=dev, dtype=torch.float32)
    for i in range(rounds):
        sub = PoseGraph(poses=poses[pt.gidx], edges_i=pt.edges_i,
                        edges_j=pt.edges_j, rel=pt.rel, weight=pt.weight,
                        mask=pt.emask, fixed=pt.fixed)
        sub = optimize_pose_graph(sub, iters=inner_iters, lam0=lam0)
        # Gauss-Seidel colour schedule: edge-coupled blocks never update
        # in the same round (simultaneous updates oscillate and stall)
        w = ownf * (pt.color == i % n_colors).to(torch.float32)
        contrib = torch.zeros((v, 6), device=dev).index_add_(
            0, pt.gidx, sub.poses * w)
        cnt = torch.zeros((v,), device=dev).index_add_(0, pt.gidx, w[:, 0])
        total = psum(contrib, mesh)
        cnt = psum(cnt, mesh)
        poses = torch.where(cnt[:, None] > 0,
                            total / torch.clamp(cnt[:, None], min=1.0), poses)
    return PoseGraph(*(t.to(dev) for t in g))._replace(poses=poses)


def loop_graph(nv: int, seed: int = 7) -> PoseGraph:
    """A noisy loop trajectory of nv poses on the CPU: a slow yaw and an
    x walk, odometry edges plus a loop edge (i, i + 3) every 5 poses,
    1e-3 noise on the measurements and 0.05 on the initial poses (pose
    0 exact and fixed)."""
    rng = np.random.default_rng(seed)
    true = np.zeros((nv, 6), np.float32)
    true[:, 1] = np.linspace(0, 1.2, nv)                  # slow yaw
    true[:, 3] = np.arange(nv) * 0.5                      # x walk
    ei, ej, rel = [], [], []
    for i in range(nv - 1):
        pairs = [(i, i + 1)]
        if i % 5 == 0 and i + 3 < nv:
            pairs.append((i, i + 3))                      # loop edges
        for a, b in pairs:
            ra = so3_exp(torch.from_numpy(true[a, :3])).numpy()
            rb = so3_exp(torch.from_numpy(true[b, :3])).numpy()
            rr = ra.T @ rb
            tt = ra.T @ (true[b, 3:] - true[a, 3:])
            w = so3_log(torch.from_numpy(rr.astype(np.float32))).numpy()
            ei.append(a)
            ej.append(b)
            rel.append(np.concatenate([w + rng.normal(0, 1e-3, 3),
                                       tt + rng.normal(0, 1e-3, 3)]))
    e = len(ei)
    init = true + rng.normal(0, 0.05, true.shape).astype(np.float32)
    init[0] = true[0]
    return PoseGraph(
        poses=torch.from_numpy(init),
        edges_i=torch.tensor(ei),
        edges_j=torch.tensor(ej),
        rel=torch.from_numpy(np.array(rel, np.float32)),
        weight=torch.ones((e,)),
        mask=torch.ones((e,), dtype=torch.bool),
        fixed=torch.from_numpy(np.arange(nv) == 0))


def selftest(mesh: Mesh) -> None:
    """Convergence check on any mesh: loop_graph with 4 poses a rank must
    optimize to near the dense solver's cost."""
    g = PoseGraph(*(t.to(mesh.device)
                    for t in loop_graph(4 * axis_size(mesh))))
    c0 = float(pose_graph_cost(g))
    cd = float(pose_graph_cost(optimize_pose_graph(g, iters=20)))
    # corrections propagate about one block per round, so rounds must
    # comfortably exceed the block count
    cp = float(pose_graph_cost(optimize_pose_graph_partitioned(
        g, mesh, rounds=24, inner_iters=6)))
    if not (cd < c0 * 0.05 and cp < c0 * 0.02):
        raise AssertionError(f"pose graph did not converge: initial {c0}, "
                             f"dense {cd}, partitioned {cp}")
