"""The frozen back end of the mapping path, fed the program's own front
end: reconstruct, close the loop, correct the trajectory on the pose
graph and run the final BA, as sift_tpu_torch.sfm.mapping.run_mapping
does after its front end.

`run_back_end` is a frozen copy, made at commit e6556db, of
run_mapping's stages after mapping.front_end (and of the functions
they call, here and in sfm_plain.py and geometry_plain.py), the
expressions kept as they were but for the segment sums
(sfm_plain.host_index_add). It takes the front end's output: each
frame's pixel coordinates, descriptors and validity, and the kept
sequential matches. The RANSAC calls draw as the program's do, from a
generator on the call's device seeded with 0. Imports nothing of the
program.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from benchmark.reference.geometry_plain import pnp_ransac, so3_exp
from benchmark.reference.sfm_plain import (
    LoopClosure, PoseGraph, Reconstruction, Sampler, _ObsTable, _ba_tables,
    _pad2, bundle_adjust, draw, find_loop_closures, optimize_pose_graph,
    pow2_cap, reconstruct, reproj_rmse, resolve_device, so3_exp_f32,
    so3_log_f32)


@dataclasses.dataclass
class BackEnd:
    """The back end's map (host-side NumPy), as MappingResult holds it."""
    rec: Reconstruction
    closures: List[LoopClosure]
    cameras_pg: np.ndarray
    cameras_final: np.ndarray
    points_final: np.ndarray
    has_point: np.ndarray
    registered: np.ndarray
    reproj_rmse: float


def _rel_pose(a6: np.ndarray, b6: np.ndarray) -> np.ndarray:
    """Relative [w|t] of edge a->b (posegraph convention T_a^-1 T_b)."""
    ra = so3_exp_f32(a6[:3])
    rb = so3_exp_f32(b6[:3])
    r = ra.T @ rb
    t = ra.T @ (b6[3:] - a6[3:])
    return np.concatenate([so3_log_f32(r), t])


def _closure_pnp_edges(rec: Reconstruction, closures, xy_n,
                       threshold: float,
                       sampler: Optional[Sampler] = None,
                       device=None) -> List[Tuple[int, int,
                                                   np.ndarray, int]]:
    """Scale-resolved closure edges: PnP of frame j against the live
    map points observed in frame i through the closure's 2D-2D
    matches. The raw closure rel_pose from essential decomposition has
    unit-norm translation (monocular scale ambiguity); anchoring it to
    the map via 2D-3D PnP gives a metric edge in the map's gauge."""
    dev = resolve_device(device)
    kpt2track: List[Dict[int, int]] = [dict() for _ in xy_n]
    for t_id, tr in enumerate(rec.tracks):
        if rec.has_point[t_id]:
            for f, kidx in tr.items():
                kpt2track[f][kidx] = t_id
    edges = []
    for c in closures:
        ks = [(ki, kj) for ki, kj in c.matches
              if ki in kpt2track[c.i]]
        if len(ks) < 8:
            continue
        tids = np.array([kpt2track[c.i][ki] for ki, _ in ks])
        x3 = rec.points[tids]
        p2 = xy_n[c.j][np.array([kj for _, kj in ks])]
        cap = pow2_cap(len(ks), lo=16)
        x3p, ok = _pad2(x3, cap)
        p2p, _ = _pad2(p2, cap)
        ok = torch.as_tensor(ok, device=dev)
        pres = pnp_ransac(torch.as_tensor(x3p, device=dev),
                          torch.as_tensor(p2p, device=dev), valid=ok,
                          threshold=threshold,
                          samples=draw(sampler, "pnp", ok))
        if not bool(pres.ok):
            continue
        cam_j = np.concatenate([so3_log_f32(pres.R), pres.t.cpu().numpy()])
        rel = _rel_pose(rec.cameras[c.i], cam_j)
        edges.append((c.i, c.j, rel, int(pres.n_inliers)))
    return edges


def _pose_graph_correct(rec: Reconstruction, closure_edges,
                        closure_weight: float = 4.0,
                        iters: int = 30, device=None) -> np.ndarray:
    """Odometry edges between consecutive registered frames (from the
    incremental trajectory) + metric closure edges -> corrected
    trajectory. Unregistered frames are marked fixed so their dummy
    poses stay out of the solve."""
    dev = resolve_device(device)
    reg = np.where(rec.registered)[0]
    ei, ej, rels, w = [], [], [], []
    for a, b in zip(reg[:-1], reg[1:]):
        ei.append(a)
        ej.append(b)
        rels.append(_rel_pose(rec.cameras[a], rec.cameras[b]))
        w.append(1.0)
    for (i, j, rel, n_inl) in closure_edges:
        ei.append(i)
        ej.append(j)
        rels.append(rel)
        w.append(closure_weight)
    fixed = ~rec.registered.copy()
    fixed[reg[0]] = True

    def on(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    g = PoseGraph(
        poses=on(rec.cameras, torch.float32),
        edges_i=on(ei, torch.long), edges_j=on(ej, torch.long),
        rel=on(np.array(rels), torch.float32),
        weight=on(w, torch.float32),
        mask=torch.ones(len(ei), dtype=torch.bool, device=dev),
        fixed=on(fixed, torch.bool))
    out = optimize_pose_graph(g, iters=iters)
    return out.poses.cpu().numpy().astype(np.float64)


def _prune_table(table: _ObsTable, cameras, registered, points,
                 has_point, max_err: float) -> int:
    """Drop observations whose reprojection error exceeds max_err
    (vectorized over the flat table); tracks left with < 2 registered
    observations lose their point. Returns observations removed."""
    usable = registered & np.isfinite(cameras).all(axis=1)
    sel = table.alive & usable[table.frame] & has_point[table.track]
    idx = np.where(sel)[0]
    if not len(idx):
        return 0
    f = table.frame[idx].astype(np.int64)
    t = table.track[idx].astype(np.int64)
    rw = so3_exp_f32(cameras[:, :3])
    xc = np.einsum("oij,oj->oi", rw[f], points[t]) + cameras[f, 3:]
    z = xc[:, 2]
    err = np.linalg.norm(
        xc[:, :2] / np.maximum(z, 1e-12)[:, None] - table.uv[idx],
        axis=1)
    bad = (z <= 1e-6) | (err > max_err)
    table.alive[idx[bad]] = False
    cnt = np.bincount(table.track[table.alive & usable[table.frame]],
                      minlength=len(has_point))
    has_point[cnt < 2] = False
    return int(bad.sum())


def umeyama_alignment(src: np.ndarray, dst: np.ndarray,
                      with_scale: bool = True
                      ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Similarity transform (R, t, s) minimizing ||s R src + t - dst||.

    src, dst: (N, 3). Standard Umeyama 1991 closed form.
    """
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    u, d, vt = np.linalg.svd(cov)
    s = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s[2, 2] = -1
    r = u @ s @ vt
    if with_scale:
        var = (xs ** 2).sum() / len(src)
        scale = np.trace(np.diag(d) @ s) / var
    else:
        scale = 1.0
    t = mu_d - scale * r @ mu_s
    return r, t, float(scale)


def ate_rmse(est_positions: np.ndarray, gt_positions: np.ndarray,
             align: bool = True) -> float:
    """Absolute trajectory error (RMSE of camera centers) after
    similarity alignment (monocular SfM has gauge/scale freedom)."""
    est = np.asarray(est_positions, np.float64)
    gt = np.asarray(gt_positions, np.float64)
    if align:
        r, t, s = umeyama_alignment(est, gt)
        est = (s * (est @ r.T)) + t
    return float(np.sqrt(((est - gt) ** 2).sum(axis=1).mean()))


def run_back_end(xy: Sequence[np.ndarray], descs: Sequence[torch.Tensor],
                 valids: Sequence[torch.Tensor],
                 seq: Dict[Tuple[int, int], np.ndarray], k: np.ndarray,
                 ratio: float = 0.86, min_gap: int = 6,
                 closure_candidates: int = 2,
                 ransac_threshold: float = 2e-3,
                 ba_window: Optional[int] = 8, sampler: Optional[Sampler] = None,
                 proj=None, device=None) -> BackEnd:
    """run_mapping's stages after its front end, on `device`: xy are the
    frames' (N, 2) pixel coordinates, descs and valids their descriptors
    and validity, seq the kept sequential matches {(i, j): (M, 2)}."""
    dev = resolve_device(device)
    fx, fy = k[0, 0], k[1, 1]
    cx, cy = k[0, 2], k[1, 2]
    xy_n = [np.stack([(p[:, 0] - cx) / fx, (p[:, 1] - cy) / fy], 1)
            .astype(np.float32) for p in xy]

    rec = reconstruct(xy_n, seq, ransac_threshold=ransac_threshold,
                      ba_window=ba_window, sampler=sampler, device=dev)

    closures = find_loop_closures(
        descs, valids, xy_n, min_gap=min_gap,
        candidates_per_frame=closure_candidates,
        ransac_threshold=ransac_threshold, ratio=ratio, proj=proj,
        sampler=sampler, device=dev)
    closure_edges = _closure_pnp_edges(rec, closures, xy_n,
                                       ransac_threshold, sampler, dev)
    if closure_edges:
        cameras_pg = _pose_graph_correct(rec, closure_edges, device=dev)
    else:
        cameras_pg = rec.cameras.copy()

    tracks = [dict(tr) for tr in rec.tracks]
    kpt2track: List[Dict[int, int]] = [dict() for _ in xy_n]
    for t_id, tr in enumerate(tracks):
        for f, kidx in tr.items():
            kpt2track[f][kidx] = t_id
    for c in closures:
        for ki, kj in c.matches:
            t_i = kpt2track[c.i].get(int(ki))
            t_j = kpt2track[c.j].get(int(kj))
            if t_i is None or not rec.has_point[t_i]:
                continue
            if t_j is None and c.j not in tracks[t_i]:
                tracks[t_i][c.j] = int(kj)
                kpt2track[c.j][int(kj)] = t_i
    table = _ObsTable(tracks, xy_n, len(xy_n))
    cameras = cameras_pg.copy()
    points = rec.points.copy()
    has_point = rec.has_point.copy()
    anchor = int(np.where(rec.registered)[0][0])
    rmse = np.inf
    for _ in range(2):
        prob, live = _ba_tables(table, cameras, rec.registered, points,
                                has_point, anchor_frame=anchor, device=dev)
        out = bundle_adjust(prob, iters=24, loss="cauchy",
                            huber_delta=ransac_threshold)
        cameras[rec.registered] = out.cameras.cpu().numpy()[rec.registered]
        points[live] = out.points.cpu().numpy()[:len(live)]
        rmse = float(reproj_rmse(out))
        n_bad = _prune_table(table, cameras, rec.registered, points,
                             has_point, 4.0 * ransac_threshold)
        if n_bad == 0:
            break
    return BackEnd(rec=rec, closures=closures, cameras_pg=cameras_pg,
                   cameras_final=cameras, points_final=points,
                   has_point=has_point, registered=rec.registered,
                   reproj_rmse=rmse)


def camera_centers(cams: np.ndarray) -> np.ndarray:
    """(C, 6) [w|t] world->cam poses -> (C, 3) camera centers -R^T t,
    with R from the float32 so3_exp on the CPU (utils/metrics.py's)."""
    cams = np.asarray(cams)
    r = so3_exp(torch.as_tensor(cams[:, :3], dtype=torch.float32)).numpy()
    return -np.einsum("cji,cj->ci", r, cams[:, 3:])
