"""End-to-end mapping pipeline (twin of sift_tpu/sfm/mapping.py).

  image sequence
    -> detect + describe per frame (sift.detect_and_compute: K1, the K2
       compact scan and select, K3-ori, K3-desc)
    -> sequential pairwise matching (ops.match: K4)
    -> incremental SfM (sfm.incremental: tracks, essential init,
       PnP registration, windowed Schur/CG BA)
    -> loop-closure detection (sfm.loopclosure: signature retrieval
       + cascade matcher + essential verification)
    -> scale-resolved closure edges via PnP against the live map
    -> pose-graph correction (sfm.posegraph: odometry + closure edges)
    -> final global BA with the closure observations folded into the
       track graph, initialized from the corrected trajectory
    -> PLY / JSON export (sfm.export)

It runs on the card unless the caller passes device="cpu". The RANSAC
draws and the retrieval projection can be injected (`sampler=`,
`proj=`; sfm/incremental.py, sfm/loopclosure.py).

`render_corner_sequence` renders a known closed camera loop through
four textured planes of a concave box corner (one planar homography per
plane; real parallax between the planes; revisited viewpoints for the
loop-closure stage), with exact ground-truth poses. It warps each plane
by inverse mapping in NumPy (cv::warpPerspective's 1/32-pixel bilinear
weights for the texture, nearest for the coverage mask, zero outside),
so neither it nor the rest of the path needs OpenCV.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sift_tpu_torch.geometry.pnp import pnp_ransac
from sift_tpu_torch.sfm.ba import bundle_adjust, reproj_rmse
from sift_tpu_torch.sfm.incremental import (Reconstruction, Sampler,
                                            _ObsTable, _ba_tables, _pad2,
                                            draw, reconstruct,
                                            resolve_device, so3_exp_f32,
                                            so3_log_f32)
from sift_tpu_torch.sfm.loopclosure import LoopClosure, find_loop_closures
from sift_tpu_torch.sfm.posegraph import PoseGraph, optimize_pose_graph
from sift_tpu_torch.utils.caps import pow2_cap
from sift_tpu_torch.utils.metrics import ate_rmse, camera_centers
from sift_tpu_torch.utils.profiling import span


# ---------------------------------------------------------------------------
# sequence renderer
# ---------------------------------------------------------------------------

# (origin, u-axis, v-axis) of each textured plane, world units; the
# four planes form a concave box corner (back wall, floor, ceiling,
# left wall) so no plane ever occludes another from the camera region
_PLANES = [
    ((-3.0, -2.0, 6.0), (6.0, 0.0, 0.0), (0.0, 4.0, 0.0)),   # back
    ((-3.0, 2.0, 2.0), (6.0, 0.0, 0.0), (0.0, 0.0, 4.0)),    # floor
    ((-3.0, -2.0, 2.0), (6.0, 0.0, 0.0), (0.0, 0.0, 4.0)),   # ceiling
    ((-3.0, -2.0, 2.0), (0.0, 0.0, 4.0), (0.0, 4.0, 0.0)),   # left wall
]

_TEXTURES = ["scene.jpg", "bike.png", "airplane.jpg", "cat2.jpg"]

_INTER_TAB = 32          # cv::warpPerspective's sub-pixel steps


def _look_at(center: np.ndarray, target: np.ndarray) -> np.ndarray:
    """World->cam rotation with +z forward, +y down (pinhole rows)."""
    fwd = target - center
    fwd = fwd / np.linalg.norm(fwd)
    up = np.array([0.0, 1.0, 0.0])
    right = np.cross(up, fwd)
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    return np.stack([right, down, fwd])


def load_textures(data_dir: str) -> List[np.ndarray]:
    """The four plane textures, `_TEXTURES` under data_dir, as float32
    gray (cv::IMREAD_GRAYSCALE weights), the larger side shrunk to 640
    px with bilinear resampling; read through the port's io module."""
    from sift_tpu_torch import io as sio
    texs = []
    for name in _TEXTURES:
        img = sio.read_gray_u8(f"{data_dir}/{name}")
        s = 640.0 / max(img.shape)
        if s < 1.0:
            img = sio.resize_bilinear(img, int(img.shape[0] * s),
                                      int(img.shape[1] * s))
        texs.append(img.astype(np.float32))
    return texs


def _warp_plane(tex: np.ndarray, hom: np.ndarray, h: int, w: int):
    """cv::warpPerspective(tex, hom, (w, h)) by inverse mapping, with a
    zero border: (bilinear texture (h, w) float32, nearest-neighbour
    coverage mask (h, w) bool). Source coordinates are rounded to
    1/32 pixel and weighted as the INTER_LINEAR tables weight them."""
    th, tw = tex.shape
    minv = np.linalg.inv(hom)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    x0 = minv[0, 0] * xs + minv[0, 1] * ys + minv[0, 2]
    y0 = minv[1, 0] * xs + minv[1, 1] * ys + minv[1, 2]
    w0 = minv[2, 0] * xs + minv[2, 1] * ys + minv[2, 2]
    lim = np.iinfo(np.int32)
    # a pixel on the plane's horizon (w0 == 0) sees a point at infinity,
    # outside any texture
    finite = w0 != 0
    with np.errstate(divide="ignore", invalid="ignore"):
        inv_w = np.where(finite, 1.0 / w0, 0.0)

    def fixed(v, scale):
        return np.rint(np.clip(v * inv_w * scale, lim.min, lim.max)
                       ).astype(np.int64)

    nx, ny = fixed(x0, 1.0), fixed(y0, 1.0)
    mask = finite & (nx >= 0) & (nx < tw) & (ny >= 0) & (ny < th)
    fx_i, fy_i = fixed(x0, _INTER_TAB), fixed(y0, _INTER_TAB)
    ix, iy = fx_i >> 5, fy_i >> 5
    fx = (fx_i & (_INTER_TAB - 1)).astype(np.float32) / _INTER_TAB
    fy = (fy_i & (_INTER_TAB - 1)).astype(np.float32) / _INTER_TAB
    out = np.zeros((h, w), np.float32)
    for dy, wy in ((0, 1.0 - fy), (1, fy)):
        for dx, wx in ((0, 1.0 - fx), (1, fx)):
            sx, sy = ix + dx, iy + dy
            inside = finite & (sx >= 0) & (sx < tw) & (sy >= 0) & (sy < th)
            val = tex[np.clip(sy, 0, th - 1), np.clip(sx, 0, tw - 1)]
            out += np.where(inside, val, 0.0).astype(np.float32) * wx * wy
    return out, mask


def render_corner_sequence(data_dir: Optional[str] = None,
                           n_frames: int = 24,
                           size: Tuple[int, int] = (240, 320),
                           radius: float = 0.9,
                           seed: int = 0,
                           textures: Optional[Sequence[np.ndarray]] = None
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Render a closed camera loop through the textured corner.

    textures: the four (H, W) float32 gray images for the planes, in
    `_TEXTURES` order; None reads them from data_dir (load_textures),
    which is then required.
    Returns (frames (F, H, W) float32 0-255, K (3, 3),
    gt_cams (F, 6) [w|t] world->cam). The trajectory is a circle in
    the x/z plane (plus a small y bob) that returns to its start, so
    the last frames revisit the first frames' viewpoint.
    """
    h, w = size
    f = 0.9 * w
    k = np.array([[f, 0.0, w / 2.0], [0.0, f, h / 2.0], [0.0, 0.0, 1.0]])
    rng = np.random.default_rng(seed)
    if textures is None and data_dir is None:
        raise ValueError("render_corner_sequence needs textures= or "
                         "data_dir=")
    texs = (load_textures(data_dir) if textures is None
            else [np.asarray(t, np.float32) for t in textures])

    frames = np.zeros((n_frames, h, w), np.float32)
    cams = np.zeros((n_frames, 6), np.float64)
    for i in range(n_frames):
        th = 2.0 * np.pi * i / n_frames
        center = np.array([radius * np.sin(th),
                           0.25 * np.sin(2 * th),
                           0.35 * radius * (1.0 - np.cos(th))])
        target = np.array([0.6 * np.sin(th), 0.0, 6.0])
        r = _look_at(center, target)
        t = -r @ center
        cams[i, :3] = so3_log_f32(r)
        cams[i, 3:] = t
        canvas = np.zeros((h, w), np.float32)
        covered = np.zeros((h, w), bool)
        for (o, u, v), tex in zip(_PLANES, texs):
            th_, tw_ = tex.shape
            m = np.stack([r @ np.asarray(u), r @ np.asarray(v),
                          r @ np.asarray(o) + t], axis=1)
            hom = k @ m @ np.diag([1.0 / (tw_ - 1), 1.0 / (th_ - 1), 1.0])
            warped, mask = _warp_plane(tex, hom, h, w)
            put = mask & ~covered
            canvas[put] = warped[put]
            covered |= mask
        # mild sensor noise so repeated texture does not match exactly
        canvas += rng.normal(0.0, 1.0, canvas.shape)
        frames[i] = np.clip(canvas, 0.0, 255.0)
    return frames, k, cams


# ---------------------------------------------------------------------------
# pipeline
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MappingResult:
    """End-to-end mapping output (host-side NumPy)."""
    rec: Reconstruction            # sequential-odometry reconstruction
    closures: List[LoopClosure]
    cameras_pg: np.ndarray         # (F, 6) pose-graph-corrected
    cameras_final: np.ndarray      # (F, 6) after closure-aware global BA
    points_final: np.ndarray       # (T, 3)
    has_point: np.ndarray          # (T,) bool
    registered: np.ndarray         # (F,) bool
    reproj_rmse: float
    stats: Dict


def _detect_all(frames: np.ndarray, cfg, dev: torch.device):
    """Per frame: descriptors and valid mask (on dev) and (N, 2) pixel
    coordinates (NumPy)."""
    from sift_tpu_torch import sift
    descs, valids, xy = [], [], []
    for f in frames:
        kp, d = sift.detect_and_compute(
            torch.as_tensor(f, dtype=torch.float32, device=dev), cfg)
        descs.append(d)
        valids.append(kp.valid)
        xy.append(torch.stack([kp.x, kp.y], 1).cpu().numpy())
    return descs, valids, xy


def _sequential_matches(descs, valids, pair_window: int, ratio: float
                        ) -> Dict[Tuple[int, int], np.ndarray]:
    from sift_tpu_torch.ops.match import match_ratio
    out: Dict[Tuple[int, int], np.ndarray] = {}
    n = len(descs)
    for i in range(n):
        for j in range(i + 1, min(i + 1 + pair_window, n)):
            m = match_ratio(descs[i], descs[j], q_valid=valids[i],
                            t_valid=valids[j], ratio=ratio)
            good = m.good.cpu().numpy()
            qi = np.where(good)[0]
            if len(qi) >= 8:
                out[(i, j)] = np.stack(
                    [qi, m.train_idx.cpu().numpy()[qi].astype(np.int64)],
                    axis=1)
    return out


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


def run_mapping(frames: np.ndarray, k: np.ndarray,
                cfg=None,
                pair_window: int = 3,
                ratio: float = 0.86,
                min_gap: int = 6,
                closure_candidates: int = 2,
                ransac_threshold: float = 2e-3,
                ba_window: Optional[int] = 8,
                export_prefix: Optional[str] = None,
                sampler: Optional[Sampler] = None,
                proj=None,
                device=None) -> MappingResult:
    """Run the full pipeline on an (F, H, W) image sequence.

    `k` is the (3, 3) pinhole intrinsics matrix of the sequence. It
    runs on `device` (default CUDA), in four spans of utils.profiling:
    mapping.front_end (detect + sequential match), mapping.reconstruct,
    mapping.loop_closure (closures, their PnP edges, the pose graph) and
    mapping.final_ba (with the export). Each stage ends by reading its
    results on the host, so its span also holds its device work.
    """
    from sift_tpu_torch.config import DEFAULT_CONFIG
    cfg = cfg or DEFAULT_CONFIG
    dev = resolve_device(device)

    with span("mapping.front_end"):
        descs, valids, xy = _detect_all(frames, cfg, dev)
        fx, fy = k[0, 0], k[1, 1]
        cx, cy = k[0, 2], k[1, 2]
        xy_n = [np.stack([(p[:, 0] - cx) / fx, (p[:, 1] - cy) / fy], 1)
                .astype(np.float32) for p in xy]
        seq = _sequential_matches(descs, valids, pair_window, ratio)

    with span("mapping.reconstruct"):
        rec = reconstruct(xy_n, seq, ransac_threshold=ransac_threshold,
                          ba_window=ba_window, sampler=sampler, device=dev)

    with span("mapping.loop_closure"):
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

    with span("mapping.final_ba"):
        # final global BA: closure matches join the track graph as new
        # observations of existing tracks; cameras start from the
        # pose-graph-corrected trajectory
        tracks = [dict(tr) for tr in rec.tracks]
        kpt2track: List[Dict[int, int]] = [dict() for _ in xy_n]
        for t_id, tr in enumerate(tracks):
            for f, kidx in tr.items():
                kpt2track[f][kidx] = t_id
        n_closure_obs = 0
        for c in closures:
            for ki, kj in c.matches:
                t_i = kpt2track[c.i].get(int(ki))
                t_j = kpt2track[c.j].get(int(kj))
                if t_i is None or not rec.has_point[t_i]:
                    continue
                if t_j is None and c.j not in tracks[t_i]:
                    tracks[t_i][c.j] = int(kj)
                    kpt2track[c.j][int(kj)] = t_i
                    n_closure_obs += 1
        table = _ObsTable(tracks, xy_n, len(xy_n))
        cameras = cameras_pg.copy()
        points = rec.points.copy()
        has_point = rec.has_point.copy()
        anchor = int(np.where(rec.registered)[0][0])
        rmse = np.inf
        # BA -> prune wrong-correspondence observations (closure matches
        # are ratio-tested but unverified per-observation) -> BA again
        for _ in range(2):
            prob, live = _ba_tables(table, cameras, rec.registered, points,
                                    has_point, anchor_frame=anchor,
                                    device=dev)
            out = bundle_adjust(prob, iters=24, loss="cauchy",
                                huber_delta=ransac_threshold)
            cameras[rec.registered] = \
                out.cameras.cpu().numpy()[rec.registered]
            points[live] = out.points.cpu().numpy()[:len(live)]
            rmse = float(reproj_rmse(out))
            n_bad = _prune_table(table, cameras, rec.registered, points,
                                 has_point, 4.0 * ransac_threshold)
            if n_bad == 0:
                break

        result = MappingResult(
            rec=rec, closures=closures, cameras_pg=cameras_pg,
            cameras_final=cameras, points_final=points,
            has_point=has_point, registered=rec.registered,
            reproj_rmse=rmse,
            stats={
                "n_frames": len(frames),
                "n_registered": int(rec.registered.sum()),
                "n_points": int(has_point.sum()),
                "n_seq_pairs": len(seq),
                "n_closures": len(closures),
                "n_closure_edges": len(closure_edges),
                "n_closure_obs": n_closure_obs,
                "reproj_rmse": rmse,
            })
        if export_prefix is not None:
            from sift_tpu_torch.sfm.export import save_reconstruction
            final = Reconstruction(
                cameras=cameras, registered=rec.registered,
                points=points, has_point=has_point,
                tracks=tracks, reproj_rmse=rmse)
            result.stats["export"] = save_reconstruction(export_prefix,
                                                         final)
    return result


def _read_frames(frames_dir: str, max_side: int) -> List[np.ndarray]:
    """Gray float32 frames of a directory, sorted by name, the larger
    side shrunk to max_side (cv2 or PIL decodes, through the io
    module)."""
    import glob
    from sift_tpu_torch import io as sio
    paths = sorted(p for p in glob.glob(f"{frames_dir}/*")
                   if p.lower().endswith((".jpg", ".jpeg", ".png", ".bmp")))
    frames = []
    for p in paths:
        g = sio.read_gray_u8(p).astype(np.float32)
        s = max(g.shape) / max_side
        if s > 1.0:
            g = sio.resize_bilinear(g, int(g.shape[0] / s),
                                    int(g.shape[1] / s))
        frames.append(g)
    return frames


def main(argv=None) -> int:
    """CLI: map an image sequence (a directory of frames, sorted by
    name) and export the reconstruction.

    python -m sift_tpu_torch.sfm.mapping <frames_dir> --out map \\
        [--fov-deg 58] [--fx F --fy F --cx C --cy C] [--device cuda]

    Without explicit intrinsics, fx=fy is derived from --fov-deg and
    the principal point sits at the image center. The default device is
    CUDA, which must be present; --device cpu runs the plain versions.
    """
    import argparse
    import json
    import math

    ap = argparse.ArgumentParser(prog="sift_tpu_torch.sfm.mapping")
    ap.add_argument("frames_dir")
    ap.add_argument("--out", default="map",
                    help="export prefix (-> .ply / .json)")
    ap.add_argument("--fov-deg", type=float, default=58.0)
    ap.add_argument("--fx", type=float)
    ap.add_argument("--fy", type=float)
    ap.add_argument("--cx", type=float)
    ap.add_argument("--cy", type=float)
    ap.add_argument("--max-side", type=int, default=640)
    ap.add_argument("--pair-window", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("CUDA is not available; pass --device cpu for a CPU run")

    frames = _read_frames(args.frames_dir, args.max_side)
    if len(frames) < 3:
        print(f"need >= 3 frames, found {len(frames)}", flush=True)
        return 2
    hw = frames[0].shape
    if any(f.shape != hw for f in frames):
        print("all frames must share one resolution", flush=True)
        return 2
    h, w = hw
    fx = args.fx or w / (2.0 * math.tan(math.radians(args.fov_deg) / 2))
    k = np.array([[fx, 0.0, args.cx if args.cx else w / 2.0],
                  [0.0, args.fy or fx, args.cy if args.cy else h / 2.0],
                  [0.0, 0.0, 1.0]])
    res = run_mapping(np.stack(frames), k, pair_window=args.pair_window,
                      export_prefix=args.out, device=device)
    print(json.dumps(res.stats))
    return 0


def mapping_ate(result: MappingResult, gt_cams: np.ndarray
                ) -> Dict[str, float]:
    """ATE (sim3-aligned RMSE of camera centers) of each pipeline
    stage against ground truth, over registered frames."""
    reg = result.registered
    gt = camera_centers(gt_cams[reg])
    return {
        "ate_odometry": ate_rmse(
            camera_centers(result.rec.cameras[reg]), gt),
        "ate_posegraph": ate_rmse(
            camera_centers(result.cameras_pg[reg]), gt),
        "ate_final": ate_rmse(
            camera_centers(result.cameras_final[reg]), gt),
    }


if __name__ == "__main__":
    import sys
    sys.exit(main())
