"""Reconstruction export: PLY point clouds + JSON camera trajectories
(twin of sift_tpu/sfm/export.py, NumPy as there).

The reference visualizes with imshow and persists nothing
(SURVEY.md §5); downstream users of an SfM engine need the map in
standard formats — ASCII PLY opens in MeshLab/CloudCompare/Open3D,
the JSON carries [w|t] world->cam poses plus derived camera centers.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np

from sift_tpu_torch.sfm.incremental import Reconstruction


def save_ply(path: str, points: np.ndarray,
             colors: Optional[np.ndarray] = None) -> str:
    """Write an ASCII PLY point cloud; colors are (N, 3) uint8."""
    pts = np.asarray(points, np.float64)
    n = len(pts)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        f.write("end_header\n")
        # vectorized body: per-row Python writes cost seconds at
        # map-scale point counts
        if colors is None:
            np.savetxt(f, pts, fmt="%.6f %.6f %.6f")
        else:
            body = np.concatenate(
                [pts, np.asarray(colors, np.float64)], axis=1)
            np.savetxt(f, body, fmt="%.6f %.6f %.6f %d %d %d")
    return path


def save_reconstruction(path_prefix: str, rec: Reconstruction) -> dict:
    """Write <prefix>.ply (live points) and <prefix>.json (cameras).

    Returns {"ply": ..., "json": ...} with the written paths.
    """
    from sift_tpu_torch.utils.metrics import camera_centers

    ply = save_ply(path_prefix + ".ply", rec.points[rec.has_point])
    # exportable = registered AND finite (the same guard the SfM
    # host loop applies; a NaN camera would make the JSON unparseable
    # for strict RFC 8259 consumers)
    exportable = rec.registered & np.isfinite(rec.cameras).all(axis=1)
    reg = np.where(exportable)[0]
    centers = (camera_centers(rec.cameras[exportable])
               if len(reg) else np.zeros((0, 3)))
    payload = {
        "n_points": int(rec.has_point.sum()),
        "reproj_rmse": (float(rec.reproj_rmse)
                        if np.isfinite(rec.reproj_rmse) else None),
        "cameras": [
            {"frame": int(f),
             "wt": [float(x) for x in rec.cameras[f]],
             "center": [float(x) for x in centers[k]]}
            for k, f in enumerate(reg)],
        "unregistered": [int(f) for f in np.where(~exportable)[0]],
    }
    jpath = path_prefix + ".json"
    with open(jpath, "w") as f:
        json.dump(payload, f, indent=1)
    return {"ply": ply, "json": jpath}
