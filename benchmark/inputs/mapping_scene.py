"""The mapping cell's scene: a closed camera loop through the four
textured planes of a concave box corner, with exact ground-truth poses.

`render_corner_sequence` and its helpers are frozen copies, made at
commit e6556db, of sift_tpu_torch/sfm/mapping.py's renderer (a plane's
texture warped by inverse mapping in NumPy, cv::warpPerspective's
1/32-pixel bilinear weights, nearest coverage; mild seeded sensor
noise), taking the textures as an argument; the ground-truth rotations
go through the frozen float32 so3_log (reference/geometry_plain.py).
`mapping_textures` is chip_smoke.py's mapping_textures: four 480x640
textures of recipes.texture from seeds 100-103. Nothing here imports
the program.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from benchmark.inputs.recipes import texture, to_gray
from benchmark.reference.geometry_plain import so3_log

TEXTURE_HW = (480, 640)
TEXTURE_SEEDS = (100, 101, 102, 103)


def mapping_textures(hw: Tuple[int, int] = TEXTURE_HW) -> List[np.ndarray]:
    """The four plane textures: gray recipes.texture images of 300 blobs
    from seeds 100-103 (chip_smoke.mapping_textures)."""
    return [to_gray(texture(*hw, seed=s, n_blobs=300))
            for s in TEXTURE_SEEDS]


# (origin, u-axis, v-axis) of each textured plane, world units; the
# four planes form a concave box corner (back wall, floor, ceiling,
# left wall) so no plane ever occludes another from the camera region
_PLANES = [
    ((-3.0, -2.0, 6.0), (6.0, 0.0, 0.0), (0.0, 4.0, 0.0)),   # back
    ((-3.0, 2.0, 2.0), (6.0, 0.0, 0.0), (0.0, 0.0, 4.0)),    # floor
    ((-3.0, -2.0, 2.0), (6.0, 0.0, 0.0), (0.0, 0.0, 4.0)),   # ceiling
    ((-3.0, -2.0, 2.0), (0.0, 0.0, 4.0), (0.0, 4.0, 0.0)),   # left wall
]


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


def render_corner_sequence(textures: Sequence[np.ndarray],
                           n_frames: int = 24,
                           size: Tuple[int, int] = (240, 320),
                           radius: float = 0.9,
                           seed: int = 0
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Render a closed camera loop through the textured corner.

    textures: the four (H, W) float32 gray images for the planes (back
    wall, floor, ceiling, left wall).
    Returns (frames (F, H, W) float32 0-255, K (3, 3),
    gt_cams (F, 6) [w|t] world->cam). The trajectory is a circle in
    the x/z plane (plus a small y bob) that returns to its start, so
    the last frames revisit the first frames' viewpoint.
    """
    h, w = size
    f = 0.9 * w
    k = np.array([[f, 0.0, w / 2.0], [0.0, f, h / 2.0], [0.0, 0.0, 1.0]])
    rng = np.random.default_rng(seed)
    texs = [np.asarray(t, np.float32) for t in textures]

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
        cams[i, :3] = so3_log(
            torch.as_tensor(r, dtype=torch.float32)).numpy()
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
