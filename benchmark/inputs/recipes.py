"""Seeded synthetic inputs of the benchmark's cells.

`texture`, `to_gray`, `warp_into` and `project` are frozen copies, made
at commit e1604af, of chip_smoke.py's input recipes (the recipe of
tests/conftest.py:small_image); `object_homography` generalises
chip_smoke.object_homography (10 degrees, scale 0.8, centred right of
the middle) to a pose drawn from a generator. Everything here is NumPy
on the host and depends on nothing but its arguments, so one seed gives
one set of inputs.
"""

from __future__ import annotations

import math

import numpy as np

# an object's pose in the scene: rotation (degrees), scale, and where
# its centre lies as a share of the scene's width and height
ANGLE_DEG = (-20.0, 20.0)
SCALE = (0.7, 0.9)
CENTRE_X = (0.35, 0.65)
CENTRE_Y = (0.4, 0.6)
PERSPECTIVE = (1.5e-4, -1e-4)


def texture(h: int, w: int, seed: int, n_blobs: int, amp=(50.0, 120.0),
            block: int = 8, block_amp: float = 60.0) -> np.ndarray:
    """Synthetic gray image (float64, unclipped): a smooth field, Gaussian
    blobs of both polarities and scales, blocky texture and noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = 110.0 + 35.0 * np.sin(xx / 13.0) * np.cos(yy / 17.0)
    for k in range(n_blobs):
        cy, cx = rng.uniform(10, h - 10), rng.uniform(10, w - 10)
        s = rng.uniform(1.2, 7.0)
        a = rng.uniform(*amp) * (1 if k % 2 == 0 else -1)
        r = int(4 * s) + 1
        y0, y1 = max(int(cy) - r, 0), min(int(cy) + r + 1, h)
        x0, x1 = max(int(cx) - r, 0), min(int(cx) + r + 1, w)
        img[y0:y1, x0:x1] += a * np.exp(
            -((yy[y0:y1, x0:x1] - cy) ** 2 + (xx[y0:y1, x0:x1] - cx) ** 2)
            / (2 * s * s))
    blocks = rng.uniform(-block_amp, block_amp,
                         (-(-h // block), -(-w // block)))
    img += np.kron(blocks, np.ones((block, block)))[:h, :w]
    img += rng.normal(0, 3.0, (h, w))
    return img


def to_gray(img: np.ndarray) -> np.ndarray:
    """8-bit gray as the reference ingests it, as float32 0..255."""
    return np.clip(np.rint(img), 0, 255).astype(np.float32)


def project(pts: np.ndarray, h: np.ndarray) -> np.ndarray:
    p = np.concatenate([pts, np.ones((len(pts), 1))], 1) @ h.T
    return p[:, :2] / p[:, 2:3]


def warp_into(scene: np.ndarray, obj: np.ndarray, h: np.ndarray) -> None:
    """Paste obj into scene through h (object -> scene), bilinear, in
    place, over the object's footprint."""
    oh, ow = obj.shape
    corners = project(np.array([[0, 0], [ow, 0], [ow, oh], [0, oh]],
                               np.float64), h)
    x0, y0 = np.floor(corners.min(0)).astype(int)
    x1, y1 = np.ceil(corners.max(0)).astype(int)
    yy, xx = np.mgrid[y0:y1 + 1, x0:x1 + 1].astype(np.float64)
    src = project(np.stack([xx.ravel(), yy.ravel()], 1), np.linalg.inv(h))
    sx, sy = src[:, 0], src[:, 1]
    inside = (sx >= 0) & (sx <= ow - 1) & (sy >= 0) & (sy <= oh - 1)
    sx, sy = sx[inside], sy[inside]
    ix, iy = np.minimum(sx.astype(int), ow - 2), np.minimum(sy.astype(int),
                                                            oh - 2)
    fx, fy = sx - ix, sy - iy
    val = (obj[iy, ix] * (1 - fx) * (1 - fy) + obj[iy, ix + 1] * fx * (1 - fy)
           + obj[iy + 1, ix] * (1 - fx) * fy + obj[iy + 1, ix + 1] * fx * fy)
    scene[yy.ravel()[inside].astype(int), xx.ravel()[inside].astype(int)] = val


def object_homography(obj_hw, scene_hw, rng: np.random.Generator
                      ) -> np.ndarray:
    """Object -> scene: a rotation, a scale, the recipe's mild
    perspective and a centre, drawn from rng within the ranges above."""
    oh, ow = obj_hw
    sh, sw = scene_hw
    a = math.radians(rng.uniform(*ANGLE_DEG))
    s = rng.uniform(*SCALE)
    cx, cy = rng.uniform(*CENTRE_X) * sw, rng.uniform(*CENTRE_Y) * sh
    t0 = np.array([[1, 0, -ow / 2], [0, 1, -oh / 2], [0, 0, 1]], np.float64)
    rs = s * np.array([[math.cos(a), -math.sin(a), 0],
                       [math.sin(a), math.cos(a), 0], [0, 0, 1 / s]])
    persp = np.array([[1, 0, 0], [0, 1, 0], [*PERSPECTIVE, 1]], np.float64)
    t1 = np.array([[1, 0, cx], [0, 1, cy], [0, 0, 1]], np.float64)
    h = t1 @ persp @ rs @ t0
    return h / h[2, 2]


def object_scene(scene_hw, obj_hw, seed: int):
    """(scene, object, H object -> scene, true corners (4, 2)): the
    object recipe of chip_smoke.full_size_inputs, pasted into the scene
    recipe, with textures and pose drawn from `seed`."""
    rng = np.random.default_rng(seed)
    s_obj, s_scene = (int(v) for v in rng.integers(0, 2 ** 31, 2))
    obj = to_gray(texture(*obj_hw, seed=s_obj, n_blobs=400, block_amp=40.0))
    sh, sw = scene_hw
    scene = texture(sh, sw, seed=s_scene,
                    n_blobs=int(800 * sh * sw / (1080 * 1920)),
                    amp=(30.0, 90.0), block=24, block_amp=20.0)
    h = object_homography(obj_hw, scene_hw, rng)
    warp_into(scene, obj.astype(np.float64), h)
    oh, ow = obj_hw
    true = project(np.array([[0, 0], [ow, 0], [ow, oh], [0, oh]],
                            np.float64), h)
    return to_gray(scene), obj, h, true


def pan_frames(frame_hw, obj_hw, n_frames: int, step: int, seed: int
               ) -> np.ndarray:
    """(n_frames, H, W) float32: a pan across one wide seeded scene
    (object_scene's recipe at the width the pan needs), frame i the
    crop that starts `step` * i columns in."""
    h, w = frame_hw
    wide, _, _, _ = object_scene((h, w + step * (n_frames - 1)), obj_hw,
                                 seed)
    return np.stack([wide[:, i * step:i * step + w]
                     for i in range(n_frames)])
