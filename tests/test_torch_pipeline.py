"""The whole slice, port against sift_tpu: detect -> describe -> match
-> RANSAC -> corners on a synthetic scene and a crop of it, plus the
port's CLI.

The JAX side runs once per module with a reduced configuration: exact
f32 descriptors, dynamic_slice gathers (identical values to the Pallas
gather, tests/test_ori_gather.py, test_descr_gather.py) and smaller
caps, which keep its CPU compile to about half a minute.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from sift_tpu.config import SIFTConfig as JaxConfig
from sift_tpu.ops import match as jmatch
from sift_tpu.pipeline import detect_object as jax_detect_object

from sift_tpu_torch.config import DEFAULT_CONFIG, from_jax_config
from sift_tpu_torch.ops import match as tmatch
from sift_tpu_torch.pipeline import detect_object

JCFG = JaxConfig(descr_rc_bf16=False, ori_gather_impl="dynamic_slice",
                 descr_gather_impl="dynamic_slice",
                 detect_caps=(512, 256, 128, 64, 32),
                 out_caps=(256, 128, 64, 64, 64))
TCFG = from_jax_config(dataclasses.asdict(JCFG))
CROP = (40, 60)      # object = scene[40:200, 60:260]


def _scene(h=240, w=320, seed=42):
    """Blobs of both polarities on a smooth field, blocky texture and
    noise (the recipe of tests/conftest.py:small_image, larger)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = 110.0 + 35.0 * np.sin(xx / 13.0) * np.cos(yy / 17.0)
    for k in range(150):
        cy, cx = rng.uniform(10, h - 10), rng.uniform(10, w - 10)
        s = rng.uniform(1.2, 7.0)
        a = rng.uniform(50, 120) * (1 if k % 2 == 0 else -1)
        img += a * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
    blocks = rng.uniform(-60, 60, (h // 8, w // 8))
    img += ndimage.zoom(blocks, 8, order=0)[:h, :w]
    img += rng.normal(0, 3.0, (h, w))
    return np.clip(np.rint(img), 0, 255).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    scene = _scene()
    r0, c0 = CROP
    return scene, scene[r0:r0 + 160, c0:c0 + 200].copy()


@pytest.fixture(scope="module")
def results(pair):
    scene, obj = pair
    jd = jax_detect_object(jnp.asarray(scene), jnp.asarray(obj), JCFG)
    td = detect_object(torch.from_numpy(scene), torch.from_numpy(obj), TCFG)
    return jd, td


def _kps(kp):
    a = {f: np.asarray(getattr(kp, f)) for f in
         ("octave", "layer", "r", "c", "x", "y", "angle", "valid")}
    return {f: v[a["valid"]] for f, v in a.items()}


@pytest.mark.parametrize("which", ["scene_kp", "object_kp"])
def test_keypoint_sets_agree(results, which):
    # >= 99% of JAX's keypoints have a port keypoint at the same
    # (octave, layer, r, c) with x/y within 1e-3 px; counts within 1%
    jk, tk = (_kps(getattr(d, which)) for d in results)
    n_j, n_t = len(jk["x"]), len(tk["x"])
    assert n_j > 20
    assert abs(n_t - n_j) <= 0.01 * n_j
    port = {}
    for i in range(n_t):
        key = (tk["octave"][i], tk["layer"][i], tk["r"][i], tk["c"][i])
        port.setdefault(key, []).append((tk["x"][i], tk["y"][i]))
    hit = 0
    for i in range(n_j):
        key = (jk["octave"][i], jk["layer"][i], jk["r"][i], jk["c"][i])
        hit += any(abs(x - jk["x"][i]) < 1e-3 and abs(y - jk["y"][i]) < 1e-3
                   for x, y in port.get(key, ()))
    assert hit >= 0.99 * n_j


def _good_rows(det, d2):
    """Good matches as (query identity, train identity, borderline):
    an identity is (octave, layer, r, c, angle) of a keypoint, and a
    row is borderline when |d1 - 0.86 d2| < 1e-4."""
    good = np.asarray(det.matches.good)
    tidx = np.asarray(det.matches.train_idx)
    d1 = np.asarray(det.matches.distance)
    border = np.abs(d1 - 0.86 * np.asarray(d2)) < 1e-4
    q = {f: np.asarray(getattr(det.object_kp, f))
         for f in ("octave", "layer", "r", "c", "angle")}
    t = {f: np.asarray(getattr(det.scene_kp, f))
         for f in ("octave", "layer", "r", "c", "angle")}

    def ident(kp, i):
        return tuple(int(kp[f][i]) for f in ("octave", "layer", "r", "c")
                     ) + (float(kp["angle"][i]),)

    return [(ident(q, i), ident(t, tidx[i]), bool(border[i]))
            for i in np.where(good)[0]]


def _same(a, b):
    """One keypoint identity: equal integers, angle within 1e-2 deg."""
    da = abs(a[4] - b[4]) % 360.0
    return a[:4] == b[:4] and min(da, 360.0 - da) < 1e-2


def test_good_matches_agree(results):
    # the good-match sets are equal, except rows whose d1 lies within
    # 1e-4 of 0.86 * d2, which float rounding may decide either way
    jd, td = results
    jrows = _good_rows(jd, jmatch.knn2_l1(jd.object_desc, jd.scene_desc,
                                          jd.scene_kp.valid, impl="xla").d2)
    trows = _good_rows(td, tmatch.knn2_l1(td.object_desc, td.scene_desc,
                                          td.scene_kp.valid).d2)
    assert len(jrows) > 15
    for mine, other in ((jrows, trows), (trows, jrows)):
        for q, t, border in mine:
            found = any(_same(q, q2) and _same(t, t2) for q2, t2, _ in other)
            assert found or border, (q, t)


def test_homography_and_corners_agree(results):
    # corners within 0.05 px: both sides fit the same inlier set
    jd, td = results
    assert bool(td.found) == bool(jd.found) is True
    np.testing.assert_allclose(td.corners.numpy(), np.asarray(jd.corners),
                               atol=0.05)
    r0, c0 = CROP
    true = np.array([[c0, r0], [c0 + 200, r0], [c0 + 200, r0 + 160],
                     [c0, r0 + 160]], np.float32)
    assert np.abs(td.corners.numpy() - true).max() < 0.5


def test_cli_prints_the_demo_lines(pair, tmp_path, capsys):
    cv2 = pytest.importorskip("cv2")
    from sift_tpu_torch import cli
    scene, obj = pair
    sp, op = str(tmp_path / "scene.png"), str(tmp_path / "object.png")
    cv2.imwrite(sp, scene.astype(np.uint8))
    cv2.imwrite(op, obj.astype(np.uint8))
    assert cli.main([sp, op, "--device", "cpu", "--no-resize"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    det = detect_object(torch.from_numpy(scene), torch.from_numpy(obj),
                        DEFAULT_CONFIG)
    assert lines[:5] == [
        f"scene keypoints:  {int(det.scene_kp.count())}",
        f"object keypoints: {int(det.object_kp.count())}",
        f"good matches:     {int(det.matches.good.sum())}",
        f"RANSAC inliers:   {int(det.n_inliers)}",
        "object found:     True"]
    c = det.corners.numpy()
    assert lines[5] == "corners in scene: " + ", ".join(
        f"({x:.1f},{y:.1f})" for x, y in c)
