"""The two-view initialization of sfm.incremental.reconstruct keeps a pair
only where its map explains the views that see most of it.

A near-planar pair fits two essential matrices alike, and RANSAC may
return the wrong one; its points then put the views a few frames away
off most of their correspondences, and the whole odometry drifts. The
check runs PnP of the views that see most of the pair's points. Here
the first checked view's PnP is made to keep a fifth of its
correspondences: reconstruct rolls the first pair back and starts from
another; made so for every pair, it keeps the first (the behaviour
before the check); left alone, a pair that every checked view fits is
kept, and one whose farthest views fit less than half is passed over
with the sequence still mapped. A rendered loop whose first pair was
such a pair now maps within the gate. A witness that shares none of
the check's code, the true trajectory of a planar scene aligned by a
NumPy similarity fit, holds it on more than the rendered loop: without
the check, half of such scenes' seeds map 25-75x off the sound
trajectories; with it, each maps as a scene with depth does. No JAX
here: tests/test_torch_sfm.py and test_torch_mapping.py hold
reconstruct and run_mapping to sift_tpu's on sequences whose first pair
passes.
"""

import pathlib

import numpy as np
import pytest
import torch

from sift_tpu_torch.geometry.lie import so3_exp
from sift_tpu_torch.sfm import incremental as inc
from sift_tpu_torch.utils.metrics import ate_rmse, camera_centers


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    # reconstruct's many small ops run several times faster on one
    # thread than on threads that contend with other test processes
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _so3(w):
    return so3_exp(torch.as_tensor(w, dtype=torch.float64)).numpy()


def _sequence(seed=0, n_frames=7, n_pts=250, noise=4e-4, drop=0.25):
    """Cameras along an arc in front of a point cloud; keypoints the
    visible points' projections with noise; matches from ground truth
    between frames up to 2 apart."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-2, 2, n_pts), rng.uniform(-1.5, 1.5, n_pts),
                    rng.uniform(5, 11, n_pts)], 1)
    cams = np.zeros((n_frames, 6))
    for i in range(n_frames):
        w = np.array([0.02 * i, 0.1 * (i - n_frames / 2), 0.0])
        center = np.array([1.6 * i / n_frames - 0.8, 0.05 * np.sin(i),
                           0.05 * i])
        cams[i, :3] = w
        cams[i, 3:] = -_so3(w) @ center
    kp_xy, kp_of_pt = [], []
    for f in range(n_frames):
        xc = pts @ _so3(cams[f, :3]).T + cams[f, 3:]
        proj = xc[:, :2] / xc[:, 2:3]
        idx = np.where(rng.random(n_pts) > drop)[0]
        kp_xy.append((proj[idx] + rng.normal(0, noise, (len(idx), 2))
                      ).astype(np.float32))
        kp_of_pt.append({int(p): k for k, p in enumerate(idx)})
    matches = {}
    for i in range(n_frames):
        for j in range(i + 1, min(i + 3, n_frames)):
            pairs = [(kp_of_pt[i][p], kp_of_pt[j][p])
                     for p in kp_of_pt[i] if p in kp_of_pt[j]]
            matches[(i, j)] = np.array(pairs, np.int64)
    return cams, kp_xy, matches


def _counting(monkeypatch, n_bad):
    """find_essential_ransac counted, and pnp_ransac whose first n_bad
    calls keep a fifth of their correspondences as inliers (the next
    view of a map built on the wrong one of two essential matrices)."""
    calls = {"essential": 0, "pnp": 0}
    ess, pnp = inc.find_essential_ransac, inc.pnp_ransac

    def counted(*a, **k):
        calls["essential"] += 1
        return ess(*a, **k)

    def missing(*a, **k):
        res = pnp(*a, **k)
        calls["pnp"] += 1
        if calls["pnp"] <= n_bad:
            n = int(k["valid"].sum()) // 5
            res = res._replace(n_inliers=torch.tensor(n, dtype=torch.int32))
        return res

    monkeypatch.setattr(inc, "find_essential_ransac", counted)
    monkeypatch.setattr(inc, "pnp_ransac", missing)
    return calls


def _ate(rec, cams):
    reg = rec.registered
    return ate_rmse(camera_centers(rec.cameras[reg]),
                    camera_centers(cams[reg]))


def test_a_pair_whose_map_misses_the_next_view_is_rolled_back(monkeypatch):
    cams, kp_xy, matches = _sequence()
    calls = _counting(monkeypatch, 1)
    got = inc.reconstruct(kp_xy, matches, device="cpu")
    assert calls["essential"] >= 2          # another pair was tried
    assert got.registered.all()
    assert _ate(got, cams) < 0.05


def test_the_first_pair_is_kept_when_none_explains_the_next_view(
        monkeypatch):
    cams, kp_xy, matches = _sequence()
    want = inc.reconstruct(kp_xy, matches, device="cpu")
    calls = _counting(monkeypatch, len(matches))
    got = inc.reconstruct(kp_xy, matches, device="cpu")
    # every candidate tried, then the first pair initialized again
    assert calls["essential"] == len(matches) + 1
    assert np.array_equal(got.registered, want.registered)


def test_a_pair_that_explains_the_views_is_kept(monkeypatch):
    """An unaltered first pair whose map every checked view fits passes
    the check: one essential RANSAC, and the map of the first pair by
    match count."""
    cams, kp_xy, matches = _sequence(0)
    calls = _counting(monkeypatch, 0)
    got = inc.reconstruct(kp_xy, matches, device="cpu")
    assert calls["essential"] == 1
    assert got.registered.all() and _ate(got, cams) < 0.05


def test_a_short_baseline_pair_passed_over_still_maps(monkeypatch):
    """Sequence 1's first pair keeps 38 of 100 correspondences of its
    farthest checked view (a short baseline's depth, not a wrong
    essential matrix): it is passed over for the next pair, and the
    sequence still maps."""
    cams, kp_xy, matches = _sequence(1)
    calls = _counting(monkeypatch, 0)
    got = inc.reconstruct(kp_xy, matches, device="cpu")
    assert calls["essential"] >= 2
    assert got.registered.all() and _ate(got, cams) < 0.05


def test_a_near_planar_first_pair_no_longer_breaks_the_loop(monkeypatch):
    """chip_smoke's mapping textures, 16 frames of 240x320 and the
    noise of seed 152428184 (the front end saved in
    golden/near_planar_front_end.npz: each frame's normalized keypoint
    coordinates and the matches of frames up to 3 apart): the first pair
    by match count (frames 6 and 7) gave the wrong one of its two
    essential matrices, whose map kept 8 of 104 correspondences of the
    next view, and the odometry ended 0.545 off the truth (ATE). Now
    that pair is rolled back and the odometry maps the loop within the
    gate; with the check off, the fault is back."""
    from sift_tpu_torch.eval import GATES
    saved = np.load(pathlib.Path(__file__).parent / "golden"
                    / "near_planar_front_end.npz")
    gt = saved["gt"]
    xy_n = [saved[f"xy_{i}"] for i in range(int(saved["n_frames"]))]
    seq = {tuple(int(v) for v in k.split("_")[1:]): saved[k].astype(np.int64)
           for k in saved.files if k.startswith("m_")}
    rec = inc.reconstruct(xy_n, seq, device="cpu")
    assert rec.registered.all()
    assert _ate(rec, gt) <= GATES["mapping_max_ate"]
    monkeypatch.setattr(inc, "INIT_CHECK_VIEWS", 0)
    unchecked = inc.reconstruct(xy_n, seq, device="cpu")
    assert _ate(unchecked, gt) > 5 * GATES["mapping_max_ate"]


def _rodrigues(w):
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.eye(3)
    k = w / th
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * kx + (1 - np.cos(th)) * kx @ kx


def _wall_sequence(seed, n_frames=8, n_pts=200, noise=5e-4, drop=0.25):
    """A tilted textured wall at depth ~8 seen from an arc of cameras
    that look at its centre: every point on one plane, so a pair fits
    two essential matrices alike. Keypoints the visible points'
    projections with noise; matches from ground truth between frames up
    to 3 apart. Returns (the true camera centres, keypoints, matches)."""
    rng = np.random.default_rng(seed)
    u, v = rng.uniform(-3, 3, n_pts), rng.uniform(-2, 2, n_pts)
    pts = np.stack([u, v, 8 + 0.3 * u + 0.1 * v], 1)
    look = np.array([0.0, 0.0, 8.0])
    rots, centers = [], []
    for i in range(n_frames):
        a = 0.7 * np.pi * i / n_frames - 0.35
        c = (np.array([6 * np.sin(a), 0.3 * np.sin(3 * a),
                       8 - 6 * np.cos(a)]) + rng.normal(0, 0.02, 3))
        z = (look - c) / np.linalg.norm(look - c)
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        rots.append(np.stack([x, np.cross(z, x), z]))
        centers.append(c)
    kp_xy, kp_of_pt = [], []
    for f in range(n_frames):
        xc = (pts - centers[f]) @ rots[f].T
        proj = xc[:, :2] / xc[:, 2:3]
        seen = ((xc[:, 2] > 0.5) & (np.abs(proj) < 0.6).all(1)
                & (rng.random(n_pts) > drop))
        idx = np.where(seen)[0]
        kp_xy.append((proj[idx] + rng.normal(0, noise, (len(idx), 2))
                      ).astype(np.float32))
        kp_of_pt.append({int(p): k for k, p in enumerate(idx)})
    matches = {}
    for i in range(n_frames):
        for j in range(i + 1, min(i + 4, n_frames)):
            pairs = [(kp_of_pt[i][p], kp_of_pt[j][p])
                     for p in kp_of_pt[i] if p in kp_of_pt[j]]
            matches[(i, j)] = np.array(pairs, np.int64)
    return np.array(centers), kp_xy, matches


def _witness_ate(rec, true_centers):
    """RMS distance of the registered cameras' centres from the truth
    after a least-squares similarity fit (Umeyama), over the true
    trajectory's extent; NumPy alone."""
    reg = rec.registered
    est = np.array([-_rodrigues(c[:3]).T @ c[3:]
                    for c in rec.cameras[reg].astype(np.float64)])
    gt = true_centers[reg]
    e, g = est - est.mean(0), gt - gt.mean(0)
    u, d, vt = np.linalg.svd(g.T @ e / len(e))
    sign = np.eye(3)
    sign[2, 2] = np.sign(np.linalg.det(u @ vt))
    r = u @ sign @ vt
    scale = np.trace(np.diag(d) @ sign) / (e ** 2).sum(1).mean()
    fit = scale * e @ r.T
    return (np.sqrt(((fit - g) ** 2).sum(1).mean())
            / np.ptp(true_centers, 0).max())


# seeds of _wall_sequence that mapped 0.72 % and 1.53 % of the extent off
# without the check, where sound maps read 0.02-0.06 %
@pytest.mark.parametrize("seed", [1, 9])
def test_a_planar_scene_maps_as_its_truth(monkeypatch, seed):
    centers, kp_xy, matches = _wall_sequence(seed)
    rec = inc.reconstruct(kp_xy, matches, device="cpu")
    assert rec.registered.all() and _witness_ate(rec, centers) < 1e-3
    monkeypatch.setattr(inc, "INIT_CHECK_VIEWS", 0)
    unchecked = inc.reconstruct(kp_xy, matches, device="cpu")
    assert _witness_ate(unchecked, centers) > 5e-3
