"""The benchmark's plain reference (reference/sift_plain.py,
homography_plain.py), a frozen copy of the port's plain path, held to
witnesses that share none of its code: the frozen NumPy twin of the
reference CPU SIFT (reference/oracle_numpy.py), a NumPy brute-force
ratio test, and the object's true corners. A fault that was already in
the port's facade, matcher or RANSAC when they were frozen shows here,
not in a run, since a run holds the port to the copy.

The gates are those of the port's own oracle tests
(tests/test_torch_oracle.py): descriptor L1 median 0.05 and 90th
percentile 0.2, and keypoint recall and precision 0.99 where those ask
0.97 (the frozen copy reads 1.0 on both seeds). The caps are raised so
that no octave saturates, as the twin keeps every keypoint."""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark.inputs import recipes
from benchmark.reference import homography_plain, oracle_numpy, sift_plain
from benchmark.traffic.object import detect_object_plain

SEEDS = (2 ** 33 + 5, 2 ** 31 + 9)
CFG = dataclasses.replace(sift_plain.RefConfig(),
                          detect_caps=(8192, 4096, 2048, 1024, 512),
                          out_caps=(4096, 2048, 1024, 512, 256))


@pytest.fixture(scope="module", params=SEEDS)
def both(request):
    """(twin keypoints, twin descriptors, reference Kp fields, reference
    descriptors) of the first of two seeded frames of a pan, and the
    reference's (B = 2) keypoints and descriptors of both."""
    imgs = recipes.pan_frames((480, 640), (160, 200), 2, 17, request.param)
    kpts, desc = oracle_numpy.sift_ncl(imgs[0], CFG)
    kp, d = sift_plain.detect_and_compute(torch.from_numpy(imgs), CFG)
    kp0 = {f: getattr(kp, f)[0].numpy() for f in kp._fields}
    return kpts, desc, kp0, d[0].numpy(), (kp, d)


def _hits(kpts, kp, pos_tol=0.1, size_rtol=0.01, ang_tol=1.0):
    """For each twin keypoint, a valid reference keypoint that agrees in
    position, size and angle, or -1."""
    hits = []
    for k in kpts:
        d = np.abs(kp["x"] - k["x"]) + np.abs(kp["y"] - k["y"])
        best = -1
        for i in np.where(kp["valid"] & (d < pos_tol))[0]:
            da = abs(kp["angle"][i] - k["angle"])
            if (abs(kp["size"][i] - k["size"]) <= size_rtol * k["size"]
                    and min(da, 360 - da) <= ang_tol):
                best = int(i)
                break
        hits.append(best)
    return np.array(hits)


def test_no_octave_saturates(both):
    _, _, kp, _, _ = both
    for o, cap in enumerate(CFG.out_caps):
        assert int((kp["valid"] & (kp["octave"] == o)).sum()) < cap


def test_keypoints_agree_with_the_twin(both):
    kpts, _, kp, _, _ = both
    assert len(kpts) > 100
    recall = float((_hits(kpts, kp) >= 0).mean())
    valid = np.where(kp["valid"])[0]
    rx = np.array([k["x"] for k in kpts])
    ry = np.array([k["y"] for k in kpts])
    precision = float(np.mean([
        np.min(np.abs(rx - kp["x"][i]) + np.abs(ry - kp["y"][i])) < 0.1
        for i in valid]))
    assert recall >= 0.99 and precision >= 0.99, (recall, precision)


def test_descriptors_agree_with_the_twin(both):
    kpts, desc, kp, d, _ = both
    hits = _hits(kpts, kp)
    found = np.where(hits >= 0)[0]
    l1 = np.abs(desc[found] - d[hits[found]]).sum(1)
    assert np.median(l1) < 0.05 and np.quantile(l1, 0.9) < 0.2, (
        np.median(l1), np.quantile(l1, 0.9))


def test_matcher_agrees_with_brute_force(both):
    """The reference's ratio test against the twin's NumPy brute force
    (BFMatcher NORM_L1, k = 2, src/main.cpp:25-40), on the reference's
    own descriptors of the pan's two frames."""
    kp, d = both[4]
    tidx, good, _ = sift_plain.match_ratio(d[1], d[0], kp.valid[1],
                                           kp.valid[0], CFG.match_ratio)
    q = np.where(kp.valid[1].numpy())[0]
    t = np.where(kp.valid[0].numpy())[0]
    ours = {(int(i), int(tidx[i])) for i in np.where(good.numpy())[0]}
    twin = {(int(q[a]), int(t[b])) for a, b, _ in oracle_numpy.match_l1_ratio(
        d[1].numpy()[q], d[0].numpy()[t], CFG.match_ratio)}
    assert len(twin) > 100
    assert len(ours ^ twin) <= 0.01 * len(twin), (len(ours ^ twin),
                                                 len(twin))


@pytest.mark.parametrize("seed", SEEDS)
def test_ransac_finds_the_true_corners(seed):
    """The reference demo (detect, match, RANSAC, corners) finds the
    pasted object within 2 px of its true corners."""
    scene, obj, _, true = recipes.object_scene((480, 640), (160, 200),
                                               seed)
    ref = detect_object_plain(torch.from_numpy(scene),
                              torch.from_numpy(obj), sift_plain.RefConfig())
    assert bool(ref["found"])
    gap = np.linalg.norm(ref["corners"].numpy() - true, axis=1).max()
    assert gap < 2.0, gap


def test_perspective_transform_is_the_homography():
    h = torch.tensor([[1.1, 0.1, 5.0], [-0.2, 0.9, 7.0], [1e-4, 2e-4, 1.0]])
    pts = torch.tensor([[0.0, 0.0], [10.0, 20.0], [300.0, -40.0]])
    got = homography_plain.perspective_transform(pts, h).numpy()
    want = recipes.project(pts.numpy().astype(np.float64),
                           h.numpy().astype(np.float64))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
