"""The port's SfM back end against sift_tpu's on the CPU: bundle
adjustment, the pose graph, tracks, incremental reconstruction, loop
closures and export.

RANSAC draws: the port takes sift_tpu's minimal samples through its
`sampler=` seam (jax_sampler draws them exactly as
sift_tpu/geometry/epipolar.py:123-130 and pnp.py:158-161 do), and its
retrieval projection through `proj=` (sift_tpu's seed-7 matrix).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_tpu.geometry import lie as jlie
from sift_tpu.ops.match_cascade import _projection as jax_projection
from sift_tpu.sfm import ba as jba
from sift_tpu.sfm import incremental as jinc
from sift_tpu.sfm import loopclosure as jlc
from sift_tpu.sfm import posegraph as jpg
from sift_tpu.utils.metrics import umeyama_alignment

from sift_tpu_torch.sfm import ba as tba
from sift_tpu_torch.sfm import incremental as tinc
from sift_tpu_torch.sfm import loopclosure as tlc
from sift_tpu_torch.sfm import posegraph as tpg
from sift_tpu_torch.sfm.export import save_reconstruction
from sift_tpu_torch.utils.logger import COUNTERS

from _torch_threads import one_thread  # noqa: F401


def jax_sampler(kind, valid, n_samples, k, seed):
    """sift_tpu's RANSAC draw for a call with this validity mask."""
    key = jax.random.PRNGKey(seed)
    g = jax.random.gumbel(key, (n_samples, valid.shape[0]))
    g = jnp.where(jnp.asarray(valid.cpu().numpy())[None, :], g, -jnp.inf)
    return np.array(jax.lax.top_k(g, k)[1])


def _so3(w):
    return np.asarray(jlie.so3_exp(jnp.asarray(w, jnp.float32)))


def _rel(a6, b6):
    """Ground-truth relative [w|t] of edge a->b."""
    ra, rb = _so3(a6[:3]), _so3(b6[:3])
    return np.concatenate([np.asarray(jlie.so3_log(
        jnp.asarray(ra.T @ rb, jnp.float32))), ra.T @ (b6[3:] - a6[3:])])


# ----------------------------------------------------------------- BA

def _ba_rig(seed, noise=1e-3, outliers=0.0):
    """tests/test_ba.py's rig: 6 cameras on an arc, 120 points, 20 % of
    observations dropped, padded to a power of two, perturbed start."""
    rng = np.random.default_rng(seed)
    n_cams, n_pts = 6, 120
    pts = np.stack([rng.uniform(-2, 2, n_pts), rng.uniform(-2, 2, n_pts),
                    rng.uniform(6, 12, n_pts)], axis=1)
    cams = []
    for i in range(n_cams):
        w = np.array([0.0, (i - n_cams / 2) * 0.12, 0.0])
        center = np.array([2.0 * i / n_cams - 1.0, 0.1 * i, 0.0])
        cams.append(np.concatenate([w, -_so3(w) @ center]))
    cams = np.stack(cams)
    cam_idx, pt_idx, uv = [], [], []
    for ci in range(n_cams):
        xc = pts @ _so3(cams[ci, :3]).T + cams[ci, 3:]
        proj = xc[:, :2] / xc[:, 2:3]
        for pi in range(n_pts):
            if rng.random() < 0.2:
                continue
            cam_idx.append(ci)
            pt_idx.append(pi)
            uv.append(proj[pi] + rng.normal(0, noise, 2))
    uv = np.array(uv)
    bad = rng.random(len(uv)) < outliers
    uv[bad] += rng.uniform(0.1, 0.3, (int(bad.sum()), 2))
    o = len(cam_idx)
    pad = (1 << int(np.ceil(np.log2(o)))) - o
    cams0 = cams.copy()
    cams0[1:] += rng.normal(0, 0.03, cams0[1:].shape)
    fixed = np.zeros(n_cams, bool)
    fixed[0] = True
    return dict(
        cameras=cams0.astype(np.float32),
        points=(pts + rng.normal(0, 0.05, pts.shape)).astype(np.float32),
        cam_idx=np.array(cam_idx + [0] * pad, np.int32),
        pt_idx=np.array(pt_idx + [0] * pad, np.int32),
        uv=np.concatenate([uv, np.zeros((pad, 2))]).astype(np.float32),
        mask=np.array([True] * o + [False] * pad),
        fixed_cams=fixed)


def _jax_problem(d):
    return jba.BAProblem(**{k: jnp.asarray(v) for k, v in d.items()})


def _port_problem(d):
    p = {k: torch.from_numpy(np.array(v)) for k, v in d.items()}
    p["cam_idx"] = p["cam_idx"].long()
    p["pt_idx"] = p["pt_idx"].long()
    return tba.BAProblem(**p)


def _rel_err(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("loss,outliers", [("huber", 0.0), ("cauchy", 0.1)])
def test_bundle_adjust_matches_jax(loss, outliers):
    # After 4 LM iterations of 10 CG steps: cameras and points within
    # 1e-4 relative (Frobenius; tools/torch_mapping_parity.py reads
    # <= 7.7e-6). With the default 30 CG steps, CG runs on past
    # convergence along the unfixed scale direction, where float32
    # rounding steers the two runs apart (up to 1.3e-2 relative) while
    # the cost they reach agrees: there, the final cost within 1e-3
    # relative (the tool reads <= 2.5e-5).
    d = _ba_rig(0, outliers=outliers)
    want = jba.bundle_adjust(_jax_problem(d), iters=4, cg_iters=10, loss=loss)
    got = tba.bundle_adjust(_port_problem(d), iters=4, cg_iters=10, loss=loss)
    assert _rel_err(got.cameras.numpy(), np.asarray(want.cameras)) < 1e-4
    assert _rel_err(got.points.numpy(), np.asarray(want.points)) < 1e-4
    np.testing.assert_array_equal(got.cameras[0].numpy(), d["cameras"][0])
    want = jba.bundle_adjust(_jax_problem(d), iters=4, loss=loss)
    got = tba.bundle_adjust(_port_problem(d), iters=4, loss=loss)
    c_want = float(jba._cost(want, 3e-3, loss))
    c_got = float(tba._cost(got, 3e-3, loss))
    assert abs(c_got - c_want) <= 1e-3 * c_want
    assert abs(float(tba.reproj_rmse(got)) - float(jba.reproj_rmse(want))) \
        <= 1e-3 * float(jba.reproj_rmse(want))


def test_bundle_adjust_system_matches_jax():
    # the analytic per-observation Jacobians against jax.jacfwd's: atol
    # 2e-6 on blocks of order 0.1-1, residuals to 1e-7; the Huber
    # weights delta / |r| within 1e-4 relative (|r| is ~1e-3, known to
    # ~1e-8 in float32)
    d = _ba_rig(1)
    want = jba._build_system(_jax_problem(d), 3e-3, "huber")
    got = tba._build_system(_port_problem(d), 3e-3, "huber")
    for g, w, atol in zip(got[:3], want[:3], (2e-6, 2e-6, 1e-7)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]),
                               rtol=1e-4)


def test_bundle_adjust_converges_and_ignores_masked_slots():
    d = _ba_rig(2, noise=5e-4)
    prob = _port_problem(d)
    rmse0 = float(tba.reproj_rmse(prob))
    out = tba.bundle_adjust(prob, iters=25, cg_iters=40)
    assert rmse0 > 5e-3 and float(tba.reproj_rmse(out)) < 1.5e-3
    # garbage in every masked slot must not change the result
    poisoned = dict(d)
    poisoned["uv"] = d["uv"].copy()
    poisoned["uv"][~d["mask"]] = 1e3
    out2 = tba.bundle_adjust(_port_problem(poisoned), iters=25, cg_iters=40)
    assert torch.equal(out.cameras, out2.cameras)
    assert torch.equal(out.points, out2.points)


# ---------------------------------------------------------- pose graph

def _pose_graph(extra_edges):
    """tests/test_posegraph.py's drifting 12-pose circle with an exact
    closure edge 11 -> 0, plus noisy `extra_edges`."""
    rng = np.random.default_rng(0)
    n = 12
    truth = np.zeros((n, 6))
    for i in range(n):
        ang = 2 * np.pi * i / n
        truth[i, :3] = [0, 0, ang]
        truth[i, 3:] = [np.cos(ang), np.sin(ang), 0.0]
    ei, ej, rels, w = [], [], [], []
    est = np.zeros((n, 6))
    est[0] = truth[0]
    for i in range(n - 1):
        noisy = _rel(truth[i], truth[i + 1]) + rng.normal(0, 0.01, 6)
        ei.append(i)
        ej.append(i + 1)
        rels.append(noisy)
        w.append(1.0)
        ra, rr = _so3(est[i, :3]), _so3(noisy[:3])
        est[i + 1, :3] = np.asarray(jlie.so3_log(
            jnp.asarray(ra @ rr, jnp.float32)))
        est[i + 1, 3:] = est[i, 3:] + ra @ noisy[3:]
    for a, b in [(n - 1, 0)] + extra_edges:
        ei.append(a)
        ej.append(b)
        rels.append(_rel(truth[a], truth[b]) + (rng.normal(0, 0.01, 6)
                                                if (a, b) != (n - 1, 0)
                                                else 0.0))
        w.append(4.0)
    fixed = np.zeros(n, bool)
    fixed[0] = True
    return (est.astype(np.float32), np.array(ei, np.int32),
            np.array(ej, np.int32), np.array(rels, np.float32),
            np.array(w, np.float32), np.ones(len(w), bool), fixed)


@pytest.mark.parametrize("extra", [[], [(3, 5), (2, 6), (0, 3), (9, 11)]],
                         ids=["loop", "shared_vertices"])
def test_pose_graph_matches_jax(extra):
    # "shared_vertices": closure edges that meet odometry edges at
    # vertices 0, 2, 3, 5, 6, 9 and 11, so the normal equations take
    # several blocks at one index (index_add_ must accumulate them).
    # Poses after 1 and 20 iterations within 1e-4 relative, cost within
    # 1e-3 relative.
    arrs = _pose_graph(extra)
    jg = jpg.PoseGraph(*map(jnp.asarray, arrs))
    tg = tpg.PoseGraph(*(torch.from_numpy(np.array(a)) for a in arrs))
    for iters in (1, 20):
        want = jpg.optimize_pose_graph(jg, iters=iters)
        got = tpg.optimize_pose_graph(tg, iters=iters)
        assert _rel_err(got.poses.numpy(), np.asarray(want.poses)) < 1e-4
        c_want = float(jpg.pose_graph_cost(want))
        assert abs(float(tpg.pose_graph_cost(got)) - c_want) <= 1e-3 * c_want
    assert float(tpg.pose_graph_cost(got)) < float(tpg.pose_graph_cost(tg))


def test_pose_graph_ignores_masked_edges():
    n = 4
    poses = np.zeros((n, 6), np.float32)
    poses[:, 3] = np.arange(n)
    ei = np.array([0, 1, 2, 0])
    ej = np.array([1, 2, 3, 3])
    rels = np.stack([_rel(poses[i], poses[j]) for i, j in zip(ei, ej)])
    rels[3] += 100.0                              # poison the masked edge
    fixed = np.zeros(n, bool)
    fixed[0] = True
    g = tpg.PoseGraph(torch.from_numpy(poses), torch.from_numpy(ei),
                      torch.from_numpy(ej),
                      torch.from_numpy(rels.astype(np.float32)),
                      torch.ones(4), torch.tensor([True, True, True, False]),
                      torch.from_numpy(fixed))
    out = tpg.optimize_pose_graph(g, iters=5)
    np.testing.assert_allclose(out.poses.numpy(), poses, atol=1e-5)


# ------------------------------------------------------ incremental SfM

def _synthetic_sequence(rng, n_frames=7, n_pts=250, noise=4e-4, drop=0.25):
    """tests/test_sfm.py's sequence: cameras orbiting a cloud; per-frame
    keypoints = projections of the visible points (+noise), pairwise
    matches from ground truth."""
    pts = np.stack([rng.uniform(-2, 2, n_pts), rng.uniform(-1.5, 1.5, n_pts),
                    rng.uniform(5, 11, n_pts)], 1)
    cams = np.zeros((n_frames, 6))
    for i in range(n_frames):
        w = np.array([0.02 * i, 0.1 * (i - n_frames / 2), 0.0])
        center = np.array([1.6 * i / n_frames - 0.8,
                           0.05 * np.sin(i), 0.05 * i])
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
            if len(pairs) >= 16:
                matches[(i, j)] = np.array(pairs, np.int64)
    return cams, kp_xy, matches


@pytest.fixture(scope="module")
def reconstructions():
    """sift_tpu's and the port's reconstruct on one sequence, the port
    with sift_tpu's RANSAC draws."""
    cams, kp_xy, matches = _synthetic_sequence(np.random.default_rng(0))
    want = jinc.reconstruct(kp_xy, matches)
    COUNTERS.reset()
    got = tinc.reconstruct(kp_xy, matches, sampler=jax_sampler, device="cpu")
    return want, got, COUNTERS.snapshot()


def test_build_tracks_matches_jax():
    _, _, matches = _synthetic_sequence(np.random.default_rng(0))
    assert tinc.build_tracks(7, matches) == jinc.build_tracks(7, matches)


def test_reconstruct_registers_the_same_frames(reconstructions):
    want, got, counters = reconstructions
    np.testing.assert_array_equal(got.registered, want.registered)
    np.testing.assert_array_equal(got.has_point, want.has_point)
    assert got.tracks == want.tracks
    assert any(k.startswith("ba_shape/") for k in counters)


def test_reconstruct_cameras_and_points_match_jax(reconstructions):
    # after a similarity (Umeyama) alignment of the port's camera
    # centers onto sift_tpu's: centers within 1e-3 and points within
    # 2e-3 (the trajectory spans ~1.6 units; float32 BA in both, with
    # eigh/SVD/solve from other libraries); RMSE within 1 % relative
    want, got, _ = reconstructions
    reg = want.registered

    def centers(c):
        r = np.stack([_so3(w) for w in c[:, :3]])
        return -np.einsum("cji,cj->ci", r, c[:, 3:])

    cw, cg = centers(want.cameras[reg]), centers(got.cameras[reg])
    r, t, s = umeyama_alignment(cg, cw)
    assert np.abs(s * cg @ r.T + t - cw).max() < 1e-3
    hp = want.has_point
    pg = s * got.points[hp] @ r.T + t
    assert np.median(np.abs(pg - want.points[hp])) < 2e-3
    assert abs(got.reproj_rmse - want.reproj_rmse) <= 0.01 * want.reproj_rmse


def test_export_writes_the_reconstruction(reconstructions, tmp_path):
    _, got, _ = reconstructions
    out = save_reconstruction(str(tmp_path / "rec"), got)
    ply = open(out["ply"]).read().splitlines()
    assert ply[0] == "ply"
    n_declared = int([line for line in ply
                      if line.startswith("element vertex")][0].split()[-1])
    assert n_declared == int(got.has_point.sum()) > 50
    j = json.load(open(out["json"]))
    assert len(j["cameras"]) == int(got.registered.sum())
    assert np.isfinite(j["reproj_rmse"])


# --------------------------------------------------------- loop closure

def _descriptor_sequence():
    """tests/test_loopclosure.py's sequence: 10 frames of a 300-point
    cloud, sqrt-L1 descriptors per point with per-view noise."""
    rng = np.random.default_rng(5)
    n_frames, n_pts = 10, 300
    pts = np.stack([rng.uniform(-2, 2, n_pts), rng.uniform(-1.5, 1.5, n_pts),
                    rng.uniform(5, 11, n_pts)], 1)
    true_desc = rng.random((n_pts, 128)).astype(np.float32) ** 2
    true_desc = np.sqrt(true_desc / true_desc.sum(axis=1, keepdims=True))
    kp_xy, descs, valids = [], [], []
    for f in range(n_frames):
        w = np.array([0.02 * f, 0.1 * (f - n_frames / 2), 0.0])
        center = np.array([1.6 * f / n_frames - 0.8, 0.05 * np.sin(f),
                           0.05 * f])
        r = _so3(w)
        xc = pts @ r.T - r @ center
        proj = xc[:, :2] / xc[:, 2:3]
        idx = np.where(rng.random(n_pts) > 0.25)[0]
        kp_xy.append((proj[idx] + rng.normal(0, 4e-4, (len(idx), 2))
                      ).astype(np.float32))
        descs.append(np.abs(true_desc[idx] + rng.normal(
            0, 5e-3, (len(idx), 128))).astype(np.float32))
        valids.append(np.ones(len(idx), bool))
    return kp_xy, descs, valids


def test_loop_closures_match_jax():
    # with sift_tpu's projection and draws: the same closure pairs, the
    # same matches, n_inliers within 1 % and rel_pose within 1e-3
    kp_xy, descs, valids = _descriptor_sequence()
    kw = dict(min_gap=7, candidates_per_frame=1)
    want = jlc.find_loop_closures(descs, valids, kp_xy, **kw)
    proj = np.asarray(jax_projection(128, 16, 7))
    got = tlc.find_loop_closures(descs, valids, kp_xy, proj=proj,
                                 sampler=jax_sampler, device="cpu", **kw)
    assert want, "no closure in the reference run"
    assert [(c.i, c.j) for c in got] == [(c.i, c.j) for c in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.matches, w.matches)
        assert abs(g.n_inliers - w.n_inliers) <= 0.01 * w.n_inliers
        np.testing.assert_allclose(g.rel_pose, w.rel_pose, atol=1e-3)
    np.testing.assert_allclose(
        tlc.frame_signatures(descs, valids, proj),
        jlc.frame_signatures(descs, valids), atol=1e-5)
    assert tlc.closures_as_matches(got).keys() == \
        jlc.closures_as_matches(want).keys()
