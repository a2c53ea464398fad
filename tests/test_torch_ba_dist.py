"""The port's distributed back end against sift_tpu on the CPU:
observation- and point-sharded bundle adjustment and the partitioned
pose graph on 2 gloo ranks against sift_tpu on conftest's virtual mesh
with n = 2 (and against single-device BA), the host-side partitioners,
rotation averaging, the npz checkpoint interchange, and the restartable
BA of utils/health.

The BA problem is the dry run's: 4 cameras, 32 points, 128 observations
(__graft_entry__.py:75-88), 4 LM iterations of 10 CG steps.
"""

import concurrent.futures
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_tpu.parallel import default_mesh as j_default_mesh
from sift_tpu.parallel import ba as jpba
from sift_tpu.sfm import ba as jba
from sift_tpu.sfm import checkpoint as jck
from sift_tpu.sfm import posegraph as jpg
from sift_tpu.sfm import posegraph_dist as jpgd
from sift_tpu.sfm.rotation_avg import average_rotations as j_average
from sift_tpu.utils import health as jhealth

import _torch_rank_jobs as jobs
from sift_tpu_torch.geometry import lie as tlie
from sift_tpu_torch.parallel import ba as tpba
from sift_tpu_torch.parallel.dryrun import (ba_problem_arrays,
                                            chain_graph_arrays, to_graph,
                                            to_problem)
from sift_tpu_torch.parallel.mesh import run_spmd
from sift_tpu_torch.sfm import ba as tba
from sift_tpu_torch.sfm import checkpoint as tck
from sift_tpu_torch.sfm import posegraph as tpg
from sift_tpu_torch.sfm import posegraph_dist as tpgd
from sift_tpu_torch.sfm.rotation_avg import average_rotations as t_average
from sift_tpu_torch.utils import health as thealth

from _torch_threads import one_thread  # noqa: F401

ITERS, CG_ITERS = 4, 10
RANK_TIMEOUT_S = 240


def _rel_err(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / np.linalg.norm(np.asarray(b)))


@pytest.fixture(scope="module")
def arrays():
    rng = np.random.default_rng(0)
    return ba_problem_arrays(rng), chain_graph_arrays(rng, 8)


def _jax_problem(a):
    return jba.BAProblem(*(jnp.asarray(a[f]) for f in jba.BAProblem._fields))


def _jax_graph(a):
    return jpg.PoseGraph(*(jnp.asarray(a[f]) for f in jpg.PoseGraph._fields))


@pytest.fixture(scope="module")
def back_end(arrays):
    """(the port's 2 ranks, run in the background, sift_tpu's sharded
    results on the virtual mesh)."""
    ba_a, g_a = arrays
    mesh = j_default_mesh(2)
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        port = ex.submit(run_spmd, jobs.back_end_job, 2,
                         args=(ba_a, g_a, ITERS, CG_ITERS),
                         backend="gloo", device="cpu",
                         timeout_s=RANK_TIMEOUT_S)
        prob, g = _jax_problem(ba_a), _jax_graph(g_a)
        want = {"graph": jpgd.optimize_pose_graph_partitioned(
            g, mesh, rounds=8, inner_iters=3)}
        for n, cg in ((1, 3), (ITERS, CG_ITERS)):
            want["obs", n] = jpba.bundle_adjust_sharded(
                prob, mesh, iters=n, cg_iters=cg)
            want["point", n] = jpba.bundle_adjust_point_sharded(
                prob, mesh, iters=n, cg_iters=cg)
        return port.result(), want


@pytest.mark.parametrize("which", ["obs", "point"])
def test_sharded_ba_matches_jax_and_single_device(arrays, back_end, which):
    # After one LM iteration of 3 CG steps: the cost equals single-device
    # BA's within 1e-5 relative (the psum only regroups the segment
    # sums), cameras and points within 1e-4 relative of sift_tpu's
    # sharded run and of the single-device run (test_torch_sfm.py's BA
    # bound). After 4 iterations of 10 steps CG has reached the unfixed
    # scale direction of this noise-free problem, where float32 rounding
    # steers runs apart by up to 1.3e-2 relative (ROADMAP Queue 3): there
    # the parameters within 2e-2 relative of both references, and the
    # RMSE a tenth of the initial one or less. Both ranks hold the same
    # solution.
    port, want = back_end
    ba_a, _ = arrays
    prob = to_problem(ba_a, "cpu")
    rmse_in = float(tba.reproj_rmse(prob))
    for n, cg, rel in ((1, 3, 1e-4), (ITERS, CG_ITERS, 2e-2)):
        single = tba.bundle_adjust(prob, iters=n, cg_iters=cg)
        c_single = float(tba._cost(single, 3e-3, "huber"))
        w = want[which, n]
        for r in port:
            got = r[which, n]
            assert torch.equal(got.cameras, port[0][which, n].cameras)
            assert torch.equal(got.points, port[0][which, n].points)
            if n == 1:
                c = float(tba._cost(got, 3e-3, "huber"))
                assert abs(c - c_single) <= 1e-5 * c_single, (c, c_single)
            for f in ("cameras", "points"):
                assert _rel_err(getattr(got, f).numpy(),
                                np.asarray(getattr(w, f))) < rel
                assert _rel_err(getattr(got, f).numpy(),
                                getattr(single, f).numpy()) < rel
            np.testing.assert_array_equal(got.cameras[0].numpy(),
                                          ba_a["cameras"][0])
            assert float(tba.reproj_rmse(got)) < (0.1 if n > 1 else 1.0) \
                * rmse_in


def test_point_sharded_inputs_match_jax(arrays):
    # the host partitioner is a copy of sift_tpu's: equal blocks, exactly
    ba_a, _ = arrays
    for n in (2, 4):
        want, p_w = jpba.point_sharded_inputs(_jax_problem(ba_a),
                                              j_default_mesh(n))
        got, p_g = tpba.point_sharded_inputs(to_problem(ba_a, "cpu"), n)
        assert p_g == p_w == 32
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_partitioned_pose_graph_matches_jax(arrays, back_end):
    # poses within 1e-4 relative and cost within 1e-3 relative of
    # sift_tpu's partitioned run (test_torch_sfm.py's pose-graph bounds);
    # the cost falls; the ranks agree; the rank job's selftest passed
    # (a loop trajectory within 2 % of its initial cost)
    _, g_a = arrays
    port, want = back_end
    w = want["graph"]
    c_want = float(jpg.pose_graph_cost(w))
    for r in port:
        got = r["graph"]
        assert torch.equal(got.poses, port[0]["graph"].poses)
        assert _rel_err(got.poses.numpy(), np.asarray(w.poses)) < 1e-4
        c = float(tpg.pose_graph_cost(got))
        assert abs(c - c_want) <= 1e-3 * c_want
        assert c < float(tpg.pose_graph_cost(to_graph(g_a, "cpu")))


def test_partition_pose_graph_matches_jax(arrays):
    # the host partitioner, block colours included, equals sift_tpu's on
    # the chain and on a graph with a loop-closure edge between blocks
    _, g_a = arrays
    loop = dict(g_a)
    for k, extra in (("edges_i", 0), ("edges_j", 7)):
        loop[k] = np.append(g_a[k], np.int32(extra))
    loop["rel"] = np.concatenate([g_a["rel"], g_a["rel"][:1]])
    loop["weight"] = np.append(g_a["weight"], np.float32(1))
    loop["mask"] = np.append(g_a["mask"], True)
    for a in (g_a, loop):
        for n in (2, 4):
            want = jpgd.partition_pose_graph(_jax_graph(a), n)
            got = tpgd.partition_pose_graph(to_graph(a, "cpu"), n)
            for f in want._fields:
                np.testing.assert_array_equal(getattr(got, f).numpy(),
                                              np.asarray(getattr(want, f)))


@pytest.fixture(scope="module")
def rotations():
    """tests/test_rotation_avg.py's problem: 24 random rotations, edges
    to the next 3 frames with 0.01 rad noise and a few long ones."""
    rng = np.random.default_rng(0)
    n = 24
    rots = tlie.so3_exp(torch.from_numpy(
        rng.normal(0, 1.0, (n, 3)).astype(np.float32))).numpy()
    rots = np.einsum("nij,kj->nik", rots, rots[0])
    ei, ej, rel = [], [], []
    for i in range(n):
        for j in range(i + 1, min(i + 4, n)):
            noise = tlie.so3_exp(torch.from_numpy(
                rng.normal(0, 0.01, 3).astype(np.float32))).numpy()
            ei.append(i)
            ej.append(j)
            rel.append(noise @ rots[j] @ rots[i].T)
    for i in range(0, n - 8, 5):
        ei.append(i)
        ej.append(i + 8)
        rel.append(rots[i + 8] @ rots[i].T)
    return rots, np.array(ei), np.array(ej), np.stack(rel)


def _max_angle_deg(a, b) -> float:
    a, b = np.float64(a), np.float64(b)
    c = (np.einsum("nij,nij->n", a, b) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1, 1))).max())


@pytest.mark.parametrize("irls", [0, 3])
def test_rotation_averaging_matches_jax(rotations, irls):
    # within 0.1 deg of sift_tpu's solution (each float32 eigh lies ~0.05
    # deg from the float64 solution on this problem), and within
    # sift_tpu's own bounds of the truth: 2 deg clean, 3 deg with 10 %
    # garbage edges, IRLS no worse than one solve
    rots, ei, ej, rel = rotations
    rel = rel.copy()
    if irls:
        rng = np.random.default_rng(1)
        for b in rng.choice(len(rel), size=len(rel) // 10, replace=False):
            rel[b] = tlie.so3_exp(torch.from_numpy(
                rng.normal(0, 1.0, 3).astype(np.float32))).numpy()
    want = j_average(len(rots), ei, ej, rel, irls_rounds=irls)
    got = t_average(len(rots), ei, ej, rel, irls_rounds=irls, device="cpu")
    assert got.shape == (24, 3, 3)
    assert _max_angle_deg(got, want) < 0.1
    assert _max_angle_deg(got, rots) < (3.0 if irls else 2.0)
    np.testing.assert_allclose(got[0], np.eye(3), atol=1e-5)
    if irls:
        one = t_average(len(rots), ei, ej, rel, irls_rounds=0, device="cpu")
        assert _max_angle_deg(got, rots) <= _max_angle_deg(one, rots) + 1e-6


def test_checkpoint_interchange(arrays, tmp_path):
    # a port-written npz loads in sift_tpu's load_ba; an npz in sift_tpu's
    # layout (int32 indices, `step`) written with np.savez loads in the
    # port; latest() orders both kinds by step; an orbax path is refused
    ba_a, _ = arrays
    prob = to_problem(ba_a, "cpu")
    path = tck.save_ba_step(str(tmp_path), prob, 4)
    assert os.path.basename(path) == "ba_00000004.npz"
    with open(path + ".step") as f:
        assert f.read() == "4"
    jprob, step = jck.load_ba(path)
    assert step == 4
    for f in jba.BAProblem._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jprob, f)),
                                      ba_a[f])
    with np.load(path) as z:
        assert z["cam_idx"].dtype == np.int32 and int(z["step"]) == 4

    jpath = str(tmp_path / "ba_from_jax.npz")
    np.savez(jpath, **{f: np.asarray(ba_a[f]) for f in jba.BAProblem._fields},
             step=np.asarray(9))
    got, step = tck.load_ba(jpath, device="cpu")
    assert step == 9 and got.cam_idx.dtype == torch.int64
    for f in jba.BAProblem._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), ba_a[f])
    # the embedded step (9) outranks ba_00000004's name
    assert tck.latest(str(tmp_path)) == jpath
    assert jck.latest(str(tmp_path)) == jpath
    tck.save_ba(str(tmp_path / "ba_named"), prob, step=12)
    assert tck.latest(str(tmp_path)) == str(tmp_path / "ba_named.npz")
    assert tck.latest(str(tmp_path / "absent")) is None
    with pytest.raises(ValueError, match="orbax"):
        tck.load_ba(str(tmp_path / "ba_00000001.orbax"))


def test_restartable_ba_matches_jax(arrays):
    # a convergent problem needs no restart in either package; the RMSE
    # reached agrees within 1e-3 relative (test_torch_sfm.py's BA bound)
    ba_a, _ = arrays
    want, w_restarts = jhealth.bundle_adjust_restartable(_jax_problem(ba_a),
                                                         iters=8)
    prob = to_problem(ba_a, "cpu")
    got, restarts = thealth.bundle_adjust_restartable(prob, iters=8)
    assert restarts == w_restarts == 0
    # both converge to float32 rounding (~1e-5 of an initial ~8e-3): the
    # RMSEs agree within 1e-3 of the initial RMSE
    r_in = float(tba.reproj_rmse(prob))
    r_w, r_g = float(jba.reproj_rmse(want)), float(tba.reproj_rmse(got))
    assert abs(r_g - r_w) <= 1e-3 * r_in and r_g < 0.01 * r_in
    # a problem whose every step diverges gives up and returns the input
    bad = to_problem(ba_a, "cpu")
    bad = bad._replace(uv=bad.uv * float("nan"))
    out, restarts = thealth.bundle_adjust_restartable(bad, iters=2,
                                                      max_restarts=1)
    assert restarts == 2 and out is bad


def test_finiteness_guard_matches_jax():
    # the same verdicts on trees of tensors, arrays, NamedTuples and
    # dataclasses
    from sift_tpu_torch.types import Keypoints
    ok = {"a": torch.ones(3), "b": (np.ones(2), [torch.zeros(1)])}
    bad = {"a": torch.tensor([1.0, float("nan")])}
    assert thealth.tree_all_finite(ok) == jhealth.tree_all_finite(
        {"a": jnp.ones(3)}) is True
    assert thealth.tree_all_finite(bad) == jhealth.tree_all_finite(
        {"a": jnp.array([1.0, np.nan])}) is False
    kp = Keypoints.zeros(4)
    assert thealth.tree_all_finite(kp)
    assert not thealth.tree_all_finite(
        Keypoints(**{**kp.__dict__, "x": torch.full((4,), float("inf"))}))
    with pytest.raises(FloatingPointError):
        thealth.assert_finite(torch.tensor([float("inf")]), "x")

