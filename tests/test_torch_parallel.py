"""The port's multi-device layer (sift_tpu_torch.parallel) on 2 gloo
ranks against sift_tpu.parallel on conftest's virtual CPU mesh with
n = 2: the mesh and its collectives, data-parallel frames, both sharded
matchers with their masks and tie order, and the mesh health check.

Each test feeds both packages the same numpy inputs from a seed. The
port's ranks are processes of their own (mesh.run_spmd, a FileStore in
a temporary directory, one CPU thread each, joined with a deadline);
they run while the JAX side compiles.
"""

import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from sift_tpu.config import SIFTConfig as JaxConfig
from sift_tpu.ops import match as jmatch
from sift_tpu.parallel import (batched_detect_and_compute as j_frames,
                               default_mesh as j_default_mesh,
                               make_mesh as j_make_mesh,
                               sharded_match_ratio as j_query_sharded)
from sift_tpu.parallel.match import \
    sharded_match_ratio_train_sharded as j_train_sharded
from sift_tpu.utils import health as jhealth

import _torch_rank_jobs as jobs
from sift_tpu_torch import sift
from sift_tpu_torch.config import from_jax_config
from sift_tpu_torch.ops import match as tmatch
from sift_tpu_torch.parallel.match import merge_top2
from sift_tpu_torch.parallel.mesh import rank_device, run_spmd
from sift_tpu_torch.utils import health as thealth

from _torch_threads import one_thread  # noqa: F401

JCFG = JaxConfig(descr_rc_bf16=False, ori_gather_impl="dynamic_slice",
                 descr_gather_impl="dynamic_slice",
                 detect_caps=(512, 256, 128, 64, 32),
                 out_caps=(256, 128, 64, 64, 64))
TCFG = from_jax_config(dataclasses.asdict(JCFG))
FIELDS = ("x", "y", "size", "angle", "response", "octave", "layer", "r",
          "c", "valid")
TIES = 40          # query rows equal to train rows in both train shards
RANK_TIMEOUT_S = 240


@pytest.fixture(scope="module")
def mesh2():
    return j_default_mesh(2)


@pytest.fixture(scope="module")
def inputs(small_image):
    """4 shifted 120x160 crops of the synthetic image; 256 query and 512
    train descriptors (sift_tpu's tests/test_parallel.py recipe) where
    query rows 0..39 equal train rows 0..39 and train rows 256..295 (the
    second shard) repeat them; a train mask that drops every other row
    but the tied ones."""
    crops = [small_image[i:i + 120, i:i + 160] for i in range(0, 16, 4)]
    rng = np.random.default_rng(0)

    def descs(n):
        d = rng.random((n, 128)).astype(np.float32) ** 2
        d /= d.sum(axis=1, keepdims=True)
        return np.sqrt(d)
    q, t = descs(256), descs(512)
    t[256:256 + TIES] = t[:TIES]
    q[:TIES] = t[:TIES]
    t_valid = np.ones(512, bool)
    t_valid[1::2] = False
    t_valid[:TIES] = t_valid[256:256 + TIES] = True
    return np.stack(crops).astype(np.float32), q, t, t_valid


@pytest.fixture(scope="module")
def results(inputs, mesh2):
    """(port rank results, sift_tpu's results): the port's 2 ranks run
    in the background while JAX compiles."""
    frames, q, t, t_valid = inputs
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        port = ex.submit(run_spmd, jobs.front_end_job, 2,
                         args=(frames, TCFG, q, t, t_valid),
                         backend="gloo", device="cpu",
                         timeout_s=RANK_TIMEOUT_S)
        jkp, jd = j_frames(jnp.asarray(frames), mesh2, JCFG)
        want = {
            "frames": (jkp, np.asarray(jd)),
            "query": j_query_sharded(jnp.asarray(q), jnp.asarray(t), mesh2,
                                     impl="xla"),
            "train": j_train_sharded(jnp.asarray(q), jnp.asarray(t), mesh2,
                                     impl="xla"),
            "train_masked": j_train_sharded(
                jnp.asarray(q), jnp.asarray(t), mesh2,
                t_valid=jnp.asarray(t_valid), impl="xla"),
            "query_masked": j_query_sharded(
                jnp.asarray(q), jnp.asarray(t), mesh2,
                t_valid=jnp.asarray(t_valid), impl="xla"),
            "healthy": jhealth.mesh_health_check(mesh2)}
        return port.result(), want


def test_mesh_construction():
    # the port's make_mesh((2, 2)) on 4 ranks names and shapes its axes as
    # sift_tpu's on 4 devices do, with one process group per axis; every
    # function uses the first axis; it refuses a mesh larger or smaller
    # than the world
    want = j_make_mesh((2, 2))
    got = run_spmd(jobs.mesh_job, 4, backend="gloo", device="cpu",
                   timeout_s=RANK_TIMEOUT_S)
    assert [r["index"] for r in got] == [0, 0, 1, 1]
    assert [r["model_index"] for r in got] == [0, 1, 0, 1]
    for r in got:
        assert r["axis_names"] == want.axis_names == ("data", "model")
        assert r["shape"] == dict(want.shape) == {"data": 2, "model": 2}
        assert r["axis_size"] == r["model_size"] == 2
        assert r["default"] == (("data",), {"data": 4})
        assert "needs 8 devices, have 4" in r["refused"][0]
        assert "covers 2 of the world's 4" in r["refused"][1]
    # psum over "data" adds ranks r and r + 2 (the column of the mesh)
    assert [float(r["psum"][0]) for r in got] == [2.0, 4.0, 2.0, 4.0]
    jm = j_default_mesh(2)
    assert jm.axis_names == got[0]["default"][0]


@pytest.mark.parametrize("device,cards,want", [
    ("cuda", 1, ["cuda:0", "cuda:0", "cuda:0", "cuda:0"]),
    ("cuda", 2, ["cuda:0", "cuda:1", "cuda:0", "cuda:1"]),
    ("cuda", 4, ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]),
    ("cuda:1", 4, ["cuda:1", "cuda:1", "cuda:1", "cuda:1"]),
    ("cpu", 0, ["cpu", "cpu", "cpu", "cpu"])])
def test_rank_device(device, cards, want):
    # a bare "cuda" gives rank r card r % cards (a card per rank where
    # the host has enough, as NCCL needs; ranks share one card where it
    # has one); a named card or the CPU is kept for every rank
    assert [str(rank_device(device, r, cards)) for r in range(4)] == want


def test_collectives_match_jax(mesh2):
    # psum, tiled all_gather and ppermute (a shift with zero fill and a
    # ring) on 2 ranks against jax.lax's inside shard_map: exact (a sum
    # of two float32 values, and copies)
    x = np.random.default_rng(3).random((2, 3, 4)).astype(np.float32)
    got = run_spmd(jobs.collectives_job, 2, args=(x,), backend="gloo",
                   device="cpu", timeout_s=RANK_TIMEOUT_S)

    def lax_ops(v):
        return (jax.lax.psum(v, "data"),
                jax.lax.all_gather(v, "data", tiled=True),
                jax.lax.ppermute(v, "data", [(0, 1)]),
                jax.lax.ppermute(v, "data", [(0, 1), (1, 0)]))

    fn = shard_map(lax_ops, mesh=mesh2, in_specs=P("data"),
                   out_specs=(P("data"),) * 4, check_vma=False)
    want = [np.asarray(a).reshape(2, -1, 4) for a in
            jax.jit(fn)(jnp.asarray(x.reshape(6, 4)))]
    for r in range(2):
        for i, key in enumerate(("psum", "all_gather", "shift", "ring")):
            np.testing.assert_array_equal(got[r][key].numpy(),
                                          want[i][r].reshape(
                                              got[r][key].shape))
        np.testing.assert_array_equal(got[r]["bool"].numpy(),
                                      x.reshape(6, 4) > 0.5)


def _frame_kps(kp, b):
    a = {f: np.asarray(getattr(kp, f))[b] for f in FIELDS}
    return {f: v[a["valid"]] for f, v in a.items()}


@pytest.mark.parametrize("b", [0, 1, 2, 3])
def test_frames_match_jax(results, b):
    # frame b as the keypoint set of tests/test_torch_batch.py: >= 99 % of
    # JAX's keypoints have a port keypoint at the same (octave, layer, r,
    # c) with x/y within 1e-3 px, counts within 1 % (ROADMAP Queue 3);
    # descriptors of keypoints paired by identity and angle (1e-2 deg)
    # within atol 1e-3, exact-f32 mode on both sides
    port, want = results
    for r in port:              # every rank returns the whole batch
        assert r["frames"][1].shape == (4, sum(TCFG.out_caps), 128)
    tkp, td = port[0]["frames"]
    jkp, jd = want["frames"]
    jk, tk = _frame_kps(jkp, b), _frame_kps(tkp, b)
    jdesc = jd[b][np.asarray(jkp.valid)[b]]
    tdesc = td[b].numpy()[tkp.valid[b].numpy()]
    n_j, n_t = len(jk["x"]), len(tk["x"])
    assert n_j > 20 and abs(n_t - n_j) <= 0.01 * n_j
    hit = paired = 0
    for i in range(n_j):
        same = [j for j in range(n_t)
                if all(jk[f][i] == tk[f][j] for f in ("octave", "layer",
                                                       "r", "c"))]
        hit += any(abs(jk["x"][i] - tk["x"][j]) < 1e-3
                   and abs(jk["y"][i] - tk["y"][j]) < 1e-3 for j in same)
        for j in same:
            da = abs(jk["angle"][i] - tk["angle"][j]) % 360.0
            if min(da, 360.0 - da) < 1e-2:
                np.testing.assert_allclose(tdesc[j], jdesc[i], atol=1e-3)
                paired += 1
                break
    assert hit >= 0.99 * n_j and paired >= 0.99 * n_j


def test_frames_equal_single_process_batch(inputs, results):
    # the ranks' gathered rows are detect_and_compute_batch's rows on the
    # whole batch in one process: valid and integer fields exact, float
    # fields within 1e-4 and descriptors within 1e-3 (tests/test_batch.py's
    # bounds; the CPU's batched matrix products may split their sums
    # differently in another process)
    port, _ = results
    kp, d = sift.detect_and_compute_batch(torch.from_numpy(inputs[0]), TCFG)
    for r in port:
        tkp, td = r["frames"]
        for f in ("valid", "octave", "layer", "r", "c"):
            assert torch.equal(getattr(tkp, f), getattr(kp, f)), f
        for f in ("x", "y", "size", "angle", "response"):
            diff = (getattr(tkp, f) - getattr(kp, f)).abs()
            assert float(diff[kp.valid].max()) <= 1e-4, f
        assert float((td - d).abs().max()) <= 1e-3


@pytest.mark.parametrize("which", ["query", "train", "train_masked",
                                   "query_masked"])
def test_sharded_matchers_match_jax(inputs, results, which):
    # good and train_idx exact, distance within rtol 1e-5 (L1 sums over
    # 128 dims reassociate between XLA and the plain K4); both ranks
    # return the same whole result, and it equals the port's single
    # match_ratio on the same inputs
    _, q, t, t_valid = inputs
    port, want = results
    w = want[which]
    tv = torch.from_numpy(t_valid) if which.endswith("masked") else None
    single = tmatch.match_ratio(torch.from_numpy(q), torch.from_numpy(t),
                                t_valid=tv)
    for r in port:
        got = r[which]
        np.testing.assert_array_equal(got.query_idx.numpy(), np.arange(256))
        np.testing.assert_array_equal(got.good.numpy(), np.asarray(w.good))
        np.testing.assert_array_equal(got.train_idx.numpy(),
                                      np.asarray(w.train_idx))
        np.testing.assert_allclose(got.distance.numpy(),
                                   np.asarray(w.distance), rtol=1e-5)
        for a, b in zip(got, single):
            assert torch.equal(a, b)
    assert 0 < int(np.asarray(w.good).sum()) < 256


def test_train_sharded_tie_order(inputs, results):
    # query rows 0..39 equal train rows j and j + 256, one in each shard:
    # the merge's strict < keeps the first shard's row, the lowest train
    # index, as the single-device kernel does, with d1 = d2 = 0
    port, want = results
    for which in ("train", "train_masked"):
        got = port[0][which]
        np.testing.assert_array_equal(got.train_idx.numpy()[:TIES],
                                      np.arange(TIES))
        np.testing.assert_array_equal(np.asarray(want[which].train_idx)[:TIES],
                                      np.arange(TIES))
        assert np.all(got.distance.numpy()[:TIES] == 0)
    # (shards, queries): query 0 ties at 1.0 across the shards, so shard
    # 0's row wins and the second best is the tie; query 1's best is shard
    # 1's 1.0, its second best shard 1's 1.5
    d1 = torch.tensor([[1.0, 2.0], [1.0, 1.0]])
    d2 = torch.tensor([[3.0, 2.5], [4.0, 1.5]])
    idx = torch.tensor([[0, 5], [7, 9]])
    bi, bd1, bd2 = merge_top2(d1, d2, idx)
    assert bi.tolist() == [0, 9] and bd1.tolist() == [1.0, 1.0]
    assert bd2.tolist() == [1.0, 1.5]


def test_mesh_health_check(results, mesh2):
    # every rank answers the scalar all_reduce in time, as on sift_tpu's
    # mesh
    port, want = results
    assert want["healthy"] is True
    assert [r["healthy"] for r in port] == [True, True]


def test_mesh_health_check_deadline():
    # a rank that arrives 3 s late fails a 1 s deadline; its own check
    # then completes the pending collective, and a second check passes
    got = run_spmd(jobs.health_deadline_job, 2, backend="gloo",
                   device="cpu", timeout_s=RANK_TIMEOUT_S)
    assert got == [{"late": False, "in_time": True},
                   {"late": True, "in_time": True}]


def test_backend_health_probe():
    # the probe's report has sift_tpu's keys; on this CPU-only host the
    # CUDA probe fails in its child process and says why
    want = jhealth.backend_health(120.0, platform="cpu")
    got = thealth.backend_health(120.0, device="cpu")
    assert want["ok"] and got["ok"]
    assert set(got) == set(want) == {"ok", "backend", "devices", "init_s"}
    assert got["backend"] == want["backend"] == "cpu"
    assert got["devices"] == 1
    if not torch.cuda.is_available():
        bad = thealth.backend_health(120.0)
        assert not bad["ok"] and bad["error"] == "backend_init_failed"
    with pytest.raises(ValueError):
        thealth.backend_health(1.0, device="tpu")


def test_dryrun_on_two_cpu_ranks():
    # the counterpart of __graft_entry__.dryrun_multichip runs its steps
    # and assertions on 2 gloo ranks; without a card it refuses the
    # default --device cuda
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cmd = [sys.executable, "-m", "sift_tpu_torch.parallel.dryrun",
           "--world", "2"]
    proc = subprocess.run(cmd + ["--device", "cpu"], cwd=repo,
                          capture_output=True, text=True,
                          timeout=RANK_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr
    assert "dryrun_multichip(2) on cpu (gloo): OK" in proc.stdout
    if not torch.cuda.is_available():
        proc = subprocess.run(cmd, cwd=repo, capture_output=True, text=True,
                              timeout=RANK_TIMEOUT_S)
        assert proc.returncode == 1 and "no CUDA device" in proc.stderr
