"""Functions that run on every rank of a sift_tpu_torch.parallel world
(mesh.run_spmd), for the tests/test_torch_{parallel,spatial,ba_dist}.py
files. They import torch and sift_tpu_torch only: each rank is a fresh
process, and JAX stays in the test process."""

import time

import torch
import torch.distributed as dist

from sift_tpu_torch.parallel import mesh as pm


def mesh_job(mesh):
    """make_mesh's axes and groups on a world of 4, as a (2, 2) mesh; the
    shapes it refuses."""
    m = pm.make_mesh((2, 2))
    refused = []
    for shape in ((8,), (2,)):
        try:
            pm.make_mesh(shape)
        except ValueError as e:
            refused.append(str(e))
    return {"axis_names": m.axis_names, "shape": m.shape,
            "index": pm.axis_index(m), "axis_size": pm.axis_size(m),
            "model_size": dist.get_world_size(m.group("model")),
            "model_index": dist.get_rank(m.group("model")),
            "default": (mesh.axis_names, mesh.shape),
            "psum": pm.psum(torch.tensor([float(dist.get_rank())]), m),
            "refused": refused}


def collectives_job(mesh, x):
    """psum, all_gather and two ppermutes of rank r's x[r]."""
    mine = torch.from_numpy(x[pm.axis_index(mesh)])
    n = pm.axis_size(mesh)
    return {"psum": pm.psum(mine, mesh),
            "all_gather": pm.all_gather(mine, mesh),
            "shift": pm.ppermute(mine, mesh, [(i, i + 1)
                                              for i in range(n - 1)]),
            "ring": pm.ppermute(mine, mesh, [(i, (i + 1) % n)
                                             for i in range(n)]),
            "bool": pm.all_gather(mine > 0.5, mesh)}


def health_deadline_job(mesh):
    """Rank 0 checks with a 1 s deadline while rank 1 arrives 3 s late:
    rank 0 gives up (False), and rank 1's check completes the collective
    rank 0 left pending (True); then both check again in time (True)."""
    from sift_tpu_torch.utils.health import mesh_health_check
    if pm.axis_index(mesh) == 1:
        time.sleep(3.0)
    late = mesh_health_check(mesh, timeout_s=1.0 if pm.axis_index(mesh) == 0
                             else 30.0)
    dist.barrier()
    return {"late": late, "in_time": mesh_health_check(mesh, timeout_s=30.0)}


def front_end_job(mesh, frames, cfg, q, t, t_valid):
    """Frames over the ranks, then both matchers with and without a
    train mask, and the health check."""
    from sift_tpu_torch.parallel.frames import batched_detect_and_compute
    from sift_tpu_torch.parallel.match import (
        sharded_match_ratio, sharded_match_ratio_train_sharded)
    from sift_tpu_torch.utils.health import mesh_health_check
    kp, desc = batched_detect_and_compute(torch.from_numpy(frames), mesh, cfg)
    q, t, tv = (torch.from_numpy(a) for a in (q, t, t_valid))
    return {"frames": (kp, desc),
            "query": sharded_match_ratio(q, t, mesh),
            "train": sharded_match_ratio_train_sharded(q, t, mesh),
            "train_masked": sharded_match_ratio_train_sharded(
                q, t, mesh, t_valid=tv),
            "query_masked": sharded_match_ratio(q, t, mesh, t_valid=tv),
            "healthy": mesh_health_check(mesh)}


def spatial_job(mesh, img, cfg, runs):
    """detect_and_compute_tiled for each (tiled_octaves, halo) of `runs`;
    the ValueError of a band too thin for its halo."""
    from sift_tpu_torch.parallel.spatial import detect_and_compute_tiled
    out = [detect_and_compute_tiled(img, mesh, cfg, tiled_octaves=t,
                                    halo=h) for t, h in runs]
    try:
        detect_and_compute_tiled(img, mesh, cfg, tiled_octaves=2,
                                 halo=img.shape[0])
        thin = None
    except ValueError as e:
        thin = str(e)
    return {"tiled": out, "thin": thin}


def back_end_job(mesh, ba_arrays, graph_arrays, iters, cg_iters):
    """Observation- and point-sharded BA: one LM iteration of 3 CG
    steps, and `iters` of `cg_iters`; the partitioned pose graph and its
    self-test."""
    from sift_tpu_torch.parallel.ba import (bundle_adjust_point_sharded,
                                            bundle_adjust_sharded)
    from sift_tpu_torch.parallel.dryrun import to_graph, to_problem
    from sift_tpu_torch.sfm import posegraph_dist
    prob = to_problem(ba_arrays, mesh.device)
    g = to_graph(graph_arrays, mesh.device)
    posegraph_dist.selftest(mesh)
    out = {"graph": posegraph_dist.optimize_pose_graph_partitioned(
        g, mesh, rounds=8, inner_iters=3)}
    for n, cg in ((1, 3), (iters, cg_iters)):
        out["obs", n] = bundle_adjust_sharded(prob, mesh, iters=n,
                                              cg_iters=cg)
        out["point", n] = bundle_adjust_point_sharded(prob, mesh, iters=n,
                                                      cg_iters=cg)
    return out
