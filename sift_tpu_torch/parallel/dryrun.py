"""Multi-device dry run (counterpart of __graft_entry__.dryrun_multichip).

    python -m sift_tpu_torch.parallel.dryrun --world N --device cuda|cpu \
        [--backend gloo|nccl]

Starts N rank processes and runs on each, at tiny shapes, the steps,
sizes and assertions of sift_tpu's dry run: data-parallel frames for
detect+describe, both sharded matchers, observation- and point-sharded
bundle adjustment, the partitioned pose graph and the spatially tiled
detector against the single-device one. The inputs come from one
numpy seed in the same order as sift_tpu's (the helpers below make
them). It refuses to start without a card unless given --device cpu.
With --device cuda, rank r runs on card r % the host's cards. The
backend defaults to nccl on cuda and gloo on cpu; N ranks on a host with
fewer than N cards share cards, which needs --backend gloo.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from sift_tpu_torch.config import SIFTConfig

# sift_tpu's dry-run configurations (__graft_entry__.py:43-45, 153-154)
FRAMES_CFG = SIFTConfig(detect_caps=(64, 32, 16, 8, 8),
                        out_caps=(64, 32, 16, 8, 8), max_keypoints=128)
TILED_CFG = SIFTConfig(detect_caps=(64, 32, 16, 8, 8),
                       out_caps=(32, 16, 8, 8, 8), max_keypoints=72)
TIMEOUT_S = 600.0      # the ranks' deadline


def ba_problem_arrays(rng, n_cams: int = 4, n_pts: int = 32,
                      n_obs: int = 128) -> dict:
    """The dry run's synthetic, convergent BA problem as numpy arrays
    (the draws of __graft_entry__.py:75-88, in their order)."""
    pts = np.stack([rng.uniform(-1, 1, n_pts), rng.uniform(-1, 1, n_pts),
                    rng.uniform(4, 8, n_pts)], 1).astype(np.float32)
    cams = np.zeros((n_cams, 6), np.float32)
    cams[:, 3] = np.linspace(-0.5, 0.5, n_cams)
    cam_idx = rng.integers(0, n_cams, n_obs).astype(np.int32)
    pt_idx = rng.integers(0, n_pts, n_obs).astype(np.int32)
    xc = pts[pt_idx] + cams[cam_idx][:, 3:]
    uv = (xc[:, :2] / xc[:, 2:3]).astype(np.float32)
    fixed = np.zeros(n_cams, bool)
    fixed[0] = True
    cams0 = cams + rng.normal(0, 0.01, cams.shape).astype(np.float32) \
        * ~fixed[:, None]
    return dict(cameras=cams0, points=pts, cam_idx=cam_idx, pt_idx=pt_idx,
                uv=uv, mask=np.ones(n_obs, bool), fixed_cams=fixed)


def chain_graph_arrays(rng, nv: int) -> dict:
    """The dry run's noisy chain pose graph as numpy arrays
    (__graft_entry__.py:116-130)."""
    poses = np.zeros((nv, 6), np.float32)
    poses[:, 3] = np.arange(nv) * 0.3
    ei = np.arange(nv - 1, dtype=np.int32)
    rel = np.zeros((nv - 1, 6), np.float32)
    rel[:, 3] = 0.3
    return dict(poses=poses + rng.normal(0, 0.02, poses.shape)
                .astype(np.float32),
                edges_i=ei, edges_j=ei + 1, rel=rel,
                weight=np.ones(nv - 1, np.float32),
                mask=np.ones(nv - 1, bool), fixed=np.arange(nv) == 0)


def to_problem(arrays: dict, device):
    from sift_tpu_torch.sfm.ba import BAProblem
    t = {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
    for k in ("cam_idx", "pt_idx"):
        t[k] = t[k].long()
    return BAProblem(**t)


def to_graph(arrays: dict, device):
    from sift_tpu_torch.sfm.posegraph import PoseGraph
    t = {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
    for k in ("edges_i", "edges_j"):
        t[k] = t[k].long()
    return PoseGraph(**t)


def xy_set(kp) -> set:
    """{(x, y)} of the valid keypoints, rounded to 1e-3 (the dry run's
    comparison)."""
    v = kp.valid.cpu().numpy()
    return {(round(float(x), 3), round(float(y), 3))
            for x, y in zip(kp.x.cpu().numpy()[v], kp.y.cpu().numpy()[v])}


def _check(ok: bool, *info) -> None:
    if not ok:
        raise AssertionError(info)


def dryrun(mesh) -> dict:
    """The dry run's steps on this rank; raises AssertionError on a
    miss. Returns the numbers it checked."""
    from sift_tpu_torch import sift
    from sift_tpu_torch.parallel.ba import (bundle_adjust_point_sharded,
                                            bundle_adjust_sharded)
    from sift_tpu_torch.parallel.frames import batched_detect_and_compute
    from sift_tpu_torch.parallel.match import (
        sharded_match_ratio, sharded_match_ratio_train_sharded)
    from sift_tpu_torch.parallel.mesh import axis_size
    from sift_tpu_torch.parallel.spatial import detect_and_compute_tiled
    from sift_tpu_torch.sfm.ba import reproj_rmse
    from sift_tpu_torch.sfm.posegraph import pose_graph_cost
    from sift_tpu_torch.sfm.posegraph_dist import \
        optimize_pose_graph_partitioned

    n = axis_size(mesh)
    dev = mesh.device
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.random((n, 48, 64), np.float32) * 255)
    kp, desc = batched_detect_and_compute(frames, mesh, FRAMES_CFG)
    _check(tuple(desc.shape) == (n, 128, 128), desc.shape)

    # cross-frame matching, both layouts (frames 0 and 1; one frame on a
    # world of one matches against itself)
    j = 1 % n
    m1 = sharded_match_ratio(desc[0], desc[j], mesh, q_valid=kp.valid[0],
                             t_valid=kp.valid[j])
    m2 = sharded_match_ratio_train_sharded(desc[0], desc[j], mesh,
                                           q_valid=kp.valid[0],
                                           t_valid=kp.valid[j])
    _check(m1.good.shape == m2.good.shape == (128,)
           and torch.equal(m1.good, m2.good), m1.good, m2.good)

    prob = to_problem(ba_problem_arrays(rng), dev)
    rmse_in = float(reproj_rmse(prob))
    rmse_obs = float(reproj_rmse(bundle_adjust_sharded(prob, mesh, iters=4,
                                                       cg_iters=10)))
    _check(np.isfinite(rmse_obs) and rmse_obs < rmse_in, rmse_obs, rmse_in)
    rmse_pt = float(reproj_rmse(bundle_adjust_point_sharded(
        prob, mesh, iters=4, cg_iters=10)))
    _check(np.isfinite(rmse_pt) and rmse_pt < rmse_in, rmse_pt, rmse_in)

    g = to_graph(chain_graph_arrays(rng, 2 * n), dev)
    cost_in = float(pose_graph_cost(g))
    cost_out = float(pose_graph_cost(optimize_pose_graph_partitioned(
        g, mesh, rounds=4, inner_iters=3)))
    _check(np.isfinite(cost_out) and cost_out < cost_in, cost_out, cost_in)

    # one frame row-split over the whole mesh must give the
    # single-device keypoints
    img = torch.from_numpy(rng.random((n * 64, 128), np.float32) * 255)
    kp_t, _ = detect_and_compute_tiled(img, mesh, TILED_CFG,
                                       tiled_octaves=1, halo=48)
    kp_1, _ = sift.detect_and_compute(img.to(dev), TILED_CFG)
    st, s1 = xy_set(kp_t), xy_set(kp_1)
    _check(st == s1, len(st), len(s1))
    return {"ranks": n, "good": int(m1.good.sum()), "rmse_in": rmse_in,
            "rmse_obs": rmse_obs, "rmse_pt": rmse_pt, "cost_in": cost_in,
            "cost_out": cost_out, "tiled_keypoints": len(st)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="sift_tpu_torch.parallel.dryrun")
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--backend", choices=["gloo", "nccl"], default=None,
                    help="default: nccl with --device cuda, gloo with cpu")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("dryrun: no CUDA device (use --device cpu to run on the CPU)",
              file=sys.stderr)
        return 1
    from sift_tpu_torch.parallel.mesh import run_spmd
    # by its module's name, so the rank processes can unpickle it
    from sift_tpu_torch.parallel.dryrun import dryrun as rank_fn
    backend = args.backend or ("nccl" if args.device == "cuda" else "gloo")
    # a bare "cuda": rank r on card r % the host's cards
    out = run_spmd(rank_fn, args.world, backend=backend, device=args.device,
                   timeout_s=TIMEOUT_S)
    print(f"dryrun rank results: {out}")
    print(f"dryrun_multichip({args.world}) on {args.device} "
          f"({backend}): OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
