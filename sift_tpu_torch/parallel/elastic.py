"""Elastic recovery: supervised, checkpointed BA that shrinks on failure
(twin of sift_tpu/parallel/elastic.py).

`utils.health.mesh_health_check` DETECTS a dead or wedged rank, but a
world cannot drop a rank and go on, so the recovery unit is the
incarnation: a group of `n` rank processes.

  * worker (this module run with ``--worker --rank r --world n``): one
    rank of an incarnation. It joins the world through a FileStore,
    loads the latest checkpoint (or the initial problem), runs the
    observation-sharded Schur/CG BA (parallel/ba.py) in chunks, and rank
    0 writes a checkpoint after each chunk, before any rank goes on.
    Divergence (non-finite state) exits nonzero BEFORE checkpointing, so
    a poisoned state is never kept.
  * ``supervise_ba`` starts the n ranks, and on ANY nonzero exit of one
    of them -- a crash, a SIGKILL from outside, an injected fault -- or
    on the deadline, kills the others and starts a new incarnation with
    n halved (floor ``min_devices``), resuming from the last good
    checkpoint. A failed incarnation costs at most one chunk.

Where sift_tpu pins --xla_force_host_platform_device_count to simulate a
shrunken device set, the supervisor passes the world size. The caller
names the device and the backend, the latter for every world size at
once or per size (a dict): two ranks that share one card need gloo, one
rank may take NCCL.

Fault injection for tests: ``inject_crash_step`` makes every rank of the
FIRST incarnation exit (os._exit(17)) right after the checkpoint of that
step; ``on_spawn(popen)``, called for each rank's process, lets a test
reach a live rank (e.g. to SIGKILL it).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, Optional, Tuple, Union

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _worker_main(args) -> int:
    import torch
    import torch.distributed as dist
    from sift_tpu_torch.parallel.ba import bundle_adjust_sharded
    from sift_tpu_torch.parallel.mesh import (RANK_THREADS, default_mesh,
                                              init_process, rank_device)
    from sift_tpu_torch.sfm import checkpoint as ck
    from sift_tpu_torch.utils.health import tree_all_finite

    torch.set_num_threads(RANK_THREADS)
    device = rank_device(args.device, args.rank, torch.cuda.device_count())
    init_process(args.rank, args.world, args.store, args.backend, device)
    try:
        mesh = default_mesh(device=device)
        last = ck.latest(args.ckpt_dir)
        prob, step = ck.load_ba(last or args.problem, device=mesh.device)
        print(f"ELASTIC_WORKER rank={args.rank} world={args.world} "
              f"backend={args.backend} resume_step={step}", flush=True)
        while step < args.total_iters:
            k = min(args.chunk_iters, args.total_iters - step)
            out = bundle_adjust_sharded(prob, mesh, iters=k,
                                        cg_iters=args.cg_iters)
            if not tree_all_finite((out.cameras, out.points)):
                print("ELASTIC_DIVERGED", flush=True)
                return 3                  # do not checkpoint poison
            step += k
            if args.rank == 0:
                ck.save_ba_step(args.ckpt_dir, out, step)
            dist.barrier()                # the checkpoint is on disk
            print(f"ELASTIC_CHUNK step={step}", flush=True)
            prob = out
            if args.crash_after_step is not None \
                    and step >= args.crash_after_step:
                os._exit(17)              # injected fault (tests)
        print(f"ELASTIC_DONE step={step}", flush=True)
        return 0
    finally:
        dist.destroy_process_group()


def _wait_all(procs, timeout_s: float) -> list:
    """Exit codes of the rank processes once all have exited, or as soon
    as one exits nonzero or the deadline passes; then the rest are
    killed (their code is the kill's)."""
    deadline = time.monotonic() + timeout_s
    while True:
        codes = [p.poll() for p in procs]
        if all(c == 0 for c in codes):
            return codes
        if any(c not in (None, 0) for c in codes) \
                or time.monotonic() > deadline:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            return [p.wait() for p in procs]
        time.sleep(0.05)


def supervise_ba(problem_path: str, ckpt_dir: str, *,
                 backend: Union[str, Dict[int, str]], device: str,
                 total_iters: int = 16, chunk_iters: int = 4,
                 cg_iters: int = 10,
                 n_devices: int = 8, min_devices: int = 1,
                 max_restarts: int = 4,
                 inject_crash_step: Optional[int] = None,
                 worker_timeout: float = 600.0,
                 on_spawn=None) -> Tuple[str, int]:
    """Run the elastic BA to completion; returns (final checkpoint path,
    restart count). Both required: an incarnation of n ranks runs on
    `device` ("cpu"; "cuda:i" for every rank on card i; "cuda" for card
    rank % the host's cards, mesh.rank_device) with `backend`, a name or
    {world size: name}."""
    from sift_tpu_torch.sfm import checkpoint as ck
    restarts = 0
    n = n_devices
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    while True:
        name = backend if isinstance(backend, str) else backend[n]
        with tempfile.TemporaryDirectory(prefix="elastic_") as tmp:
            cmd = [sys.executable, "-m", "sift_tpu_torch.parallel.elastic",
                   "--worker", "--world", str(n),
                   "--store", os.path.join(tmp, "store"),
                   "--problem", problem_path, "--ckpt-dir", ckpt_dir,
                   "--total-iters", str(total_iters),
                   "--chunk-iters", str(chunk_iters),
                   "--cg-iters", str(cg_iters), "--backend", name,
                   "--device", device]
            if inject_crash_step is not None and restarts == 0:
                cmd += ["--crash-after-step", str(inject_crash_step)]
            logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+")
                    for r in range(n)]
            try:
                procs = [subprocess.Popen(cmd + ["--rank", str(r)], env=env,
                                          stdout=log,
                                          stderr=subprocess.STDOUT)
                         for r, log in enumerate(logs)]
                if on_spawn is not None:
                    for p in procs:
                        on_spawn(p)
                codes = _wait_all(procs, worker_timeout)
                out = []
                for r, log in enumerate(logs):
                    log.seek(0)
                    out.append(f"--- rank {r} (exit {codes[r]}):\n"
                               f"{log.read()}")
            finally:
                for log in logs:
                    log.close()
        if all(c == 0 for c in codes):
            final = ck.latest(ckpt_dir)
            if final is None:
                raise RuntimeError("worker finished without checkpoint")
            return final, restarts
        restarts += 1
        if restarts > max_restarts:
            raise RuntimeError(
                f"elastic BA failed after {max_restarts} restarts; last "
                f"incarnation's output:\n" + "\n".join(out))
        n = max(min_devices, n // 2)      # lost participant -> re-shard


def _parse(argv=None):
    ap = argparse.ArgumentParser(prog="sift_tpu_torch.parallel.elastic")
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--problem", required=True)
    ap.add_argument("--ckpt-dir", required=True, dest="ckpt_dir")
    ap.add_argument("--total-iters", type=int, default=16,
                    dest="total_iters")
    ap.add_argument("--chunk-iters", type=int, default=4,
                    dest="chunk_iters")
    ap.add_argument("--cg-iters", type=int, default=10, dest="cg_iters")
    ap.add_argument("--backend", required=True, choices=["gloo", "nccl"])
    ap.add_argument("--device", required=True)
    ap.add_argument("--crash-after-step", type=int, default=None,
                    dest="crash_after_step")
    return ap.parse_args(argv)


if __name__ == "__main__":
    a = _parse()
    if not a.worker:
        print("run with --worker (the supervisor is supervise_ba())",
              file=sys.stderr)
        sys.exit(2)
    sys.exit(_worker_main(a))
