"""Failure detection and recovery helpers (twin of
sift_tpu/utils/health.py).

Non-finite detection on device state, a restartable BA (re-run with
stronger damping instead of passing on a diverged solve), a mesh health
check (every rank proves liveness through one scalar all_reduce with a
deadline) and a bounded probe of the CUDA backend in a subprocess.
"""

from __future__ import annotations

import dataclasses
import datetime
import subprocess
import sys
from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

from sift_tpu_torch.sfm.ba import BAProblem, bundle_adjust, reproj_rmse


def _leaves(tree):
    """The tensors and arrays of a tree of tuples, lists, dicts,
    NamedTuples and dataclasses."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        yield tree
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name))
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def tree_all_finite(tree) -> bool:
    """True iff every float tensor or array of the tree is finite (one
    host read per float leaf)."""
    for leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            if leaf.is_floating_point() and not bool(leaf.isfinite().all()):
                return False
        elif leaf.dtype.kind == "f" and not np.isfinite(leaf).all():
            return False
    return True


def assert_finite(tree, name: str = "state") -> None:
    if not tree_all_finite(tree):
        raise FloatingPointError(f"non-finite values in {name}")


def mesh_health_check(mesh, timeout_s: float = 30.0) -> bool:
    """True iff every rank of the mesh's first axis answers one scalar
    all_reduce within the deadline (Work.wait(timeout=...)); every rank
    calls it.

    A False return does not tell a dead rank from a wedged backend: the
    collective may still be pending, and device work from the same
    process can block behind it. Treat False as "this process's view of
    the mesh is unusable" and restart the process (parallel/elastic.py),
    rather than retrying in place."""
    from sift_tpu_torch.parallel.mesh import axis_size
    n = axis_size(mesh)
    dev = torch.device("cpu") if mesh.host_staged else mesh.device
    x = torch.ones((1,), dtype=torch.float32, device=dev)
    try:
        work = dist.all_reduce(x, group=mesh.group(), async_op=True)
        work.wait(timeout=datetime.timedelta(seconds=timeout_s))
    except RuntimeError:          # a timed-out or failed collective
        return False
    return float(x.item()) == n


_BACKEND_PROBE_SRC = """
import time
t0 = time.time()
import torch
dev = __DEV__
n = torch.cuda.device_count() if dev == "cuda" else 1
x = torch.ones((256, 256), dtype=torch.bfloat16, device=dev)
v = float((x @ x)[0, 0])
assert v == 256.0, v
print(f"{dev} {n} {time.time() - t0:.1f}")
"""


def backend_health(timeout_s: float = 180.0, device: str = "cuda") -> dict:
    """Bounded backend init + tiny-matmul probe in a subprocess (a
    wedged CUDA runtime can block its init, so the probe lives in a
    killable child). Returns {"ok": True, "backend", "devices",
    "init_s"} or {"ok": False, "error", "detail"}; does not initialise
    CUDA in this process. device: "cuda" (default) or "cpu"."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    src = _BACKEND_PROBE_SRC.replace("__DEV__", repr(device))
    try:
        r = subprocess.run([sys.executable, "-c", src],
                           capture_output=True, text=True, timeout=timeout_s)
    except subprocess.TimeoutExpired:
        return {"ok": False, "error": "backend_init_timeout",
                "detail": f"no {device} backend within {timeout_s:.0f}s"}
    if r.returncode != 0:
        tail = (r.stderr.strip().splitlines() or ["unknown"])[-1]
        return {"ok": False, "error": "backend_init_failed",
                "detail": tail[:500]}
    # the LAST stdout line is the probe's: libraries may print before it
    backend, ndev, init_s = r.stdout.strip().splitlines()[-1].split()[-3:]
    return {"ok": True, "backend": backend, "devices": int(ndev),
            "init_s": float(init_s)}


def bundle_adjust_restartable(prob: BAProblem, iters: int = 20,
                              cg_iters: int = 30,
                              huber_delta: float = 3e-3,
                              loss: str = "huber",
                              max_restarts: int = 2
                              ) -> Tuple[BAProblem, int]:
    """BA that detects a diverged or non-finite result and retries with
    100x the damping from the last good state. Returns (result,
    restarts); past max_restarts, (prob, max_restarts + 1)."""
    lam0 = 1e-3
    rmse_in = float(reproj_rmse(prob))
    for attempt in range(max_restarts + 1):
        out = bundle_adjust(prob, iters=iters, cg_iters=cg_iters,
                            huber_delta=huber_delta, loss=loss, lam0=lam0)
        rmse_out = float(reproj_rmse(out))
        if tree_all_finite((out.cameras, out.points)) and \
                np.isfinite(rmse_out) and rmse_out <= rmse_in * 1.001:
            return out, attempt
        lam0 *= 100.0
    return prob, max_restarts + 1


if __name__ == "__main__":
    import json
    rep = backend_health(float(sys.argv[1]) if len(sys.argv) > 1 else 180.0,
                         sys.argv[2] if len(sys.argv) > 2 else "cuda")
    print(json.dumps(rep))
    sys.exit(0 if rep["ok"] else 1)
