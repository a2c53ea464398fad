"""Device meshes over torch.distributed, and the collectives of the
multi-device layer (twin of sift_tpu/parallel/mesh.py).

sift_tpu runs one program over a jax.sharding.Mesh under shard_map and
reduces with jax.lax collectives. Here each rank is a process of its own
in one torch.distributed world, and this module is the one place that
holds what jax.lax gives the JAX code:

  axis_index, axis_size   this rank's place on the mesh's first axis
  psum                    all_reduce (sum)
  all_gather              tiled along dim 0, in rank order
  ppermute                (source, destination) pairs; a rank that no
                          rank sends to receives zeros

A `Mesh` carries a torch DeviceMesh (one process group per axis), the
axis names ("data" first, as sift_tpu names them), the device its
tensors live on and the world's backend. Every function of parallel/
works on the first axis, as the JAX functions do.

The caller names the backend: gloo on the CPU, NCCL when each rank owns
a card. Nothing switches backends behind the caller's back. The one
combination that needs care, gloo with CUDA tensors (two ranks that
share one card, where NCCL refuses), stages every collective's tensors
through host memory explicitly (`HOST_STAGED`); all compute stays on the
card.

`init_process` joins a world through a FileStore (a file, not a TCP
port, so concurrent test workers never collide); `run_spmd` starts one
process per rank, runs a function on each and joins them all with a
deadline. Neither has a default backend or device; a bare "cuda" given
to `run_spmd` puts rank r on card r % the host's cards (`rank_device`).
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import os
import pickle
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

# collectives whose tensors a gloo world with CUDA tensors copies to the
# host and back
HOST_STAGED = ("psum", "all_gather", "ppermute")
BACKENDS = ("gloo", "nccl")
# CPU threads of a rank process: many ranks share one host (and the test
# suite runs several worker processes), so one each
RANK_THREADS = 1


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A logical mesh of ranks: `shape` over `axis_names`, one process
    group per axis (device_mesh.get_group(name)), tensors on `device`."""
    device_mesh: DeviceMesh
    axis_names: Tuple[str, ...]
    device: torch.device
    backend: str

    @property
    def shape(self) -> dict:
        """{axis name: size}, as jax.sharding.Mesh.shape."""
        return dict(zip(self.axis_names, self.device_mesh.mesh.shape))

    def group(self, axis: Optional[str] = None):
        """The process group of `axis` (default the first)."""
        return self.device_mesh.get_group(axis or self.axis_names[0])

    @property
    def host_staged(self) -> bool:
        """True where collectives copy CUDA tensors through the host."""
        return self.backend == "gloo" and self.device.type == "cuda"


def rank_device(device, rank: int, n_cards: int) -> torch.device:
    """The device of `rank` on a host with `n_cards` cards: a bare
    "cuda" is card rank % n_cards, so that on a host with a card per
    rank each rank owns one (as NCCL needs) and ranks on a one-card host
    share it; any other device is kept as given."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    return torch.device("cuda", rank % n_cards)


def init_process(rank: int, world: int, store_path: str, backend: str,
                 device, timeout_s: float = 300.0) -> None:
    """Join a `world`-rank torch.distributed world as `rank`, through a
    FileStore at `store_path` (fresh for each world). `backend` is
    "gloo" or "nccl" and `device` the rank's device ("cpu", "cuda:i"),
    both as the caller names them; a CUDA device becomes the current
    one."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    dev = torch.device(device)
    if dev.type == "cuda":
        # "cuda" without an index is the process's current card
        torch.cuda.set_device(torch.cuda.current_device() if dev.index is None
                              else dev.index)
    elif backend == "nccl":
        raise ValueError("the nccl backend needs a CUDA device")
    store = dist.FileStore(store_path, world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))


def make_mesh(shape: Sequence[int],
              axis_names: Tuple[str, ...] = ("data", "model"),
              device=None) -> Mesh:
    """A mesh of the given logical shape over the world's ranks, in rank
    order; every rank calls it. Its size must be the world's: a rank is
    a process, and a mesh over part of the world would leave processes
    with no place on it. device: the ranks' tensor device (default: the
    current CUDA device under nccl, else the CPU)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed "
                           "world (init_process)")
    n = int(np.prod(shape))
    world = dist.get_world_size()
    if n > world:
        raise ValueError(f"mesh shape {tuple(shape)} needs {n} devices, "
                         f"have {world}")
    if n < world:
        raise ValueError(f"mesh shape {tuple(shape)} covers {n} of the "
                         f"world's {world} ranks; it must cover them all")
    backend = str(dist.get_backend())
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if backend == "nccl" else torch.device("cpu"))
    device = torch.device(device)
    names = tuple(axis_names[:len(shape)])
    dm = DeviceMesh(device.type, torch.arange(n).reshape(tuple(shape)),
                    mesh_dim_names=names)
    return Mesh(dm, names, device, backend)


def default_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """1-D "data" mesh over the world (n_devices, if given, must be the
    world size)."""
    n = dist.get_world_size() if n_devices is None else n_devices
    return make_mesh((n,), ("data",), device)


def axis_index(mesh: Mesh) -> int:
    """This rank's index along the mesh's first axis."""
    return dist.get_rank(mesh.group())


def axis_size(mesh: Mesh) -> int:
    """The size of the mesh's first axis."""
    return dist.get_world_size(mesh.group())


def _staged(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """x as the collective takes it: on the host for a gloo world with
    CUDA tensors, else x itself; bool as uint8 (gloo and NCCL both take
    bytes)."""
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    return x.cpu() if mesh.host_staged else x


def _unstaged(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A collective's output back on like's device, in like's dtype."""
    return y.to(device=like.device, dtype=like.dtype)


def psum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum of x over the mesh's first axis (jax.lax.psum); x unchanged."""
    y = _staged(mesh, x).clone().reshape(-1)
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=mesh.group())
    return _unstaged(y.reshape(x.shape), x)


def all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """(n0, ...) on each rank -> (axis_size * n0, ...), the ranks' x in
    rank order (jax.lax.all_gather(..., tiled=True)); every rank's x
    has one shape."""
    y = _staged(mesh, x).contiguous()
    parts = [torch.empty_like(y) for _ in range(axis_size(mesh))]
    dist.all_gather(parts, y, group=mesh.group())
    return _unstaged(torch.cat(parts), x)


def ppermute(x: torch.Tensor, mesh: Mesh,
             pairs: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """jax.lax.ppermute along the first axis: for each (src, dst) in
    `pairs`, rank dst receives src's x; a rank that no pair sends to
    receives zeros. Each rank is the source and the destination of at
    most one pair."""
    me = axis_index(mesh)
    group = mesh.group()
    y = _staged(mesh, x).contiguous()
    out = torch.zeros_like(y)
    ops = []
    for src, dst in pairs:
        if src == me:
            ops.append(dist.isend(y, dist.get_global_rank(group, dst),
                                  group=group))
        if dst == me:
            ops.append(dist.irecv(out, dist.get_global_rank(group, src),
                                  group=group))
    for op in ops:
        op.wait()
    return _unstaged(out, x)


def _to_host(obj):
    """obj with every tensor moved to the CPU (tuples, lists, dicts,
    NamedTuples and dataclasses are walked)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _to_host(getattr(obj, f.name))
            for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_to_host(v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    return obj


def _rank_main(rank: int, world: int, store_path: str, backend: str,
               device: str, timeout_s: float, fn: Callable, args: tuple,
               results) -> None:
    """One rank of run_spmd: join the world, run fn(mesh, *args), send
    (rank, ok, pickled result or traceback) to the parent."""
    torch.set_num_threads(RANK_THREADS)
    try:
        device = rank_device(device, rank, torch.cuda.device_count())
        init_process(rank, world, store_path, backend, device, timeout_s)
        try:
            out = fn(default_mesh(device=device), *args)
            msg = (rank, True, pickle.dumps(_to_host(out)))
        finally:
            dist.destroy_process_group()
    except Exception:
        msg = (rank, False, traceback.format_exc())
    results.put(msg)


def run_spmd(fn: Callable, world: int, args: tuple = (), *, backend: str,
             device: str, timeout_s: float = 300.0) -> List:
    """Run fn(mesh, *args) on `world` new rank processes, one per rank,
    on a 1-D "data" mesh with `backend` ("gloo" or "nccl") and `device`
    ("cpu", "cuda:i" for every rank on card i, or "cuda" for card
    rank % the host's cards: rank_device), both required; returns the
    ranks' results in rank order, with tensors on the CPU. fn must be importable by name (a module-level
    function). Each rank pins RANK_THREADS CPU threads. Every rank is
    joined with a deadline: past `timeout_s` the ranks are killed and
    TimeoutError is raised; a rank that fails kills the others and
    raises RuntimeError with its traceback."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="spmd_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True, args=(
            r, world, store, backend, device, timeout_s, fn, args, results))
            for r in range(world)]
        got = {}
        deadline = time.monotonic() + timeout_s
        try:
            for p in procs:
                p.start()
            while len(got) < world:
                try:
                    rank, ok, payload = results.get(timeout=0.2)
                except queue_mod.Empty:
                    dead = [p.exitcode for p in procs
                            if p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"a rank process exited with "
                                           f"{dead[0]} before its result")
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"{world} ranks did not finish "
                                           f"within {timeout_s} s")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{payload}")
                got[rank] = pickle.loads(payload)
        finally:
            for p in procs:
                if p.pid is None:
                    continue              # never started
                p.join(timeout=max(1.0, deadline - time.monotonic())
                       if len(got) == world else 0.5)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
    return [got[r] for r in range(world)]
