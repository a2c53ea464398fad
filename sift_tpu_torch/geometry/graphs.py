"""CUDA graphs of the geometry layer's sync-free stretches, cached by shape.

A RANSAC call of the mapping path dispatches thousands of small kernels
(the 5-point solver's 80 Durand-Kerner steps, the Sampson scoring over
every candidate, the jacfwd of each Gauss-Newton polish), and on the
card the host's dispatch, not the kernels, sets its pace. Some stretches
of such a call neither wait for the card nor copy from the host.
`GraphCache.run` replays each of them as one CUDA graph:

  * an input on the CPU: the stretch runs eagerly and the cache is not
    touched;
  * a key seen for the first time (a miss): the stretch runs eagerly and
    that result is the result. Then it is captured on static copies of
    its inputs, replayed once, and kept only if the replay gives the
    eager result bit for bit; a key whose capture raises or whose replay
    differs runs eagerly from then on (`refused`);
  * a key seen before (a hit): the inputs are copied into the static
    buffers, the graph replays on the current stream and the outputs are
    handed back as clones (the next replay overwrites the static ones).

A graph replays the very kernels the eager path launches, with the same
arguments, so it gives the same bits. Each static input keeps its
input's strides and storage offset, so every kernel sees the layout and
alignment that the eager run saw; the check at capture makes the equality
a fact of each key, not an assumption (a library could choose another
algorithm under capture).

The key: the stretch's name, each input's shape, strides, storage offset,
dtype and device, and the Python scalars the stretch bakes into its
kernels. A stretch is a function `fn(*tensors, *scalars)` returning a
tensor or a tuple of tensors; it must make no host synchronisation and
copy nothing from the host (a constant it needs is cached on the device
beforehand). The callers pad their inputs to power-of-two capacities, so
a process meets a handful of keys; each holds its graph, in a memory pool
that the device's graphs share, until `clear()`.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

Capture = Callable[[Callable, Sequence, dict],
                   Tuple[Callable[[], None], tuple]]


def _cuda_capture(fn: Callable, args: Sequence, pools: dict):
    """Capture fn(*args) into a CUDA graph on a side stream:
    (replay, the static outputs).

    Every graph of a device allocates from one memory pool, `pools`'
    entry for the device (made here at the device's first capture), so
    the cache holds about the largest stretch's working memory, not the
    sum over its keys. Graphs then overwrite each other's intermediates
    and outputs, which is safe because replays run one at a time on the
    current stream, each followed by clones of its outputs, and because
    the static inputs and the clones lie outside the pool."""
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    if dev not in pools:
        pools[dev] = torch.cuda.graph_pool_handle()
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        graph.capture_begin(pool=pools[dev],
                            capture_error_mode="thread_local")
        try:
            outs = fn(*args)
        finally:
            graph.capture_end()
    torch.cuda.current_stream(dev).wait_stream(stream)
    return graph.replay, outs


def _all_cuda(tensors: Sequence[torch.Tensor]) -> bool:
    return all(t.is_cuda for t in tensors)


def _static_like(t: torch.Tensor) -> torch.Tensor:
    """An uninitialised tensor with t's shape, strides, storage offset,
    dtype and device."""
    extent = 1 + sum((n - 1) * s for n, s in zip(t.shape, t.stride())) \
        if t.numel() else 0
    base = torch.empty(t.storage_offset() + extent, dtype=t.dtype,
                       device=t.device)
    return base.as_strided(t.shape, t.stride(), t.storage_offset())


def same_bits(a, b) -> bool:
    """Whether two tensors (or tuples of tensors) hold the same bits:
    dtype, shape and every byte (a NaN equals a NaN of the same bits)."""
    if isinstance(a, torch.Tensor):
        a, b = (a,), (b,)
    return len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(x.reshape(-1).view(torch.uint8),
                        y.reshape(-1).view(torch.uint8))
        for x, y in zip(a, b))


class GraphCache:
    """Captured stretches by key, and counts of what `run` did: `misses`
    (keys captured, each run eagerly the first time), `hits` (calls
    replayed from the cache), `replays` (graph replays, the check at each
    capture included) and `refused` (keys left eager)."""

    def __init__(self, capture: Capture = _cuda_capture,
                 on_card: Callable[[Sequence[torch.Tensor]], bool]
                 = _all_cuda):
        self._capture = capture
        self._on_card = on_card
        self._graphs: Dict[tuple, Optional[tuple]] = {}
        self._pools: dict = {}
        self.hits = self.misses = self.replays = self.refused = 0

    def run(self, name: str, fn: Callable, tensors: Sequence[torch.Tensor],
            scalars: Sequence = ()):
        """fn(*tensors, *scalars), replayed from a graph where the inputs
        are on the card and the key was captured before."""
        if not self._on_card(tensors):
            return fn(*tensors, *scalars)
        key = (name, tuple((tuple(t.shape), t.stride(), t.storage_offset(),
                            t.dtype, t.device) for t in tensors),
               tuple(scalars))
        if key not in self._graphs:
            self.misses += 1
            out = fn(*tensors, *scalars)
            self._graphs[key] = self._capture_checked(fn, tensors, scalars,
                                                      out)
            return out
        entry = self._graphs[key]
        if entry is None:
            return fn(*tensors, *scalars)
        static, replay, outs = entry
        for s, t in zip(static, tensors):
            s.copy_(t)
        replay()
        self.hits += 1
        self.replays += 1
        if isinstance(outs, torch.Tensor):
            return outs.clone()
        return tuple(o.clone() for o in outs)

    def _capture_checked(self, fn, tensors, scalars, want):
        """(static inputs, replay, static outputs) of fn, or None where
        the capture raises or its replay differs from `want`."""
        static = [_static_like(t) for t in tensors]
        for s, t in zip(static, tensors):
            s.copy_(t)
        try:
            replay, outs = self._capture(fn, (*static, *scalars),
                                         self._pools)
            replay()
            self.replays += 1
            if same_bits(outs, want):
                return static, replay, outs
        except RuntimeError:
            pass
        # the refused graph may have been its pool's only one, and a pool
        # without graphs takes no capture: the next capture starts another
        self.refused += 1
        self._pools = {}
        return None

    def clear(self) -> None:
        """Drop every graph and zero the counts. The pools go too: a pool
        whose graphs are all gone takes no new capture (the allocator
        asserts that a shared pool is live), so the next captures start a
        new one."""
        self._graphs.clear()
        self._pools = {}
        self.hits = self.misses = self.replays = self.refused = 0

    def keys(self):
        return list(self._graphs)


# the process's cache, shared by the geometry solvers
CACHE = GraphCache()
