"""Spans inside the program, on the profiler's clock (the port's stage
timing; sift_tpu/utils/profiling.py is its JAX counterpart).

    with span("sift.refine", octave=o):
        ...

    with span("geometry.pnp", n=n, graph_hit=False) as sp:
        ...
        sp.set(graph_hit=True)     # an attribute known at the end

A span records its name, its start and end on `time.time_ns()` (the
Unix clock that torch.profiler's kineto events carry), the id of the
span it opened inside, its trace id (the id of its root span) and its
attributes. Spans record while `tracing()` is open or while a torch
profiler records; under a profiler each span also opens a profiler
range of its name, so that it sits in the profiler's trace beside the
device work it dispatched, as a host event. The range is a CPU-op range
(`torch._C._profiler._RecordFunctionFast`), not
`torch.profiler.record_function`: that one is a user annotation, for
which the profiler also puts one range per span on the device's
timeline, among the device events. Otherwise `span` makes one check and
returns a shared no-op.

A span never synchronises, reads a device value, launches device work
or allocates on the device, so it is safe inside a CUDA-graph capture.
Its times are host times: the dispatch of the work inside, plus any
wait for the card that the code inside makes itself. A caller that
wants device work inside its own wall time synchronises itself
(`sync`).

The records live in a ring of RING spans; `dropped()` counts the ones
it pushed out. `summary()` and `report()` give host ms by span name.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import threading
import time
from typing import Any, Dict, Iterator, List, NamedTuple, Optional

import torch

RING = 65536


class Span(NamedTuple):
    """One finished span; times in ns on time.time_ns()."""
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]    # the enclosing span's id; None for a root
    trace: int               # the root span's id
    attrs: Dict[str, Any]


class _Off:
    """The span of a program that is not traced: does nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


_OFF = _Off()
_profiler_enabled = torch.autograd._profiler_enabled
_lock = threading.Lock()
_local = threading.local()           # .stack: this thread's open spans
_ids = itertools.count(1)
_ring: collections.deque = collections.deque(maxlen=RING)
_dropped = 0
_forced = 0                          # open tracing() blocks


class _Live:
    """A span that records."""
    __slots__ = ("name", "attrs", "prof", "id", "parent", "trace", "start",
                 "rf")

    def __init__(self, name: str, attrs: Dict[str, Any], prof: bool):
        self.name = name
        self.attrs = attrs
        self.prof = prof

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.id = next(_ids)
        if stack:
            self.parent, self.trace = stack[-1].id, stack[-1].trace
        else:
            self.parent, self.trace = None, self.id
        stack.append(self)
        self.rf = None
        self.start = time.time_ns()
        if self.prof:
            self.rf = torch._C._profiler._RecordFunctionFast(self.name)
            self.rf.__enter__()
        return self

    def set(self, **attrs):
        """Set attributes known only inside the span (a result's count,
        whether a cache hit)."""
        self.attrs.update(attrs)

    def __exit__(self, *exc):
        global _dropped
        try:
            if self.rf is not None:
                self.rf.__exit__(*exc)
        finally:
            end = time.time_ns()
            _local.stack.pop()
            rec = Span(self.name, self.start, end, self.id, self.parent,
                       self.trace, self.attrs)
            with _lock:
                if len(_ring) == RING:
                    _dropped += 1
                _ring.append(rec)
        return False


def span(name: str, **attrs):
    """A context manager around one stage of the program: records when
    tracing is on, else the shared no-op."""
    prof = _profiler_enabled()
    if not (_forced or prof):
        return _OFF
    return _Live(name, attrs, prof)


@contextlib.contextmanager
def tracing():
    """Record spans inside the block (also without a profiler)."""
    global _forced
    with _lock:
        _forced += 1
    try:
        yield
    finally:
        with _lock:
            _forced -= 1


def spans() -> List[Span]:
    """The recorded spans, oldest first (a span is recorded when it
    ends, so an inner span comes before the one it ran inside)."""
    with _lock:
        return list(_ring)


def dropped() -> int:
    """Spans the ring pushed out since the last clear()."""
    return _dropped


def clear() -> None:
    global _dropped
    with _lock:
        _ring.clear()
        _dropped = 0


def summary() -> Dict[str, Dict[str, float]]:
    """Host ms by span name, in the order each name first started:
    calls, total_ms, and self_ms (total less the spans directly inside).
    A span with an `octave` attribute also counts under
    `<name>/octave<o>`."""
    recs = spans()
    inner: Dict[int, int] = collections.Counter()
    for s in recs:
        if s.parent is not None:
            inner[s.parent] += s.end_ns - s.start_ns
    out: Dict[str, Dict[str, float]] = {}
    for s in sorted(recs, key=lambda s: s.start_ns):
        total = s.end_ns - s.start_ns
        keys = [s.name]
        if "octave" in s.attrs:
            keys.append(f"{s.name}/octave{s.attrs['octave']}")
        for k in keys:
            row = out.setdefault(k, {"calls": 0, "total_ms": 0.0,
                                     "self_ms": 0.0})
            row["calls"] += 1
            row["total_ms"] += total * 1e-6
            row["self_ms"] += (total - inner[s.id]) * 1e-6
    return out


def report() -> str:
    """summary() as one line a name."""
    return "\n".join(
        f"{k:>28s}: {v['total_ms']:10.3f} ms total {v['self_ms']:10.3f} "
        f"ms self {v['calls']:6d} calls" for k, v in summary().items())


def _tensors(tree) -> Iterator[torch.Tensor]:
    """Every tensor in a nest of tuples, lists, dicts and dataclasses."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))


def sync(tree) -> None:
    """Wait for the work behind every CUDA tensor in `tree` (one
    torch.cuda.synchronize per device); a no-op for CPU tensors."""
    devices = {t.device for t in _tensors(tree) if t.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)
