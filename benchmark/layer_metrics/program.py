"""Readers of the program's own spans (sift_tpu_torch.utils.profiling).

The program records spans while a torch profiler records, so after a
traced run the store holds the spans of exactly the profiled requests
(run.profile_requests). Each number is host ms per profiled request:
durations summed over the store, divided by the profile's `steps`. A
reader gives None when the program has no such store (a tree before
the tracer), the store is empty, or the request's root spans do not
number `steps` (spans that are not the profiled requests')."""

from __future__ import annotations

from typing import Iterable, List, Optional


def _spans(trace, root: str) -> Optional[List]:
    """The store's spans, if it holds `steps` spans named `root`."""
    try:
        from sift_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    p = trace.profile
    if read is None or not p or not p.get("steps"):
        return None
    recs = read()
    if sum(1 for s in recs if s.name == root) != p["steps"]:
        return None
    return recs


def _ms_per_step(trace, recs: Iterable) -> float:
    ns = sum(s.end_ns - s.start_ns for s in recs)
    return ns * 1e-6 / trace.profile["steps"]


def host_ms(trace, root: str, names: Iterable[str]) -> Optional[float]:
    """Host ms a request spends in the spans named `names` (every
    octave, every image of the request)."""
    recs = _spans(trace, root)
    if recs is None:
        return None
    names = set(names)
    return _ms_per_step(trace, (s for s in recs if s.name in names))


def host_wait_ms(trace, root: str) -> Optional[float]:
    """The profiled wall time per request less the host ms of its root
    spans (those opened inside no other span): the time the host spent
    outside the program, mostly waiting for the card at the request's
    synchronisation."""
    recs = _spans(trace, root)
    if recs is None:
        return None
    wall_ms = 1e3 * trace.profile["window_s"] / trace.profile["steps"]
    return wall_ms - _ms_per_step(trace, (s for s in recs
                                          if s.parent is None))
