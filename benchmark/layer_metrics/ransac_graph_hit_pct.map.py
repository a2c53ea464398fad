"""ransac_graph_hit_pct.map: the share, in %, of a request's
`geometry.essential` and `geometry.pnp` spans whose `graph_hit` attribute
is true, i.e. calls in which every sync-free stretch replayed a cached
CUDA graph (sift_tpu_torch/geometry/graphs.py) rather than dispatching
its kernels one by one. Over the profiled requests under `mapping.run`;
None where the program records no such span or the spans carry no
`graph_hit`."""

from benchmark.layer_metrics.program import _spans

NAMES = ("geometry.essential", "geometry.pnp")


def read(trace):
    recs = _spans(trace, "mapping.run")
    if recs is None:
        return None
    calls = [s for s in recs if s.name in NAMES]
    if not calls or any("graph_hit" not in s.attrs for s in calls):
        return None
    return 100.0 * sum(bool(s.attrs["graph_hit"]) for s in calls) / len(calls)
