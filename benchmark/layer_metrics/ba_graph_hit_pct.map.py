"""ba_graph_hit_pct.map: the share, in %, of a request's `sfm.ba` spans
whose `graph_hit` attribute is true, i.e. bundle adjustments in which
every Levenberg-Marquardt iteration replayed a cached CUDA graph
(sift_tpu_torch/sfm/ba.py through geometry/graphs.py) rather than
dispatching its kernels one by one. Over the profiled requests under
`mapping.run`; None where the program records no such span or the spans
carry no `graph_hit`."""

from benchmark.layer_metrics.program import _spans


def read(trace):
    recs = _spans(trace, "mapping.run")
    if recs is None:
        return None
    calls = [s for s in recs if s.name == "sfm.ba"]
    if not calls or any("graph_hit" not in s.attrs for s in calls):
        return None
    return 100.0 * sum(bool(s.attrs["graph_hit"]) for s in calls) / len(calls)
