"""sfm_ransac_host_ms.map: host ms a request spends in the program's
`geometry.essential` and `geometry.pnp` spans (every essential-matrix and
PnP RANSAC of the request: the two-view init and its check, each view's
registration, each loop-closure candidate pair and each closure edge),
under the request's root span `mapping.run`. None where the program
records no such span (a tree before them)."""

from benchmark.layer_metrics.program import _spans, host_ms

NAMES = ("geometry.essential", "geometry.pnp")


def read(trace):
    recs = _spans(trace, "mapping.run")
    if recs is None or not any(s.name in NAMES for s in recs):
        return None
    return host_ms(trace, "mapping.run", NAMES)
