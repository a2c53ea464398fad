"""ba_host_ms.map: host ms a request spends in the program's `sfm.ba`
spans, one a bundle adjustment (the windowed ones of reconstruct, its
final ones and the two of the final BA), under the request's root span
`mapping.run`."""

from benchmark.layer_metrics.program import host_ms


def read(trace):
    return host_ms(trace, "mapping.run", ("sfm.ba",))
