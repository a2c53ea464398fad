"""match_host_ms.object: host ms a request spends in the program's
`match.ratio` span: K4 and the ratio test."""

from benchmark.layer_metrics.program import host_ms


def read(trace):
    return host_ms(trace, "pipeline.detect_object", ("match.ratio",))
