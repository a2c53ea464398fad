"""ransac_host_ms.object: host ms a request spends in the program's
`geometry.ransac` span: the RANSAC homography and its refit."""

from benchmark.layer_metrics.program import host_ms


def read(trace):
    return host_ms(trace, "pipeline.detect_object", ("geometry.ransac",))
