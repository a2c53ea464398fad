"""refine_host_ms.object: host ms a request spends in the program's
`sift.refine` spans, over the octaves of the scene and the object."""

from benchmark.layer_metrics.program import host_ms


def read(trace):
    return host_ms(trace, "pipeline.detect_object", ("sift.refine",))
