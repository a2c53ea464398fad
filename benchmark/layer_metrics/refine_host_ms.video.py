"""refine_host_ms.video: host ms a request spends in the program's
`sift.refine` spans, over the octaves: the subpixel refinement and the
mid-compaction."""

from benchmark.layer_metrics.program import host_ms


def read(trace):
    return host_ms(trace, "sift.detect_and_compute_batch", ("sift.refine",))
