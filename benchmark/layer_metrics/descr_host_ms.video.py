"""descr_host_ms.video: host ms a request spends in the program's
`sift.descr` spans, over the octaves: K3-desc, the fold and the
normalisation."""

from benchmark.layer_metrics.program import host_ms


def read(trace):
    return host_ms(trace, "sift.detect_and_compute_batch", ("sift.descr",))
