"""orient_host_ms.video: host ms a request spends in the program's
`sift.orient` spans, over the octaves: K3-ori and the peak tail."""

from benchmark.layer_metrics.program import host_ms


def read(trace):
    return host_ms(trace, "sift.detect_and_compute_batch", ("sift.orient",))
