"""scan_host_ms.video: host ms a request spends in the program's
`sift.scan` spans, over the octaves: K2's compact scan and select."""

from benchmark.layer_metrics.program import host_ms


def read(trace):
    return host_ms(trace, "sift.detect_and_compute_batch", ("sift.scan",))
