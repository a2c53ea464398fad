"""pyramid_host_ms.video: host ms a request spends in the program's
`sift.pyramid` span: the Gaussian and DoG pyramids of the B frames."""

from benchmark.layer_metrics.program import host_ms


def read(trace):
    return host_ms(trace, "sift.detect_and_compute_batch", ("sift.pyramid",))
