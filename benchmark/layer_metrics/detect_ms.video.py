"""detect_ms.video: mean ms of `sift.detect_and_compute_batch` on the
B frames of a request, a benchmark span ended by a synchronisation."""

from benchmark.layer_metrics.common import span_mean_ms


def read(trace):
    return span_mean_ms(trace, "detect")
