"""host_wait_ms.video: the profiled wall time per request less the host
ms of its root spans (`sift.detect_and_compute_batch`, `match.ratio`):
how long the host waited for the card at the request's synchronisation."""

from benchmark.layer_metrics.program import host_wait_ms


def read(trace):
    return host_wait_ms(trace, "sift.detect_and_compute_batch")
