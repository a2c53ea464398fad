"""host_wait_ms.object: the profiled wall time per request less the host
ms of its root span (`pipeline.detect_object`): how long the host waited
for the card at the request's synchronisation."""

from benchmark.layer_metrics.program import host_wait_ms


def read(trace):
    return host_wait_ms(trace, "pipeline.detect_object")
