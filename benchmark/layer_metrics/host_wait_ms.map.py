"""host_wait_ms.map: the profiled wall time per request less the host
ms of its root span (`mapping.run`): how long the host spent outside the
program, mostly at the request's synchronisation."""

from benchmark.layer_metrics.program import host_wait_ms


def read(trace):
    return host_wait_ms(trace, "mapping.run")
