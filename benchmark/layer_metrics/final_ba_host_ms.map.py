"""final_ba_host_ms.map: host ms a request spends in the program's
`mapping.final_ba` span (the stage's host time, with its wait for the
card: each stage ends by reading its results on the host), under the
request's root span `mapping.run`."""

from benchmark.layer_metrics.program import host_ms


def read(trace):
    return host_ms(trace, "mapping.run", ("mapping.final_ba",))
