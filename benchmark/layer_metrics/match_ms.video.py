"""match_ms.video: mean ms of the batched `ops.match.match_ratio`
over a request's B - 1 pairs (one K4 launch), a benchmark span ended by a
synchronisation."""

from benchmark.layer_metrics.common import span_mean_ms


def read(trace):
    return span_mean_ms(trace, "match")
