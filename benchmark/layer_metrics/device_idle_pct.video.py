"""device_idle_pct.video: 100 x (1 - the union of the device events'
intervals / the profiled requests' wall time)."""

from benchmark.layer_metrics.common import idle_pct


def read(trace):
    return idle_pct(trace)
