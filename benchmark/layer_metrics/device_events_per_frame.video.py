"""device_events_per_frame.video: device events (kernels, copies, fills)
of the profiled requests per frame: the facade's dispatch."""

from benchmark.layer_metrics.common import events_per_unit


def read(trace):
    return events_per_unit(trace)
