"""device_events_per_frame.map: device events of the profiled request
per frame mapped: the single-frame front end's dispatch, K4, and the
back end's solver launches."""

from benchmark.layer_metrics.common import events_per_unit


def read(trace):
    return events_per_unit(trace)
