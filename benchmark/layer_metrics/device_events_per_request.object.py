"""device_events_per_request.object: device events of the profiled
requests per `detect_object`: the single-frame facade's dispatch, the
match and RANSAC."""

from benchmark.layer_metrics.common import events_per_unit


def read(trace):
    return events_per_unit(trace)
