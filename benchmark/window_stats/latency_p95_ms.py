"""latency_p95_ms: the 95th percentile, in ms, of the latencies of all
the window's requests (Python's statistics.quantiles, exclusive
method)."""

import statistics


def value(window: dict) -> float:
    lat = window["latencies_s"]
    if len(lat) < 2:
        return lat[0] * 1e3
    return statistics.quantiles(lat, n=100)[94] * 1e3
