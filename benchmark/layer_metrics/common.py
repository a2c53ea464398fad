"""Helpers the per-layer readers share. Each reader gets a run.Trace:
`spans` (seconds by span name, the traced window's requests after the
profiled ones), `profile` (the profiled requests: busy_s, window_s,
device_events, units, steps, device_s_by_name), `sift` (the
configuration's SIFT block), `shapes` (what one request runs: its
batches of images and its matched pairs) and `roofline_pct(kernel)`. A
reader that finds nothing to read returns None."""

from __future__ import annotations

from typing import Optional


def span_mean_ms(trace, name: str) -> Optional[float]:
    times = trace.spans.get(name)
    return 1e3 * sum(times) / len(times) if times else None


def idle_pct(trace) -> Optional[float]:
    p = trace.profile
    if not p or p["window_s"] <= 0 or p["device_events"] == 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])


def events_per_unit(trace) -> Optional[float]:
    p = trace.profile
    if not p or p["units"] == 0 or p["device_events"] == 0:
        return None
    return p["device_events"] / p["units"]
