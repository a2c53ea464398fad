"""The window and statistics logic of run.py with a fake request: the
window ends with the first request that finishes past --seconds, rates
count all the work and all the time, and a stall moves both the rate
and the p95."""

import time

import pytest

from benchmark import run


class Fake:
    """Requests of `base` seconds, `stall` seconds at request `at`,
    3 units each, over a pool of 2."""
    pool_size = 2

    def __init__(self, base, stall=0.0, at=-1, fail_at=-1):
        self.base, self.stall, self.at, self.fail_at = base, stall, at, fail_at

    def step(self, i, span):
        with span("work"):
            time.sleep(self.stall if i == self.at else self.base)
        if i == self.fail_at:
            raise RuntimeError("boom")
        return 3


def window(fake, seconds=0.5, record=False):
    spans = run.Spans(lambda: None)
    return run.run_window(fake, seconds, lambda: None, spans, 0, record), \
        spans


def test_window_counts_all_work_and_time():
    w, _ = window(Fake(0.01))
    assert w["window_s"] >= 0.5
    assert w["window_s"] - 0.5 < 0.05
    assert w["units"] == 3 * w["attempted"] and w["failed"] == 0
    assert len(w["latencies_s"]) == w["attempted"] == w["next"]
    rate = run.statistic("units_per_s")(w)
    assert rate == pytest.approx(w["units"] / w["window_s"])
    assert 200 < rate < 300


def test_a_stall_moves_the_rate_and_the_p95():
    calm, _ = window(Fake(0.01), 1.0)
    # 10 stalls of 0.1 s among ~70 requests: above the 95th percentile
    stalled = Fake(0.01)
    stalled.step = lambda i, span, f=stalled: (
        time.sleep(0.1 if i % 7 == 3 else 0.01), 3)[1]
    hit, _ = window(stalled, 1.0)
    p95 = run.statistic("latency_p95_ms")
    assert p95(calm) < 20 and p95(hit) > 90
    assert run.statistic("units_per_s")(hit) < \
        0.6 * run.statistic("units_per_s")(calm)


def test_one_long_request_lengthens_the_window():
    w, _ = window(Fake(0.01, stall=0.8, at=2), 0.5)
    assert w["window_s"] >= 0.8 and w["attempted"] == 3


def test_the_window_serves_the_whole_pool():
    slow = Fake(0.3)
    slow.pool_size = 4
    w, _ = window(slow, 0.1)
    assert w["attempted"] == 4 and w["window_s"] >= 1.2


def test_failures_are_counted_and_spans_recorded():
    w, spans = window(Fake(0.01, fail_at=1), 0.1, record=True)
    assert w["failed"] == 1 and w["units"] == 3 * (w["attempted"] - 1)
    assert len(spans.times["work"]) == w["attempted"]
    quiet, spans = window(Fake(0.01), 0.1, record=False)
    assert spans.times == {}


def test_latency_percentiles():
    lat = [0.001 * (i + 1) for i in range(100)]
    w = {"latencies_s": lat}
    assert run.statistic("latency_p95_ms")(w) == pytest.approx(95.95)


def test_profile_summary():
    """Busy time is the union of device intervals; idle gaps go to the
    innermost host event around their middle."""
    dev = [(0, 10, "k"), (5, 20, "k"), (40, 50, "m")]
    host = [(0, 100, "outer"), (22, 38, "aten::nonzero")]
    p = run.summarize_profile(dev, host, 1e-7, 6, 2)
    assert p["busy_s"] == pytest.approx(30e-9)
    assert p["device_events"] == 3 and p["units"] == 6
    assert p["idle_gaps"] == [["aten::nonzero", pytest.approx(20e-9)]]
    assert p["device_ops"][0] == ["k", pytest.approx(25e-9)]
