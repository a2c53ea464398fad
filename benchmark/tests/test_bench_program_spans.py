"""The readers of the program's spans (layer_metrics/program.py and the
`program_span` metrics of BENCHMARK.json): their values on a hand-built
store, None where there is nothing to read (an empty store, a program
without the tracer, spans that are not the profiled requests'), and
every such metric of a cell in a traced run at the small size."""

import json
import pathlib

import pytest

from benchmark import run
from benchmark.tests.small import OVERRIDES
from sift_tpu_torch.utils import profiling
from sift_tpu_torch.utils.profiling import Span

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
PROGRAM = {m["name"]: m for m in BENCH["per_layer"]
           if m["source"] == "program_span"}
MS = 1_000_000                                   # ns


def _store(nested):
    """Spans from (name, start ms, end ms, [children...]) trees, ids
    and parents filled in."""
    out, ids = [], iter(range(1, 10 ** 6))

    def add(node, parent, trace):
        name, a, b, kids, *attrs = node
        me = next(ids)
        trace = trace or me
        for k in kids:
            add(k, me, trace)
        out.append(Span(name, a * MS, b * MS, me, parent, trace,
                        attrs[0] if attrs else {}))
    for n in nested:
        add(n, None, None)
    return out


def _video_request(t):
    """One video request from t ms: a 20 ms batch facade, then a 1 ms
    match."""
    octaves = [(stage, t + 4 + 3 * o + k * 0.5, t + 4.5 + 3 * o + k * 0.5,
                [], {"octave": o})
               for o in range(5) for k, stage in enumerate(
                   ("sift.scan", "sift.refine", "sift.orient",
                    "sift.compact", "sift.descr"))]
    return [("sift.detect_and_compute_batch", t, t + 20,
             [("sift.pyramid", t, t + 3, [])] + octaves),
            ("match.ratio", t + 20, t + 21, [])]


def _object_request(t):
    """One object request from t ms: 40 ms in all, two images with a
    2 ms refine each, a 1 ms match and a 3 ms RANSAC."""
    return [("pipeline.detect_object", t, t + 40, [
        ("sift.detect_and_compute", t, t + 15, [
            ("sift.refine", t + 5, t + 7, [], {"octave": 0})]),
        ("sift.detect_and_compute", t + 15, t + 30, [
            ("sift.refine", t + 20, t + 22, [], {"octave": 0})]),
        ("match.ratio", t + 30, t + 31, []),
        ("geometry.ransac", t + 31, t + 34, [])])]


def _trace(steps, window_s):
    return run.Trace({}, {"steps": steps, "window_s": window_s}, {}, {})


# per request: video 2 requests in a 50 ms window (25 ms each, 21 in
# root spans); object 2 requests in a 100 ms window (50 ms each, 40 in
# the root)
VIDEO = {"pyramid_host_ms.video": 3.0, "scan_host_ms.video": 2.5,
         "refine_host_ms.video": 2.5, "orient_host_ms.video": 2.5,
         "descr_host_ms.video": 2.5, "host_wait_ms.video": 4.0}
OBJECT = {"refine_host_ms.object": 4.0, "match_host_ms.object": 1.0,
          "ransac_host_ms.object": 3.0, "host_wait_ms.object": 10.0}


def test_the_metrics_are_the_readers():
    assert sorted(PROGRAM) == sorted([*VIDEO, *OBJECT])
    for name, m in PROGRAM.items():
        cell = "video_b8_1080p" if name.endswith(".video") else \
            "object_1080p"
        assert m["workloads"] == [cell] and m["unit"] == "ms"


@pytest.mark.parametrize("name", sorted([*VIDEO, *OBJECT]))
def test_reader_on_a_hand_built_store(monkeypatch, name):
    if name in VIDEO:
        store = _store(_video_request(0) + _video_request(25))
        trace, want = _trace(2, 0.050), VIDEO[name]
    else:
        store = _store(_object_request(0) + _object_request(50))
        trace, want = _trace(2, 0.100), OBJECT[name]
    monkeypatch.setattr(profiling, "spans", lambda: list(store))
    reader = run.layer_reader(name)
    assert reader.read(trace) == pytest.approx(want)
    # spans that are not the profiled requests': the roots miscount
    assert reader.read(_trace(3, 0.075)) is None


@pytest.mark.parametrize("name", sorted([*VIDEO, *OBJECT]))
def test_reader_finds_nothing(monkeypatch, name):
    profiling.clear()
    reader = run.layer_reader(name)
    assert reader.read(_trace(2, 0.05)) is None
    assert reader.read(run.Trace({}, None, {}, {})) is None
    monkeypatch.delattr(profiling, "spans")      # a tree before the tracer
    assert reader.read(_trace(2, 0.05)) is None


@pytest.mark.parametrize("cell", sorted(OVERRIDES))
def test_traced_small_run_reports_every_span_metric(cell):
    profiling.clear()
    out = run.run_cell(cell, 2 ** 33 + 41, 1.0, True, device="cpu",
                       overrides=OVERRIDES[cell])
    profiling.clear()
    mine = [n for n, m in PROGRAM.items() if cell in m["workloads"]]
    assert mine
    for name in mine:
        v = out["metrics"][name]["value"]
        assert v == v and v != float("inf"), name
        assert v >= 0.0 if name.startswith("host_wait") else v > 0.0, name
