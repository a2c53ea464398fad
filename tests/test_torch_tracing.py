"""The port's tracer (sift_tpu_torch/utils/profiling.py): an off span
costs one check and touches no clock or profiler; spans under tracing()
nest, with parent and trace ids and self times; the ring is bounded;
under a torch profiler each span is also a kineto event on the same
clock; and the facade, the object pipeline and the matcher open the
spans their stages are named by, with no synchronisation."""

import time

import numpy as np
import pytest
import torch

from sift_tpu_torch import pipeline, sift
from sift_tpu_torch.config import DEFAULT_CONFIG
from sift_tpu_torch.ops import pyramid as pyr
from sift_tpu_torch.utils import profiling

from _torch_threads import one_thread  # noqa: F401

OCTAVE_STAGES = ("sift.scan", "sift.refine", "sift.orient", "sift.compact",
                 "sift.descr")


@pytest.fixture(autouse=True)
def _empty_store():
    profiling.clear()
    yield
    profiling.clear()


def _fail(*a, **k):
    pytest.fail("called on the off path")


def _usable_octaves(img: torch.Tensor) -> list:
    octs = pyr.build_gaussian_pyramid(img, DEFAULT_CONFIG)
    return [o for o in range(DEFAULT_CONFIG.n_octaves)
            if sift._octave_usable(octs[o].shape[-2:], DEFAULT_CONFIG)]


def test_off_span_records_nothing_and_touches_no_clock(monkeypatch,
                                                       small_image):
    monkeypatch.setattr(time, "time_ns", _fail)
    monkeypatch.setattr(torch.profiler, "record_function", _fail)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _fail)
    checks = []

    def enabled():
        checks.append(1)
        return False

    monkeypatch.setattr(profiling, "_profiler_enabled", enabled)
    first = profiling.span("sift.refine", octave=0)
    with first:
        with profiling.span("sift.orient", octave=0) as inner:
            assert inner is first          # one shared no-op object
    assert len(checks) == 2                # one check a span
    # the whole facade, off: no clock read, no profiler range
    img = torch.from_numpy(small_image[:96, :128].copy())
    sift.detect_and_compute(img)
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_tracing_nests_with_parent_trace_and_self_time(monkeypatch):
    clock = iter(range(1000, 10 ** 9, 1000))
    monkeypatch.setattr(time, "time_ns", lambda: next(clock))
    with profiling.tracing():
        with profiling.span("a"):              # 1000 .. 6000
            with profiling.span("b", octave=1):   # 2000 .. 3000
                pass
            with profiling.span("b", octave=2):   # 4000 .. 5000
                pass
        with profiling.span("c"):              # a second root
            pass
    with profiling.span("not traced"):
        pass
    recs = {(s.name, s.attrs.get("octave")): s for s in profiling.spans()}
    assert len(recs) == 4 and ("not traced", None) not in recs
    a, c = recs[("a", None)], recs[("c", None)]
    b1, b2 = recs[("b", 1)], recs[("b", 2)]
    assert a.parent is None and c.parent is None
    assert b1.parent == a.id and b2.parent == a.id
    assert {a.trace, b1.trace, b2.trace} == {a.id} and c.trace == c.id
    assert a.id != c.id
    assert (a.start_ns, a.end_ns) == (1000, 6000)
    summ = profiling.summary()
    assert list(summ)[:4] == ["a", "b", "b/octave1", "b/octave2"]
    assert summ["a"]["total_ms"] == pytest.approx(5000e-6)
    assert summ["a"]["self_ms"] == pytest.approx(3000e-6)  # 5000 - 2 x 1000
    assert summ["b"]["calls"] == 2
    assert summ["b"]["self_ms"] == summ["b"]["total_ms"] == \
        pytest.approx(2000e-6)
    assert summ["b/octave2"]["calls"] == 1


def test_ring_is_bounded_and_counts_drops():
    assert profiling.RING == 65536
    extra = 10
    with profiling.tracing():
        for i in range(profiling.RING + extra):
            with profiling.span("s", i=i):
                pass
    recs = profiling.spans()
    assert len(recs) == profiling.RING and profiling.dropped() == extra
    assert recs[0].attrs["i"] == extra and recs[-1].attrs["i"] == \
        profiling.RING + extra - 1
    profiling.clear()
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_spans_are_kineto_events_on_the_same_clock():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("warm-up"):     # the first range looks up ops
            pass
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("outer.stage"):
            with profiling.span("inner.stage", octave=3):
                torch.ones(64).cumsum(0)
    with profiling.span("after.profile"):      # the profiler has stopped
        pass
    recs = profiling.spans()
    assert sorted(s.name for s in recs) == ["inner.stage", "outer.stage"]
    events = prof.profiler.kineto_results.events()
    for s in recs:
        mine = [e for e in events if e.name() == s.name]
        assert mine, s.name
        # a host op, not a user annotation: the profiler mirrors each
        # user annotation on the device's timeline as a device event
        assert not any(e.is_user_annotation() for e in mine), s.name
        assert min(abs(e.start_ns() - s.start_ns) for e in mine) \
            < 1_000_000, s.name


def _tree(root_name: str):
    """The one root span, named root_name, and the spans directly
    inside it; every recorded span is of its trace."""
    recs = profiling.spans()
    roots = [s for s in recs if s.parent is None]
    assert [s.name for s in roots] == [root_name]
    root = roots[0]
    assert root.trace == root.id
    assert all(s.trace == root.id for s in recs)
    return root, [s for s in recs if s.parent == root.id]


@pytest.mark.parametrize("batch", [False, True])
def test_facade_span_tree(small_image, batch):
    img = torch.from_numpy(small_image[:128, :160].copy())
    usable = _usable_octaves(img)
    assert 2 <= len(usable) < DEFAULT_CONFIG.n_octaves
    with profiling.tracing():
        if batch:
            sift.detect_and_compute_batch(torch.stack([img, img.flip(1)]))
        else:
            sift.detect_and_compute(img)
    root_name = ("sift.detect_and_compute_batch" if batch
                 else "sift.detect_and_compute")
    root, kids = _tree(root_name)
    names = sorted((s.name, s.attrs.get("octave")) for s in kids)
    want = sorted([("sift.pyramid", None)] + [
        (n, o) for n in OCTAVE_STAGES for o in usable])
    assert names == want
    assert len(profiling.spans()) == 1 + len(want)
    for s in kids:
        assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns


def test_object_pipeline_spans(small_image):
    scene = torch.from_numpy(small_image.copy())
    obj = torch.from_numpy(small_image[30:130, 40:170].copy())
    with profiling.tracing():
        pipeline.detect_object(scene, obj, device="cpu")
    root, kids = _tree("pipeline.detect_object")
    assert sorted(s.name for s in kids) == [
        "geometry.ransac", "match.ratio", "sift.detect_and_compute",
        "sift.detect_and_compute"]
    summ = profiling.summary()
    assert summ["pipeline.detect_object"]["calls"] == 1
    assert summ["sift.refine"]["calls"] == sum(
        v["calls"] for k, v in summ.items()
        if k.startswith("sift.refine/octave"))


def test_traced_run_never_synchronises(monkeypatch, small_image):
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: pytest.fail("synchronised"))
    scene = torch.from_numpy(small_image.copy())
    obj = torch.from_numpy(small_image[30:130, 40:170].copy())
    with profiling.tracing():
        pipeline.detect_object(scene, obj, device="cpu")
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        sift.detect_and_compute_batch(torch.stack([scene, scene]))
    # the span machinery alone reads no tensor on the host
    for name in ("item", "cpu", "__bool__", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, _fail)
    with profiling.tracing():
        with profiling.span("x", octave=1):
            pass
    names = {s.name for s in profiling.spans()}
    assert {"pipeline.detect_object", "sift.detect_and_compute_batch",
            "geometry.ransac", "x"} <= names
    assert np.isfinite(profiling.summary()["x/octave1"]["total_ms"])


def test_mapping_span_tree():
    """A small CPU run_mapping (caps of 640 keypoints a frame, so that
    the plain matcher stays cheap): one root `mapping.run`, its four
    stages as children, each bundle adjustment an `sfm.ba` span (in
    reconstruct and in the final BA) with the padded table's shapes,
    the rows its sums read, the loop's counts and graph_hit (false on
    the CPU), the pose graph an `sfm.posegraph` span in the loop-closure
    stage with its poses, edges and iterations."""
    import dataclasses
    import chip_smoke
    from sift_tpu_torch.sfm.mapping import render_corner_sequence, run_mapping
    texs = chip_smoke.mapping_textures()
    frames, k, _ = render_corner_sequence(n_frames=10, size=(200, 268),
                                          textures=texs, seed=5)
    cfg = dataclasses.replace(DEFAULT_CONFIG, out_caps=(384, 128, 64, 32, 32))
    with profiling.tracing():
        res = run_mapping(frames, k, cfg, device="cpu")
    root, kids = _tree("mapping.run")
    assert [s.name for s in sorted(kids, key=lambda s: s.start_ns)] == [
        "mapping.front_end", "mapping.reconstruct", "mapping.loop_closure",
        "mapping.final_ba"]
    stage = {s.id: s.name for s in kids}
    recs = profiling.spans()
    by_id = {s.id: s for s in recs}

    def stage_of(s):
        while s.parent != root.id:
            s = by_id[s.parent]
        return stage[s.id]

    bas = [s for s in recs if s.name == "sfm.ba"]
    graphs = [s for s in recs if s.name == "sfm.posegraph"]
    assert {stage_of(s) for s in bas} == {"mapping.reconstruct",
                                          "mapping.final_ba"}
    assert res.stats["n_closure_edges"] >= 1
    assert [stage_of(s) for s in graphs] == ["mapping.loop_closure"]
    for s in bas:
        assert set(s.attrs) == {"obs", "obs_used", "points", "cams",
                                "iters", "cg_iters", "graph_hit"}
        # the CPU's loop runs eagerly: no iteration replays a graph
        assert s.attrs["graph_hit"] is False
        assert s.attrs["cams"] == len(frames) and s.attrs["cg_iters"] == 30
        # padded to powers of two: 64 observations and 32 points at least
        for n, lo in (("obs", 64), ("points", 32)):
            assert s.attrs[n] >= lo and s.attrs[n] & (s.attrs[n] - 1) == 0
        # the unmasked rows: more than half the padded table, or all of
        # the smallest one
        assert (s.attrs["obs"] // 2 < s.attrs["obs_used"] <= s.attrs["obs"]
                or s.attrs["obs_used"] <= s.attrs["obs"] == 64)
    assert [s.attrs["iters"] for s in bas if stage_of(s)
            == "mapping.final_ba"][0] == 24
    (g,) = graphs
    assert g.attrs == {"poses": len(frames), "iters": 30,
                       "edges": int(res.registered.sum()) - 1
                       + res.stats["n_closure_edges"]}
