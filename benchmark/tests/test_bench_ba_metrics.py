"""The reader of the mapping cell's BA graph share, ba_graph_hit_pct.map
(the share of `sfm.ba` spans with `graph_hit`), on a hand-built store,
and None where a program records no such span (a tree before them) or
no `graph_hit` (a tree before the BA graphs)."""

import pytest

from benchmark import run
from benchmark.tests.test_bench_program_spans import _store, _trace
from sift_tpu_torch.utils import profiling

NAME = "ba_graph_hit_pct.map"


def _map_request(t, hits=(False, True, True), attrs=True):
    """One mapping request from t ms: 100 ms in all; two windowed BAs in
    reconstruct and one in the final BA, with graph_hit as `hits` says,
    and an essential call whose graph_hit the reader must not count."""
    def ba(a, b, hit):
        shapes = {"obs": 4096, "obs_used": 3000, "points": 1024, "cams": 24,
                  "iters": 12, "cg_iters": 30}
        return ("sfm.ba", t + a, t + b, [],
                {**shapes, "graph_hit": hit} if attrs else shapes)
    return [("mapping.run", t, t + 100, [
        ("mapping.reconstruct", t + 10, t + 40, [
            ("geometry.essential", t + 10, t + 12, [],
             {"n": 1024, "graph_hit": False}),
            ba(14, 20, hits[0]), ba(25, 30, hits[1])]),
        ("mapping.final_ba", t + 80, t + 95, [ba(80, 95, hits[2])])])]


def _read(monkeypatch, store, steps=2):
    monkeypatch.setattr(profiling, "spans", lambda: list(store))
    return run.layer_reader(NAME).read(_trace(steps, 0.2))


def test_reader_on_a_hand_built_store(monkeypatch):
    store = _store(_map_request(0) + _map_request(100, (True,) * 3))
    assert _read(monkeypatch, store) == pytest.approx(500 / 6)
    assert _read(monkeypatch, _store(_map_request(0, (True,) * 3)),
                 steps=1) == pytest.approx(100.0)
    # spans that are not the profiled requests': the roots miscount
    assert _read(monkeypatch, store, steps=3) is None


def test_reader_finds_nothing_in_a_tree_before_the_spans(monkeypatch):
    bare = [("mapping.run", t, t + 100, [("mapping.reconstruct", t + 10,
                                          t + 40, [])]) for t in (0, 100)]
    assert _read(monkeypatch, _store(bare)) is None
    assert _read(monkeypatch, []) is None
    monkeypatch.delattr(profiling, "spans")
    assert run.layer_reader(NAME).read(_trace(2, 0.2)) is None


def test_reader_needs_the_attribute(monkeypatch):
    store = _store(_map_request(0, attrs=False) + _map_request(100))
    assert _read(monkeypatch, store) is None
