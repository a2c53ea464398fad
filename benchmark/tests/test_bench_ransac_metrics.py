"""The readers of the mapping cell's RANSAC spans: sfm_ransac_host_ms.map
(host ms a request in `geometry.essential` and `geometry.pnp`) and
ransac_graph_hit_pct.map (the share of those spans with `graph_hit`), on
a hand-built store, and None where a program records no such span (a
tree before them) or no `graph_hit`."""

import pytest

from benchmark import run
from benchmark.tests.test_bench_program_spans import _store, _trace
from sift_tpu_torch.utils import profiling

NAMES = ("sfm_ransac_host_ms.map", "ransac_graph_hit_pct.map")


def _map_request(t, hits=(True, False, True), attrs=True):
    """One mapping request from t ms: 100 ms in all; in reconstruct an
    essential call of 4 ms and a PnP call of 2 ms, in loop closure an
    essential call of 3 ms, with graph_hit as `hits` says."""
    def call(name, a, b, hit):
        return (name, t + a, t + b, [],
                {"n": 1024, "graph_hit": hit} if attrs else {})
    return [("mapping.run", t, t + 100, [
        ("mapping.reconstruct", t + 10, t + 40, [
            call("geometry.essential", 10, 14, hits[0]),
            call("geometry.pnp", 20, 22, hits[1])]),
        ("mapping.loop_closure", t + 40, t + 80, [
            call("geometry.essential", 50, 53, hits[2])])])]


def _read(monkeypatch, name, store, steps=2):
    monkeypatch.setattr(profiling, "spans", lambda: list(store))
    return run.layer_reader(name).read(_trace(steps, 0.2))


def test_readers_on_a_hand_built_store(monkeypatch):
    store = _store(_map_request(0) + _map_request(100, (True,) * 3))
    assert _read(monkeypatch, NAMES[0], store) == pytest.approx(9.0)
    assert _read(monkeypatch, NAMES[1], store) == pytest.approx(500 / 6)
    # spans that are not the profiled requests': the roots miscount
    for name in NAMES:
        assert _read(monkeypatch, name, store, steps=3) is None


@pytest.mark.parametrize("name", NAMES)
def test_readers_find_nothing_in_a_tree_before_the_spans(monkeypatch, name):
    bare = [("mapping.run", t, t + 100, [("mapping.reconstruct", t + 10,
                                          t + 40, [])]) for t in (0, 100)]
    assert _read(monkeypatch, name, _store(bare)) is None
    assert _read(monkeypatch, name, []) is None
    monkeypatch.delattr(profiling, "spans")
    assert run.layer_reader(name).read(_trace(2, 0.2)) is None


def test_hit_share_needs_the_attribute(monkeypatch):
    store = _store(_map_request(0, attrs=False) + _map_request(100))
    assert _read(monkeypatch, NAMES[1], store) is None
    assert _read(monkeypatch, NAMES[0], store) == pytest.approx(9.0)
