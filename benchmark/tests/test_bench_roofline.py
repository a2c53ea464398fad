"""The roofline counts reproduce the bounds recorded for K1 and K4
(PERF.md's kernel table: 0.0124 ms for K1 on one 1080p base at S = 4,
0.0990 ms for K1-batch on 8, 0.1262 ms for K4 on 7 pairs of 1,536)."""

import json
import pathlib

import pytest

from benchmark.reference.sift_plain import RefConfig, stack_kernels
from benchmark.roofline import k1, k4

ROOT = pathlib.Path(__file__).resolve().parents[2]
TAPS = stack_kernels(RefConfig().scale_sigmas()[1:])


@pytest.mark.parametrize("frames, want_ms", [(1, 0.0124), (8, 0.0990)])
def test_k1_bound(frames, want_ms):
    got = k1.bound_s({"frames": frames, "h": 1080, "w": 1920,
                      "taps": TAPS}) * 1e3
    assert TAPS.shape[0] == 4
    assert got == pytest.approx(want_ms, abs=5e-5)


def test_k4_bound():
    got = k4.bound_s({"pairs": 7, "n": 1536, "m": 1536, "d": 128}) * 1e3
    assert got == pytest.approx(0.1262, abs=5e-5)


def test_roofline_share_reads_the_profile():
    """Trace.roofline_pct: bound of a request's launches x requests /
    the named kernels' device time; nothing to read gives None."""
    from benchmark import run
    launch = {"pairs": 7, "n": 1536, "m": 1536, "d": 128}
    prof = {"steps": 2, "device_s_by_name": {
        "knn2_split_kernel(float const*, ...)": 0.0004,
        "knn2_merge_kernel(float const*, ...)": 0.0001, "other": 1.0}}
    sift = json.loads((ROOT / "benchmark/configs/sift_1080p.json"
                       ).read_text())["sift"]
    shapes = {"images": [[8, 1080, 1920]], "match_pairs": 7}
    tr = run.Trace({}, prof, sift, shapes)
    assert tr.roofline_pct("k4") == pytest.approx(
        100 * 2 * k4.bound_s(launch) / 0.0005)
    assert tr.roofline_pct("k1") is None
    no_pairs = run.Trace({}, prof, sift, {"images": [[1, 96, 128]],
                                          "match_pairs": 0})
    assert no_pairs.roofline_pct("k4") is None


@pytest.mark.parametrize("shapes, frames", [
    ({"images": [[8, 1080, 1920]], "match_pairs": 7}, [8] * 6),
    ({"images": [[1, 1080, 1920], [1, 480, 640]], "match_pairs": 1},
     [1] * 12)])
def test_launches_follow_the_request(shapes, frames):
    """K1: a base blur and one launch an octave for each batch of images,
    halving; K4: one launch over all the request's pairs."""
    sift = json.loads((ROOT / "benchmark/configs/sift_1080p.json"
                       ).read_text())["sift"]
    got = k1.launches(sift, shapes)
    assert [x["frames"] for x in got] == frames
    assert [x["taps"].shape[0] for x in got[:6]] == [1, 4, 4, 4, 4, 4]
    assert [(x["h"], x["w"]) for x in got[:6]] == [
        (1080, 1920), (1080, 1920), (540, 960), (270, 480), (135, 240),
        (67, 120)]
    (k4_launch,) = k4.launches(sift, shapes)
    assert k4_launch == {"pairs": shapes["match_pairs"], "n": 1536,
                         "m": 1536, "d": 128}
