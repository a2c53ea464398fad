"""The port's utils against sift_tpu.utils (metrics and the capacity
ladder give equal results on seeded inputs), the counters and the span
report as specified, and the CLI's saturation counters and span
report."""

import ast
import dataclasses
import logging
import pathlib
import threading

import numpy as np
import pytest
import torch

from sift_tpu.utils import caps as jcaps
from sift_tpu.utils import metrics as jmetrics

from sift_tpu_torch.types import Keypoints
from sift_tpu_torch.utils import caps as tcaps
from sift_tpu_torch.utils import logger as tlogger
from sift_tpu_torch.utils import metrics as tmetrics
from sift_tpu_torch.utils import profiling as tprof

from _torch_threads import one_thread  # noqa: F401


def test_every_port_test_module_takes_the_thread_rule():
    """Every tests/test_torch_*.py module imports the one thread fixture
    from tests/_torch_threads.py, and none defines a fixture of its own
    that sets torch's thread count."""
    paths = sorted(pathlib.Path(__file__).parent.glob("test_torch_*.py"))
    assert len(paths) >= 30
    for path in paths:
        tree = ast.parse(path.read_text())
        assert any(isinstance(node, ast.ImportFrom)
                   and node.module == "_torch_threads"
                   and "one_thread" in {a.name for a in node.names}
                   for node in tree.body), path.name
        for fn in ast.walk(tree):
            if not isinstance(fn, ast.FunctionDef) or not any(
                    "fixture" in ast.unparse(d) for d in fn.decorator_list):
                continue
            assert not any(isinstance(n, ast.Attribute)
                           and n.attr == "set_num_threads"
                           for n in ast.walk(fn)), (path.name, fn.name)


def test_pow2_cap_matches_jax():
    for n in (0, 1, 2, 3, 15, 16, 17, 100, 1023, 1024, 1025, 70000):
        for lo in (1, 16, 64):
            assert tcaps.pow2_cap(n, lo) == jcaps.pow2_cap(n, lo), (n, lo)


def _metric_args(name, rng):
    xy = rng.random((40, 2)) * 100
    if name == "match_recall":
        ref = [tuple(p) for p in rng.integers(0, 30, (25, 2))]
        return ref[:18] + [(99, 99)], ref
    if name == "keypoint_recall":
        return xy, xy[:30] + rng.normal(0, 1.5, (30, 2))
    if name == "correspondence_recall":
        src2 = xy[:25] + rng.normal(0, 1.0, (25, 2))
        return xy[:20], xy[20:40], src2[:20], src2[5:25]
    if name == "keypoint_repeatability":
        h = np.array([[1.02, 0.05, 3.0], [-0.04, 0.98, -2.0],
                      [1e-4, -2e-4, 1.0]])
        p = np.concatenate([xy, np.ones((40, 1))], 1) @ h.T
        return xy, p[:30, :2] / p[:30, 2:] + rng.normal(0, 1.0, (30, 2)), h
    src = rng.normal(0, 1, (30, 3))
    a = 0.4
    r = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                  [0, 0, 1]])
    dst = 1.7 * src @ r.T + np.array([0.3, -1.0, 2.0]) + rng.normal(
        0, 0.01, (30, 3))
    return src, dst


METRICS = ("match_recall", "keypoint_recall", "correspondence_recall",
           "keypoint_repeatability", "umeyama_alignment", "ate_rmse")


@pytest.mark.parametrize("name", METRICS)
def test_metrics_match_jax(name):
    # both are NumPy: equal results, to the last bit
    args = _metric_args(name, np.random.default_rng(METRICS.index(name)))
    got = getattr(tmetrics, name)(*args)
    want = getattr(jmetrics, name)(*args)
    if isinstance(want, tuple):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    else:
        assert got == want
    # the empty-input conventions too
    if name in ("keypoint_recall", "keypoint_repeatability"):
        empty = np.zeros((0, 2))
        extra = args[2:]
        assert (getattr(tmetrics, name)(empty, args[1], *extra)
                == getattr(jmetrics, name)(empty, args[1], *extra))


def test_counters():
    c = tlogger.Counters()
    c.inc("a")
    c.inc("a", 2.5)
    c.set("g", 7.0)
    assert c.snapshot() == {"a": 3.5, "g": 7.0}
    snap = c.snapshot()
    snap["a"] = 0.0                     # a copy, not a view
    assert c.snapshot()["a"] == 3.5

    def bump():
        for _ in range(1000):
            c.inc("t")
    threads = [threading.Thread(target=bump) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert c.snapshot()["t"] == 8000.0
    c.reset()
    assert c.snapshot() == {}
    assert isinstance(tlogger.COUNTERS, tlogger.Counters)


def test_logger_names_and_configure():
    assert tlogger.get_logger().name == "sift_tpu_torch"
    assert tlogger.get_logger("cli").name == "sift_tpu_torch.cli"
    root = tlogger.get_logger()
    before = list(root.handlers)
    try:
        tlogger.configure("debug")
        tlogger.configure("warning")     # safe to call again: one handler
        assert len(root.handlers) == max(len(before), 1)
        assert root.level == logging.WARNING
    finally:
        for h in root.handlers[len(before):]:
            root.removeHandler(h)
        root.setLevel(logging.NOTSET)


def test_span_report(monkeypatch):
    tprof.clear()
    clock = iter(range(0, 10 ** 12, 250_000))      # 0.25 ms a clock read
    monkeypatch.setattr(tprof.time, "time_ns", lambda: next(clock))
    with tprof.tracing():
        for _ in range(3):
            with tprof.span("detect"):
                with tprof.span("sift.refine", octave=0):
                    pass
        with tprof.span("match"):
            pass
    summary = tprof.summary()
    assert list(summary) == ["detect", "sift.refine", "sift.refine/octave0",
                             "match"]
    assert summary["detect"] == {"calls": 3, "total_ms": 2.25,
                                 "self_ms": 1.5}
    assert summary["sift.refine/octave0"]["total_ms"] == 0.75
    lines = tprof.report().splitlines()
    assert [ln.split(":")[0].strip() for ln in lines] == list(summary)
    assert lines[0].split(":")[1].split() == [
        "2.250", "ms", "total", "1.500", "ms", "self", "3", "calls"]
    tprof.clear()


def test_sync_finds_every_tensor():
    @dataclasses.dataclass
    class Box:
        a: torch.Tensor
        b: tuple

    kp = Keypoints.zeros(2)
    tree = {"k": kp, "l": [Box(torch.ones(1), (torch.ones(2), 3))]}
    found = list(tprof._tensors(tree))
    assert len(found) == len(dataclasses.fields(Keypoints)) + 2
    tprof.sync(tree)                    # CPU only: returns at once


def test_tracing_blocks_nest():
    tprof.clear()
    with tprof.tracing():
        with tprof.tracing():
            with tprof.span("inner"):
                pass
        with tprof.span("still on"):       # the outer block is open
            pass
    with tprof.span("off"):
        pass
    assert [s.name for s in tprof.spans()] == ["inner", "still on"]
    tprof.clear()


def _textured(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = 110.0 + 35.0 * np.sin(xx / 13.0) * np.cos(yy / 17.0)
    for k in range(200):
        cy, cx = rng.uniform(8, h - 8), rng.uniform(8, w - 8)
        s = rng.uniform(1.2, 5.0)
        a = rng.uniform(50, 120) * (1 if k % 2 == 0 else -1)
        img += a * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
    img += rng.normal(0, 3.0, (h, w))
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def test_cli_counts_saturated_octaves(tmp_path, monkeypatch, capsys):
    # with tiny caps, octave 0 fills on both images: the CLI bumps
    # out_cap_saturated/... and, under --diagnose-caps,
    # detect_cap_saturated/...; --timing prints the span report
    cv2 = pytest.importorskip("cv2")
    from sift_tpu_torch import cli
    cfg = dataclasses.replace(cli.DEFAULT_CONFIG,
                              detect_caps=(24, 16, 16, 16, 16),
                              out_caps=(16, 8, 8, 8, 8))
    monkeypatch.setattr(cli, "DEFAULT_CONFIG", cfg)
    scene = _textured(160, 200, 5)
    sp, op = str(tmp_path / "scene.png"), str(tmp_path / "object.png")
    cv2.imwrite(sp, scene)
    cv2.imwrite(op, scene[20:140, 30:180].copy())
    tlogger.COUNTERS.reset()
    assert cli.main([sp, op, "--device", "cpu", "--no-resize", "--timing",
                     "--diagnose-caps"]) == 0
    counts = tlogger.COUNTERS.snapshot()
    for name in ("scene", "object"):
        assert counts.get(f"out_cap_saturated/{name}/octave0") == 1.0
        assert counts.get(f"detect_cap_saturated/{name}/octave0") == 1.0
    lines = capsys.readouterr().out.splitlines()
    report = {ln.split(":")[0].strip(): ln.split(":")[1].split()
              for ln in lines if ln.endswith(" calls")}
    assert list(report)[:3] == ["cli.ingest", "cli.first_run",
                                "pipeline.detect_object"]
    for name, calls in (("cli.ingest", 1), ("cli.first_run", 1),
                        ("cli.steady", 1), ("pipeline.detect_object", 2),
                        ("sift.detect_and_compute", 4), ("match.ratio", 2),
                        ("geometry.ransac", 2), ("sift.refine/octave0", 4)):
        assert int(report[name][6]) == calls, name
    # the CLI's stages hold the program's: self time at most the total
    first = report["cli.first_run"]
    assert float(first[0]) >= float(first[3]) >= 0.0
    tlogger.COUNTERS.reset()
