"""The mapping cell (map24_480p) at a small size on the CPU: its driver
runs and is correct as the program ships; the frozen back end fed the
program's front end gives the program's map bit for bit and meets the
ATE gate; each control of faults_map.py makes `correct` false; a traced
run reports the cell's span metrics; the segment-sum roofline counts
the work of one request; and a program that hands back no front end
fails the cell at set-up.

The small size is 16 frames of 240x320 of the cell's scene. Before the
two-view initialization was checked against the views that see it, two
of the six seeds 8589934669 to 8589934674 mapped that loop off the gate
(ATE 0.448 and 0.323, a CPU run); SEED maps it within the gate.
"""

import dataclasses
import json
import pathlib

import numpy as np
import pytest

from benchmark import faults_map, run
from benchmark.inputs import mapping_scene
from benchmark.reference import compare_map, mapping_plain
from benchmark.roofline import segsum as segsum_roofline

ROOT = pathlib.Path(__file__).resolve().parents[2]
CELL = "map24_480p"
SMALL = {"frame_hw": [240, 320], "n_frames": 16, "warmup_requests": 0,
         "profile_requests": 1, "check_frames": 4}
SEED = 8589934670
SECONDS = 1.0
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SPAN_METRICS = sorted(m["name"] for m in BENCH["per_layer"]
                      if CELL in m.get("workloads", [])
                      and m["source"] == "program_span")


@pytest.fixture(autouse=True)
def _threads(monkeypatch):
    # a few CPU threads keep a small run near a minute; the card's runs
    # keep the harness's one
    monkeypatch.setattr(run, "TORCH_THREADS", 4)


def run_small(trace: bool = False):
    return run.run_cell(CELL, SEED, SECONDS, trace, device="cpu",
                        overrides=SMALL)


def test_sound_program_is_correct():
    out = run_small()
    assert out["correct"], (out["checked"], out["_notes"][-3:])
    assert out["attempted"] >= 1 and out["failed"] == 0
    for name in ("registered_differs", "closures_differ", "points_differ",
                 "cam_gap", "rot_gap_deg", "point_gap", "rmse_gap"):
        assert out["checked"][name]["value"] == 0.0, name


@pytest.mark.parametrize("control", sorted(faults_map.CONTROLS))
def test_control_is_not_correct(control):
    with faults_map.planted(control):
        out = run_small()
    assert not out["correct"], out["checked"]
    assert out["failed"] == 0


def test_reference_is_the_program_bit_for_bit():
    """run_back_end on run_mapping's own front end: the same registered
    frames, closures (pairs and matches), points, cameras after the pose
    graph and after the final BA, bit for bit; its final trajectory
    within the cell's ATE gate of the ground truth."""
    from sift_tpu_torch.sfm.mapping import run_mapping
    import torch
    torch.set_num_threads(4)
    s = int(np.random.default_rng([SEED, 0]).integers(0, 2 ** 31, 1)[0])
    frames, k, gt = mapping_scene.render_corner_sequence(
        mapping_scene.mapping_textures(), n_frames=16, size=(240, 320),
        seed=s)
    prog = run_mapping(frames, k, device="cpu")
    fe = prog.front_end
    ref = mapping_plain.run_back_end(fe.xy, fe.descriptors,
                                     [kp.valid for kp in fe.keypoints],
                                     fe.matches, k, device="cpu")
    numbers, _ = compare_map.map_numbers(prog, ref)
    assert all(v == 0.0 for v in numbers.values()), numbers
    for f in ("cameras_pg", "cameras_final", "points_final"):
        a, b = getattr(prog, f), getattr(ref, f)
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), f
    limit = json.loads((ROOT / "benchmark/workloads/map24_480p.json"
                        ).read_text())["limits"]["ate_final"]
    assert compare_map.ate(ref.cameras_final, ref.registered, gt) <= limit
    assert prog.registered.all()


def test_traced_small_run_reports_every_span_metric():
    from sift_tpu_torch.utils import profiling
    profiling.clear()
    out = run_small(trace=True)
    profiling.clear()
    assert len(SPAN_METRICS) == 6
    for name in SPAN_METRICS:
        v = out["metrics"][name]["value"]
        assert v == v and v != float("inf"), name
        assert v >= 0.0 if name.startswith("host_wait") else v > 0.0, name
    # no device on the CPU: the device readers and the roofline find
    # nothing to read
    for name in ("device_idle_pct.map", "device_events_per_frame.map",
                 "segsum_roofline.map"):
        assert name not in out["metrics"]


def test_roofline_counts_the_sums_of_a_request():
    """66 sums an LM iteration (5, then 2 a CG iteration, then 1) and 6
    a pose-graph iteration; each reads its rows and the permutation and
    reads and writes its outputs once, one add a row and column."""
    shapes = {"ba": [{"obs": 1024, "points": 256, "cams": 8, "iters": 3,
                      "cg_iters": 30}],
              "posegraph": [{"poses": 8, "edges": 10, "iters": 4}]}
    got = segsum_roofline.launches({}, shapes)
    assert len(got) == 66 * 3 + 6 * 4
    step = got[:66]
    assert [x["width"] for x in step[:5]] == [36, 9, 6, 3, 6]
    assert [x["width"] for x in step[5:65]] == [3, 6] * 30
    assert step[65]["width"] == 3
    assert {x["segments"] for x in step} == {8, 256}
    pg = got[198:204]
    assert [(x["rows"], x["segments"], x["width"]) for x in pg] == \
        [(360, 2304, 1)] * 4 + [(10, 8, 6)] * 2
    big = {"rows": 32768, "segments": 24, "width": 36}
    want = max(4.0 * (32768 * 36 + 32768 + 2 * 24 * 36) / 3.35e12,
               32768 * 36 / 33.5e12)
    assert segsum_roofline.bound_s(big) == pytest.approx(want)
    assert segsum_roofline.launches({}, {"images": [], "match_pairs": 0}) \
        == []
    # the unmasked rows, where the span gives them
    used = {"ba": [{**shapes["ba"][0], "obs_used": 700}]}
    assert {x["rows"] for x in segsum_roofline.launches({}, used)} == {700}


def test_roofline_share_reads_the_segsum_kernels():
    prof = {"steps": 1, "device_s_by_name": {
        "(anonymous namespace)::segsum_kernel(float*, ...)": 0.002,
        "(anonymous namespace)::segsum_short_kernel(float*, ...)": 0.001,
        "other": 1.0}}
    shapes = {"ba": [{"obs": 1024, "points": 256, "cams": 8, "iters": 1,
                      "cg_iters": 2}], "posegraph": []}
    tr = run.Trace({}, prof, {}, shapes)
    bound = sum(segsum_roofline.bound_s(x)
                for x in segsum_roofline.launches({}, shapes))
    assert tr.roofline_pct("segsum") == pytest.approx(100 * bound / 0.003)


def test_a_program_without_its_front_end_fails_at_set_up(monkeypatch):
    """The parent of the fixed-order sums hands back no front end: the
    cell stops in set-up, before any request."""
    from sift_tpu_torch.sfm import mapping as prog

    @dataclasses.dataclass
    class Bare:
        stats: dict

    monkeypatch.setattr(prog, "MappingResult", Bare)
    drv = run.traffic("mapping")
    with pytest.raises(RuntimeError, match="front end"):
        drv.make(run.cell_files(CELL)[1], {**run.cell_files(CELL)[0][
            "params"], **SMALL}, SEED, __import__("torch").device("cpu"))


def test_config_states_the_programs_defaults():
    """The configuration's back-end block is run_mapping's defaults, its
    SIFT block the port's DEFAULT_CONFIG, its focal length the scene's."""
    import inspect
    from sift_tpu_torch.config import DEFAULT_CONFIG, from_jax_config
    from sift_tpu_torch.sfm.mapping import run_mapping
    conf = json.loads((ROOT / "benchmark/configs/map_480p.json").read_text())
    entry = next(c for c in BENCH["configs"] if c["name"] == "map_480p")
    assert conf["reduced"] == entry["reduced"] == ["n_frames"]
    assert conf["source"] == entry["source"]
    assert from_jax_config(conf["sift"]) == DEFAULT_CONFIG
    params = inspect.signature(run_mapping).parameters
    for name, value in conf["back_end"].items():
        assert params[name].default == value, name
    _, k, _ = mapping_scene.render_corner_sequence(
        mapping_scene.mapping_textures(), n_frames=1,
        size=tuple(conf["frame_hw"]))
    assert k[0, 0] == conf["focal_over_width"] * conf["frame_hw"][1]
