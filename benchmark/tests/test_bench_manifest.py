"""BENCHMARK.json against the benchmark's contract, and every file a
cell needs found by name."""

import json
import pathlib
import re

import pytest

HERE = pathlib.Path(__file__).resolve().parents[1]
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRIC_KEYS = {"name", "unit", "better", "source"}


def _text_ok(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_manifest_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_text():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names))
    for n in names + [w["config"] for w in BENCH["workloads"]] + [
            w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for w in BENCH["workloads"]:
        assert _text_ok(w["why"]), w["name"]
    for c in BENCH["configs"]:
        assert _text_ok(c["source"]) and _text_ok(c["why"])
        assert len(c["reduced"]) <= 16
    for m in BENCH["per_layer"]:
        assert _text_ok(m["layer"])
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) \
        == len(CELLS)


def test_setup_and_each_cell_reports_enough():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for cell in CELLS:
        mine = [n for n, m in e2e.items() if cell in m.get("workloads",
                                                            [cell])]
        assert "setup_s" in mine and len(mine) >= 2, cell
        assert any(cell in m.get("workloads", [cell])
                   for m in BENCH["per_layer"]), cell


def test_layer_metrics_move_a_metric_their_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", CELLS):
            assert cell in moved.get("workloads", CELLS), (m["name"], cell)
        if "roofline" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    work = json.loads((HERE / "workloads" / f"{cell}.json").read_text())
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    for k in ("config", "traffic", "chips", "why"):
        assert work[k] == entry[k], k
    conf = next(c for c in BENCH["configs"] if c["name"] == work["config"])
    assert (ROOT / conf["file"]).is_file()
    assert conf["file"] == f"benchmark/configs/{work['config']}.json"
    assert (HERE / "traffic" / f"{work['kind']}.py").is_file()
    e2e = [m["name"] for m in BENCH["end_to_end"]
           if cell in m.get("workloads", [cell]) and m["name"] != "setup_s"]
    assert sorted(work["metrics"]) == sorted(e2e)
    for stat in work["metrics"].values():
        assert (HERE / "window_stats" / f"{stat}.py").is_file(), stat
    for m in BENCH["per_layer"]:
        if cell in m.get("workloads", CELLS):
            assert (HERE / "layer_metrics" / f"{m['name']}.py").is_file()
    assert set(work["limits"]) and all(
        isinstance(v, float) for v in work["limits"].values())


def test_config_is_the_programs_default():
    """The configuration file's SIFT block is the port's DEFAULT_CONFIG,
    field for field, and the reference's own copy of the block."""
    import dataclasses
    from sift_tpu_torch.config import DEFAULT_CONFIG, from_jax_config
    from benchmark.reference.sift_plain import RefConfig, ref_config
    for c in BENCH["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["source"] == c["source"] and conf["reduced"] == []
        assert from_jax_config(conf["sift"]) == DEFAULT_CONFIG
        assert ref_config(conf["sift"]) == RefConfig()
        assert {f.name for f in dataclasses.fields(RefConfig)} == {
            f.name for f in dataclasses.fields(type(DEFAULT_CONFIG))}


def test_check_budget_fits_every_later_check():
    """A full check of 24 cells fits its 43,200 seconds."""
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
