"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level name (sift_tpu_torch begins with sift_tpu and is
allowed), and the reference imports nothing of the program."""

import ast
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parents[1]
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "sift_tpu"}
SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_imports_jax_or_the_jax_package():
    assert SOURCES
    for p in SOURCES:
        for name in _imports(p):
            assert name.split(".")[0] not in FORBIDDEN, (p, name)


def test_the_name_check_is_whole():
    assert "sift_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "sift_tpu.ops".split(".")[0] in FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    for p in sorted((HERE / "reference").rglob("*.py")):
        for name in _imports(p):
            assert not name.startswith("sift_tpu"), (p, name)
            assert name.split(".")[0] in {"__future__", "dataclasses",
                                          "math", "typing", "numpy",
                                          "scipy", "torch",
                                          "benchmark"}, (p, name)


def test_a_run_loads_no_jax():
    """Every module a run loads, in a fresh process: the harness, each
    traffic driver with the program modules it calls, each reader and
    each roofline count."""
    code = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
from benchmark import run
for k in ("video", "object"):
    run.traffic(k)
import sift_tpu_torch.sift, sift_tpu_torch.pipeline, sift_tpu_torch.ops.match
import json
bench = run.manifest()
for m in bench["per_layer"]:
    run.layer_reader(m["name"])
for k in ("k1", "k4"):
    run.roofline(k)
for w in bench["workloads"]:
    for s in run.cell_files(w["name"])[0]["metrics"].values():
        run.statistic(s)
from benchmark.reference import compare, sift_plain, homography_plain
from benchmark import calibrate, faults
print(run.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_the_card(tmp_path):
    """With no CUDA card the run exits non-zero and prints no result."""
    import torch
    if torch.cuda.is_available():
        return
    out = subprocess.run([sys.executable, str(HERE / "run.py"),
                          "--workload", "video_b8_1080p", "--seed",
                          str(2 ** 33), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
