"""The port stands alone: it imports no JAX, and no kernel of its path is
a library stand-in or sits behind a fallback."""

import pathlib
import re
import subprocess
import sys

import pytest

PKG = pathlib.Path(__file__).resolve().parent.parent / "sift_tpu_torch"
SOURCES = sorted(PKG.rglob("*.py"))


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import sift_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    sift_tpu_torch.__path__, 'sift_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k == 'jax' or k.startswith(('jax.', 'sift_tpu.'))\n"
        "             or k == 'sift_tpu')\n"
        "assert len(mods) >= 20, mods\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("pattern", [r"torch\.compile",
                                     r"scaled_dot_product_attention",
                                     r"^\s*(import jax|from jax)",
                                     r"^\s*(import|from) sift_tpu(\.|\s)"])
def test_no_forbidden_source(pattern):
    for src in SOURCES:
        text = src.read_text()
        assert not re.search(pattern, text, re.M), (src, pattern)


def test_kernel_launches_have_no_fallback():
    # a module that launches a kernel carries no try: a CUDA tensor goes
    # through the kernel or the call raises
    launching = [s for s in SOURCES if "_build.library()" in s.read_text()]
    assert {s.name for s in launching} == {
        "conv_cuda.py", "extrema_cuda.py", "ori_gather_cuda.py",
        "ori_hist_cuda.py", "descr_hist_cuda.py", "match_cuda.py"}
    for src in launching:
        assert not re.search(r"^\s*try\s*:", src.read_text(), re.M), src
        assert ".launches += 1" in src.read_text()


def test_every_kernel_has_a_cuda_source():
    names = {p.name for p in (PKG / "csrc").glob("*.cu")}
    assert names == {"blur.cu", "extrema.cu", "gather.cu", "ori_hist.cu",
                     "descr_hist.cu", "knn2.cu"}
    entries = set()
    for p in (PKG / "csrc").glob("*.cu"):
        text = p.read_text()
        assert "sift_tpu/ops/" in text and "_pallas.py" in text, p
        assert 'extern "C"' in text and "cudaGetLastError" in text, p
        entries |= set(re.findall(r'extern "C" int (\w+)\(', text))
    # ctypes binds exactly the C entry points the sources define
    from sift_tpu_torch import _build
    assert entries == set(_build._SIGNATURES)
